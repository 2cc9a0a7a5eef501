"""The split-KV arithmetic of the card's decode-attention kernel (K4,
csrc/decode_attention.cu), emulated in plain torch by
``decode_attention_split_plain``, against the one-pass plain version and
against the JAX package's Pallas kernels ``decode_attention`` /
``decode_attention_int8`` run in interpret mode (as
tests/test_torch_decode_attention.py runs them), at the kernel's edge
cases: ``idx`` one before, at and one after a split boundary, past the
cache end and below 0, rows at mixed positions, rep 1 and 16, f32 and
int8 caches.  Inputs are numpy draws from a seed, f32 on both sides.

Tolerance atol = rtol = 1e-6: every side computes in f32; the split
emulation rescales each split's exact partial by e^(m_j - M) and sums the
splits in order, which moves a result by a few f32 ulps of entries of
size ~1 (the observed gap is below 4e-7), not by 1e-6.  The card kernel
itself runs only on the card (tests/test_torch_cuda_kernels.py, marked
``cuda``, and chip_smoke.py's phase 2a)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.models.llama import _amax_quantize as jax_amax_quantize
from bluefog_tpu.parallel.pallas_decode import (
    decode_attention as jax_decode, decode_attention_int8 as jax_decode8)
from bluefog_tpu_torch.parallel import decode_attention as da

TOL = dict(atol=1e-6, rtol=1e-6)
SPLIT = 32


def _case(b, n_kv, rep, s, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, 1, n_kv * rep, d).astype(np.float32)
    k = rng.randn(b, n_kv, s, d).astype(np.float32)
    v = rng.randn(b, n_kv, s, d).astype(np.float32)
    return q, k, v


def _quantized(k, v):
    kq, ks = (np.asarray(a) for a in jax_amax_quantize(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jax_amax_quantize(jnp.asarray(v)))
    return kq, ks[..., 0], vq, vs[..., 0]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# each row of a call at its own position: around the boundaries of the
# 32-position splits, the last position, past the end, and no key at all
BOUNDARY_ROWS = [SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT - 1, 2 * SPLIT,
                 2 * SPLIT + 1, 0, 99]


@pytest.mark.parametrize("rep", [1, 16])
@pytest.mark.parametrize("quantized", [False, True])
def test_split_emulation_matches_plain_at_split_boundaries(rep, quantized):
    b, n_kv, s, d = len(BOUNDARY_ROWS), 2, 100, 16
    q, k, v = _case(b, n_kv, rep, s, d, seed=rep)
    idx = torch.tensor(BOUNDARY_ROWS, dtype=torch.int32)
    if quantized:
        kq, ks, vq, vs = _t(*_quantized(k, v))
        args, scales = (kq, vq), (ks, vs)
    else:
        args, scales = tuple(_t(k, v)), ()
    qt = torch.from_numpy(q)
    got = da.decode_attention_split_plain(qt, *args, idx, SPLIT, *scales)
    want = da.decode_attention_plain(qt, *args, idx, *scales)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("idx", [SPLIT - 1, SPLIT, SPLIT + 1, 127, 130])
@pytest.mark.parametrize("rep", [1, 4])
def test_split_emulation_matches_jax_kernel(idx, rep):
    """One row position per call, as the JAX kernel takes it (a scalar);
    130 is past the cache end (S = 128), where both read every key."""
    q, k, v = _case(2, 2, rep, 128, 16, seed=idx)
    got = da.decode_attention_split_plain(*_t(q, k, v), idx, SPLIT).numpy()
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.int32(idx))
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("idx", [SPLIT - 1, SPLIT + 1, 127])
def test_split_emulation_int8_matches_jax_kernel(idx):
    """int8 cache: the value scale rides in each split's numerator and
    not in its denominator, as in the JAX kernel's single pass."""
    q, k, v = _case(2, 2, 4, 128, 32, seed=10 + idx)
    kq, ks, vq, vs = _quantized(k, v)
    got = da.decode_attention_split_plain(
        torch.from_numpy(q), *_t(kq, vq), idx, SPLIT, *_t(ks, vs)).numpy()
    ref = jax_decode8(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks),
                      jnp.asarray(vq), jnp.asarray(vs), jnp.int32(idx))
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_empty_splits_and_masked_rows_give_no_nan():
    """Rows whose later splits hold no live position, and a row with no
    key at all (idx < 0), merge without NaN: dead splits are left out,
    and the masked row is 0 as the kernel's max(l, 1e-30) guard gives."""
    q, k, v = _t(*_case(3, 1, 2, 96, 16, seed=3))
    idx = torch.tensor([-1, 0, 95], dtype=torch.int32)
    got = da.decode_attention_split_plain(q, k, v, idx, SPLIT)
    assert torch.isfinite(got).all()
    assert torch.count_nonzero(got[0]) == 0
    np.testing.assert_allclose(got.numpy(), da.decode_attention_plain(
        q, k, v, idx).numpy(), **TOL)


def test_dropping_the_last_live_split_is_a_different_result():
    """The planted fault of chip_smoke.py's phase 2a: a merge one split
    short.  Rows with one live split lose everything; rows with more lose
    their last split's positions."""
    q, k, v = _t(*_case(4, 2, 4, 128, 16, seed=4))
    idx = torch.tensor([10, SPLIT, 2 * SPLIT - 1, 127], dtype=torch.int32)
    live = idx // SPLIT + 1
    good = da.decode_attention_split_plain(q, k, v, idx, SPLIT)
    bad = da.decode_attention_split_plain(q, k, v, idx, SPLIT,
                                          n_live=live - 1)
    assert torch.count_nonzero(bad[0]) == 0
    for row in range(4):
        assert (bad[row] - good[row]).abs().max() > 1e-2


@pytest.mark.parametrize("seq_len,pairs,sms,want", [
    (2048, 64, 132, 256),   # Llama-3.1-8B serving: B=8, KV=8 -> 8 splits
    (8192, 64, 132, 928),
    (1024, 64, 132, 128),   # MoE serving at 8B width: 8 slots
    (1024, 8, 132, 32),     # one row: 32 splits
    (64, 8, 132, 32),       # a 64-position cache: 2 splits
    (77, 8, 132, 32),       # short caches: 32 positions per split
    (100, 1024, 132, 128),  # more pairs than 4 blocks per SM: one split
])
def test_split_len_is_whole_units_and_fills_the_card(seq_len, pairs, sms,
                                                     want):
    split = da.split_len(seq_len, pairs, sms)
    assert split == want and split % da.SPLIT_UNIT == 0
    n_splits = -(-seq_len // split)
    assert n_splits * split >= seq_len > (n_splits - 1) * split
    assert pairs * n_splits <= max(pairs, da.BLOCKS_PER_SM * sms) + pairs

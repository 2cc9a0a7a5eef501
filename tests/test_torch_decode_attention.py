"""The port's decode-attention module
(bluefog_tpu_torch/parallel/decode_attention.py) against the JAX
package: its plain version against ``_cached_attention`` and against
the Pallas kernel ``decode_attention``/``decode_attention_int8`` run in
interpret mode, at the cases of tests/test_pallas_decode.py.  Inputs are
numpy draws from a seed, f32 on both sides (conftest turns on x64, so
every JAX array is pinned to f32).  Tolerance atol = rtol = 1e-5: both
sides compute in f32 and differ only in summation order.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda_
kernels.py (marked ``cuda``) and chip_smoke.py's phase 2 hold it
against the plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.models.llama import _amax_quantize as jax_amax_quantize
from bluefog_tpu.models.llama import _cached_attention as jax_cached
from bluefog_tpu.parallel.pallas_decode import (
    decode_attention as jax_decode, decode_attention_int8 as jax_decode8)
from bluefog_tpu_torch.parallel import decode_attention as da

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(b, n_kv, rep, s, d, idx, seed, q_scale=1.0, zero_tail=True):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, 1, n_kv * rep, d) * q_scale).astype(np.float32)
    k = rng.randn(b, n_kv, s, d).astype(np.float32)
    v = rng.randn(b, n_kv, s, d).astype(np.float32)
    if zero_tail:  # an unwritten cache tail is zeros; it must be masked
        mask = (np.arange(s) <= idx)[None, None, :, None]
        k, v = k * mask, v * mask
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("idx", [0, 5, 127])
@pytest.mark.parametrize("rep", [1, 4])
def test_plain_matches_jax_cached_attention_and_kernel(idx, rep):
    q, k, v = _case(2, 3, rep, 128, 16, idx, seed=1)
    out = da.decode_attention_plain(*_t(q, k, v), idx).numpy()
    ref = jax_cached(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.int32(idx))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    ker = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.int32(idx))
    np.testing.assert_allclose(out, np.asarray(ker), **TOL)


def test_int8_plain_matches_jax_kernel_and_dequant_reference():
    """int8 cache at idx 200: the plain version (key scale on the score
    columns, value scale on the probabilities) equals both the JAX int8
    kernel and float attention over the dequantized cache."""
    idx = 200
    q, k, v = _case(2, 2, 4, 256, 32, idx, seed=2)
    kq, ks = jax_amax_quantize(jnp.asarray(k))
    vq, vs = jax_amax_quantize(jnp.asarray(v))
    ks, vs = ks[..., 0], vs[..., 0]
    out = da.decode_attention_plain(
        *_t(q, np.asarray(kq), np.asarray(vq)), idx,
        *_t(np.asarray(ks), np.asarray(vs))).numpy()
    ker = jax_decode8(jnp.asarray(q), kq, ks, vq, vs, jnp.int32(idx))
    np.testing.assert_allclose(out, np.asarray(ker), **TOL)
    ref = jax_cached(jnp.asarray(q), kq.astype(jnp.float32) * ks[..., None],
                     vq.astype(jnp.float32) * vs[..., None], jnp.int32(idx))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_plain_matches_blocked_online_softmax():
    """The JAX kernel's flash recurrence over S blocks (block_s=128 at
    S=512, large query scale) equals the plain one-shot softmax."""
    q, k, v = _case(1, 2, 2, 512, 16, 511, seed=4, q_scale=4.0,
                    zero_tail=False)
    out = da.decode_attention_plain(*_t(q, k, v), 511).numpy()
    ker = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.int32(511), block_s=128)
    np.testing.assert_allclose(out, np.asarray(ker), **TOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_per_row_idx_matches_scalar_idx_row_by_row(quantized):
    """One call with idx [B] == the JAX scalar-idx kernel called once per
    row at that row's position."""
    b, n_kv, rep, s, d = 3, 2, 2, 64, 16
    idxs = [0, 37, 63]
    q, k, v = _case(b, n_kv, rep, s, d, 63, seed=7, zero_tail=False)
    if quantized:
        kq, ks = (np.asarray(a) for a in jax_amax_quantize(jnp.asarray(k)))
        vq, vs = (np.asarray(a) for a in jax_amax_quantize(jnp.asarray(v)))
        args = (kq, vq)
        scales = (ks[..., 0], vs[..., 0])
    else:
        args, scales = (k, v), ()
    out = da.decode_attention_plain(
        torch.from_numpy(q), *_t(*args),
        torch.tensor(idxs, dtype=torch.int32), *_t(*scales)).numpy()
    for row, idx in enumerate(idxs):
        sl = slice(row, row + 1)
        if quantized:
            ref = jax_decode8(jnp.asarray(q[sl]), jnp.asarray(args[0][sl]),
                              jnp.asarray(scales[0][sl]),
                              jnp.asarray(args[1][sl]),
                              jnp.asarray(scales[1][sl]), jnp.int32(idx))
        else:
            ref = jax_decode(jnp.asarray(q[sl]), jnp.asarray(k[sl]),
                             jnp.asarray(v[sl]), jnp.int32(idx))
        np.testing.assert_allclose(out[sl], np.asarray(ref), **TOL)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    q, k, v = _t(*_case(2, 2, 2, 32, 16, 9, seed=3))
    da.reset_launch_counts()
    np.testing.assert_array_equal(
        da.decode_attention(q, k, v, 9).numpy(),
        da.decode_attention_plain(q, k, v, 9).numpy())
    kq, ks = torch.ones_like(k, dtype=torch.int8), torch.ones(2, 2, 32)
    np.testing.assert_array_equal(
        da.decode_attention_int8(q, kq, ks, kq, ks, 9).numpy(),
        da.decode_attention_plain(q, kq, kq, 9, ks, ks).numpy())
    assert da.decode_attention.launches == 0
    assert da.decode_attention_int8.launches == 0


def test_masked_row_gives_zero_like_the_kernel_guard():
    """idx < 0 masks every key: the kernel's max(l, 1e-30) guard returns
    0, and so does the plain version."""
    q, k, v = _t(*_case(1, 1, 2, 8, 16, 7, seed=5))
    out = da.decode_attention_plain(q, k, v, -1)
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("bad", ["head_dim", "rep", "dtype", "scales",
                                 "contiguous", "shape", "idx"])
def test_launch_refuses_what_the_kernel_does_not_take(bad):
    """The CUDA path validates before it binds the library, so these
    refusals are checked on the host."""
    b, n_kv, rep, s, d = 2, 2, 2, 16, 16
    q = torch.zeros(b, 1, n_kv * rep, d)
    k = torch.zeros(b, n_kv, s, d)
    v = torch.zeros(b, n_kv, s, d)
    ks = vs = None
    idx = 3
    if bad == "head_dim":
        q, k, v = q[..., :8], k[..., :8], v[..., :8]
    elif bad == "rep":
        q = torch.zeros(b, 1, n_kv * 17, d)
    elif bad == "dtype":
        q = q.half()
    elif bad == "scales":
        ks = vs = torch.ones(b, n_kv, s)   # scales with a float cache
    elif bad == "contiguous":
        v = torch.zeros(b, n_kv, d, s).transpose(2, 3)
    elif bad == "shape":
        v = torch.zeros(b, n_kv, s + 1, d)
    elif bad == "idx":
        idx = torch.zeros(b + 1, dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        da._launch(q, k, v, ks, vs, idx)

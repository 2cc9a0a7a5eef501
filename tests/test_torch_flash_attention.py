"""The port's flash attention (bluefog_tpu_torch/parallel/
flash_attention.py) and single-device attention references
(parallel/ring_attention.py) against the JAX package's.

The same numpy inputs go through the JAX flash kernels in interpret mode
(``bluefog_tpu/parallel/pallas_attention.py``, as
``tests/test_pallas_attention.py`` runs them on the CPU) and through the
port's ``flash_attention`` on CPU tensors, where each kernel wrapper runs
its plain version.  The six tests of ``tests/test_pallas_attention.py``
are mirrored one for one.  Tolerance: 1e-5 in f32 (the reference's own;
the two sum in another order) and 1e-4 for gradients (the reference's);
bf16 below."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.parallel import pallas_attention as jpa
from bluefog_tpu.parallel import ring_attention as jra
from bluefog_tpu_torch.parallel import flash_attention as tfa
from bluefog_tpu_torch.parallel import flash_check
from bluefog_tpu_torch.parallel import ring_attention as tra

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(seed, b, tq, tk, h, hkv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, tq, h, d).astype(np.float32),
            rng.randn(b, tk, hkv, d).astype(np.float32),
            rng.randn(b, tk, hkv, d).astype(np.float32))


def _j(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _t(*arrs, grad=False):
    return tuple(torch.tensor(a, requires_grad=grad) for a in arrs)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 2])
def test_flash_matches_full(causal, hkv):
    q, k, v = _qkv(0, 2, 64, 64, 4, hkv, 16)
    ref = jpa.flash_attention(*_j(q, k, v), causal=causal, block_q=16,
                              block_k=16)
    out = tfa.flash_attention(*_t(q, k, v), causal=causal, block_q=16,
                              block_k=16)
    assert out.shape == (2, 64, 4, 16) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    dense = tra.full_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **TOL)


def test_flash_offsets_mask_globally():
    """A kv block strictly in the future is fully masked (out 0, lse
    -1e30); a block strictly in the past is fully visible."""
    q, k, v = _qkv(1, 1, 16, 16, 2, 2, 8)
    out, lse = tfa.flash_attention_with_lse(*_t(q, k, v), causal=True,
                                            q_offset=0, kv_offset=64)
    jout, jlse = jpa.flash_attention_with_lse(*_j(q, k, v), causal=True,
                                              q_offset=0, kv_offset=64,
                                              block_q=16, block_k=16)
    assert lse.shape == (1, 2, 16) and lse.dtype == torch.float32
    assert lse.max().item() < -1e29
    np.testing.assert_array_equal(out.numpy(), 0.0)
    np.testing.assert_array_equal(lse.numpy(), np.asarray(jlse))
    np.testing.assert_array_equal(np.asarray(jout), 0.0)

    out2, lse2 = tfa.flash_attention_with_lse(*_t(q, k, v), causal=True,
                                              q_offset=64, kv_offset=0)
    jout2, jlse2 = jpa.flash_attention_with_lse(*_j(q, k, v), causal=True,
                                                q_offset=64, kv_offset=0,
                                                block_q=16, block_k=16)
    np.testing.assert_allclose(out2.numpy(), np.asarray(jout2), **TOL)
    np.testing.assert_allclose(lse2.numpy(), np.asarray(jlse2), **TOL)
    ref = tra.full_attention(*_t(q, k, v), causal=False)
    np.testing.assert_allclose(out2.numpy(), ref.numpy(), **TOL)


def test_flash_lse_values():
    q, k, v = _qkv(2, 1, 32, 32, 2, 2, 8)
    _, lse = tfa.flash_attention_with_lse(*_t(q, k, v), causal=False)
    _, jlse = jpa.flash_attention_with_lse(*_j(q, k, v), causal=False,
                                           block_q=8, block_k=8)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(8)
    expected = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    np.testing.assert_allclose(lse.numpy(), expected, **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


def _grads_jax(q, k, v, **kw):
    def loss(q, k, v):
        return jnp.sum(jpa.flash_attention(q, k, v, block_q=8, block_k=8,
                                           **kw) ** 2)

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(*_j(q, k, v))]


def _grads_port(q, k, v, **kw):
    tq, tk, tv = _t(q, k, v, grad=True)
    loss = (tfa.flash_attention(tq, tk, tv, **kw) ** 2).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (tq, tk, tv))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [2, 1])
def test_flash_gradients(causal, hkv):
    """The backward (K3a, K3b plain versions) against JAX's two Pallas
    backward passes, GQA head-group sums included; and against autograd
    through the dense reference."""
    q, k, v = _qkv(3, 2, 32, 32, 2, hkv, 8)
    g_port = _grads_port(q, k, v, causal=causal)
    for a, b in zip(g_port, _grads_jax(q, k, v, causal=causal)):
        np.testing.assert_allclose(a, b, **GTOL)
    tq, tk, tv = _t(q, k, v, grad=True)
    loss = (tra.full_attention(tq, tk, tv, causal=causal) ** 2).sum()
    for a, b in zip(g_port, torch.autograd.grad(loss, (tq, tk, tv))):
        np.testing.assert_allclose(a, b.numpy(), **GTOL)


def test_flash_gradients_with_offsets():
    """The backward respects the global-position causal mask: a fully
    past kv block has the gradients of non-causal attention, a fully
    future one zero gradients."""
    q, k, v = _qkv(6, 1, 16, 16, 2, 2, 8)
    g_port = _grads_port(q, k, v, causal=True, q_offset=64, kv_offset=0)
    for a, b in zip(g_port, _grads_jax(q, k, v, causal=True, q_offset=64,
                                       kv_offset=0)):
        np.testing.assert_allclose(a, b, **GTOL)
    for a, b in zip(g_port, _grads_port(q, k, v, causal=False)):
        np.testing.assert_allclose(a, b, **GTOL)
    dead = _grads_port(q, k, v, causal=True, q_offset=0, kv_offset=64)
    for g in dead:
        np.testing.assert_array_equal(g, 0.0)


def test_flash_offsets_are_plain_ints():
    """JAX traces the offsets (one compile serves every ring step); the
    port takes them as ints, one function for all.  Both agree at two
    offsets with the dense non-causal reference."""
    q, k, v = _qkv(4, 1, 16, 16, 2, 2, 8)

    @jax.jit
    def f(off):
        return jpa.flash_attention(*_j(q, k, v), causal=True, q_offset=off,
                                   kv_offset=0, block_q=16, block_k=16)

    ref = tra.full_attention(*_t(q, k, v), causal=False).numpy()
    for off in (16, 64):
        out = tfa.flash_attention(*_t(q, k, v), causal=True, q_offset=off,
                                  kv_offset=0)
        np.testing.assert_allclose(out.numpy(), np.asarray(f(jnp.int32(off))),
                                   **TOL)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_flash_bf16_matches_jax_bf16():
    """bf16 q/k/v through both packages' flash (JAX in interpret mode
    with one block per sequence, so its online softmax has one step like
    the plain version's).  Tolerance: 2 bf16 ulps of the output's
    magnitude (rtol = atol = 1.6e-2): P is rounded to bf16 before P·V on
    both sides, from f32 exponentials that may differ in the last bit;
    lse is f32 (1e-5)."""
    q, k, v = _qkv(7, 2, 32, 32, 4, 2, 16)
    jq, jk, jv = (x.astype(jnp.bfloat16) for x in _j(q, k, v))
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    jout, jlse = jpa.flash_attention_with_lse(jq, jk, jv, causal=True,
                                              block_q=32, block_k=32)
    out, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=1.6e-2, atol=1.6e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


def test_flash_casts_kv_to_q_dtype_and_any_length():
    """k/v are cast to q's dtype; a sequence length the reference's
    blocks would not tile (T = 37) still matches the dense reference."""
    q, k, v = _qkv(8, 1, 37, 37, 4, 2, 16)
    tq, tk, tv = _t(q, k, v)
    out = tfa.flash_attention(tq, tk.double(), tv.double(), causal=True)
    assert out.dtype == torch.float32
    ref = tra.full_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offsets", [(0, 0), (0, 40), (32, 0)])
def test_full_attention_matches_jax(causal, offsets):
    q, k, v = _qkv(9, 2, 24, 24, 4, 2, 16)
    q_off, kv_off = offsets
    ref = jra.full_attention(*_j(q, k, v), causal=causal, q_offset=q_off,
                             kv_offset=kv_off)
    out = tra.full_attention(*_t(q, k, v), causal=causal, q_offset=q_off,
                             kv_offset=kv_off)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 1])
def test_blockwise_attention_matches_jax(causal, hkv):
    q, k, v = _qkv(10, 2, 32, 32, 4, hkv, 16)
    ref = jra.blockwise_attention(*_j(q, k, v), 8, causal=causal)
    out = tra.blockwise_attention(*_t(q, k, v), 8, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    tq, tk, tv = _t(q, k, v, grad=True)
    jg = jax.grad(lambda *a: jnp.sum(jra.blockwise_attention(
        *a, 8, causal=causal) ** 2), argnums=(0, 1, 2))(*_j(q, k, v))
    loss = (tra.blockwise_attention(tq, tk, tv, 8, causal=causal) ** 2).sum()
    for a, b in zip(torch.autograd.grad(loss, (tq, tk, tv)), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GTOL)


def test_cpu_path_counts_no_launches():
    """On CPU tensors the wrappers run their plain versions and count
    nothing (the counts are the card's launches)."""
    tfa.reset_launch_counts()
    q, k, v = _t(*_qkv(12, 1, 16, 16, 2, 1, 16), grad=True)
    tfa.flash_attention(q, k, v).sum().backward()
    assert (tfa.flash_forward.launches, tfa.flash_backward_dq.launches,
            tfa.flash_backward_dkv.launches) == (0, 0, 0)


@pytest.fixture(scope="module")
def bf16_at_training_length():
    """bf16 inputs at the Llama training length (T = 2048, D = 128, GQA
    rep 4), one kv head wide, with the plain versions' outputs."""
    g = torch.Generator().manual_seed(13)
    q, do = (torch.randn(1, 2048, 4, 128, generator=g).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(1, 2048, 1, 128, generator=g).to(torch.bfloat16)
            for _ in range(2))
    out, lse = tfa.flash_forward_plain(q, k, v)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    ref = dict(zip(("out", "dq", "dk", "dv"),
                   (out, *tfa.flash_backward_plain(q, k, v, do, lse,
                                                   delta))))
    terms = flash_check.term_sizes(q, k, v, do, lse, delta)
    return q, k, v, do, lse, delta, ref, terms


def test_kernel_check_passes_online_softmax_rounding(bf16_at_training_length):
    """The card check's bound (``flash_check.mismatch``) leaves room for
    the kernel's own order: a forward taken in 64-key tiles with P
    rounded to bf16 from the running maximum, as K2 does, passes it
    against the plain version (which rounds P from the final maximum)."""
    q, k, v, _, _, _, ref, terms = bf16_at_training_length
    b, t, h, d = q.shape
    s = tfa._scores(q, k, True, d ** -0.5, 0, 0)       # [B, KV, rep, T, S]
    m = torch.full(s.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(*s.shape[:-1], d)
    vt = v.float().transpose(1, 2)[:, :, None]           # [B, KV, 1, S, D]
    for j in range(0, t, 64):
        sj = s[..., j:j + 64]
        m_new = torch.maximum(m, sj.amax(-1, keepdim=True))
        p = torch.where(sj <= -5e29, 0.0, torch.exp(sj - m_new))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vt[..., j:j + 64, :]
        m = m_new
    tiled = tfa._heads(acc / l, b, t, h).to(torch.bfloat16)
    assert not torch.equal(tiled, ref["out"])
    assert flash_check.mismatch(tiled, ref["out"], terms["out"]) <= 1


def test_kernel_check_passes_wgmma_backward_rounding(bf16_at_training_length):
    """The same bound leaves room for the wgmma K3a's and K3b's own
    arithmetic: P recomputed as 2**(x·c - lse·log2 e) from the unscaled
    f32 score x with c = scale·log2 e (one fused multiply-add, rounded
    once to f32), P rounded to bf16 for dV and dS for dK and dQ, and each
    output summed over the kernels' tiles in their order (dQ over steps of
    ``DQ_KEY_TILE`` keys; dK and dV over 64-row query tiles, the group
    members inside each).  The emulation differs from the plain versions
    and passes the unchanged bound, which still rejects the planted faults
    at K3a's key tile."""
    q, k, v, do, lse, delta, ref, terms = bf16_at_training_length
    b, t, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = d ** -0.5
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    q5, do5 = (x.reshape(b, t, kv, rep, d).float() for x in (q, do))
    x = torch.einsum("btgrd,bsgd->bgrts", q5, k.float())  # unscaled
    c = torch.tensor(scale, dtype=torch.float32) * log2e
    l2 = lse.reshape(b, kv, rep, t, 1) * log2e
    p = torch.exp2((x.double() * c.double() - l2.double()).float())
    pos = torch.arange(t)
    p = torch.where(pos[:, None] >= pos[None, :], p, 0.0)
    dp = torch.einsum("btgrd,bsgd->bgrts", do5, v.float())
    ds = p * (dp - delta.reshape(b, kv, rep, t, 1))
    p16, ds16 = (y.to(torch.bfloat16).float() for y in (p, ds))
    k4 = k.float().transpose(1, 2)[:, :, None]            # [B, KV, 1, S, D]
    dq = torch.zeros(b, kv, rep, t, d)
    for j in range(0, t, tfa.DQ_KEY_TILE):
        dq += ds16[..., j:j + tfa.DQ_KEY_TILE] @ k4[..., j:j + tfa.DQ_KEY_TILE, :]
    dk, dv = torch.zeros(b, kv, t, d), torch.zeros(b, kv, t, d)
    q6, do6 = (y.permute(0, 2, 3, 1, 4) for y in (q5, do5))  # [B, KV, rep, T, D]
    for i in range(0, t, 64):
        for r in range(rep):
            rows = slice(i, i + 64)
            dv += p16[:, :, r, rows].transpose(-1, -2) @ do6[:, :, r, rows]
            dk += ds16[:, :, r, rows].transpose(-1, -2) @ q6[:, :, r, rows]
    got = {"dq": tfa._heads(dq * scale, b, t, h).to(torch.bfloat16),
           "dk": (dk * scale).transpose(1, 2).to(torch.bfloat16),
           "dv": dv.transpose(1, 2).to(torch.bfloat16)}
    for key, y in got.items():
        assert not torch.equal(y, ref[key]), key
        assert flash_check.mismatch(y, ref[key], terms[key]) <= 1, key
    faults = flash_check.planted_faults(q, k, v, do, lse, delta, ref,
                                        tile=tfa.DQ_KEY_TILE)
    assert [key for _, key, _ in faults] == ["out", "dq", "dk", "dv"]
    for fault, key, bad in faults:
        assert flash_check.mismatch(bad, ref[key], terms[key]) > 1, \
            (fault, key)


def test_kernel_check_rejects_noncausal_planted_faults():
    """At the ViT-B/16 shape (T = 200, D = 64, 12 heads, non-causal) the
    bound rejects a skipped last key tile (out, dQ) and a skipped last
    query tile (dK, dV), each wrong only from max(T/2, tile) on, for K3a's
    key tile and for a tile that divides T."""
    g = torch.Generator().manual_seed(17)
    q, k, v, do = (torch.randn(1, 200, 12, 64, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = tfa.flash_forward_plain(q, k, v, False)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    ref = dict(zip(("out", "dq", "dk", "dv"),
                   (out, *tfa.flash_backward_plain(q, k, v, do, lse, delta,
                                                   False))))
    terms = flash_check.term_sizes(q, k, v, do, lse, delta, False)
    for tile in (tfa.DQ_KEY_TILE, 50):
        faults = flash_check.planted_faults(q, k, v, do, lse, delta, ref,
                                            tile=tile, causal=False)
        assert [key for _, key, _ in faults] == ["out", "dq", "dk", "dv"]
        start = max(200 // 2 // tile * tile, tile)
        for fault, key, bad in faults:
            assert flash_check.mismatch(ref[key], ref[key], terms[key]) == 0
            assert flash_check.mismatch(bad, ref[key], terms[key]) > 1, \
                (tile, fault, key)
            assert torch.equal(bad[:, :start], ref[key][:, :start])


def test_kernel_check_rejects_planted_faults_within_one_tile():
    """At the uncached rollout's shape (one 23-token causal row at 8B
    width, under one tile) the faults lose a block of 8 keys within the
    tile: rows from 8 on see only the keys of the blocks before their
    own (out, dQ), and keys from 8 on lose the last group member (dK,
    dV); the bound rejects each, and rows before 8 stay as they were."""
    case = flash_check.CASES[flash_check.N_MODEL - 1]
    b, t, h, kv, d, dtype, causal, q_off, kv_off = case
    assert (b, t, causal, q_off, kv_off) == (1, 23, True, 0, 0)
    g = torch.Generator().manual_seed(23)
    q, do = (torch.randn(b, t, h, d, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, t, kv, d, generator=g).to(dtype)
            for _ in range(2))
    out, lse = tfa.flash_forward_plain(q, k, v, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    ref = dict(zip(("out", "dq", "dk", "dv"),
                   (out, *tfa.flash_backward_plain(q, k, v, do, lse, delta,
                                                   True))))
    terms = flash_check.term_sizes(q, k, v, do, lse, delta, True)
    faults = flash_check.planted_faults(q, k, v, do, lse, delta, ref,
                                        tile=tfa.DQ_KEY_TILE)
    assert [key for _, key, _ in faults] == ["out", "dq", "dk", "dv"]
    for fault, key, bad in faults:
        assert flash_check.mismatch(bad, ref[key], terms[key]) > 1, \
            (fault, key)
        assert torch.equal(bad[:, :8], ref[key][:, :8])
        assert not torch.equal(bad[:, 8:], ref[key][:, 8:])


def test_kernel_check_rejects_planted_faults(bf16_at_training_length):
    """The same bound rejects wrong kernels whose error lies only past
    T/2, where entries are smallest: a skipped diagonal key tile (out,
    dQ) and a skipped group member (dK, dV)."""
    *inputs, ref, terms = bf16_at_training_length
    faults = flash_check.planted_faults(*inputs, ref)
    assert [key for _, key, _ in faults] == ["out", "dq", "dk", "dv"]
    for fault, key, bad in faults:
        assert flash_check.mismatch(ref[key], ref[key], terms[key]) == 0
        assert flash_check.mismatch(bad, ref[key], terms[key]) > 1, \
            (fault, key)
        half = bad.shape[1] // 2
        assert torch.equal(bad[:, :half], ref[key][:, :half])

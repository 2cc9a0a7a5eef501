"""Sequence-parallel attention on the card: ring and Ulysses attention
over K2, K3a and K3b against their plain versions, and the kernels on a
block the causal mask covers whole.  Marked ``cuda``: without an NVIDIA
card every test here skips (a CUDA kernel has no CPU mode).  The file
imports torch and the port only, so it also runs where jax is not
installed:

    python -m pytest --noconftest -q tests/test_torch_ring_cuda.py

Tolerance: ``flash_check.mismatch``, each entry within its own bound (bf16:
two ulps of the entry plus 2**-7 of the sizes of its terms whose bf16
rounding may differ, summed over the ring's live pairs by
``flash_check.ring_term_sizes``); lse within 1e-4 absolute plus 1e-5
relative; a block masked whole must give exactly out 0, lse -1e30 and
dQ, dK, dV 0."""

import pytest
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch.parallel import flash_attention as fa
from bluefog_tpu_torch.parallel import flash_check
from bluefog_tpu_torch.parallel.ring_attention import (PLAIN_KERNELS,
                                                       ring_attention,
                                                       ring_flash_parts)
from bluefog_tpu_torch.parallel.ulysses import ulysses_attention


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")


def _rand(g, shape, dtype):
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


def _ring_inputs(seed, s, b, t, h, kv, d, dtype=torch.bfloat16):
    g = torch.Generator("cuda").manual_seed(seed)
    return (_rand(g, (s, b, t, h, d), dtype),
            _rand(g, (s, b, t, kv, d), dtype),
            _rand(g, (s, b, t, kv, d), dtype),
            _rand(g, (s, b, t, h, d), dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("causal,d", [(True, 128), (False, 64)])
def test_ring_on_card_matches_plain(causal, d):
    """The flash ring at sp = 4 (K2, K3a, K3b per live pair: 10 of 16
    causal) against the same ring over the plain versions on the same
    card tensors, entry by entry; the autograd path gives the same bits
    as the ring's parts; the bound rejects the ring with one live pair
    left out."""
    _card()
    s, b, t, h, kv = 4, 1, 256, 8, 2
    q, k, v, do = _ring_inputs(0, s, b, t, h, kv, d)
    axis = bt.SeqAxis("sp", s)
    fa.reset_launch_counts()
    got = ring_flash_parts(q, k, v, do, axis, causal)
    torch.cuda.synchronize()
    live = 10 if causal else 16
    assert (fa.flash_forward.launches, fa.flash_backward_dq.launches,
            fa.flash_backward_dkv.launches) == (live,) * 3
    want = ring_flash_parts(q, k, v, do, axis, causal,
                            kernels=PLAIN_KERNELS)
    delta = (do.float() * want["out"].float()).sum(-1).transpose(2, 3)
    terms = flash_check.ring_term_sizes(q, k, v, do, want["lse"], delta, s,
                                        causal)
    for key in ("out", "dq", "dk", "dv"):
        ratio = flash_check.mismatch(got[key], want[key], terms[key])
        assert ratio <= 1, f"{key}: {ratio:.3g} times its bound"
    torch.testing.assert_close(got["lse"], want["lse"], rtol=1e-5,
                               atol=1e-4)
    # the autograd path: the same kernels in the same order
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ring_attention(*leaves, axis, causal=causal, impl="flash")
    grads = torch.autograd.grad(out, leaves, do)
    assert torch.equal(out, got["out"])
    for a, key in zip(grads, ("dq", "dk", "dv")):
        assert torch.equal(a, got[key]), key
    bad = flash_check.ring_planted_fault(q, k, v, do, axis, causal)
    for key in ("out", "dq", "dk", "dv"):
        assert flash_check.mismatch(bad[key], want[key], terms[key]) > 1, key


@pytest.mark.cuda
def test_ulysses_on_card_is_the_unsharded_kernel():
    """Ulysses at sp = 4 on the card: one K2 launch and one K3a/K3b pair
    for every shard (the head groups folded into the batch), bit-equal
    to ``flash_attention`` over the whole sequence (each (batch, head)
    is computed alone, and a group stays whole in its shard)."""
    _card()
    s, b, t, h, kv, d = 4, 1, 256, 16, 4, 128
    q, k, v, do = _ring_inputs(1, s, b, t, h, kv, d)
    axis = bt.SeqAxis("sp", s)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fa.reset_launch_counts()
    out = ulysses_attention(*leaves, axis, impl="flash")
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_backward_dq.launches,
            fa.flash_backward_dkv.launches) == (1, 1, 1)
    whole = lambda x: x.movedim(0, 1).reshape(  # noqa: E731
        b, s * t, *x.shape[3:]).detach().clone().requires_grad_(True)
    ref_leaves = [whole(x) for x in (q, k, v)]
    ref = fa.flash_attention(*ref_leaves)
    ref_grads = torch.autograd.grad(ref, ref_leaves, whole(do).detach())
    assert torch.equal(whole(out).detach(), ref.detach())
    for a, r in zip(grads, ref_grads):
        assert torch.equal(whole(a).detach(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (16, torch.float32)])
@pytest.mark.parametrize("t,s_len,q_off,kv_off", [
    (256, 256, 0, 256),       # the block right after the shard's
    (256, 256, 512, 1024),    # a later block, both offsets nonzero
    (1, 64, 0, 1),            # T = 1
])
def test_wholly_masked_block_on_card(d, dtype, t, s_len, q_off, kv_off):
    """K2, K3a and K3b on a block the causal mask covers whole
    (``kv_offset >= q_offset + T``): out 0 and lse -1e30 for every row,
    dQ, dK and dV 0, into output buffers that held NaN before."""
    _card()
    b, h, kv = 2, 8, 2
    g = torch.Generator("cuda").manual_seed(d + t)
    q, do = (_rand(g, (b, t, h, d), dtype) for _ in range(2))
    k, v = (_rand(g, (b, s_len, kv, d), dtype) for _ in range(2))
    lse = torch.randn(b, h, t, generator=g, device="cuda")
    delta = torch.randn(b, h, t, generator=g, device="cuda")
    args = (True, None, q_off, kv_off)

    def poisoned(fn):
        # the caching allocator hands the kernels' outputs blocks that
        # held NaN, so a kernel that writes nothing fails here
        junk = [torch.full((1 << 20,), float("nan"), device="cuda")
                for _ in range(8)]
        del junk
        return fn()

    fa.reset_launch_counts()
    out, lse_out = poisoned(lambda: fa.flash_forward(q, k, v, *args))
    dq = poisoned(lambda: fa.flash_backward_dq(q, k, v, do, lse, delta,
                                               *args))
    dk, dv = poisoned(lambda: fa.flash_backward_dkv(q, k, v, do, lse, delta,
                                                    *args))
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_backward_dq.launches,
            fa.flash_backward_dkv.launches) == (1, 1, 1)
    assert not out.isnan().any() and not out.any()
    assert bool((lse_out == -1e30).all())
    for name, x in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert not x.isnan().any() and not x.any(), name


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["none", "dots"])
def test_ring_llama_under_remat_on_card(policy):
    """A bf16 ring + flash Llama (D = 64, sp 4, causal) under ``remat=True``
    on the card: the recompute relaunches K2 on every live pair (2 x 10
    launches a layer, K3a and K3b 10), and the logits and gradients are
    bit-equal to the model without remat (deterministic kernels, the
    same inputs)."""
    _card()
    s, n_layers = 4, 2
    tokens = torch.randint(0, 256, (s, 1, 128), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3))
    axis = bt.SeqAxis("sp", s)
    out = {}
    for remat in (False, True):
        over = dict(remat=True, remat_policy=policy) if remat else {}
        cfg = bt.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                  n_layers=n_layers, attn_mode="ring",
                                  sp_axis="sp", attn_impl="flash", **over)
        model = bt.Llama(cfg, device="cuda", param_dtype=torch.float32,
                         generator=torch.Generator("cuda").manual_seed(1))
        params = {k: v.requires_grad_(True)
                  for k, v in model.state(release=True).items()}
        fa.reset_launch_counts()
        with bt.bind_axis(axis):
            logits = model.apply(params, tokens,
                                 pos_offset=axis.index("cuda") * 128)
            grads = torch.autograd.grad(logits.float().square().mean(),
                                        list(params.values()))
        torch.cuda.synchronize()
        fwd = (2 if remat else 1) * 10 * n_layers
        assert (fa.flash_forward.launches, fa.flash_backward_dq.launches,
                fa.flash_backward_dkv.launches) == (fwd, 10 * n_layers,
                                                    10 * n_layers)
        out[remat] = (logits.detach(), grads)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)

"""The CUDA kernels of bluefog_tpu_torch against their plain versions,
on the card.  Marked ``cuda``: without an NVIDIA card every test here
skips (a CUDA kernel has no CPU mode).  The file imports torch and the
port only, so it also runs where jax is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from bluefog_tpu_torch.models.llama import _amax_quantize
from bluefog_tpu_torch.parallel import decode_attention as da


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_kernel_matches_plain_on_card(quantized):
    """The CUDA kernel against its plain version, bf16 q and cache (or
    int8 cache), Llama-3.1-8B head layout.  Tolerance: 2 bf16 ulps of
    the output's magnitude (atol = rtol = 1.6e-2)."""
    _card()
    g = torch.Generator("cuda").manual_seed(0)
    b, n_kv, rep, s, d = 8, 8, 4, 2048, 128
    q = torch.randn(b, 1, n_kv * rep, d, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(b, n_kv, s, d, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn(b, n_kv, s, d, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    idx = torch.tensor([0, 1, 31, 32, 700, 1500, 2046, 2047],
                       dtype=torch.int32, device="cuda")
    if quantized:
        kq, ks = _amax_quantize(k)
        vq, vs = _amax_quantize(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
        out = da.decode_attention_int8(q, kq, ks, vq, vs, idx)
        ref = da.decode_attention_plain(q, kq, vq, idx, ks, vs)
    else:
        out = da.decode_attention(q, k, v, idx)
        ref = da.decode_attention_plain(q, k, v, idx)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=1.6e-2,
                               rtol=1.6e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(16, torch.float32),
                                     (32, torch.bfloat16),
                                     (64, torch.float32)])
def test_kernel_head_dims_and_types_on_card(d, dtype):
    """Every compiled head dim, q and cache in bf16 or f32, rep 1-16,
    positions at 0, inside, at and past the cache end."""
    _card()
    g = torch.Generator("cuda").manual_seed(d)
    b, n_kv, s = 4, 2, 77
    for rep in (1, 3, 16):
        q = torch.randn(b, 1, n_kv * rep, d, generator=g, device="cuda",
                        dtype=dtype)
        k = torch.randn(b, n_kv, s, d, generator=g, device="cuda",
                        dtype=dtype)
        v = torch.randn(b, n_kv, s, d, generator=g, device="cuda",
                        dtype=dtype)
        idx = torch.tensor([0, 40, s - 1, s + 5], dtype=torch.int32,
                           device="cuda")
        da.reset_launch_counts()
        out = da.decode_attention(q, k, v, idx)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == 1
        tol = 1.6e-2 if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(
            out.float(), da.decode_attention_plain(q, k, v, idx).float(),
            atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# K1: the fused 1x1-conv backward (parallel/conv1x1.py,
# csrc/conv1x1_backward.cu) against its plain version on the card.
# Tolerances: dx is rounded to x's type after an f32 sum taken in another
# order than the plain version's, so bf16 dx may differ by one bf16 ulp
# (rtol 2**-7) plus 1e-3 of the largest entry near zero; dw is f32 from
# exact bf16 products summed in another order: 1e-4 of its largest entry.
# ---------------------------------------------------------------------------

from bluefog_tpu_torch.parallel import conv1x1 as k1  # noqa: E402

K1_SHAPES = [
    (401408, 64, 256, torch.bfloat16),   # ResNet-50 stage 1 (expand, proj)
    (100352, 128, 512, torch.bfloat16),  # stage 2 expand
    (100352, 256, 512, torch.bfloat16),  # stage 2 projection
    (25088, 256, 1024, torch.bfloat16),  # stage 3 expand
    (25088, 512, 1024, torch.bfloat16),  # stage 3 projection
    (6272, 512, 2048, torch.bfloat16),   # stage 4 expand
    (6272, 1024, 2048, torch.bfloat16),  # stage 4 projection
    (98, 32, 16, torch.float32),         # odd N, f32 (FMA path)
    (196, 64, 24, torch.float32),
    (4096, 8, 8, torch.bfloat16),        # narrow, tensor cores
    (1000, 12, 20, torch.bfloat16),      # ragged widths: bf16 FMA path
]


def _k1_inputs(n, ci, co, dtype, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(n, ci, generator=g, device="cuda").to(dtype)
    dy = torch.randn(n, co, generator=g, device="cuda").to(dtype)
    w = (torch.randn(ci, co, generator=g, device="cuda") * 0.1).to(dtype)
    return x, dy, w


def _k1_close(dx, dw, ref_dx, ref_dw):
    torch.testing.assert_close(
        dx.float(), ref_dx.float(), rtol=2 ** -7,
        atol=1e-3 * ref_dx.float().abs().max().item())
    torch.testing.assert_close(
        dw, ref_dw, rtol=0, atol=1e-4 * ref_dw.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("n,ci,co,dtype", K1_SHAPES)
def test_k1_matches_plain_on_card(n, ci, co, dtype):
    """K1 against its plain version, and dw bit-equal across two runs
    (split-N partials summed in a fixed order, no atomics)."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, dy, w = _k1_inputs(n, ci, co, dtype)
    k1.reset_launch_counts()
    dx, dw = k1.conv1x1_backward(x, dy, w)
    dx2, dw2 = k1.conv1x1_backward(x, dy, w)
    torch.cuda.synchronize()
    assert k1.conv1x1_backward.launches == 2
    assert dx.dtype == dtype and dw.dtype == torch.float32
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)
    ref_dx, ref_dw = k1.conv1x1_backward_plain(x, dy, w)
    _k1_close(dx, dw, ref_dx, ref_dw)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_k1_autograd_on_card_matches_host(stride):
    """conv1x1's autograd on the card (kernel) against the same function
    on the host (plain version), f32, the stride-2 scatter included."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(stride)
    x = torch.randn(2, 14, 14, 64, generator=g)
    w = torch.randn(64, 24, generator=g) * 0.1
    outs = []
    for dev in ("cuda", "cpu"):
        xd = x.to(dev).requires_grad_(True)
        wd = w.to(dev).requires_grad_(True)
        y = k1.conv1x1(xd, wd, stride)
        gx, gw = torch.autograd.grad(torch.sin(y).sum(), (xd, wd))
        outs.append((y.detach().cpu(), gx.cpu(), gw.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_k1_tile_table_comes_from_the_library():
    """Every configuration the wrapper picks has its block tile in the
    library's one table, and an unknown configuration is refused."""
    _card()
    for ci in (8, 64, 128, 1024):
        for tensor_cores in (True, False):
            for cfg in k1.tile_configs(ci, tensor_cores):
                bm, bn = k1._tile(cfg)
                assert bm % 16 == 0 and bn % 16 == 0
    with pytest.raises(RuntimeError, match="no tile configuration"):
        k1._tile(7)

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

"""The int8 products of the port's ``param_quant`` on the card: cuBLASLt's
int8 GEMM behind ``int8_matmul`` (with the row and column padding its
shape rules need) and the w8a8 attention's f32 route, each against the
exact integer product, and the attention against an f64 reference of the
host.  Marked ``cuda``: without an NVIDIA card every test here skips.
The file imports torch, numpy and the port only, so it also runs where
jax is not installed:

    python -m pytest --noconftest -q tests/test_torch_quant_cuda.py
"""

import numpy as np
import pytest
import torch

from bluefog_tpu_torch.models import llama as tl


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (cuBLASLt's int8 GEMM)")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 4096, 14336), (1, 64, 24),
                                   (40, 4096, 1024), (3, 36, 20)])
def test_int_mm_row_padding_on_card(m, k, n):
    """On the card ``int8_matmul`` pads M up past 16 and K, N to multiples
    of 8 for cuBLASLt: the product equals the exact integer one, with
    the kernel in QuantDense's column-major storage and row-major."""
    _card()
    g = torch.Generator("cuda").manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                      dtype=torch.int8)
    exact = (a.double() @ w.double().t()).long()
    for b in (w.t(), w.t().contiguous()):
        got = tl.int8_matmul(a, b)
        assert got.shape == (m, n) and got.dtype == torch.int32
        assert torch.equal(got.long(), exact)


def _int8_attention_reference(q, kq, ks, vq, vs, idx, eps=2e-3):
    """An f64 reference of the w8a8 attention on the host, written apart
    from the port: the queries' int8 codes as the port makes them (f32
    elementwise, so every device gives the same codes), exact integer
    scores, an f64 softmax, and the probabilities' int8 codes.  Returns
    the output and, per element, how far a device whose f32 softmax
    rounds apart from f64 may stray: one probability code at each
    position whose real-valued code lies within ``eps`` of a rounding
    boundary, times that position's |value code|, times the row's
    probability scale."""
    q = q.double().numpy()
    kq, vq = kq.double().numpy(), vq.double().numpy()
    ks, vs = ks.double().numpy(), vs.double().numpy()
    b, t, n_q, d = q.shape
    n_kv, s = kq.shape[1], kq.shape[2]
    q32 = torch.from_numpy(q).float().reshape(b, t, n_kv, n_q // n_kv, d)
    qs = torch.clamp_min(q32.abs().amax(-1, keepdim=True), 1e-8) / 127.0
    qq = torch.round(q32 / qs).double().numpy()
    qs = qs.double().numpy()
    scores = (np.einsum("btkrd,bksd->bkrts", qq, kq)
              * qs.transpose(0, 2, 3, 1, 4) * ks[:, :, None, None, :]
              / np.sqrt(d))
    live = np.arange(s)[None, :] <= idx + np.arange(t)[:, None]
    scores = np.where(live, scores, -np.inf)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    pv = p * vs[:, :, None, None, :]
    ps = pv.max(-1, keepdims=True) / 127.0
    codes = pv / ps
    pq = np.round(codes)
    near = np.abs(codes - np.floor(codes) - 0.5) < eps
    out = np.einsum("bkrts,bksd->btkrd", pq, vq) * ps.transpose(0, 3, 1, 2,
                                                                4)
    slack = np.einsum("bkrts,bksd->btkrd", near.astype(np.float64),
                      np.abs(vq)) * ps.transpose(0, 3, 1, 2, 4)
    return out.reshape(b, t, n_q, d), slack.reshape(b, t, n_q, d)


@pytest.mark.cuda
def test_int8_attention_f32_route_on_card():
    """The w8a8 attention's f32 route on the card, TF32 off, at the
    serving shape (head_dim 128, a 1024-long cache, a 256-token chunk):
    bit-equal to the same function through f64, whose products of int8
    codes are exact; and held to the host's f64 reference: where no
    probability code sits within 2e-3 of a rounding boundary the two
    agree to 1e-5 relative, elsewhere by at most one code at each such
    position (the card's softmax rounds apart from f64's), and fewer
    than 1% of the elements differ at all."""
    _card()
    g = torch.Generator().manual_seed(0)
    b, t, n_kv, rep, s, d = 1, 256, 8, 4, 1024, 128
    q = torch.randn(b, t, n_kv * rep, d, generator=g)
    kq, ks = tl._amax_quantize(torch.randn(b, n_kv, s, d, generator=g))
    vq, vs = tl._amax_quantize(torch.randn(b, n_kv, s, d, generator=g))
    host = (q, kq, ks[..., 0], vq, vs[..., 0])
    args = [a.cuda() for a in host + (torch.tensor([700]),)]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        assert tl._exact_float(args[0].device, s) == torch.float32
        got = tl._cached_attention_int8(*args)
        torch.backends.cuda.matmul.allow_tf32 = True   # the f64 route
        assert tl._exact_float(args[0].device, s) == torch.float64
        exact = tl._cached_attention_int8(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.isfinite(got).all()
    assert torch.equal(got, exact)
    ref, slack = _int8_attention_reference(*host, 700)
    err = np.abs(got.double().cpu().numpy() - ref)
    assert (err <= slack + 1e-5 * np.abs(ref) + 1e-30).all()
    assert (err > 1e-5 * np.abs(ref)).mean() < 0.01

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


def _sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 16])
@pytest.mark.parametrize("cache", ["bf16", "f32", "int8"])
def test_split_kv_kernel_at_split_boundaries_on_card(cache, rep):
    """The split-KV kernel and its ordered merge: rows at positions one
    before, at and one after split boundaries, the last position, past
    the cache end and at 0, in one call; against the plain version
    (bf16 q: 2 bf16 ulps, atol = rtol = 1.6e-2; f32 q: 1e-5) and
    bit-equal across two runs (no atomics)."""
    _card()
    g = torch.Generator("cuda").manual_seed(rep)
    b, n_kv, s, d = 8, 2, 300, 128
    split = da.split_len(s, b * n_kv, _sm_count())
    assert split < s  # several splits per row at this shape
    qdt = torch.float32 if cache == "f32" else torch.bfloat16
    kdt = torch.float32 if cache == "f32" else torch.bfloat16
    q = torch.randn(b, 1, n_kv * rep, d, generator=g, device="cuda",
                    dtype=qdt)
    k = torch.randn(b, n_kv, s, d, generator=g, device="cuda", dtype=kdt)
    v = torch.randn(b, n_kv, s, d, generator=g, device="cuda", dtype=kdt)
    idx = torch.tensor([split - 1, split, split + 1, 2 * split - 1,
                        2 * split + 1, s - 1, s + 7, 0], dtype=torch.int32,
                       device="cuda")
    da.reset_launch_counts()
    if cache == "int8":
        kq, ks = _amax_quantize(k)
        vq, vs = _amax_quantize(v)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
        outs = [da.decode_attention_int8(q, kq, ks, vq, vs, idx)
                for _ in range(2)]
        ref = da.decode_attention_plain(q, kq, vq, idx, ks, vs)
        assert da.decode_attention_int8.launches == 2
    else:
        outs = [da.decode_attention(q, k, v, idx) for _ in range(2)]
        ref = da.decode_attention_plain(q, k, v, idx)
        assert da.decode_attention.launches == 2
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    tol = 1e-5 if qdt == torch.float32 else 1.6e-2
    torch.testing.assert_close(outs[0].float(), ref.float(), atol=tol,
                               rtol=tol)


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
    (4096, 8, 8, torch.bfloat16),        # narrow: bf16 FMA path
    (1000, 12, 20, torch.bfloat16),      # ragged widths: bf16 FMA path
    (1000, 64, 256, torch.bfloat16),     # fused kernel, ragged N
    (300, 64, 256, torch.bfloat16),      # fused kernel, one split
    (4096, 64, 128, torch.bfloat16),     # two GEMMs at ci 64
    (1000, 192, 320, torch.bfloat16),    # two GEMMs, ragged tiles
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
    """Every configuration the wrapper picks has its dw block tile in the
    library's one table, and an unknown configuration is refused."""
    _card()
    for ci, co in ((8, 8), (64, 256), (64, 128), (128, 512), (1024, 2048)):
        for tensor_cores in (True, False):
            bm, bn = k1._tile(k1.tile_config(ci, co, tensor_cores))
            assert bm % 16 == 0 and bn % 16 == 0
    assert k1._tile(k1.tile_config(64, 256, True)) == (64, 256)
    with pytest.raises(RuntimeError, match="no tile configuration"):
        k1._tile(7)


def _k1_tile_check(x, dy, w):
    """K1's wgmma layouts on one tile (``csrc/conv1x1_tile_check.cu``, a
    test-only library that includes ``conv1x1_backward.cu``): x [128,
    128], dy [128, 256], w [128, 256] bf16; returns f32 ``(dx_f, dw_f,
    dx_g, dw_g)``: the fused kernel's dx = dy[:64]·w[:64]ᵀ and dw =
    x[:64, :64]ᵀ·dy[:64] on its 64-row tile, and the GEMMs' dx = dy[:,
    :64]·w[:, :64]ᵀ and dw = x[:64]ᵀ·dy[:64, :128] on one 64-deep
    slice."""
    import ctypes

    from bluefog_tpu_torch import cuda_build

    outs = [torch.empty(*shape, dtype=torch.float32, device="cuda")
            for shape in ((64, 64), (64, 256), (128, 128), (128, 128))]
    fn = cuda_build.load("conv1x1_tile_check").bf_conv1x1_tile_check
    fn.argtypes = [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), dy.data_ptr(), w.data_ptr(),
             *[o.data_ptr() for o in outs],
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"tile check launch failed with code {err}"
    return outs


@pytest.mark.cuda
def test_k1_tile_forms_on_card():
    """K1's 2-D TMA maps and wgmma forms on one tile against torch.matmul:
    dx with dy and w K-major (n64 over four 64-column boxes of co, and n128
    from a box of 128 rows), dw with xᵀ and dy MN-major (the transpose
    bits; dy's two 64-column halves through LBO, two n128 halves of co
    256).  Both sides multiply exact bf16 values and sum in f32 in
    another order: 1e-5 relative plus 1e-3 absolute (entries ~10-100)."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(11)
    x, dy, w = (torch.randn(*shape, generator=g, device="cuda")
                .to(torch.bfloat16)
                for shape in ((128, 128), (128, 256), (128, 256)))
    dx_f, dw_f, dx_g, dw_g = _k1_tile_check(x, dy, w)
    torch.cuda.synchronize()
    xf, dyf, wf = x.float(), dy.float(), w.float()
    for got, want in ((dx_f, dyf[:64] @ wf[:64].T),
                      (dw_f, xf[:64, :64].T @ dyf[:64]),
                      (dx_g, dyf[:, :64] @ wf[:, :64].T),
                      (dw_g, xf[:64].T @ dyf[:64, :128])):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# K2, K3a, K3b: flash attention forward and backward (parallel/
# flash_attention.py, csrc/flash_attention.cu) against their plain
# versions on the card, at parallel/flash_check.py's shapes and to its
# bound, entry by entry (the one chip_smoke.py uses): bf16 two ulps of
# each entry (each side rounds its f32 sum) plus 2**-7 of the sizes of
# the terms whose bf16 factor (P or dS) may round the other way, and
# 2**-12 of the largest such size; f32 1e-5 of the largest.  lse is f32
# in both (1e-4 absolute, ~1e-5 of its size).  A row with no live key is
# exact: out 0, lse -1e30, zero gradients.
# ---------------------------------------------------------------------------

from bluefog_tpu_torch.parallel import flash_attention as fa  # noqa: E402
from bluefog_tpu_torch.parallel import flash_check  # noqa: E402


def flash_inputs(b, t, h, kv, d, dtype, seed=0, s_len=None):
    """q, k, v, dO on the card: q and dO ``[b, t, h, d]``, k and v
    ``[b, s_len, kv, d]`` (``s_len`` defaults to t)."""
    g = torch.Generator("cuda").manual_seed(seed)
    q, do = (torch.randn(b, t, h, d, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, s_len or t, kv, d, generator=g,
                        device="cuda").to(dtype) for _ in range(2))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,kv,d,dtype,causal,q_off,kv_off",
                         flash_check.CASES)
def test_flash_kernels_match_plain_on_card(b, t, h, kv, d, dtype, causal,
                                           q_off, kv_off):
    """K2, K3a and K3b against their plain versions; dQ, dK and dV
    bit-equal across two runs (no atomics)."""
    _card()
    q, k, v, do = flash_inputs(b, t, h, kv, d, dtype)
    args = (causal, None, q_off, kv_off)
    fa.reset_launch_counts()
    out, lse = fa.flash_forward(q, k, v, *args)
    out2, lse2 = fa.flash_forward(q, k, v, *args)
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, *args)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    terms = flash_check.term_sizes(q, k, v, do, lse, delta, *args)
    assert flash_check.mismatch(out, ref_out, terms["out"]) <= 1
    dq = fa.flash_backward_dq(q, k, v, do, lse, delta, *args)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, delta, *args)
    dq2 = fa.flash_backward_dq(q, k, v, do, lse, delta, *args)
    dk2, dv2 = fa.flash_backward_dkv(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_backward_dq.launches,
            fa.flash_backward_dkv.launches) == (2, 2, 2)
    # bf16 at D = 64 and 128 runs the wgmma kernels, at D = 16 and 32 the
    # mma.sync ones
    mma_sync = 2 if dtype == torch.bfloat16 and d < 64 else 0
    assert (fa.flash_forward.launches_mma_sync,
            fa.flash_backward_dq.launches_mma_sync,
            fa.flash_backward_dkv.launches_mma_sync) == (mma_sync,) * 3
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
        and torch.equal(dv, dv2)
    ref = fa.flash_backward_plain(q, k, v, do, lse, delta, *args)
    for key, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == dtype
        assert flash_check.mismatch(got, want, terms[key]) <= 1
    if causal and kv_off > q_off:  # rows before kv_off - q_off see no key
        dead = kv_off - q_off
        assert not out[:, :dead].any() and not dq[:, :dead].any()
        assert bool((lse[..., :dead] == -1e30).all())
        if dead >= t:
            assert not (dk.any() or dv.any())


def _tile_check(a, b, v):
    """K2's wgmma layouts on one tile: ``a [64, D]``, ``b [128, D]``,
    ``v [128, D]`` bf16 on the card, D 64 or 128; returns ``(s, o)`` f32
    with ``s = a·bᵀ`` and ``o = bf16(s)·v`` computed by the forward's own
    descriptor, TMA and re-pack code (``csrc/flash_tile_check.cu``, a
    test-only library that includes ``flash_attention.cu``)."""
    import ctypes

    from bluefog_tpu_torch import cuda_build

    d = a.shape[-1]
    for x, rows in ((a, 64), (b, 128), (v, 128)):
        assert x.dtype == torch.bfloat16 and x.shape == (rows, d)
        assert x.is_cuda and x.is_contiguous()
    s = torch.empty(64, 128, dtype=torch.float32, device=a.device)
    o = torch.empty(64, d, dtype=torch.float32, device=a.device)
    fn = cuda_build.load("flash_tile_check").bf_flash_tile_check
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(a.data_ptr(), b.data_ptr(), v.data_ptr(), s.data_ptr(),
             o.data_ptr(), d, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"tile check launch failed with code {err}"
    return s, o


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_tile_product_and_repack_on_card(d):
    """K2's wgmma layouts on one tile, against torch.matmul: s = a·bᵀ
    (TMA boxes, the K-major descriptors of Q and K, the accumulator
    layout) and o = bf16(s)·v (the S accumulator re-packed as the
    register A operand, V's MN-major descriptor).  Both sides multiply
    exact bf16 values and sum in f32 in another order: 1e-5 relative
    plus 1e-3 (s, entries ~10) and 1e-2 (o, entries ~100)."""
    _card()
    g = torch.Generator("cuda").manual_seed(d)
    a = torch.randn(64, d, generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn(128, d, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(128, d, generator=g, device="cuda").to(torch.bfloat16)
    s, o = _tile_check(a, b, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, a.float() @ b.float().T, rtol=1e-5,
                               atol=1e-3)
    p = s.to(torch.bfloat16).float()  # the kernel rounds its own S
    torch.testing.assert_close(o, p @ v.float(), rtol=1e-5, atol=1e-2)


def _bwd_tile_check(a, b, c):
    """The backward's wgmma layouts on one tile: ``a [64, D]``, ``b [N,
    D]``, ``c [N, D]`` bf16 on the card, D and N 64 or 128; returns ``(s,
    o)`` f32 with ``s = a·bᵀ`` (both K-major) and ``o = bf16(s)·c`` (c
    MN-major) computed by K3a's and K3b's own maps and product issues
    (``bf_flash_bwd_tile_check`` of ``csrc/flash_tile_check.cu``)."""
    import ctypes

    from bluefog_tpu_torch import cuda_build

    d, n = a.shape[-1], b.shape[0]
    for x, rows in ((a, 64), (b, n), (c, n)):
        assert x.dtype == torch.bfloat16 and x.shape == (rows, d)
        assert x.is_cuda and x.is_contiguous()
    s = torch.empty(64, n, dtype=torch.float32, device=a.device)
    o = torch.empty(64, d, dtype=torch.float32, device=a.device)
    fn = cuda_build.load("flash_tile_check").bf_flash_bwd_tile_check
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), s.data_ptr(),
             o.data_ptr(), d, n, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"tile check launch failed with code {err}"
    return s, o


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_tile_backward_forms_on_card(d, n):
    """K3a's and K3b's wgmma layouts on one tile, against torch.matmul:
    the SS product of two K-major tiles at n64 (K3b's Sᵀ = K·Qᵀ and dPᵀ =
    V·dOᵀ) and n128 (K3a's S and dP), and the RS product reading a tile
    of 64 rows (K3b's dO and Q) or 128 (K3a's K) MN-major.  Tolerances as
    in test_sm90_tile_product_and_repack_on_card."""
    _card()
    g = torch.Generator("cuda").manual_seed(d + n)
    a = torch.randn(64, d, generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn(n, d, generator=g, device="cuda").to(torch.bfloat16)
    c = torch.randn(n, d, generator=g, device="cuda").to(torch.bfloat16)
    s, o = _bwd_tile_check(a, b, c)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, a.float() @ b.float().T, rtol=1e-5,
                               atol=1e-3)
    p = s.to(torch.bfloat16).float()
    torch.testing.assert_close(o, p @ c.float(), rtol=1e-5, atol=1e-2)


# (B, T, H, KV, D, causal, q_offset, kv_offset): ragged T around the
# wgmma kernel's 64-row warpgroups and 128-key tiles, offsets, rows with
# no live key (kv_offset 70: rows 0-69), non-causal
K2_ODD = ([(2, t, 4, 2, d, True, 0, 0)
           for d in (64, 128) for t in (1, 63, 65, 127, 129, 200)]
          + [(1, 129, 4, 1, 128, True, 0, 70),
             (2, 200, 4, 4, 64, False, 0, 0),
             (1, 65, 8, 2, 64, True, 37, 5),
             (1, 127, 4, 2, 128, True, 200, 64)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,kv,d,causal,q_off,kv_off", K2_ODD)
def test_k2_wgmma_odd_shapes_on_card(b, t, h, kv, d, causal, q_off, kv_off):
    """The wgmma K2 at ragged shapes, within flash_check.mismatch's bound
    (lse to 1e-4 absolute plus 1e-5), bit-equal across two runs; a row
    with no live key gives out 0 and lse -1e30 exactly."""
    _card()
    q, k, v, do = flash_inputs(b, t, h, kv, d, torch.bfloat16, seed=t)
    args = (causal, None, q_off, kv_off)
    fa.reset_launch_counts()
    out, lse = fa.flash_forward(q, k, v, *args)
    out2, lse2 = fa.flash_forward(q, k, v, *args)
    torch.cuda.synchronize()
    assert fa.flash_forward.launches == 2
    assert fa.flash_forward.launches_mma_sync == 0
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, *args)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    terms = flash_check.term_sizes(q, k, v, do, lse, delta, *args)
    assert flash_check.mismatch(out, ref_out, terms["out"]) <= 1
    if causal and kv_off > q_off:
        dead = kv_off - q_off
        assert not out[:, :dead].any()
        assert bool((lse[..., :dead] == -1e30).all())


# (B, T, S, H, KV, D, causal, q_offset, kv_offset) for the wgmma K3a and
# K3b: ragged T around their 64-row tiles and 128-key steps at rep 1, 2
# and 4, non-causal, and offsets that leave rows with no live key and
# keys with no live query (kv_offset 70 at T 129: rows 0-69 and keys
# 59-128; kv_offset 100 at T 200: rows 0-99 and keys 100-199).  T = 1
# reads 200 keys from the sequence's end (q_offset 199): with one key
# (T = S = 1) every row's dS = P·(dP - delta) is zero in exact arithmetic,
# so dQ and dK are f32 rounding noise on both sides, below any bound
# relative to their terms (PERF.md, K3a and K3b findings).
K3_ODD = ([(2, t, 200 if t == 1 else t, 4, (4, 2, 1)[i % 3], d, True,
            199 if t == 1 else 0, 0)
           for d in (64, 128)
           for i, t in enumerate((1, 63, 65, 127, 129, 200))]
          + [(2, 200, 200, 4, 4, 64, False, 0, 0),
             (1, 129, 129, 8, 2, 128, False, 0, 0),
             (1, 1, 200, 8, 2, 128, False, 0, 0),
             (1, 129, 129, 4, 1, 128, True, 0, 70),
             (1, 200, 200, 4, 2, 64, True, 0, 100),
             (1, 65, 65, 8, 2, 64, True, 37, 5),
             (1, 127, 127, 4, 2, 128, True, 200, 64)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s_len,h,kv,d,causal,q_off,kv_off", K3_ODD)
def test_k3_wgmma_odd_shapes_on_card(b, t, s_len, h, kv, d, causal, q_off,
                                     kv_off):
    """The wgmma K3a and K3b at ragged shapes: dQ, dK and dV within
    flash_check.mismatch's bound, bit-equal across two runs, exactly zero
    for rows with no live key (dQ) and keys with no live query (dK, dV),
    and no mma.sync launch."""
    _card()
    q, k, v, do = flash_inputs(b, t, h, kv, d, torch.bfloat16, seed=t + d,
                               s_len=s_len)
    args = (causal, None, q_off, kv_off)
    out, lse = fa.flash_forward(q, k, v, *args)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    fa.reset_launch_counts()
    runs = [(fa.flash_backward_dq(q, k, v, do, lse, delta, *args),
             *fa.flash_backward_dkv(q, k, v, do, lse, delta, *args))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert (fa.flash_backward_dq.launches,
            fa.flash_backward_dkv.launches) == (2, 2)
    assert (fa.flash_backward_dq.launches_mma_sync,
            fa.flash_backward_dkv.launches_mma_sync) == (0, 0)
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    dq, dk, dv = runs[0]
    terms = flash_check.term_sizes(q, k, v, do, lse, delta, *args)
    ref = fa.flash_backward_plain(q, k, v, do, lse, delta, *args)
    for key, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert flash_check.mismatch(got, want, terms[key]) <= 1, key
    if causal:
        dead_rows = max(0, min(t, kv_off - q_off))
        assert dead_rows == 0 or not dq[:, :dead_rows].any()
        first_dead_key = max(0, q_off + t - kv_off)  # key pos > last query
        if first_dead_key < s_len:
            assert not (dk[:, first_dead_key:].any()
                        or dv[:, first_dead_key:].any())


@pytest.mark.cuda
def test_flash_autograd_on_card_matches_host():
    """flash_attention's autograd on the card (K2, K3a, K3b) against the
    same function on the host (plain versions), f32, GQA, causal."""
    _card()
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 77, 4, 32, generator=g)
    k = torch.randn(2, 77, 2, 32, generator=g)
    v = torch.randn(2, 77, 2, 32, generator=g)
    outs = []
    for dev in ("cuda", "cpu"):
        leaves = [x.to(dev).requires_grad_(True) for x in (q, k, v)]
        y = fa.flash_attention(*leaves, causal=True)
        grads = torch.autograd.grad(torch.sin(y).sum(), leaves)
        outs.append([y.detach().cpu()] + [x.cpu() for x in grads])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_flash_refuses_what_the_kernel_does_not_take():
    _card()
    q, k, v, _ = flash_inputs(1, 16, 4, 2, 48, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_forward(q, k, v)
    q, k, v, _ = flash_inputs(1, 16, 4, 2, 16, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_forward(q, k, v)


# ---------------------------------------------------------------------------
# K5: splash attention's fused one-pass backward (parallel/splash.py,
# csrc/splash_backward.cu) against its plain version on the card, at
# parallel/flash_check.py's SPLASH_CASES and to the same per-entry bound
# as K3a/K3b (its dQ is summed over per-key-tile f32 partials in another
# order than K3a's; its dK/dV take K3b's order).
# ---------------------------------------------------------------------------

from bluefog_tpu_torch.parallel import splash as sp  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,kv,d,dtype", flash_check.SPLASH_CASES)
def test_splash_kernel_matches_plain_on_card(b, t, h, kv, d, dtype):
    """K5 against its plain version; dQ, dK and dV bit-equal across two
    runs (no atomics: the dQ partials are summed in a fixed order)."""
    _card()
    q, k, v, do = flash_inputs(b, t, h, kv, d, dtype, seed=1)
    out, lse = fa.flash_forward(q, k, v)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    sp.reset_launch_counts()
    got = sp.splash_backward(q, k, v, do, lse, delta)
    again = sp.splash_backward(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert sp.splash_backward.launches == 2
    assert sp.splash_backward.launches_mma_sync == (
        2 if dtype == torch.bfloat16 and d < 64 else 0)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    terms = flash_check.term_sizes(q, k, v, do, lse, delta)
    want = sp.splash_backward_plain(q, k, v, do, lse, delta)
    for key, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        assert flash_check.mismatch(g, w, terms[key]) <= 1, key


@pytest.mark.cuda
def test_splash_autograd_on_card_matches_host():
    """splash_attention's autograd on the card (K2, K5) against the same
    function on the host (plain versions), f32, GQA rep 2."""
    _card()
    g = torch.Generator().manual_seed(6)
    q = torch.randn(2, 256, 4, 32, generator=g)
    k = torch.randn(2, 256, 2, 32, generator=g)
    v = torch.randn(2, 256, 2, 32, generator=g)
    outs = []
    for dev in ("cuda", "cpu"):
        leaves = [x.to(dev).requires_grad_(True) for x in (q, k, v)]
        y = sp.splash_attention(*leaves)
        grads = torch.autograd.grad(torch.sin(y).sum(), leaves)
        outs.append([y.detach().cpu()] + [x.cpu() for x in grads])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_splash_refuses_what_the_kernel_does_not_take():
    _card()
    q, k, v, do = flash_inputs(1, 64, 4, 2, 32, torch.bfloat16)
    out, lse = fa.flash_forward(q, k, v)
    delta = torch.zeros_like(lse)
    with pytest.raises(ValueError, match="self-attention"):
        sp.splash_backward(q, k[:, :32].contiguous(), v[:, :32].contiguous(),
                           do, lse, delta)
    with pytest.raises(ValueError, match="contiguous"):
        sp.splash_backward(q, k, v, do.transpose(1, 2).contiguous()
                           .transpose(1, 2), lse, delta)


def _splash_dq_tile_check(a, b, c, n):
    """K5's dQ form on one tile (``bf_splash_dq_tile_check`` of
    ``csrc/flash_tile_check.cu``): a [KEYS, D] (keys), b [64, D] (query
    rows), c [KEYS, D] bf16, KEYS 64 or 128; returns f32 ``(s, o)`` with s
    = a·bᵀ (K5's Sᵀ, n64 SS) and o = bf16(s)ᵀ·c through the swizzled dSᵀ
    tile the threads write and the MN-major SS chain, ``n`` (32 or 64)
    columns of c a chain."""
    import ctypes

    from bluefog_tpu_torch import cuda_build

    keys, d = a.shape
    s = torch.empty(keys, 64, dtype=torch.float32, device=a.device)
    o = torch.empty(64, d, dtype=torch.float32, device=a.device)
    fn = cuda_build.load("flash_tile_check").bf_splash_dq_tile_check
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), s.data_ptr(),
             o.data_ptr(), d, keys, n,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"tile check launch failed with code {err}"
    return s, o


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("keys", [64, 128])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_tile_splash_dq_form_on_card(d, keys, n):
    """K5's new dQ operand form on one tile, against torch.matmul: dS
    stored from the bf16 register operands into a 128-byte-swizzled tile
    with keys as rows, read back MN-major as A through the transpose bit
    (m64n64 or m64n32 over 64 or 128 keys), K read MN-major as B from its
    64-column boxes, a 32-column half from 64 bytes into the swizzled
    rows.  Tolerances as in test_sm90_tile_product_and_repack_on_card."""
    _card()
    g = torch.Generator("cuda").manual_seed(d + keys + n + 1)
    a = torch.randn(keys, d, generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn(64, d, generator=g, device="cuda").to(torch.bfloat16)
    c = torch.randn(keys, d, generator=g, device="cuda").to(torch.bfloat16)
    s, o = _splash_dq_tile_check(a, b, c, n)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, a.float() @ b.float().T, rtol=1e-5,
                               atol=1e-3)
    p = s.to(torch.bfloat16).float()
    torch.testing.assert_close(o, p.T @ c.float(), rtol=1e-5, atol=1e-2)


# (B, T, H, KV, D) for the wgmma K5: ragged T around its 64-row steps,
# 64-key consumers and 256-key spans (blocks past T at T = 100), rep 1, 2
# and 4, and T = 128
K5_ODD = [(b, t, h, kv, d)
          for d in (64, 128)
          for b, t, h, kv in ((2, 100, 4, 4), (1, 1000, 8, 2),
                              (2, 128, 8, 2), (1, 1000, 4, 1),
                              (1, 100, 8, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,kv,d", K5_ODD)
def test_k5_wgmma_odd_shapes_on_card(b, t, h, kv, d):
    """The wgmma K5 at ragged shapes: dQ, dK and dV within
    flash_check.mismatch's bound, every output bit-equal across two runs,
    no mma.sync launch."""
    _card()
    q, k, v, do = flash_inputs(b, t, h, kv, d, torch.bfloat16, seed=t + d)
    out, lse = fa.flash_forward(q, k, v)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    sp.reset_launch_counts()
    runs = [sp.splash_backward(q, k, v, do, lse, delta) for _ in range(2)]
    torch.cuda.synchronize()
    assert sp.splash_backward.launches == 2
    assert sp.splash_backward.launches_mma_sync == 0
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    terms = flash_check.term_sizes(q, k, v, do, lse, delta)
    ref = sp.splash_backward_plain(q, k, v, do, lse, delta)
    for key, got, want in zip(("dq", "dk", "dv"), runs[0], ref):
        assert flash_check.mismatch(got, want, terms[key]) <= 1, key

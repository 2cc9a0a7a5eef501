"""1x1 convolution with the fused dgrad + wgrad backward kernel (K1).

Port of ``bluefog_tpu/parallel/pallas_conv.py``: the Pallas kernel
``_bwd_kernel`` becomes the hand-written CUDA kernel in
``bluefog_tpu_torch/csrc/conv1x1_backward.cu`` (built by
:mod:`bluefog_tpu_torch.cuda_build`, bound with ctypes); ``conv1x1``'s
custom VJP becomes a ``torch.autograd.Function``.  As in the JAX package:

* the forward is a plain product (``pallas_conv.py``'s ``_fwd_impl`` is
  an XLA dot outside Pallas), here ``torch.matmul``;
* a strided 1x1 slices ``x[:, ::s, ::s, :]`` in the forward and
  scatters ``dx`` back into zeros outside the kernel;
* ``dy`` and ``w`` are cast to x's type before the kernel and ``dw``
  (float32 from the kernel) to w's type after.

The kernel (:func:`tile_config`): in bf16 with ci and co multiples of 64
it runs on TMA and ``wgmma``, as one fused persistent pass that reads x
and dy once at ResNet's stage-1 shape (ci 64, co 256) and as two GEMMs
elsewhere; otherwise on a plain FMA tile.  ``dw`` is summed from per-block
f32 partials over :func:`split_plan`'s row chunks in block order
(:func:`conv1x1_backward_split_plain` emulates that order on the host).

Deviation: the JAX backend falls back to two XLA matmuls when its N tile
would be below 64 rows, a VMEM-budget artifact.  On a CUDA tensor the
wrapper always launches the kernel; on a CPU tensor it runs
:func:`conv1x1_backward_plain`.  Nothing falls back from the card to the
plain version.

:func:`conv1x1_backward` counts the calls in which it launched the kernel
(two or three CUDA kernels per call) in ``conv1x1_backward.launches``;
the plain version counts nothing.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from bluefog_tpu_torch.observe import stepprof as _stepprof

__all__ = ["conv1x1", "conv1x1_backward", "conv1x1_backward_plain",
           "conv1x1_backward_split_plain", "split_plan", "tile_config",
           "reset_launch_counts"]

# dtype codes of csrc/conv1x1_backward.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MIN_SPLIT_ROWS = 256
_CHUNK_ROWS = 128

_lib = None    # the built library, its two functions bound at first launch
_tiles = {}    # configuration -> block tile (BM, BN), read from the library


def conv1x1_backward_plain(x2d: torch.Tensor, dy2d: torch.Tensor,
                           w: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch: ``dx = dy · wᵀ`` in x's
    type and ``dw = xᵀ · dy`` in float32, both from float32 operands."""
    dx = (dy2d.float() @ w.float().T).to(x2d.dtype)
    dw = x2d.float().T @ dy2d.float()
    return dx, dw


def conv1x1_backward_split_plain(x2d: torch.Tensor, dy2d: torch.Tensor,
                                 w: torch.Tensor, splits: int, chunk: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's order of ``dw`` in plain torch (a CPU emulation): one
    f32 partial per block over rows ``[s·chunk, (s + 1)·chunk)`` of
    :func:`split_plan`, the partials summed in block order; ``dx`` as in
    :func:`conv1x1_backward_plain`."""
    dx = (dy2d.float() @ w.float().T).to(x2d.dtype)
    dw = torch.zeros(x2d.shape[1], dy2d.shape[1])
    for s in range(splits):
        rows = slice(s * chunk, (s + 1) * chunk)
        dw = dw + x2d[rows].float().T @ dy2d[rows].float()
    return dx, dw


def tile_config(ci: int, co: int, tensor_cores: bool) -> int:
    """The kernel's configuration (``bf_conv1x1_tile``'s table in
    ``csrc/conv1x1_backward.cu``): 0, the fused persistent kernel, at
    ResNet's stage-1 shape (ci 64, co 256); 1, two wgmma GEMMs, at any
    other width that is a multiple of 64; -1, the FMA path, without
    tensor cores."""
    if not tensor_cores:
        return -1
    return 0 if (ci, co) == (64, 256) else 1


def split_plan(n: int, ci: int, co: int, tile: Tuple[int, int],
               sm_count: int) -> Tuple[int, int]:
    """(splits, chunk) of the split-N ``dw`` pass whose blocks cover
    ``tile`` = (BM, BN) of ``[ci, co]`` each: enough blocks to cover the
    card's SMs once, no split under 256 rows, the chunk a multiple of 128
    rows (the fused kernel's row tile, two of the GEMM's 64-row slices).
    Block s sums rows ``[s·chunk, min(n, (s + 1)·chunk))``; at the fused
    kernel's tile (all of ``[ci, co]``) that is the persistent schedule,
    one block per SM.  A pure function of the shape, the tile and the
    card, so ``dw`` is reduced in the same order on every call.  The
    kernel's block tiles are read from the library (``bf_conv1x1_tile``),
    which holds the one table of them."""
    bm, bn = tile
    tiles = math.ceil(ci / bm) * math.ceil(co / bn)
    splits = max(1, min(math.ceil(sm_count / tiles), n // _MIN_SPLIT_ROWS))
    chunk = math.ceil(math.ceil(n / splits) / _CHUNK_ROWS) * _CHUNK_ROWS
    return math.ceil(n / chunk), chunk


def _bind():
    global _lib
    if _lib is None:
        from bluefog_tpu_torch import cuda_build

        lib = cuda_build.load("conv1x1_backward")
        lib.bf_conv1x1_backward.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.bf_conv1x1_backward.restype = ctypes.c_int
        lib.bf_conv1x1_tile.argtypes = [ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int)]
        lib.bf_conv1x1_tile.restype = ctypes.c_int
        _lib = lib
    return _lib


def _tile(cfg: int) -> Tuple[int, int]:
    """Block tile (BM, BN) of the kernel's configuration ``cfg``."""
    if cfg not in _tiles:
        bm, bn = ctypes.c_int(), ctypes.c_int()
        err = _bind().bf_conv1x1_tile(cfg, ctypes.byref(bm), ctypes.byref(bn))
        if err != 0:
            raise RuntimeError(f"conv1x1 backward has no tile configuration "
                               f"{cfg} (code {err})")
        _tiles[cfg] = (bm.value, bn.value)
    return _tiles[cfg]


def _launch(x2d, dy2d, w):
    if x2d.dim() != 2 or dy2d.dim() != 2 or w.dim() != 2:
        raise ValueError("conv1x1_backward takes x2d [N, ci], dy2d [N, co] "
                         "and w [ci, co]")
    n, ci = x2d.shape
    co = dy2d.shape[1]
    if dy2d.shape[0] != n or tuple(w.shape) != (ci, co):
        raise ValueError(f"shapes x2d {tuple(x2d.shape)}, dy2d "
                         f"{tuple(dy2d.shape)}, w {tuple(w.shape)} do not "
                         "match")
    if x2d.dtype not in _CODES:
        raise TypeError(f"conv1x1_backward takes float32 or bfloat16, got "
                        f"{x2d.dtype}")
    for name, t in (("dy2d", dy2d), ("w", w)):
        if t.dtype != x2d.dtype or t.device != x2d.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, x2d "
                             f"{x2d.dtype} on {x2d.device}")
    for name, t in (("x2d", x2d), ("dy2d", dy2d), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n == 0 or ci == 0 or co == 0:
        raise ValueError("conv1x1_backward needs a non-empty problem")
    dev = x2d.device
    dx = torch.empty_like(x2d)
    dw = torch.empty((ci, co), dtype=torch.float32, device=dev)
    tensor_cores = (x2d.dtype == torch.bfloat16 and ci % 64 == 0
                    and co % 64 == 0
                    and all(t.data_ptr() % 16 == 0
                            for t in (x2d, dy2d, w, dx)))
    cfg = tile_config(ci, co, tensor_cores)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, chunk = split_plan(n, ci, co, _tile(cfg), sms)
    scratch = (torch.empty((splits, ci, co), dtype=torch.float32,
                           device=dev) if splits > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bind().bf_conv1x1_backward(
            x2d.data_ptr(), dy2d.data_ptr(), w.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            n, ci, co, _CODES[x2d.dtype], splits, chunk, cfg, stream)
    if err != 0:
        raise RuntimeError(f"conv1x1 backward kernel launch failed with "
                           f"code {err}")
    return dx, dw


def conv1x1_backward(x2d: torch.Tensor, dy2d: torch.Tensor,
                     w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (dx, dw) for ``y = x2d @ w``.

    x2d [N, ci], dy2d [N, co], w [ci, co], all of one type (float32 or
    bfloat16); returns dx2d [N, ci] in x2d's type and dw [ci, co] in
    float32 (accumulated in f32 whatever the input type).  On a CUDA
    tensor this launches the kernel or raises; on a CPU tensor it runs
    :func:`conv1x1_backward_plain`."""
    if x2d.device.type == "cpu":
        return conv1x1_backward_plain(x2d, dy2d, w)
    if x2d.device.type != "cuda":
        raise ValueError(f"conv1x1_backward runs on cuda or cpu tensors, "
                         f"got {x2d.device}")
    out = _launch(x2d, dy2d, w)
    conv1x1_backward.launches += 1
    # dx and dw: two products of N x ci x co multiply-adds
    _stepprof.count_kernel("conv1x1_backward",
                           lambda: 4 * x2d.shape[0] * w.shape[0] * w.shape[1])
    return out


conv1x1_backward.launches = 0


def reset_launch_counts() -> None:
    """Set the kernel wrapper's launch count to 0."""
    conv1x1_backward.launches = 0


class _Conv1x1(torch.autograd.Function):
    """y = x[:, ::s, ::s, :] @ w; the backward is one K1 call."""

    @staticmethod
    def forward(ctx, x, w, stride):
        xs = x[:, ::stride, ::stride, :] if stride > 1 else x
        b, h, wd, ci = xs.shape
        xs2d = xs.reshape(-1, ci)
        y = (xs2d @ w.to(xs.dtype)).reshape(b, h, wd, -1)
        ctx.save_for_backward(xs2d, w)
        ctx.stride = stride
        ctx.x_shape = x.shape
        ctx.xs_shape = xs.shape
        return y

    @staticmethod
    def backward(ctx, dy):
        xs2d, w = ctx.saved_tensors
        dy2d = dy.reshape(-1, dy.shape[-1]).to(xs2d.dtype).contiguous()
        dx2d, dw = conv1x1_backward(xs2d.contiguous(), dy2d,
                                    w.to(xs2d.dtype).contiguous())
        dxs = dx2d.reshape(ctx.xs_shape)
        s = ctx.stride
        if s > 1:
            dx = dxs.new_zeros(ctx.x_shape)
            dx[:, ::s, ::s, :] = dxs
        else:
            dx = dxs
        return dx, dw.to(w.dtype), None


def conv1x1(x: torch.Tensor, w: torch.Tensor, stride: int = 1
            ) -> torch.Tensor:
    """1x1 convolution ``y[b,i,j,co] = sum_ci x[b,si,sj,ci] w[ci,co]``
    with the fused backward kernel.

    ``x`` NHWC, ``w`` [ci, co] (the [1,1,ci,co] conv kernel squeezed).
    The forward is a plain matmul; the backward is one K1 call producing
    dx and dw together."""
    return _Conv1x1.apply(x, w, int(stride))

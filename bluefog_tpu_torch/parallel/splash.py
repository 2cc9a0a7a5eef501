"""Splash attention: the causal training attention with a fused one-pass
backward (K5).

Port of ``bluefog_tpu/parallel/splash.py``.  The JAX package wraps the
TPU library's splash kernel (``make_splash_mha`` with
``use_fused_bwd_kernel=True``): causal attention whose backward computes
dQ, dK and dV in one pass.  Here :func:`splash_attention` keeps the JAX
signature and contract (q ``[B, T, H, D]``, k/v ``[B, T, H_kv, D]`` cast
to q's dtype, causal only, T a multiple of 128, q pre-scaled in its own
dtype) and :class:`_Splash` is its ``torch.autograd.Function``:

* forward: K2 (:func:`~bluefog_tpu_torch.parallel.flash_attention.
  flash_forward`, no offsets, scale 1 on the pre-scaled q); its lse is
  the residual.  The library's forward computes the same function, and
  the TPU's gain came from the fused backward alone (``splash.py:7-8``).
* backward: ``delta = rowsum(dO·O)`` in f32 outside the kernel, then K5
  (:func:`splash_backward`, ``csrc/splash_backward.cu``), one pass over
  the live (query, key) tiles with dQ summed from per-span f32 partials
  in a fixed order (no atomics): 256-key spans, each a cluster of blocks
  that sums its tiles over distributed shared memory, for the wgmma
  kernel (bf16 at D 64 and 128), 64-key ones otherwise.  The partials
  are packed (:func:`partial_rows`): span j holds rows from its first
  key on.

Deviations from the JAX package:

* ``block_q``/``block_kv`` are accepted for signature parity only: the
  kernels' tiles are their own.  ``interpret`` is not taken.
* The JAX wrapper refuses ``jax_enable_x64`` (the library's index maps
  fail under it); torch has no such mode, so nothing is refused.
* The library downcasts f32 operands to bf16 in its VMEM scratch; the
  port keeps f32 inputs in f32 (the kernel's FMA path, or the plain
  version on the CPU).
* Where the tensors lie decides the path: on a CUDA tensor
  :func:`splash_backward` launches the kernel or raises, on a CPU tensor
  it runs :func:`splash_backward_plain`.  Nothing falls back from the
  card to the plain version.

:func:`splash_backward` counts its launches in ``splash_backward.
launches`` (one per call: the kernel and its dQ sum), those of the
mma.sync kernel (bf16 at D 16 and 32, no model path) also in
``splash_backward.launches_mma_sync``; the plain version counts
nothing.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from bluefog_tpu_torch.parallel.flash_attention import (HEAD_DIMS, _CODES,
                                                        _count, _dims,
                                                        _dscores, _heads,
                                                        _on_card, _probs,
                                                        flash_forward)

__all__ = ["splash_attention", "splash_backward", "splash_backward_plain",
           "library_supports_head_dim", "partial_rows", "reset_launch_counts"]

_lib = None   # the built library, bound at first launch


def library_supports_head_dim(d: int) -> bool:
    """Whether the kernels are compiled for head dim ``d``."""
    return d in HEAD_DIMS


def splash_backward_plain(q, k, v, do, lse, delta,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K5's function in plain torch: ``(dq, dk, dv)`` of causal attention
    from the forward's ``lse`` and ``delta = rowsum(dO·O)`` (both ``[B,
    H, T]`` f32), with P and dS computed once for all three (the one
    pass), rounded as the kernel rounds them: P to dO's type for dV, dS
    to q's type for dK and to k's type for dQ."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    p = _probs(q, k, lse, True, scale, 0, 0)             # [B, KV, rep, T, T]
    ds = _dscores(p, v, do, delta)
    q5, do5 = (x.reshape(b, t, kv, h // kv, d) for x in (q, do))
    dv = torch.einsum("bgrts,btgrd->bsgd", p.to(do.dtype).float(),
                      do5.float())
    dk = torch.einsum("bgrts,btgrd->bsgd", ds.to(q.dtype).float(),
                      q5.float()) * scale
    dq = torch.einsum("bgrts,bsgd->bgrtd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return (_heads(dq, b, t, h).to(q.dtype).contiguous(),
            dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous())


def _bind():
    global _lib
    if _lib is None:
        from bluefog_tpu_torch import cuda_build

        lib = cuda_build.load("splash_backward")
        lib.bf_splash_key_tile.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bf_splash_key_tile.restype = ctypes.c_int
        lib.bf_splash_backward.argtypes = ([ctypes.c_void_p] * 10
                                           + [ctypes.c_int] * 5
                                           + [ctypes.c_float, ctypes.c_int,
                                              ctypes.c_void_p])
        lib.bf_splash_backward.restype = ctypes.c_int
        _lib = lib
    return _lib


def _key_tile(dtype: torch.dtype, d: int) -> int:
    """Keys per K5 dQ partial (the span) for ``dtype`` and head dim ``d``:
    256 for the wgmma kernel (bf16 at D 64 and 128), 64 for the mma.sync
    and FMA ones.  Read from the built library, which holds the one
    definition."""
    return _bind().bf_splash_key_tile(_CODES[dtype], d)


def partial_rows(t: int, span: int) -> int:
    """Rows of the packed dQ partials at length ``t``: partial j holds
    rows ``j·span .. t - 1`` only, the rows the kernel writes into it."""
    return sum(t - j * span for j in range(math.ceil(t / span)))


def _partials(span: int, q: torch.Tensor) -> torch.Tensor:
    """The packed f32 dQ partials, ``B·H·D`` floats for each row of
    :func:`partial_rows` (the layout of ``part_offset`` in
    ``csrc/splash_backward.cu``)."""
    b, t, h, d = q.shape
    return torch.empty(b * partial_rows(t, span) * h * d,
                       dtype=torch.float32, device=q.device)


@torch.no_grad()
def splash_backward(q, k, v, do, lse, delta, scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: ``(dq [B, T, H, D], dk, dv [B, T, KV, D])`` of causal
    attention in one pass, from the forward's lse and ``delta =
    rowsum(dO·O)`` (both ``[B, H, T]`` f32).  A CUDA tensor launches the
    kernel (counted in ``splash_backward.launches``) or raises; a CPU
    tensor runs :func:`splash_backward_plain`.  bf16 at D = 64 and 128
    runs the TMA + wgmma kernel (256-key dQ partials), bf16 at D = 16 and
    32 the mma.sync one (64-key partials, counted also in
    ``splash_backward.launches_mma_sync``)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if not _on_card(q):
        return splash_backward_plain(q, k, v, do, lse, delta, scale)
    b, t, s_len, h, kv, d = _dims(q, k, v, lse, delta, do)
    if s_len != t:
        raise ValueError(f"splash attention is self-attention: k has "
                         f"{s_len} positions, q {t}")
    part = _partials(_key_tile(q.dtype, d), q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = (q, k, v, do, lse, delta, part, dq, dk, dv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bind().bf_splash_backward(
            *[x.data_ptr() for x in ptrs], b, t, h, kv, d, float(scale),
            _CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"splash_backward kernel launch failed with "
                           f"code {err}")
    splash_backward.launches += 1
    if q.dtype == torch.bfloat16 and d < 64:
        splash_backward.launches_mma_sync += 1
    _count("splash_backward", 10, (b, t, t, h, kv, d), True, 0, 0)
    return dq, dk, dv


def reset_launch_counts() -> None:
    """Set K5's launch counts to 0."""
    splash_backward.launches = 0
    splash_backward.launches_mma_sync = 0


reset_launch_counts()


class _Splash(torch.autograd.Function):
    """The library kernel's custom VJP: K2 forward, K5 backward, on the
    pre-scaled q (scale 1 inside)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_forward(q, k, v, True, 1.0)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        # the softmax-jacobian diagonal term, [B, H, T] f32
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        return splash_backward(q, k, v, do, lse, delta.contiguous(), 1.0)


def splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, scale: Optional[float] = None,
                     block_q: int = 1024, block_kv: int = 1024
                     ) -> torch.Tensor:
    """Causal self-attention with the fused one-pass backward.  q ``[B,
    T, H, D]``, k/v ``[B, T, H_kv, D]`` -> ``[B, T, H, D]``: softmax(scale
    · q kᵀ + causal mask) v, differentiable.  As in the JAX wrapper, k
    and v are cast to q's dtype and q is multiplied by ``scale`` in its
    own dtype before the kernels (so a scale that bf16 cannot hold, such
    as 1/√128, is rounded as there).  ``block_q``/``block_kv`` are
    accepted for parity only."""
    del block_q, block_kv
    if not causal:
        raise NotImplementedError(
            "attn_impl='splash' supports the causal train path only; "
            "use attn_impl='flash' or 'xla' for non-causal attention")
    b, t, h, d = q.shape
    if t % 128:
        raise NotImplementedError(
            f"attn_impl='splash' needs the sequence length to be a "
            f"multiple of 128 (got {t}), as the JAX wrapper does; use "
            f"attn_impl='flash' for odd lengths")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    # the scale rounded to q's dtype on the host: a device tensor made
    # here would be a blocking copy, a stall of the stream on every call
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    return _Splash.apply((q * scale_q).contiguous(), k.contiguous(),
                         v.contiguous())

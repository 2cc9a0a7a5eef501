"""Flash attention: the forward (K2) and the two backward kernels (K3a
dQ, K3b dK/dV).

Port of ``bluefog_tpu/parallel/pallas_attention.py``:
:func:`flash_attention` and :func:`flash_attention_with_lse` keep their
signatures and layouts (q ``[B, T, H, D]``, k/v ``[B, S, H_kv, D]``, lse
``[B, H, T]`` float32; k and v are cast to q's dtype; offsets are Python
ints placing the rows in global positions for the causal mask).  The
Pallas kernels ``_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
become the hand-written CUDA kernels of
``bluefog_tpu_torch/csrc/flash_attention.cu`` (built by
:mod:`bluefog_tpu_torch.cuda_build`, bound with ctypes), and the custom
VJP ``_flash`` becomes the ``torch.autograd.Function`` :class:`_Flash`:
it saves ``(q, k, v, out, lse)``, computes ``delta = rowsum(dO·O)`` in
f32 outside the kernels, then launches K3a and K3b.

Deviations from the JAX package:

* ``block_q``/``block_k`` are accepted for signature parity only.  The
  card's tiles are the kernels' own, a pure function of the dtype and the
  head dim: in bf16 at D = 64 and 128 (the TMA + ``wgmma`` kernels) the
  forward takes 128 keys a step for 64 query rows per warpgroup, dQ
  :data:`DQ_KEY_TILE` keys a step for 64 query rows per warpgroup, and
  dK/dV 64-row query tiles for 64 keys per warpgroup; otherwise (bf16 at
  D = 16 and 32, the ``mma.sync`` kernels) 64 query rows by 64 keys, and
  64 keys by 32 query rows for dK/dV.  Tails are masked, so any T works
  (the TPU kernels needed block divisors of T).  ``interpret`` is not
  taken.
* Where the tensors lie decides the path: on a CUDA tensor each wrapper
  launches its kernel or raises, on a CPU tensor it runs the plain
  version (:func:`flash_forward_plain`, :func:`flash_backward_plain`).
  Nothing falls back from the card to the plain version.

Each kernel wrapper (:func:`flash_forward`, :func:`flash_backward_dq`,
:func:`flash_backward_dkv`) counts its launches in its ``launches``
attribute, and those of its ``mma.sync`` kernel (bf16 at D = 16 and 32)
also in ``launches_mma_sync``; the plain versions count nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from bluefog_tpu_torch.observe import stepprof as _stepprof

__all__ = ["flash_attention", "flash_attention_with_lse", "flash_forward",
           "flash_backward_dq", "flash_backward_dkv", "flash_forward_plain",
           "flash_backward_plain", "flash_backward_dq_plain",
           "flash_backward_dkv_plain", "reset_launch_counts", "HEAD_DIMS",
           "DQ_KEY_TILE"]

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)   # head dims the kernels are compiled for
# keys per step of the bf16 dQ kernel at D = 64 and 128 (kBkW in
# csrc/flash_attention.cu, the forward's key tile too)
DQ_KEY_TILE = 128
# dtype codes of csrc/flash_attention.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fns = {}  # the bound C functions, bound at first launch


# ---------------------------------------------------------------------------
# Plain versions: the kernels' function in plain torch, with their numerics
# (scores from the native operands accumulated in f32, P rounded to v's
# type before P·V, P to dO's type for dV, dS to q's / k's type for dK /
# dQ, the -1e30 mask and the p = 0 guard on scores <= -5e29).
# ---------------------------------------------------------------------------

def _scores(q, k, causal, scale, q_offset, kv_offset):
    """f32 scores ``[B, KV, rep, T, S]`` of q ``[B, T, H, D]`` against
    k ``[B, S, KV, D]`` (query head ``g * rep + r`` reads kv head g),
    masked with -1e30 in global positions."""
    b, t, h, d = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    qh = q.reshape(b, t, kv, h // kv, d).float()
    s = torch.einsum("btgrd,bsgd->bgrts", qh, k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(t, device=q.device)
        kv_pos = kv_offset + torch.arange(s_len, device=q.device)
        s = torch.where(q_pos[:, None] >= kv_pos[None, :], s, _NEG_INF)
    return s


def _heads(x: torch.Tensor, b: int, t: int, h: int) -> torch.Tensor:
    """``[B, KV, rep, T, ...]`` -> ``[B, T, H, ...]``."""
    x = x.reshape(b, h, t, *x.shape[4:])
    return x.transpose(1, 2)


def flash_forward_plain(q, k, v, causal: bool = True,
                        scale: Optional[float] = None, q_offset: int = 0,
                        kv_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's function in plain torch: ``(out [B, T, H, D] in q's dtype,
    lse [B, H, T] f32)``; a row with no live key gives out = 0 and
    lse = -1e30."""
    b, t, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    s = _scores(q, k, causal, scale, q_offset, kv_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrts,bsgd->bgrtd", p.to(v.dtype).float(), v.float())
    safe = l.clamp_min(1e-30)
    out = _heads(acc / safe, b, t, h).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(safe), _NEG_INF)[..., 0]
    return out.contiguous(), lse.reshape(b, h, t)


def _probs(q, k, lse, causal, scale, q_offset, kv_offset):
    """P = exp(S - lse) ``[B, KV, rep, T, S]``, 0 where S <= -5e29."""
    b, t, h, _ = q.shape
    kv = k.shape[2]
    s = _scores(q, k, causal, scale, q_offset, kv_offset)
    lse5 = lse.reshape(b, kv, h // kv, t, 1)
    return torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - lse5))


def _dscores(p, v, do, delta):
    """dS = P · (dO·Vᵀ - delta), f32 ``[B, KV, rep, T, S]``."""
    b, t, h, d = do.shape
    kv = v.shape[2]
    do5 = do.reshape(b, t, kv, h // kv, d).float()
    dp = torch.einsum("btgrd,bsgd->bgrts", do5, v.float())
    return p * (dp - delta.reshape(b, kv, h // kv, t, 1))


def flash_backward_dq_plain(q, k, v, do, lse, delta, causal, scale,
                            q_offset, kv_offset):
    """K3a's function in plain torch: dQ."""
    b, t, h, d = q.shape
    p = _probs(q, k, lse, causal, scale, q_offset, kv_offset)
    ds = _dscores(p, v, do, delta)
    dq = torch.einsum("bgrts,bsgd->bgrtd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return _heads(dq, b, t, h).to(q.dtype).contiguous()


def flash_backward_dkv_plain(q, k, v, do, lse, delta, causal, scale,
                             q_offset, kv_offset):
    """K3b's function in plain torch: (dK, dV)."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    p = _probs(q, k, lse, causal, scale, q_offset, kv_offset)
    do5 = do.reshape(b, t, kv, h // kv, d)
    dv = torch.einsum("bgrts,btgrd->bsgd", p.to(do.dtype).float(),
                      do5.float())
    ds = _dscores(p, v, do, delta)
    q5 = q.reshape(b, t, kv, h // kv, d)
    dk = torch.einsum("bgrts,btgrd->bsgd", ds.to(q.dtype).float(),
                      q5.float()) * scale
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def flash_backward_plain(q, k, v, do, lse, delta, causal: bool = True,
                         scale: Optional[float] = None, q_offset: int = 0,
                         kv_offset: int = 0):
    """K3a's and K3b's function in plain torch: ``(dq, dk, dv)`` from the
    forward's ``lse [B, H, T]`` and ``delta = rowsum(dO·O)`` ``[B, H, T]``
    f32, the GQA sums over each kv head's group taken without widening."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    args = (q, k, v, do, lse, delta, causal, scale, q_offset, kv_offset)
    return (flash_backward_dq_plain(*args),) \
        + flash_backward_dkv_plain(*args)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _bind(name: str, n_ptrs: int):
    fn = _fns.get(name)
    if fn is None:
        from bluefog_tpu_torch import cuda_build

        fn = getattr(cuda_build.load("flash_attention"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(name, x: torch.Tensor, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _dims(q, k, v, lse=None, delta=None, do=None):
    """Validate the kernels' operands; returns (B, T, S, H, KV, D)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be [B, T, H, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, t, h, d = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads over {kv} kv heads: need a "
                         "multiple")
    if b * max(h, kv) > 65535:
        raise ValueError(f"B * H = {b * h} exceeds the kernels' grid")
    dev = q.device
    _check("q", q, q.dtype, (b, t, h, d), dev)
    _check("k", k, q.dtype, (b, s_len, kv, d), dev)
    _check("v", v, q.dtype, (b, s_len, kv, d), dev)
    for name, x in (("lse", lse), ("delta", delta)):
        if x is not None:
            _check(name, x, torch.float32, (b, h, t), dev)
    if do is not None:
        _check("do", do, q.dtype, (b, t, h, d), dev)
    return b, t, s_len, h, kv, d


def _call(name, ptrs, dims, causal, scale, q_offset, kv_offset):
    """Launch ``name`` on ``ptrs`` (q first) on q's device and stream."""
    dev = ptrs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bind(name, len(ptrs))(
            *[x.data_ptr() for x in ptrs], *dims, int(q_offset),
            int(kv_offset), int(bool(causal)), float(scale),
            _CODES[ptrs[0].dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with code {err}")


def live_pairs(t: int, s_len: int, causal: bool, q_offset: int = 0,
               kv_offset: int = 0) -> int:
    """(query, key) pairs under the mask of one (batch, head): the work
    the kernels do."""
    if not causal:
        return t * s_len
    rows = np.arange(t)
    return int(np.clip(q_offset + rows - kv_offset + 1, 0, s_len).sum())


def _count(name, per_pair, dims, causal, q_offset, kv_offset) -> None:
    """Report a launch's operations to the step profiler: ``per_pair``
    (4 forward, 6 dQ, 8 dK/dV, 10 the fused backward) times batch x heads
    x live pairs x head dim, the formula of the kernels' bound."""
    b, t, s_len, h, _, d = dims
    _stepprof.count_kernel(name, lambda: per_pair * b * h * d * live_pairs(
        t, s_len, causal, q_offset, kv_offset))


def _on_card(q) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return q.device.type == "cuda"


@torch.no_grad()
def flash_forward(q, k, v, causal: bool = True, scale: Optional[float] = None,
                  q_offset: int = 0, kv_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(out, lse)`` of q ``[B, T, H, D]`` over k/v ``[B, S, KV, D]``
    (all one dtype).  A CUDA tensor launches the kernel (counted in
    ``flash_forward.launches``) or raises; a CPU tensor runs
    :func:`flash_forward_plain`.  bf16 at D = 64 and 128 runs the TMA +
    wgmma kernel; bf16 at D = 16 and 32 the mma.sync one, whose launches
    ``flash_forward.launches_mma_sync`` also counts.  The operands'
    checks (contiguous, 16-byte aligned, so every row stride is a
    multiple of 16 bytes) are what the tensor maps need."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if not _on_card(q):
        return flash_forward_plain(q, k, v, causal, scale, q_offset,
                                   kv_offset)
    dims = _dims(q, k, v)
    b, t, _, h, _, _ = dims
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    _call("bf_flash_forward", (q, k, v, out, lse), dims, causal, scale,
          q_offset, kv_offset)
    flash_forward.launches += 1
    if q.dtype == torch.bfloat16 and dims[-1] < 64:
        flash_forward.launches_mma_sync += 1
    _count("flash_forward", 4, dims, causal, q_offset, kv_offset)
    return out, lse


@torch.no_grad()
def flash_backward_dq(q, k, v, do, lse, delta, causal: bool = True,
                      scale: Optional[float] = None, q_offset: int = 0,
                      kv_offset: int = 0) -> torch.Tensor:
    """K3a: dQ ``[B, T, H, D]`` from the forward's lse and ``delta =
    rowsum(dO·O)`` (both ``[B, H, T]`` f32).  bf16 at D = 64 and 128 runs
    the TMA + wgmma kernel, bf16 at D = 16 and 32 the mma.sync one
    (counted also in ``flash_backward_dq.launches_mma_sync``)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if not _on_card(q):
        return flash_backward_dq_plain(q, k, v, do, lse, delta, causal,
                                       scale, q_offset, kv_offset)
    dims = _dims(q, k, v, lse, delta, do)
    dq = torch.empty_like(q)
    _call("bf_flash_backward_dq", (q, k, v, do, lse, delta, dq), dims,
          causal, scale, q_offset, kv_offset)
    flash_backward_dq.launches += 1
    if q.dtype == torch.bfloat16 and dims[-1] < 64:
        flash_backward_dq.launches_mma_sync += 1
    _count("flash_backward_dq", 6, dims, causal, q_offset, kv_offset)
    return dq


@torch.no_grad()
def flash_backward_dkv(q, k, v, do, lse, delta, causal: bool = True,
                       scale: Optional[float] = None, q_offset: int = 0,
                       kv_offset: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3b: ``(dK, dV)`` ``[B, S, KV, D]``, each kv head summed over its
    group's query heads.  bf16 at D = 64 and 128 runs the TMA + wgmma
    kernel, bf16 at D = 16 and 32 the mma.sync one (counted also in
    ``flash_backward_dkv.launches_mma_sync``)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if not _on_card(q):
        return flash_backward_dkv_plain(q, k, v, do, lse, delta, causal,
                                        scale, q_offset, kv_offset)
    dims = _dims(q, k, v, lse, delta, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("bf_flash_backward_dkv", (q, k, v, do, lse, delta, dk, dv),
          dims, causal, scale, q_offset, kv_offset)
    flash_backward_dkv.launches += 1
    if q.dtype == torch.bfloat16 and dims[-1] < 64:
        flash_backward_dkv.launches_mma_sync += 1
    _count("flash_backward_dkv", 8, dims, causal, q_offset, kv_offset)
    return dk, dv


def reset_launch_counts() -> None:
    """Set the three kernel wrappers' launch counts to 0."""
    for fn in (flash_forward, flash_backward_dq, flash_backward_dkv):
        fn.launches = 0
        fn.launches_mma_sync = 0


reset_launch_counts()


class _Flash(torch.autograd.Function):
    """``_flash``'s custom VJP: K2 forward, K3a and K3b backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, kv_offset):
        out, lse = flash_forward(q, k, v, causal, scale, q_offset, kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_offset, kv_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        # the softmax-jacobian diagonal term, [B, H, T] f32
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        dq = flash_backward_dq(q, k, v, do, lse, delta, *ctx.args)
        dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0, kv_offset: int = 0,
                    block_q: int = 1024, block_k: int = 1024
                    ) -> torch.Tensor:
    """Flash attention.  q ``[B, T, H, D]``; k/v ``[B, S, H_kv, D]`` (GQA
    by index, never widened), cast to q's dtype.  Differentiable: the
    backward recomputes P from the saved lse (K3a, K3b).  ``block_q`` and
    ``block_k`` are accepted for parity with the JAX signature; the
    kernels' tiles are their own (see the module docstring)."""
    del block_q, block_k
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    return _Flash.apply(q, k, v, causal, scale, int(q_offset),
                        int(kv_offset))


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             scale: Optional[float] = None,
                             q_offset: int = 0, kv_offset: int = 0,
                             block_q: int = 1024, block_k: int = 1024
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward only: ``(out, lse)`` with ``lse[b, h, t]`` the log-sum-exp
    of that row's masked scores (-1e30 for a row with no live key), the
    residual that merges partial attentions across ring steps."""
    del block_q, block_k
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return flash_forward(q, k.to(q.dtype), v.to(q.dtype), causal, scale,
                         int(q_offset), int(kv_offset))

"""Fused one-token GQA decode attention (full-precision and int8 cache).

Port of ``bluefog_tpu/parallel/pallas_decode.py``: ``decode_attention``
and ``decode_attention_int8`` keep their signatures' meaning, and the
Pallas kernel ``_decode_kernel`` becomes the hand-written CUDA kernel in
``bluefog_tpu_torch/csrc/decode_attention.cu`` (built by
:mod:`bluefog_tpu_torch.cuda_build`, bound with ctypes).  Deviations:

* ``idx`` may be a ``[B]`` tensor as well as a scalar: one launch serves
  every row at its own position, which is what lets the serving engine
  run all its slots as one batch.  A scalar is broadcast to ``[B]``.
* The kernel reads cache positions ``0..idx[b]`` only, so there is no
  ``block_s`` tiling for the caller to choose and no cache length the
  kernel refuses (the TPU kernel needed a block divisor of the cache
  length in [8, 512]).  ``block_s``/``interpret`` are not taken.
* Where the tensors lie decides the path: on a CUDA tensor the wrapper
  launches the kernel or raises, on a CPU tensor it runs
  :func:`decode_attention_plain`.  Nothing falls back from the card to
  the plain version.

Each wrapper counts the launches it makes in its ``launches`` attribute
(reset it to 0 to start a count); the plain version counts nothing.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

__all__ = ["decode_attention", "decode_attention_int8",
           "decode_attention_plain", "reset_launch_counts", "HEAD_DIMS",
           "MAX_REP"]

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)   # head dims the kernel is compiled for
MAX_REP = 16                    # query heads per kv head, at most
# dtype codes of csrc/decode_attention.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_fn = None  # the bound bf_decode_attention, bound at first launch


def _as_index(idx, batch: int, device) -> torch.Tensor:
    """``idx`` (int, 0-d or ``[B]`` integer tensor) as an int32 ``[B]``
    tensor on ``device``."""
    idx = torch.as_tensor(idx, device=device)
    if idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise TypeError(f"idx must be an integer tensor, got {idx.dtype}")
    idx = idx.to(torch.int32)
    if idx.dim() == 0:
        return idx.expand(batch).contiguous()
    if idx.shape != (batch,):
        raise ValueError(f"idx must be a scalar or [{batch}], got "
                         f"{tuple(idx.shape)}")
    return idx.contiguous()


def decode_attention_plain(q, k_all, v_all, idx, k_scale=None,
                           v_scale=None):
    """The kernel's function in plain torch: f32 einsums, keys at
    positions ``<= idx[b]``, softmax.  With ``k_scale``/``v_scale`` the
    cache is int8: the key scale multiplies the score columns and the
    value scale the probabilities (after the softmax, as the kernel
    folds it in after summing the denominator).

    q: [B, 1, n_q, D]; k_all/v_all: [B, KV, S, D]; scales [B, KV, S] f32;
    idx: scalar or [B].  Returns [B, 1, n_q, D] in q's dtype."""
    b, t, n_q, d = q.shape
    if t != 1:
        raise ValueError(f"decode attention serves one token, got T={t}")
    n_kv, s = k_all.shape[1], k_all.shape[2]
    rep = n_q // n_kv
    idx = _as_index(idx, b, q.device)
    q4 = q.reshape(b, n_kv, rep, d).float()
    scores = torch.einsum("bkrd,bksd->bkrs", q4,
                          k_all.float()) * (1.0 / d ** 0.5)
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, :]
    valid = (torch.arange(s, device=q.device)[None, :]
             <= idx[:, None])[:, None, None, :]          # [B, 1, 1, S]
    scores = torch.where(valid, scores, _NEG_INF)
    # a row with no valid key (idx < 0) gives 0, as the kernel's
    # max(l, 1e-30) guard does, not a uniform average
    p = torch.where(valid, torch.softmax(scores, dim=-1), 0.0)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    out = torch.einsum("bkrs,bksd->bkrd", p, v_all.float())
    return out.reshape(b, 1, n_q, d).to(q.dtype)


def _bind():
    global _fn
    if _fn is None:
        from bluefog_tpu_torch import cuda_build

        fn = cuda_build.load("decode_attention").bf_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, t: torch.Tensor, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _launch(q, k_all, v_all, k_scale, v_scale, idx) -> torch.Tensor:
    b, t, n_q, d = q.shape
    if t != 1:
        raise ValueError(f"decode attention serves one token, got T={t}")
    if k_all.dim() != 4:
        raise ValueError(f"cache must be [B, KV, S, D], got "
                         f"{tuple(k_all.shape)}")
    n_kv, s = k_all.shape[1], k_all.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if n_q % n_kv or not 1 <= n_q // n_kv <= MAX_REP:
        raise ValueError(f"{n_q} query heads over {n_kv} kv heads: need "
                         f"a multiple of at most {MAX_REP}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    quantized = k_scale is not None
    kv_dtype = k_all.dtype
    if quantized != (kv_dtype == torch.int8) or kv_dtype not in _CODES:
        raise TypeError(f"cache dtype {kv_dtype} with scales "
                        f"{'given' if quantized else 'absent'}")
    dev = q.device
    _check("q", q, None, (b, 1, n_q, d), dev)
    _check("k_all", k_all, None, (b, n_kv, s, d), dev)
    _check("v_all", v_all, kv_dtype, (b, n_kv, s, d), dev)
    if quantized:
        _check("k_scale", k_scale, torch.float32, (b, n_kv, s), dev)
        _check("v_scale", v_scale, torch.float32, (b, n_kv, s), dev)
    idx = _as_index(idx, b, dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bind()(q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
                      k_scale.data_ptr() if quantized else None,
                      v_scale.data_ptr() if quantized else None,
                      idx.data_ptr(), out.data_ptr(), b, n_kv, s,
                      n_q // n_kv, d, _CODES[q.dtype], _CODES[kv_dtype],
                      stream)
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed with "
                           f"code {err}")
    return out


def _route(q, k_all, v_all, k_scale, v_scale, idx, wrapper):
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, idx, k_scale,
                                      v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    out = _launch(q, k_all, v_all, k_scale, v_scale, idx)
    wrapper.launches += 1
    return out


def decode_attention(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor,
                     idx: Union[int, torch.Tensor]) -> torch.Tensor:
    """Fused GQA decode-attention step over a full-precision cache.

    q: [B, 1, n_q, D] (query head ``h * rep + r`` belongs to kv head
    ``h``); k_all/v_all: [B, KV, S, D] in bf16 or f32; idx: scalar or
    [B] current positions (keys at ``j <= idx[b]`` are valid, ``idx[b]``
    just written).  Returns [B, 1, n_q, D] in q's dtype."""
    return _route(q, k_all, v_all, None, None, idx, decode_attention)


def decode_attention_int8(q: torch.Tensor, kq_all: torch.Tensor,
                          ks_all: torch.Tensor, vq_all: torch.Tensor,
                          vs_all: torch.Tensor,
                          idx: Union[int, torch.Tensor]) -> torch.Tensor:
    """Fused GQA decode-attention step over the int8 K/V cache with
    in-kernel dequant and float probabilities.

    kq_all/vq_all: int8 [B, KV, S, D]; ks_all/vs_all: f32 [B, KV, S]
    per-vector scales (the ``kv_quant='int8'`` cache layout)."""
    return _route(q, kq_all, vq_all, ks_all, vs_all, idx,
                  decode_attention_int8)


decode_attention.launches = 0
decode_attention_int8.launches = 0


def reset_launch_counts() -> None:
    """Set both wrappers' launch counts to 0."""
    decode_attention.launches = 0
    decode_attention_int8.launches = 0


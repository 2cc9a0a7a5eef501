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
* The card splits each row's positions across blocks (flash-decoding):
  :func:`split_len` positions per split, a pure function of the cache
  length, ``B * KV`` and the card's SM count; each block leaves an f32
  partial (m, l, acc) in scratch this wrapper allocates, and a merge
  kernel combines a row's live partials in split order.
  :func:`decode_attention_split_plain` is that arithmetic in plain torch
  (the tests' emulation; the main path never calls it).
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

from bluefog_tpu_torch.observe import stepprof as _stepprof

__all__ = ["decode_attention", "decode_attention_int8",
           "decode_attention_plain", "decode_attention_split_plain",
           "split_len", "reset_launch_counts", "HEAD_DIMS", "MAX_REP"]

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)   # head dims the kernel is compiled for
MAX_REP = 16                    # query heads per kv head, at most
# dtype codes of csrc/decode_attention.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
SPLIT_UNIT = 32    # a split of csrc/decode_attention.cu: a multiple of 32
BLOCKS_PER_SM = 4  # the split's aim at a full-length cache

_fn = None  # the bound bf_decode_attention, bound at first launch
_sms = {}   # SM count by device index


def split_len(seq_len: int, pairs: int, sms: int) -> int:
    """Cache positions per split of the card's kernel: enough splits that
    ``pairs`` (= B * KV) rows at full length give ``BLOCKS_PER_SM`` blocks
    on each of ``sms`` SMs, each split a multiple of ``SPLIT_UNIT``
    positions."""
    units = -(-seq_len // SPLIT_UNIT)
    splits = max(1, min(-(-BLOCKS_PER_SM * sms // pairs), units))
    return -(-units // splits) * SPLIT_UNIT


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


def decode_attention_split_plain(q, k_all, v_all, idx, split: int,
                                 k_scale=None, v_scale=None,
                                 n_live=None):
    """The card kernel's split-and-merge arithmetic in plain torch (f32),
    for the tests: positions ``[j * split, (j + 1) * split)`` up to
    ``idx[b]`` (clamped to S - 1) give split j's unnormalised partial
    (m_j, l_j, acc_j), where acc_j carries the int8 value scale and l_j
    does not; the live partials are merged in split order, ``out = sum_j
    e^(m_j - M) acc_j / max(sum_j e^(m_j - M) l_j, 1e-30)``.  ``n_live``
    ([B] tensor) overrides the number of splits merged per row (a planted
    fault: one short drops the last live split).  Same arguments and
    result as :func:`decode_attention_plain`."""
    b, t, n_q, d = q.shape
    if t != 1:
        raise ValueError(f"decode attention serves one token, got T={t}")
    n_kv, s = k_all.shape[1], k_all.shape[2]
    rep = n_q // n_kv
    idx = _as_index(idx, b, q.device).long().clamp(max=s - 1)
    live = torch.where(idx < 0, 0, idx // split + 1)
    if n_live is not None:
        live = torch.as_tensor(n_live, device=q.device).long()
    q4 = q.reshape(b, n_kv, rep, d).float()
    scores = torch.einsum("bkrd,bksd->bkrs", q4,
                          k_all.float()) * (1.0 / d ** 0.5)
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, :]
    pos = torch.arange(s, device=q.device)
    n_splits = -(-s // split)
    m, l, acc = [], [], []
    for j in range(n_splits):
        cols = slice(j * split, min((j + 1) * split, s))
        valid = (pos[cols][None, :] <= idx[:, None])[:, None, None, :]
        sj = torch.where(valid, scores[..., cols], _NEG_INF)
        mj = sj.amax(dim=-1, keepdim=True)                # [B, KV, rep, 1]
        pj = torch.where(valid, torch.exp(sj - mj), 0.0)
        l.append(pj.sum(dim=-1, keepdim=True))
        if v_scale is not None:
            pj = pj * v_scale[:, :, None, cols]
        acc.append(torch.einsum("bkrs,bksd->bkrd", pj,
                                v_all[:, :, cols].float()))
        m.append(mj)
    m, l, acc = (torch.stack(x) for x in (m, l, acc))    # [n_splits, ...]
    keep = (torch.arange(n_splits, device=q.device)[:, None]
            < live[None, :])[:, :, None, None, None]      # [n_splits, B, ...]
    mx = torch.where(keep, m, _NEG_INF).amax(dim=0)
    w = torch.where(keep, torch.exp(m - mx), 0.0)
    num = (w * acc).sum(dim=0)
    den = (w * l).sum(dim=0)
    out = num / den.clamp_min(1e-30)
    return out.reshape(b, 1, n_q, d).to(q.dtype)


def _sm_count(dev) -> int:
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    n = _sms.get(index)
    if n is None:
        n = _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def _bind():
    global _fn
    if _fn is None:
        from bluefog_tpu_torch import cuda_build

        fn = cuda_build.load("decode_attention").bf_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
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
    rep = n_q // n_kv
    split = split_len(s, b * n_kv, _sm_count(dev))
    # the splits' f32 partials: acc [rep, D] and (m, l) per row
    part = torch.empty(b * n_kv * -(-s // split) * rep * (d + 2),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bind()(q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
                      k_scale.data_ptr() if quantized else None,
                      v_scale.data_ptr() if quantized else None,
                      idx.data_ptr(), out.data_ptr(), part.data_ptr(), b,
                      n_kv, s, rep, d, split, _CODES[q.dtype],
                      _CODES[kv_dtype], stream)
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
    _stepprof.count_kernel(wrapper.__name__, lambda: _ops(q, k_all, idx))
    return out


def _ops(q: torch.Tensor, k_all: torch.Tensor, idx) -> int:
    """A launch's operations: two multiply-adds per query head, live key
    position and head-dim element (the kernel's bound in
    ``chip_smoke.py``).  Reads the positions, a host sync."""
    b, _, n_q, d = q.shape
    live = torch.as_tensor(idx).clamp(max=k_all.shape[2] - 1) + 1
    n_pos = int(live.sum()) * (b if live.dim() == 0 else 1)
    return 4 * n_q * d * n_pos


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


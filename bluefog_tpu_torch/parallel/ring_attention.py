"""Ring attention (sequence parallelism) and the single-device
attention references, blockwise and dense.

Port of ``bluefog_tpu/parallel/ring_attention.py``: ``_merge_block``,
``_block_scores``, ``_repeat_kv``, :func:`ring_attention`,
:func:`blockwise_attention` and :func:`full_attention`, with the same
``-1e30`` masking in global positions and the same guard that gives a
row with no live key an output of 0.  Everything is f32-accumulated
whatever the input dtype; the output is cast to q's dtype.

:func:`ring_attention` runs over a
:class:`~bluefog_tpu_torch.parallel.collectives.SeqAxis`: the JAX
function runs per device under ``shard_map`` on one sequence shard,
here every shard of the axis is stacked along a leading axis (q ``[S,
B, T_local, H, D]``), and K/V blocks move between shards only through
the axis's ``shift`` (``lax.ppermute``).  At ring step ``s`` shard ``i``
holds the block of shard ``(i - s) mod S``.  Deviation from the JAX
package: under the causal mask a (shard, block) pair whose block comes
from a later shard (``kv_offset >= q_offset + T_local``) is masked for
every row, and the ring skips it in the forward and the backward.  That
gives the same bits: ``logaddexp(lse, -1e30) = lse`` and the merge
adds zeros.  At S shards S (S + 1) / 2 of the S² pairs are live.
"""

from __future__ import annotations

from typing import Optional

import torch

from bluefog_tpu_torch.parallel.collectives import SeqAxis, bound_axis
from bluefog_tpu_torch.parallel.flash_attention import (
    flash_backward_dkv, flash_backward_dkv_plain, flash_backward_dq,
    flash_backward_dq_plain, flash_forward, flash_forward_plain)

__all__ = ["ring_attention", "blockwise_attention", "full_attention",
           "ring_live", "ring_flash_parts", "PLAIN_KERNELS"]

_NEG_INF = -1e30


def _merge_block(carry_m, carry_l, carry_acc, scores, v):
    """Online-softmax merge of one score block into the running state.

    carry_m, carry_l: [B, H, Tq]; carry_acc: [B, H, Tq, D]; scores:
    [B, H, Tq, Tk] (already masked); v: [B, Tk, H, D]."""
    block_m = scores.amax(dim=-1)
    new_m = torch.maximum(carry_m, block_m)
    correction = torch.exp(carry_m - new_m)
    p = torch.exp(scores - new_m[..., None])
    # fully-masked rows (scores == new_m == -1e30) contribute 0, not 1
    p = torch.where(scores <= _NEG_INF / 2, 0.0, p)
    new_l = carry_l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    new_acc = carry_acc * correction[..., None] + pv
    return new_m, new_l, new_acc


def _block_scores(q, k, q_offset, kv_offset, scale, causal):
    """Scaled f32 logits ``[B, H, Tq, Tk]`` of one (Q block, KV block)
    pair, the causal mask applied in global positions."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        q_pos = q_offset + torch.arange(tq, device=q.device)
        kv_pos = kv_offset + torch.arange(tk, device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        scores = torch.where(mask[None, None], scores, _NEG_INF)
    return scores


def _repeat_kv(k, v, n_heads):
    """Grouped-query attention: tile KV heads up to the query head count
    (kv head g serves query heads g * rep .. g * rep + rep - 1)."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k, v
    if n_heads % n_kv:
        raise ValueError(f"{n_heads} query heads over {n_kv} kv heads")
    rep = n_heads // n_kv
    return (k.repeat_interleave(rep, dim=2),
            v.repeat_interleave(rep, dim=2))


def ring_live(causal: bool, q_offset: int, kv_offset: int,
              t_local: int) -> bool:
    """Does the (shard, block) pair hold a live key for some row?  Not
    under the causal mask when the block starts at or after the shard's
    last query position."""
    return not causal or kv_offset < q_offset + t_local


def _ring_args(q, k, v, axis_name):
    """The bound axis, checked against q ``[S, B, T, H, D]`` and k/v
    ``[S, B, T, H_kv, D]``."""
    axis = bound_axis(axis_name)
    if q.dim() != 5 or k.dim() != 5 or v.dim() != 5:
        raise ValueError(
            f"ring attention takes shard-major q [S, B, T, H, D] and k/v "
            f"[S, B, T, H_kv, D], got {tuple(q.shape)}, {tuple(k.shape)}")
    if q.shape[0] != axis.n_local or k.shape[:3] != q.shape[:3] \
            or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not {axis.n_local} shards "
                         f"of one sequence over {axis!r}")
    return axis


def _pairs(axis: SeqAxis, step: int, t: int, causal: bool):
    """The live (shard row, q_offset, kv_offset) of ring step ``step``."""
    n = axis.size
    for i, idx in enumerate(axis.ranks):
        src = (idx - step) % n
        q_off, kv_off = idx * t, src * t
        if ring_live(causal, q_off, kv_off, t):
            yield i, q_off, kv_off


def _kernels():
    """(forward, dQ, dK/dV) the flash ring runs: the kernel wrappers,
    looked up when the ring runs."""
    return flash_forward, flash_backward_dq, flash_backward_dkv


PLAIN_KERNELS = (flash_forward_plain, flash_backward_dq_plain,
                 flash_backward_dkv_plain)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name, causal: bool = True,
                   scale: Optional[float] = None,
                   impl: str = "xla") -> torch.Tensor:
    """Blockwise attention with K/V rotating around the ring of the
    sequence shards of ``axis_name`` (a bound axis name or the
    :class:`SeqAxis` itself).

    q: ``[S, B, T_local, H, D]``, k/v: ``[S, B, T_local, H_kv, D]``, shard
    ``s`` at global positions ``s * T_local + arange(T_local)``.  Returns
    ``[S, B, T_local, H, D]`` in q's dtype.  GQA blocks travel narrow and
    are widened per step (``impl="xla"``) or read by index (flash).

    ``impl="flash"`` runs each live (shard, block) pair through K2
    (:func:`~bluefog_tpu_torch.parallel.flash_attention.flash_forward`)
    at that shard's ``q_offset`` and the block's ``kv_offset`` and
    merges the partials by their log-sum-exp in f32; its backward (one
    ``autograd.Function`` around the whole ring, JAX's ``custom_vjp``)
    runs K3a and K3b per live pair against the global ``(out, lse)``.
    On CUDA tensors those launch the kernels or raise; on CPU tensors
    they run their plain versions.  ``impl="xla"`` is the online-softmax
    merge in plain torch, differentiable through autograd."""
    axis = _ring_args(q, k, v, axis_name)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if impl == "flash":
        return _RingFlash.apply(q, k.to(q.dtype), v.to(q.dtype), axis,
                                bool(causal), float(scale))
    s_n, b, t, n_heads, d = q.shape
    state = [(torch.full((b, n_heads, t), _NEG_INF, dtype=torch.float32,
                         device=q.device),
              torch.zeros((b, n_heads, t), dtype=torch.float32,
                          device=q.device),
              torch.zeros((b, n_heads, t, d), dtype=torch.float32,
                          device=q.device)) for _ in range(s_n)]
    k_blk, v_blk = k, v
    for step in range(axis.size):
        if step:
            # rotate, then merge: the resident block (step 0) moves last
            k_blk, v_blk = axis.shift(k_blk), axis.shift(v_blk)
        for i, q_off, kv_off in _pairs(axis, step, t, causal):
            # GQA heads are widened only here, per block
            k_full, v_full = _repeat_kv(k_blk[i], v_blk[i], n_heads)
            scores = _block_scores(q[i], k_full, q_off, kv_off, scale,
                                   causal)
            state[i] = _merge_block(*state[i], scores, v_full)
    out = torch.stack([acc / l.clamp_min(1e-30)[..., None]
                       for _, l, acc in state])
    return out.permute(0, 1, 3, 2, 4).to(q.dtype)


def _ring_flash_forward(q, k, v, axis, causal, scale, fwd):
    """The forward ring over ``fwd`` (K2 or its plain version): ``(o f32
    [S, B, T, H, D], lse f32 [S, B, H, T])``, the partials merged with
    logsumexp weights, so the softmax over the whole sequence is exact."""
    s_n, b, t, h, _ = q.shape
    o = [torch.zeros(q.shape[1:], dtype=torch.float32, device=q.device)
         for _ in range(s_n)]
    lse = [torch.full((b, h, t), _NEG_INF, dtype=torch.float32,
                      device=q.device) for _ in range(s_n)]
    k_blk, v_blk = k, v
    for step in range(axis.size):
        if step:
            k_blk, v_blk = axis.shift(k_blk), axis.shift(v_blk)
        for i, q_off, kv_off in _pairs(axis, step, t, causal):
            o_s, lse_s = fwd(q[i], k_blk[i], v_blk[i], causal, scale, q_off,
                             kv_off)
            new = torch.logaddexp(lse[i], lse_s)
            # the weights come as [B, H, T]; the outputs are [B, T, H, D]
            w_old = torch.exp(lse[i] - new).transpose(1, 2)[..., None]
            w_new = torch.exp(lse_s - new).transpose(1, 2)[..., None]
            o[i] = o[i] * w_old + o_s.float() * w_new
            lse[i] = new
    return torch.stack(o), torch.stack(lse)


class _RingFlash(torch.autograd.Function):
    """``_ring_flash``'s custom VJP around the WHOLE ring: autograd never
    traces into the kernels; the backward re-runs K3a and K3b per live
    pair against the global ``(out, lse)``, so each block's probabilities
    ``exp(S - lse)`` are the global softmax's slices and the per-block
    dQ, dK and dV sum to the exact gradients.  The dK/dV accumulators
    (f32) rotate with their block; one last hop brings each home."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale):
        fwd, bwd_dq, bwd_dkv = _kernels()
        o, lse = _ring_flash_forward(q, k, v, axis, causal, scale, fwd)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (axis, causal, scale, bwd_dq, bwd_dkv)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_flash_backward(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


def _ring_flash_backward(q, k, v, out, lse, do, axis, causal, scale,
                         bwd_dq, bwd_dkv):
    """The backward ring over ``bwd_dq`` and ``bwd_dkv`` (K3a and K3b or
    their plain versions) against the global ``(out, lse)``: (dQ, dK, dV)
    in the inputs' dtypes."""
    t = q.shape[2]
    do = do.contiguous()
    # delta = rowsum(dO·O) once, from the global out: [S, B, H, T]
    delta = (do.float() * out.float()).sum(-1).transpose(2, 3)
    delta = delta.contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_blk, v_blk = k, v
    for step in range(axis.size):
        if step:
            k_blk, v_blk = axis.shift(k_blk), axis.shift(v_blk)
            dk, dv = axis.shift(dk), axis.shift(dv)
        for i, q_off, kv_off in _pairs(axis, step, t, causal):
            args = (q[i], k_blk[i], v_blk[i], do[i], lse[i], delta[i],
                    causal, scale, q_off, kv_off)
            dq[i] += bwd_dq(*args).float()
            dk_c, dv_c = bwd_dkv(*args)
            dk[i] += dk_c.float()
            dv[i] += dv_c.float()
    # the blocks now sit one hop short of home
    dk, dv = axis.shift(dk), axis.shift(dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@torch.no_grad()
def ring_flash_parts(q, k, v, do, axis_name, causal: bool = True,
                     scale: Optional[float] = None,
                     kernels=None) -> dict:
    """The flash ring's forward and backward outside autograd: ``{"out",
    "lse", "dq", "dk", "dv"}`` for the cotangent ``do``, through
    ``kernels`` (forward, dQ, dK/dV): the kernel wrappers by default,
    :data:`PLAIN_KERNELS` for the same ring over their plain versions on
    the same tensors (the reference a card run is held to)."""
    axis = _ring_args(q, k, v, axis_name)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    fwd, bwd_dq, bwd_dkv = _kernels() if kernels is None else kernels
    k, v = k.to(q.dtype), v.to(q.dtype)
    o, lse = _ring_flash_forward(q, k, v, axis, causal, scale, fwd)
    out = o.to(q.dtype)
    dq, dk, dv = _ring_flash_backward(q, k, v, out, lse, do, axis, causal,
                                      scale, bwd_dq, bwd_dkv)
    return dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Single-device blockwise (memory-efficient) attention with the
    online-softmax merge.  q: [B, T, H, D]; k/v: [B, T, H_kv, D] (GQA
    heads widened per block only).  In causal mode the KV blocks above
    the diagonal are skipped."""
    b, t, n_heads, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    block_size = min(block_size, t)
    if t % block_size:
        raise ValueError(f"sequence length {t} is not a multiple of the "
                         f"block size {block_size}")
    n_blocks = t // block_size
    n_kv = k.shape[2]
    k_blocks = k.reshape(b, n_blocks, block_size, n_kv, d)
    v_blocks = v.reshape(b, n_blocks, block_size, n_kv, d)
    q_blocks = q.reshape(b, n_blocks, block_size, n_heads, d)
    outs = []
    for i in range(n_blocks):
        m = torch.full((b, n_heads, block_size), _NEG_INF,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros((b, n_heads, block_size), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, n_heads, block_size, d), dtype=torch.float32,
                          device=q.device)
        for j in range(i + 1 if causal else n_blocks):
            k_full, v_full = _repeat_kv(k_blocks[:, j], v_blocks[:, j],
                                        n_heads)
            scores = _block_scores(q_blocks[:, i], k_full, i * block_size,
                                   j * block_size, scale, causal)
            m, l, acc = _merge_block(m, l, acc, scores, v_full)
        out = acc / l.clamp_min(1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3))
    return torch.stack(outs, dim=1).reshape(b, t, n_heads, d).to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, scale: Optional[float] = None,
                   q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """Dense reference attention (q/k/v: [B, T, H(,_kv), D]).  The
    offsets place the blocks in global positions for the causal mask,
    the semantics of the flash kernels."""
    b, t, n_heads, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    k, v = _repeat_kv(k, v, n_heads)
    scores = _block_scores(q, k, q_offset, kv_offset, scale, causal)
    # the row-level guard zeroes rows whose every key is masked (softmax
    # would give a uniform 1/T there)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(m <= _NEG_INF / 2, 0.0, torch.softmax(scores, dim=-1))
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)

"""Single-device attention references: blockwise and dense.

Port of the single-device part of ``bluefog_tpu/parallel/
ring_attention.py``: ``_merge_block``, ``_block_scores``, ``_repeat_kv``,
:func:`blockwise_attention` and :func:`full_attention`, with the same
``-1e30`` masking in global positions and the same guard that gives a
row with no live key an output of 0.  They serve the Llama training
forward's ``attn_impl="xla"`` (``full_attention``) and
``attn_mode="blockwise"`` paths, and the tests' dense reference.
Everything is f32-accumulated whatever the input dtype; the output is
cast to q's dtype.

:func:`ring_attention` (K/V rotating around a ring of sequence shards)
is not ported yet and raises.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ring_attention", "blockwise_attention", "full_attention"]

_NEG_INF = -1e30
_RING_ITEM = ("ROADMAP.md Queue 1, item 10 (ring and Ulysses attention "
              "over the process backend)")


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


def ring_attention(q, k, v, axis_name, causal: bool = True,
                   scale: Optional[float] = None, impl: str = "xla"):
    """Not ported yet: sequence-parallel attention over a ring of ranks."""
    raise NotImplementedError(
        f"ring_attention is not ported to bluefog_tpu_torch yet; see "
        f"{_RING_ITEM}")


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

"""The acceptance check of the attention kernels (K2, K3a, K3b and the
fused splash backward K5) against their plain versions, shared by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` so that both
hold the kernels to one bound.

* :data:`CASES`: the shapes K2, K3a and K3b are checked at, the Llama
  training shape first, the ViT-B/16 shape second, Llama-1B's third,
  ViT-B/16's at 32 images (a rank's share of a resilient 4-rank step)
  fourth, the 8B width's training shape at tp 2 (each shard's heads,
  the shards in the batch) fifth, the longest forward of an uncached
  greedy rollout at 8B width (one 23-token row, under one tile) sixth
  (:data:`N_MODEL` model shapes in all);
  :data:`SPLASH_CASES` those of K5 (causal, no offsets), its two
  training shapes first.
* :func:`term_sizes`: for each entry of out, dQ, dK and dV, the sum of
  the absolute values of the terms whose bf16 rounding may differ
  between a kernel and its plain version.
* :func:`mismatch`: the largest ratio of an entry's error to its own
  bound (at most 1 passes).
* :func:`planted_faults`: the outputs of three deliberately wrong
  kernels, computed with the plain versions, which :func:`mismatch` must
  reject; they show the bound is tight enough to catch a lost tile or a
  lost group member (at a non-causal shape: a lost key tile, a lost
  query tile).  :func:`splash_planted_faults`: the same for K5's
  own failure modes (a lost dQ partial, a skipped diagonal query step).

* :func:`ring_term_sizes`: :func:`term_sizes` of the flash ring's
  outputs (``parallel/ring_attention.py``), summed over its live (shard,
  block) pairs; :func:`ring_planted_fault`: the plain ring with one live
  pair left out (:func:`drop_pair`), which :func:`mismatch` must reject.

K5 sums each dQ row over per-span f32 partials (256 keys for its wgmma
kernel, 64 for the mma.sync one), in another order than K3a; its dK and
dV take K3b's order.  The bound is the same.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from bluefog_tpu_torch.parallel.flash_attention import (
    _dscores, _heads, _probs, flash_backward_dkv_plain,
    flash_backward_dq_plain, flash_forward_plain)

__all__ = ["CASES", "N_MODEL", "SPLASH_CASES", "term_sizes", "mismatch",
           "planted_faults", "splash_planted_faults", "ring_term_sizes",
           "drop_pair", "ring_planted_fault"]

# (B, T, H, KV, D, dtype, causal, q_offset, kv_offset)
CASES = [
    # Llama-3.1-8B (phase 8; phase 26's pp 2: both stages' microbatches
    # of 2 rows folded into the batch)
    (4, 2048, 32, 8, 128, torch.bfloat16, True, 0, 0),
    (128, 200, 12, 12, 64, torch.bfloat16, False, 0, 0),  # ViT-B/16 b128
    (4, 2048, 32, 8, 64, torch.bfloat16, True, 0, 0),   # Llama-1B
    (32, 200, 12, 12, 64, torch.bfloat16, False, 0, 0),  # ViT-B/16 b32
    # 8B width at tp 2 (phase 25a): each shard's 16 q and 4 kv heads,
    # the two shards folded into the batch
    (8, 2048, 16, 4, 128, torch.bfloat16, True, 0, 0),
    (1, 23, 32, 8, 128, torch.bfloat16, True, 0, 0),    # 8B rollout
    (2, 100, 4, 4, 16, torch.float32, True, 0, 0),
    (2, 1000, 8, 2, 64, torch.float32, True, 0, 0),
    (1, 100, 4, 1, 64, torch.bfloat16, True, 0, 0),
    (2, 1000, 8, 4, 16, torch.bfloat16, False, 0, 0),
    (1, 64, 4, 2, 64, torch.bfloat16, True, 0, 64),     # every row masked
    (1, 100, 4, 2, 128, torch.float32, True, 0, 64),    # rows < 64 masked
    (1, 100, 4, 1, 32, torch.bfloat16, True, 128, 0),
    (1, 1000, 8, 2, 128, torch.float32, False, 128, 0),
]
N_MODEL = 6   # CASES[:N_MODEL] are the models' shapes

# (B, T, H, KV, D, dtype): K5, causal with no offsets
SPLASH_CASES = [
    (4, 2048, 32, 8, 64, torch.bfloat16),   # Llama-1B training
    (4, 2048, 32, 8, 128, torch.bfloat16),  # Llama-3.1-8B width
    (2, 128, 4, 4, 16, torch.float32),      # rep 1
    (2, 100, 8, 4, 32, torch.bfloat16),     # rep 2, ragged T
    (1, 1000, 8, 2, 16, torch.float32),     # rep 4, ragged T
    (2, 1000, 4, 1, 32, torch.bfloat16),
    (1, 128, 4, 2, 32, torch.bfloat16),
    (1, 100, 4, 1, 64, torch.float32),
]

BF16_ULPS = 2          # per entry, in ulps of that entry
BF16_TERMS = 2 ** -7   # of the entry's term sizes (term_sizes)
BF16_FLOOR = 2 ** -12  # of the output's largest term size
F32_TOL = 1e-5         # of the largest |want|


@torch.no_grad()
def term_sizes(q, k, v, do, lse, delta, causal: bool = True,
               scale: Optional[float] = None, q_offset: int = 0,
               kv_offset: int = 0) -> Dict[str, torch.Tensor]:
    """f32 ``{"out", "dq", "dk", "dv"}``, each the shape of that output:
    per entry, the sum of the absolute values of the terms of its sum
    whose factor is rounded to bf16 before the product (P for out and
    dV, dS for dQ and dK): ``|P|·|V|``, ``|dS|·|K|·scale``,
    ``|P|ᵀ·|dO|`` and ``|dS|ᵀ·|Q|·scale``, from the forward's lse and
    ``delta`` as the kernels take them."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    p = _probs(q, k, lse, causal, scale, q_offset, kv_offset)
    ds = _dscores(p, v, do, delta).abs_()
    q5, do5 = (x.reshape(b, t, kv, h // kv, d).float().abs()
               for x in (q, do))
    sizes = {
        "out": torch.einsum("bgrts,bsgd->bgrtd", p, v.float().abs()),
        "dq": torch.einsum("bgrts,bsgd->bgrtd", ds, k.float().abs()) * scale,
        "dv": torch.einsum("bgrts,btgrd->bsgd", p, do5),
        "dk": torch.einsum("bgrts,btgrd->bsgd", ds, q5) * scale}
    for key in ("out", "dq"):
        sizes[key] = _heads(sizes[key], b, t, h)
    return sizes


def mismatch(got: torch.Tensor, want: torch.Tensor,
             terms: Optional[torch.Tensor] = None) -> float:
    """Largest ``|got - want|`` over its bound, entry by entry; at most 1
    passes.  In bf16 an entry's bound is two ulps of the entry (each
    side rounds its f32 sum to bf16) plus 2**-7 of its ``terms``
    (:func:`term_sizes`): each term's bf16 factor may differ by one ulp,
    at most 2**-7 of its size, between the two sides.  For dQ, dK and
    dV the f32 factor differs in its last bits (another summation order)
    and may round the other way; for out, K2 rounds P from the running
    maximum and the plain version from the final one, a half-ulp on each
    side.  Plus 2**-12 of the largest term size of the whole output, for
    entries whose terms cancel: row 0's dS = P·(dP - delta) is the
    difference of two f32 sums of the same products, taken in another
    order by the kernel, so its dQ is f32 noise on both sides.  In f32
    (``terms`` not needed): 1e-5 of the largest |want|.  Both have a
    1e-6 floor, for outputs that are all zero."""
    want32 = want.float()
    err = (got.float() - want32).abs()
    if not err.numel():
        return 0.0
    if want.dtype == torch.bfloat16:
        _, exp = torch.frexp(want32)          # |want| in [2**(e-1), 2**e)
        ulp = torch.where(want32 == 0, 0.0, torch.exp2(exp - 8.0))
        bound = (BF16_ULPS * ulp + BF16_TERMS * terms
                 + BF16_FLOOR * terms.max() + 1e-6)
    else:
        bound = F32_TOL * want32.abs().max() + 1e-6
    return (err / bound).max().item()


def planted_faults(q, k, v, do, lse, delta, ref: Dict[str, torch.Tensor],
                   tile: int = 64, causal: bool = True
                   ) -> List[Tuple[str, str, torch.Tensor]]:
    """``(fault, output, tensor)`` for three wrong kernels at a causal,
    offset-free shape, each wrong only in the second half of the
    sequence, where entries are smallest: K2 and K3a skipping the
    diagonal key tile of each ``tile``-row query tile there (its rows see
    keys ``< tile·i`` only), and K3b skipping the last member of each kv
    head's group for those keys (needs more query heads than kv heads).
    With ``causal=False`` (no offsets) the faults are wrong only from
    ``max(T/2, tile)`` on: K2 and K3a skipping the last ``tile``-key tile
    (the ragged one where ``tile`` does not divide T) for those rows, and
    K3b skipping the last ``tile``-row query tile for those keys.
    Where a causal T is under two tiles (one tile holds the whole
    sequence), the faults take the largest multiple of 8 at most T/2 as
    their tile: a block of keys lost within the one tile.
    ``ref`` holds the plain versions' ``out``, ``dq``, ``dk`` and ``dv``
    on the same inputs; the faults are computed with the plain versions
    from the true forward's ``lse`` and ``delta``."""
    b, t, h, d = q.shape
    scale = d ** -0.5
    if causal and t < 2 * tile:
        tile = max(8, t // 2 // 8 * 8)
    half = t // 2 // tile * tile
    if not causal:
        return _planted_faults_noncausal(q, k, v, do, lse, delta, ref, tile,
                                         max(half, tile))
    out, dq = ref["out"].clone(), ref["dq"].clone()
    for a in range(max(half, tile), t, tile):
        rows = slice(a, min(a + tile, t))
        kv = (k[:, :a], v[:, :a])
        out[:, rows] = flash_forward_plain(q[:, rows], *kv, False, scale)[0]
        dq[:, rows] = flash_backward_dq_plain(
            q[:, rows], *kv, do[:, rows], lse[..., rows], delta[..., rows],
            False, scale, 0, 0)
    faults = [("diagonal key tile skipped past T/2", "out", out),
              ("diagonal key tile skipped past T/2", "dq", dq)]
    rep = h // k.shape[2]
    if rep > 1:
        keep = torch.arange(h, device=q.device) % rep != rep - 1
        dk, dv = flash_backward_dkv_plain(
            q, k, v, do * keep[:, None].to(do.dtype), lse,
            delta * keep[:, None], True, scale, 0, 0)
        for name, x in (("dk", dk), ("dv", dv)):
            x[:, :half] = ref[name][:, :half]
            faults.append(("last group member skipped past T/2", name, x))
    return faults


def _planted_faults_noncausal(q, k, v, do, lse, delta, ref, tile, start):
    t = q.shape[1]
    scale = q.shape[-1] ** -0.5
    last = (t - 1) // tile * tile   # the last tile's first key / query
    rows, kv = slice(start, t), (k[:, :last], v[:, :last])
    out, dq = ref["out"].clone(), ref["dq"].clone()
    out[:, rows] = flash_forward_plain(q[:, rows], *kv, False, scale)[0]
    dq[:, rows] = flash_backward_dq_plain(
        q[:, rows], *kv, do[:, rows], lse[..., rows], delta[..., rows],
        False, scale, 0, 0)
    faults = [("last key tile skipped past T/2", "out", out),
              ("last key tile skipped past T/2", "dq", dq)]
    dk, dv = flash_backward_dkv_plain(
        q[:, :last], k, v, do[:, :last], lse[..., :last], delta[..., :last],
        False, scale, 0, 0)
    for name, x in (("dk", dk), ("dv", dv)):
        x[:, :start] = ref[name][:, :start]
        faults.append(("last query tile skipped past T/2", name, x))
    return faults


def splash_planted_faults(q, k, v, do, lse, delta,
                          ref: Dict[str, torch.Tensor], tile: int = 64,
                          rows: int = 32
                          ) -> List[Tuple[str, str, torch.Tensor]]:
    """``(fault, output, tensor)`` for two wrong K5 kernels at a causal
    shape, each wrong only in the second half of the sequence: the dQ sum
    dropping each row's diagonal partial there (the ``tile``-key span
    that holds the row: the sum stops one span short), and every
    ``tile``-key span there skipping its diagonal query step (its first
    ``rows`` rows: their contributions to its dK and dV are lost).  The
    kernel's own span and query step: 256 and 64 for the wgmma kernel, 64
    and 32 for the mma.sync one.
    ``ref`` holds the plain version's ``dq``, ``dk`` and ``dv`` on the
    same inputs; the faults are computed with the plain versions from the
    true forward's ``lse`` and ``delta``."""
    t = q.shape[1]
    scale = q.shape[-1] ** -0.5
    half = t // 2 // tile * tile
    dq, dk, dv = (ref[key].float() for key in ("dq", "dk", "dv"))
    for a in range(max(half, tile), t, tile):
        blk = slice(a, min(a + tile, t))     # the tile's rows and keys
        dq[:, blk] -= flash_backward_dq_plain(
            q[:, blk], k[:, blk], v[:, blk], do[:, blk], lse[..., blk],
            delta[..., blk], True, scale, a, a).float()
        step = slice(a, min(a + rows, t))
        lost_k, lost_v = flash_backward_dkv_plain(
            q[:, step], k[:, blk], v[:, blk], do[:, step], lse[..., step],
            delta[..., step], True, scale, a, a)
        dk[:, blk] -= lost_k.float()
        dv[:, blk] -= lost_v.float()
    dq, dk, dv = (x.to(ref[key].dtype) for x, key in
                  ((dq, "dq"), (dk, "dk"), (dv, "dv")))
    return [("dQ sum drops the diagonal partial past T/2", "dq", dq),
            ("diagonal query step skipped past T/2", "dk", dk),
            ("diagonal query step skipped past T/2", "dv", dv)]


@torch.no_grad()
def ring_term_sizes(q, k, v, do, lse, delta, n_shards: int,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> Dict[str, torch.Tensor]:
    """:func:`term_sizes` of the flash ring's out, dQ, dK and dV on
    shard-major inputs (q ``[S, B, T, H, D]``, lse and ``delta =
    rowsum(dO·O)`` ``[S, B, H, T]``, the ring's own): each live (shard,
    block) pair's sizes against the global lse and delta, summed where
    the ring sums (out and dQ over a shard's blocks, dK and dV over the
    shards a block meets).  Each block's partial output is rounded to
    q's type before the f32 merge on both sides, and its terms carry
    that block's share of the softmax, so the bound of :func:`mismatch`
    holds the merged entry as it holds one kernel's."""
    from bluefog_tpu_torch.parallel.ring_attention import ring_live

    t = q.shape[2]
    sizes = {"out": torch.zeros(q.shape, dtype=torch.float32,
                                device=q.device),
             "dq": torch.zeros(q.shape, dtype=torch.float32,
                               device=q.device),
             "dk": torch.zeros(k.shape, dtype=torch.float32,
                               device=k.device),
             "dv": torch.zeros(v.shape, dtype=torch.float32,
                               device=v.device)}
    for i in range(n_shards):
        for j in range(n_shards):
            if not ring_live(causal, i * t, j * t, t):
                continue
            part = term_sizes(q[i], k[j], v[j], do[i], lse[i], delta[i],
                              causal, scale, i * t, j * t)
            sizes["out"][i] += part["out"]
            sizes["dq"][i] += part["dq"]
            sizes["dk"][j] += part["dk"]
            sizes["dv"][j] += part["dv"]
    return sizes


def drop_pair(kernels, q_offset: int, kv_offset: int):
    """The ring's ``kernels`` (forward, dQ, dK/dV) wrapped to leave out
    the (shard, block) pair at these offsets, a planted fault: there the
    forward gives out 0 and lse -1e30 (the merge then keeps the other
    blocks' result, as if the pair were skipped) and the backward gives
    zeros."""
    fwd, bwd_dq, bwd_dkv = kernels

    def hit(args):
        return tuple(args[-2:]) == (q_offset, kv_offset)

    def forward(*args):
        if not hit(args):
            return fwd(*args)
        q = args[0]
        b, t, h, _ = q.shape
        return (torch.zeros_like(q),
                torch.full((b, h, t), -1e30, dtype=torch.float32,
                           device=q.device))

    def dq(*args):
        return torch.zeros_like(args[0]) if hit(args) else bwd_dq(*args)

    def dkv(*args):
        if not hit(args):
            return bwd_dkv(*args)
        return torch.zeros_like(args[1]), torch.zeros_like(args[2])

    return forward, dq, dkv


def ring_planted_fault(q, k, v, do, axis, causal: bool = True
                       ) -> Dict[str, torch.Tensor]:
    """The plain flash ring's outputs with the longest live hop left out
    (:func:`drop_pair`): the last shard never attends to the first
    shard's block (its out and dQ lose that block's share, the block's dK
    and dV lose the last shard's queries).  :func:`mismatch` must reject
    each of out, dQ, dK and dV."""
    from bluefog_tpu_torch.parallel.ring_attention import (PLAIN_KERNELS,
                                                           ring_flash_parts)

    t = q.shape[2]
    return ring_flash_parts(
        q, k, v, do, axis, causal,
        kernels=drop_pair(PLAIN_KERNELS, (axis.size - 1) * t, 0))

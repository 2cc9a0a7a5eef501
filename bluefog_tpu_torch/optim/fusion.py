"""Shared bucket/fusion planner of the port.

Port of ``bluefog_tpu/optim/fusion.py`` (whose module imports jax) in
numpy and torch.  One grouping policy serves the train step's fused
per-bucket epilogue pipeline (``EpiloguePlan``: one bucket per leaf on
the plain path, size-balanced buckets under ``overlap="bucketed"``) and
rank-major tensor fusion (``FusionPlan``).  The plans are the JAX
package's, leaf for leaf: dtypes are named as numpy names them
(``"float32"``, ``"bfloat16"``), so a torch leaf list and the matching
JAX leaf list give equal rows and equal groups.

Grouping policy (the reference's fusion buffer): walk the leaves in
order, packing consecutive same-dtype leaves into the current bucket
until adding the next leaf would exceed ``threshold`` bytes; a dtype
change always closes the bucket, and a leaf larger than the threshold
gets a bucket of its own.  Sound for any elementwise-linear collective:
the weighted combine distributes over concatenation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "plan_groups",
    "size_balanced_threshold",
    "leaf_signature",
    "bucket_signature",
    "epilogue_stages",
    "EpilogueBucket",
    "EpiloguePlan",
    "EPILOGUE_STAGE_ORDER",
    "FusionPlan",
    "pack_bucket",
]

# Canonical stage order of the fused per-bucket epilogue pipeline:
#
#   pack         gather the bucket's leaves into one flat buffer
#   ef_encode    error-feedback delta + top-k sparsify (compressed mixing)
#   quantize     wire compression encode (int8 absmax / bf16 round; under
#                ef_encode it quantizes the kept top-k VALUES)
#   exchange     the bucket's own neighbor collective
#   dequantize   wire decode + weighted combine (f32 accumulation)
#   ef_decode    receiver-side reconstruction mirror + delta
#   guard_select per-rank skip: elementwise select against last-good
#   health_norm  partial grad/update sq-sums for the HealthVector
#   consensus    partial ||pre - mixed||^2 from the exchange's buffers
#   unpack       scatter the combined buffer back to leaf shapes
EPILOGUE_STAGE_ORDER = (
    "pack", "ef_encode", "quantize", "exchange", "dequantize",
    "ef_decode", "guard_select", "health_norm", "consensus", "unpack",
)


def epilogue_stages(compress=None, guard: bool = False,
                    health: bool = False,
                    consensus: bool = False,
                    mix: bool = False) -> Tuple[str, ...]:
    """The epilogue stage list a feature combination composes to, in
    canonical order (``bluefog_tpu.optim.fusion.epilogue_stages``)."""
    on = {"pack", "exchange", "unpack"}
    if compress:
        on |= {"quantize", "dequantize"}
    if mix:
        on |= {"ef_encode", "ef_decode"}
    if guard:
        on.add("guard_select")
    if health:
        on.add("health_norm")
    if consensus:
        on.add("consensus")
    return tuple(s for s in EPILOGUE_STAGE_ORDER if s in on)


@dataclasses.dataclass(frozen=True)
class EpilogueBucket:
    """One fusion-plan bucket plus the epilogue stage list that runs over
    it as one composed pass."""

    index: int                  # bucket position in plan order
    leaves: Tuple[int, ...]     # leaf indices, in order
    nbytes: int                 # per-rank payload bytes
    dtype: str                  # uniform dtype of the bucket's leaves
    stages: Tuple[str, ...]     # subset of EPILOGUE_STAGE_ORDER


@dataclasses.dataclass(frozen=True)
class EpiloguePlan:
    """Plan of the fused per-bucket epilogue pipeline: one bucket per leaf
    when ``n_buckets`` is None (per-tensor wire scales, no concatenation),
    size-balanced buckets otherwise."""

    buckets: Tuple[EpilogueBucket, ...]
    stages: Tuple[str, ...]

    @classmethod
    def for_leaves(cls, leaves, n_buckets, *, compress=None,
                   guard: bool = False, health: bool = False,
                   consensus: bool = False, mix: bool = False,
                   skip_leading_axis: bool = False) -> "EpiloguePlan":
        """``skip_leading_axis=True`` plans rank-major ``[n, ...]`` leaves
        by their per-rank bytes (the port's stacked layout); the JAX
        package plans the per-shard leaf, which is the same thing."""
        rows = bucket_signature(leaves, skip_leading_axis)
        if n_buckets is None:
            groups = [[i] for i in range(len(rows))]
        else:
            groups = plan_groups(rows,
                                 size_balanced_threshold(rows, n_buckets))
        stages = epilogue_stages(compress=compress, guard=guard,
                                 health=health, consensus=consensus,
                                 mix=mix)
        buckets = tuple(
            EpilogueBucket(index=b, leaves=tuple(g),
                           nbytes=sum(rows[i][0] for i in g),
                           dtype=rows[g[0]][1], stages=stages)
            for b, g in enumerate(groups))
        return cls(buckets=buckets, stages=stages)

    @property
    def groups(self) -> List[List[int]]:
        """The bare grouping (``plan_groups`` layout)."""
        return [list(b.leaves) for b in self.buckets]


# (nbytes, dtype_str) per leaf: the only inputs the grouping walk sees.
SizeDtype = Tuple[int, str]


def plan_groups(sizes_dtypes: Sequence[SizeDtype],
                threshold: int) -> List[List[int]]:
    """The ONE grouping walk: consecutive same-dtype leaves pack into a
    bucket of at most ``threshold`` bytes (an oversize leaf stands alone).
    Returns the buckets, each a list of leaf indices in order; every index
    appears exactly once."""
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i, (nbytes, dtype) in enumerate(sizes_dtypes):
        nbytes = int(nbytes)
        if cur and (dtype != cur_dtype or cur_bytes + nbytes > threshold):
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = dtype
    if cur:
        groups.append(cur)
    return groups


def size_balanced_threshold(sizes_dtypes: Sequence[SizeDtype],
                            n_buckets: int) -> int:
    """Byte threshold that makes ``plan_groups`` yield ~``n_buckets``
    size-balanced buckets: ceil(total/K).  Dtype boundaries can only
    increase the count; the walk never splits a leaf, so a dominant leaf
    can leave fewer than K buckets."""
    if n_buckets <= 0:
        raise ValueError(f"n_buckets must be positive, got {n_buckets}")
    total = sum(int(nb) for nb, _ in sizes_dtypes)
    return max(1, math.ceil(total / n_buckets))


def _dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype: ``torch.float32`` and
    ``np.float32`` are both ``"float32"``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype


def _itemsize(name: str) -> int:
    return getattr(torch, name).itemsize


def leaf_signature(leaves) -> Tuple[Tuple[Tuple[int, ...], str], ...]:
    """((shape, dtype_name), ...): the hashable identity of a leaf list
    (tensors, arrays, or anything with ``shape`` and ``dtype``)."""
    return tuple((tuple(l.shape), _dtype_name(l.dtype)) for l in leaves)


def bucket_signature(leaves, skip_leading_axis: bool = False):
    """(nbytes, dtype) rows for ``plan_groups`` from a leaf list;
    ``skip_leading_axis=True`` measures per-rank bytes of rank-major
    ``[n, ...]`` leaves."""
    rows = []
    for shape, dtype in leaf_signature(leaves):
        dims = shape[1:] if skip_leading_axis else shape
        rows.append((int(np.prod(dims, dtype=np.int64)) * _itemsize(dtype),
                     dtype))
    return rows


def pack_bucket(leaves, idx) -> torch.Tensor:
    """One bucket's flat ``[n, numel]`` buffer from rank-major leaves (a
    one-leaf bucket is the leaf itself: no copy, and an int8 wire's scale
    stays per tensor)."""
    if len(idx) == 1:
        return leaves[idx[0]]
    n = leaves[idx[0]].shape[0]
    return torch.cat([leaves[i].reshape(n, -1) for i in idx], dim=1)


class FusionPlan:
    """Rank-major tensor fusion: same-dtype leaves are packed, in order,
    into flat ``[n, K]`` buffers of at most ``threshold`` bytes per rank,
    so one combine runs over a few buffers instead of every leaf.  Plans
    are cached per (leaf signature, threshold)."""

    _cache: Dict[Any, "FusionPlan"] = {}

    def __init__(self, signature, threshold: int):
        self.signature = signature  # ((n, ...) shape, dtype name) per leaf
        rows = [(int(np.prod(shape[1:], dtype=np.int64)) * _itemsize(dtype),
                 dtype) for shape, dtype in signature]
        self.groups = plan_groups(rows, threshold)
        stages = epilogue_stages()
        self.buckets = tuple(
            EpilogueBucket(index=b, leaves=tuple(g),
                           nbytes=sum(rows[i][0] for i in g),
                           dtype=rows[g[0]][1], stages=stages)
            for b, g in enumerate(self.groups))

    def pack(self, leaves) -> tuple:
        """One ``[n, numel]`` buffer per bucket (``pack_bucket``)."""
        return tuple(pack_bucket(leaves, g) for g in self.groups)

    def unpack(self, buffers) -> tuple:
        """The leaves back from ``pack``'s buffers (views into them)."""
        outs = [None] * len(self.signature)
        for g, buf in zip(self.groups, buffers):
            if len(g) == 1:
                outs[g[0]] = buf
                continue
            off = 0
            for i in g:
                shape = self.signature[i][0]
                k = int(np.prod(shape[1:], dtype=np.int64))
                outs[i] = buf[:, off:off + k].reshape(shape)
                off += k
        return tuple(outs)

    @classmethod
    def for_leaves(cls, leaves, threshold: int) -> "FusionPlan":
        signature = leaf_signature(leaves)
        key = (signature, threshold)
        plan = cls._cache.get(key)
        if plan is None:
            plan = cls._cache[key] = cls(signature, threshold)
        return plan

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
    "DeviceView",
    "DeviceLayout",
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


def _stage_key(name: str):
    """(group key, layer index) of a stacked leaf's dotted name: the
    name with its first integer component taken out, and that integer
    (``layers.3.attention.wq.kernel`` -> ``("layers.*.attention.wq.
    kernel", 3)``)."""
    parts = name.split(".")
    for i, p in enumerate(parts):
        if p.isdigit():
            return ".".join(parts[:i] + ["*"] + parts[i + 1:]), int(p)
    raise ValueError(f"param {name!r} is one layer of a stack (its spec's "
                     "rank entry is a tuple) but its name holds no layer "
                     "index")


@dataclasses.dataclass(frozen=True)
class DeviceView:
    """One leaf of what ONE device holds, read from rank-major leaves.

    ``members``: the rank-major leaves it is read from: one, or the
    layers of one weight name a device holds (stacked along a new dim 1
    in layer order, as JAX's scanned stack holds them).  ``splits``: per
    dim of the (stacked) per-rank leaf, the mesh axes that split it,
    major first.  ``shape``: one device's shape; ``dtype`` its numpy
    name."""

    members: Tuple[int, ...]
    splits: Tuple[Tuple[str, ...], ...]
    shape: Tuple[int, ...]
    dtype: str


class DeviceLayout:
    """The per-device view of a rank's leaves: the counterpart of what
    each device of a JAX mesh holds under ``shard_map``, for the port,
    which stacks every shard and stage of a rank on one device and holds
    a replicated leaf once.

    A device is one (rank, index on every model axis), the axes in
    ``axes`` order (``[(name, size), ...]``; the device index is
    row-major over them, first axis major, as JAX's ``P("bf", rest)``
    shards a packed axis over the mesh's other axes).  Its leaves
    (``views``, in the params' order) are each sharded leaf's slice
    along the dims its spec names, a leaf replicated over an axis whole,
    and where JAX's leaf is a scanned stack (a spec whose rank entry is a
    tuple: ``(rank axis,)`` for ``scan_layers``, ``(rank axis, pp axis)``
    under a pp axis) the layers of each weight name as one leaf, ``[L,
    ...]`` or its stage's ``[L / S, ...]`` (placed where the name's first
    layer stands).

    :meth:`pack` gathers a bucket of views into ``[n, devices, numel]``
    (reshapes, one permute and one broadcast per view: no loop over
    devices); :meth:`unpack` writes a combined buffer back, the device
    with index 0 on every axis a leaf does not name supplying it (JAX's
    ``out_specs=P("bf")`` keeps the first device's copy)."""

    def __init__(self, axes: Sequence[Tuple[str, int]],
                 views: Sequence[DeviceView]):
        self.axes = tuple((str(a), int(s)) for a, s in axes)
        self.sizes = dict(self.axes)
        self.devices = int(np.prod([s for _, s in self.axes],
                                   dtype=np.int64))
        self.views = tuple(views)
        self._plans = [self._plan(v) for v in self.views]

    @classmethod
    def for_leaves(cls, names: Sequence[str], leaves, specs,
                   axes: Sequence[Tuple[str, int]]) -> "DeviceLayout":
        """The layout of rank-major ``leaves`` named ``names`` under
        ``specs`` (``{name: spec}`` or one spec; a spec the tuple of axis
        names the train step takes, the rank entry first: ``("bf",)``
        for one layer of a scanned stack, ``("bf", "pp")`` for a
        stage-owned one).  Raises JAX's ValueError when
        the specs do not match the leaves exactly."""
        sizes = dict(axes)
        if isinstance(specs, tuple):
            specs = dict.fromkeys(names, specs)
        if len(specs) != len(names) or any(k not in specs for k in names):
            raise ValueError(
                "compressed mixing needs param_specs to be None, one "
                "PartitionSpec, or a tree matching params exactly "
                f"(got {len(specs)} specs for {len(names)} leaves)")
        shapes = [tuple(l.shape[1:]) for l in leaves]
        dtypes = [_dtype_name(l.dtype) for l in leaves]

        def dim_axes(spec, nd):
            out = [()] * nd
            for d, e in enumerate(spec[1:]):
                out[d] = tuple(a for a in (e if isinstance(e, tuple)
                                           else (e,)) if a is not None)
            return out

        def stacked(spec):
            return isinstance(spec[0], tuple)

        groups: Dict[str, list] = {}
        for i, k in enumerate(names):
            if stacked(specs[k]):
                key, layer = _stage_key(k)
                groups.setdefault(key, []).append((layer, i))
        views, seen = [], set()
        for i, k in enumerate(names):
            spec = specs[k]
            dims = dim_axes(spec, len(shapes[i]))
            if not stacked(spec):
                members, shape, splits = (i,), shapes[i], dims
            else:
                key, _ = _stage_key(k)
                if key in seen:
                    continue
                seen.add(key)
                members = tuple(j for _, j in sorted(groups[key]))
                for j in members:
                    if (shapes[j], dtypes[j], specs[names[j]]) != (
                            shapes[i], dtypes[i], spec):
                        raise ValueError(
                            f"the layers of {key!r} differ in shape, dtype "
                            f"or spec ({names[j]!r} against {k!r}): one "
                            "weight name is one leaf of a stack")
                shape = (len(members),) + shapes[i]
                splits = [tuple(spec[0][1:])] + dims
            dev_shape = []
            for d, (size, ax) in enumerate(zip(shape, splits)):
                div = int(np.prod([sizes[a] for a in ax], dtype=np.int64))
                if size % div:
                    raise ValueError(
                        f"dim {d} of {k!r} ({size}) does not split over "
                        f"{ax}")
                dev_shape.append(size // div)
            views.append(DeviceView(members=members, splits=tuple(splits),
                                    shape=tuple(dev_shape),
                                    dtype=dtypes[i]))
        return cls(axes, views)

    def _plan(self, v: DeviceView) -> dict:
        """The reshapes of one view: the (stacked) leaf unflattened so
        each split axis has a dim of its own, those dims moved first in
        axis order, and the axes the view does not name broadcast."""
        unflat, pos = [], {}
        stacked = len(v.members) > 1
        lead = (len(v.members),) if stacked else ()
        for d, ax in enumerate(v.splits):
            for a in ax:
                pos[a] = len(unflat) + 1
                unflat.append(self.sizes[a])
            unflat.append(v.shape[d])
        named = [a for a, _ in self.axes if a in pos]
        inner = [i for i in range(1, len(unflat) + 1)
                 if i not in pos.values()]
        perm = [0] + [pos[a] for a in named] + inner
        inv = [perm.index(i) for i in range(len(perm))]
        return dict(
            stacked=stacked, lead=lead, unflat=tuple(unflat), perm=perm,
            inv=inv, named=tuple(self.sizes[a] for a in named),
            inner=tuple(unflat[i - 1] for i in inner),
            bcast=tuple(s if a in pos else 1 for a, s in self.axes),
            pick=tuple(slice(None) if a in pos else 0 for a, _ in self.axes),
            numel=int(np.prod(v.shape, dtype=np.int64)))

    def numel(self, vidx) -> int:
        """One device's element count of the views ``vidx``."""
        return sum(self._plans[j]["numel"] for j in vidx)

    def members(self, vidx) -> List[int]:
        """The rank-major leaves the views ``vidx`` read, in order."""
        return sorted({m for j in vidx for m in self.views[j].members})

    def _rows(self, leaves, j: int) -> torch.Tensor:
        v, p = self.views[j], self._plans[j]
        x = (leaves[v.members[0]] if not p["stacked"] else
             torch.stack([leaves[m] for m in v.members], dim=1))
        n = x.shape[0]
        y = x.reshape((n,) + p["unflat"]).permute(p["perm"])
        y = y.reshape((n,) + p["bcast"] + (p["numel"],))
        y = y.expand((n,) + tuple(s for _, s in self.axes) + (p["numel"],))
        return y.reshape(n, self.devices, p["numel"])

    def pack(self, leaves, vidx) -> torch.Tensor:
        """The bucket of views ``vidx`` from rank-major ``leaves``: ``[n,
        devices, numel]``, device-major per rank."""
        parts = [self._rows(leaves, j) for j in vidx]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)

    def unpack(self, out: torch.Tensor, leaves, vidx) -> None:
        """Copy a combined ``[n, devices, numel]`` bucket back into the
        rank-major leaves its views read."""
        n = out.shape[0]
        off = 0
        for j in vidx:
            v, p = self.views[j], self._plans[j]
            k = p["numel"]
            y = out[:, :, off:off + k].reshape(
                (n,) + tuple(s for _, s in self.axes) + (k,))
            off += k
            y = y[(slice(None),) + p["pick"]]
            y = y.reshape((n,) + p["named"] + p["inner"]).permute(p["inv"])
            y = y.reshape((n,) + p["lead"] + tuple(
                leaves[v.members[0]].shape[1:]))
            if not p["stacked"]:
                leaves[v.members[0]].copy_(y)
            else:
                for i, m in enumerate(v.members):
                    leaves[m].copy_(y[:, i])


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

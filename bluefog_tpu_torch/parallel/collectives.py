"""Rank-major collectives: the port's data plane (stacked backend).

Port of ``bluefog_tpu/parallel/collectives.py``.  The JAX functions run
per device shard under ``shard_map`` and move data with ``lax.ppermute``
/ ``lax.psum``.  Here every tensor is RANK-MAJOR: a leading ``[n_ranks]``
axis holds every rank's value on one device (the JAX package's own
single-process contract, ``optim/functional.py:19-22``), so

* ``ppermute`` over one shift class is one gather along the rank axis:
  ``out[dst] = x[src]`` for each (src, dst) of the class, and ZEROS for a
  rank that receives nothing, as ``ppermute`` gives;
* ``psum`` is a sum over the rank axis, broadcast back to every rank.

:class:`StackedBackend` bundles these for ``build_train_step``, in the
place of the JAX package's ``Mesh``.  A ``torch.distributed`` backend
(one process per card, NCCL) is a later slice (ROADMAP.md, Queue 1,
item 6); it implements the same methods on per-process tensors.

The weighted combine ``w_self·x + Σ_c w_c·recv_c`` is accumulated in
float32 for low-precision payloads (``_accum_dtype``), in the same
association order as the JAX package (collectives.py:329-331).  It stays
plain torch: the JAX package leaves it to an XLA fusion (a Pallas version
was slower and deleted, collectives.py:324-328).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.topology.spec import (DynamicTopology, Topology,
                                             self_weights_of)

CommSpec = Union[Topology, DynamicTopology]

__all__ = [
    "StackedBackend",
    "allreduce",
    "broadcast",
    "neighbor_allreduce",
    "edge_structure",
    "class_recv_weights",
    "self_weight_vector",
]


def _accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Combine in f32 for low-precision floats and integers; keep f32/f64."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    if not dtype.is_floating_point:
        return torch.float32
    return dtype


_structure_cache: dict = {}


def edge_structure(spec: DynamicTopology) -> DynamicTopology:
    """The spec with all edge weights replaced by 1.0: the edge skeleton.
    A DECLARED edge transfers even when its weight is 0.0 (matching the
    reference, mpi_controller.cc:594-600).  Memoized on ``(size, edges)``."""
    key = (spec.size, spec.edges)
    structure = _structure_cache.get(key)
    if structure is None:
        structure = DynamicTopology.from_edges(
            spec.size, {e: 1.0 for e in spec.edges})
        _structure_cache[key] = structure
    return structure


def class_recv_weights(spec: CommSpec) -> torch.Tensor:
    """[n_classes, n] float64 weight rows: row c, entry d = the weight
    rank d applies to what it receives through shift class c (0 where no
    edge).  Class order matches ``spec.shift_classes`` (for a
    DynamicTopology, its skeleton's, which has the same edges)."""
    if isinstance(spec, Topology):
        rows = [cls.recv_weights for cls in spec.shift_classes]
        if not rows:
            return torch.zeros((0, spec.size), dtype=torch.float64)
        return torch.tensor(np.asarray(rows, np.float64))
    structure = edge_structure(spec)
    ew = dict(zip(spec.edges, spec.edge_weight_values))
    rows = np.zeros((len(structure.shift_classes), spec.size), np.float64)
    for c, cls in enumerate(structure.shift_classes):
        for (src, dst) in cls.perm:
            rows[c, dst] = ew.get((src, dst), 0.0)
    return torch.tensor(rows)


def self_weight_vector(spec: CommSpec) -> torch.Tensor:
    """[n] float64 per-rank self weights."""
    return torch.tensor(np.asarray(self_weights_of(spec), np.float64))


def _rank_shape(x: torch.Tensor):
    """Broadcast shape of a per-rank [n] vector against rank-major x."""
    return (x.shape[0],) + (1,) * (x.dim() - 1)


_index_cache: dict = {}


def _device_const(values, device, dtype=None) -> torch.Tensor:
    """A constant table on ``device``, built once per (values, device,
    dtype): a host-to-device copy per call would stall the stream."""
    key = (values, str(device), dtype)
    t = _index_cache.get(key)
    if t is None:
        t = _index_cache[key] = torch.tensor(values, dtype=dtype,
                                             device=device)
    return t


def _permute(x: torch.Tensor, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """``lax.ppermute`` on the rank axis: ``out[dst] = x[src]`` for every
    (src, dst) in ``perm``, zeros where a rank receives nothing."""
    n = x.shape[0]
    if len(perm) == n:   # a full permutation: one gather
        idx = [0] * n
        for s, d in perm:
            idx[d] = s
        return x.index_select(0, _device_const(tuple(idx), x.device))
    out = torch.zeros_like(x)
    if perm:
        src = tuple(s for s, _ in perm)
        dst = tuple(d for _, d in perm)
        out.index_copy_(0, _device_const(dst, x.device),
                        x.index_select(0, _device_const(src, x.device)))
    return out


def _wire_quantize_int8(x: torch.Tensor):
    """Per-tensor (per rank) absmax int8 quantization of the payload,
    rounding to nearest (half to even, as ``jnp.round``).  Returns
    (q int8 [n, ...], scale f32 [n])."""
    x32 = x.float()
    n = x.shape[0]
    scale = x32.abs().reshape(n, -1).amax(dim=1) / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    y = x32 / safe.reshape(_rank_shape(x))
    q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return q, scale


def _as_weights(w, acc: torch.dtype, device) -> torch.Tensor:
    """Weights (floats or a float64 tensor) in the accumulation dtype:
    each float64 value rounds once, as ``jnp.asarray(w, acc)`` does."""
    if not isinstance(w, torch.Tensor):
        w = torch.tensor(np.asarray(w, np.float64))
    return w.to(device=device, dtype=acc)


def neighbor_allreduce(
    x: torch.Tensor,
    spec: CommSpec,
    compress: Optional[str] = None,
    class_weights: Optional[torch.Tensor] = None,
    self_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted neighbor averaging of a rank-major ``x`` ([n, ...]):

        out[i] = self_weight[i] * x[i] + sum_{(j,i) in E} w[j,i] * x[j]

    One gather along the rank axis per shift class of ``spec``.
    ``compress="int8"`` sends each rank's payload as per-tensor absmax
    int8 plus one f32 scale (round to nearest); ``compress="bf16"`` rounds
    the payload to bfloat16 (a no-op for bf16 payloads).  The self term
    stays full precision.  ``class_weights`` ([n_classes, n],
    ``class_recv_weights`` layout) and ``self_weights`` ([n]) supply the
    combine weights as runtime tensors; ``spec`` then contributes only the
    edge structure.  In-degree-1 classes that are pairwise disjoint (each
    round of a one-peer schedule) fuse into ONE gather with mixed shifts,
    as the JAX package fuses them into one collective-permute."""
    if compress not in (None, "int8", "bf16"):
        raise ValueError(f"unknown compress mode {compress!r}")
    if x.shape[0] != spec.size:
        raise ValueError(f"rank-major tensor has {x.shape[0]} ranks, the "
                         f"topology {spec.size}")
    acc = _accum_dtype(x.dtype)
    dev = x.device
    bshape = _rank_shape(x)
    self_w = _as_weights(self_weights_of(spec) if self_weights is None
                         else self_weights, acc, dev).reshape(bshape)
    classes = spec.shift_classes

    def recv_w(c, cls):
        if class_weights is None:
            w = _as_weights(cls.recv_weights, acc, dev)
        else:
            w = class_weights[c].to(device=dev, dtype=acc)
        return w.reshape(bshape)

    def wire(perm):
        if compress == "int8":
            return (_permute(q, perm).float()
                    * _permute(scale, perm).reshape(bshape))
        if compress == "bf16" and x.dtype != torch.bfloat16:
            return _permute(x.to(torch.bfloat16), perm)
        return _permute(x, perm)

    if compress == "int8":
        q, scale = _wire_quantize_int8(x)
    if len(classes) > 1:
        all_pairs = [p for cls in classes for p in cls.perm]
        srcs = [s for s, _ in all_pairs]
        dsts = [d for _, d in all_pairs]
        if len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts):
            merged = tuple(sorted(all_pairs))
            if class_weights is None:
                w_fused = _as_weights(
                    np.sum([cls.recv_weights for cls in classes], axis=0),
                    acc, dev)
            else:
                masks = tuple(tuple(1.0 if d in {p[1] for p in cls.perm}
                                    else 0.0 for d in range(spec.size))
                              for cls in classes)
                w_fused = (class_weights.to(device=dev, dtype=acc)
                           * _device_const(masks, dev, acc)).sum(0)
            out = (x.to(acc) * self_w
                   + wire(merged).to(acc) * w_fused.reshape(bshape))
            return out.to(x.dtype)

    out = x.to(acc) * self_w
    for c, cls in enumerate(classes):
        # out + recv * w, one pass (the JAX package's multiply-add chain)
        out.addcmul_(wire(cls.perm).to(acc), recv_w(c, cls))
    return out.to(x.dtype)


def allreduce(x: torch.Tensor, average: bool = True) -> torch.Tensor:
    """Every rank receives the sum (or mean) over ranks, accumulated in
    f32 for low-precision payloads (reference mpi_controller.cc:169)."""
    acc = _accum_dtype(x.dtype)
    total = x.to(acc).sum(0, keepdim=True)
    if average:
        total = total / x.shape[0]
    return total.to(x.dtype).expand_as(x).clone()


def broadcast(x: torch.Tensor, root_rank: int) -> torch.Tensor:
    """Every rank receives ``root_rank``'s value, exactly
    (reference mpi_controller.cc:193)."""
    if not 0 <= root_rank < x.shape[0]:
        raise ValueError(f"root rank {root_rank} outside 0..{x.shape[0] - 1}")
    return x[root_rank:root_rank + 1].expand_as(x).clone()


class StackedBackend:
    """``n_ranks`` ranks stacked on one device: the port's counterpart of
    the JAX package's one-axis ``Mesh``.  Every rank-major tensor it
    handles has a leading ``[n_ranks]`` axis on ``device``; forward and
    backward of a train step run rank after rank, so only one rank's
    activations are alive at a time.

    ``device`` defaults to ``"cuda"`` and raises without CUDA unless
    ``"cpu"`` is passed."""

    def __init__(self, n_ranks: int,
                 device: Union[str, torch.device] = "cuda"):
        if n_ranks < 1:
            raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
        self.size = int(n_ranks)
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return f"StackedBackend(n_ranks={self.size}, device={self.device})"

    def rank_major(self, tree: dict) -> dict:
        """A copy of every leaf of ``{name: tensor}`` for each rank,
        stacked along a new leading axis on this backend's device: every
        rank starts from the same point."""
        return {k: v.detach().to(self.device).unsqueeze(0)
                .repeat((self.size,) + (1,) * v.dim())
                for k, v in tree.items()}

    def neighbor_allreduce(self, x, spec, compress=None, class_weights=None,
                           self_weights=None):
        return neighbor_allreduce(x, spec, compress=compress,
                                  class_weights=class_weights,
                                  self_weights=self_weights)

    def allreduce(self, x, average: bool = True):
        return allreduce(x, average=average)

    def broadcast(self, x, root_rank: int):
        return broadcast(x, root_rank)

"""Rank-major collectives: the port's data plane.

Port of ``bluefog_tpu/parallel/collectives.py``.  The JAX functions run
per device shard under ``shard_map`` and move data with ``lax.ppermute``
/ ``lax.psum``.  Here every tensor is RANK-MAJOR: a leading axis holds
the values of the ranks this process owns (the JAX package's contract:
a process holds its addressable shards of a global rank-major array,
``optim/functional.py:19-22``).  Every function reduces to two
primitives of a :class:`RankAxis`:

* **permute** over global (src, dst) pairs, ``lax.ppermute``: ``out[dst]
  = x[src]``, and ZEROS for a rank that receives nothing;
* **gather** of every rank's rows (``gather_ranks``), from which a sum
  over ranks is taken in rank order.

:class:`StackedBackend` holds every rank on one device: a permute is one
gather along the rank axis.  :class:`ProcessBackend` holds ``k``
consecutive ranks per process of a ``torch.distributed`` job: pairs
inside the process stay gathers, pairs across processes go as one
``batch_isend_irecv`` per permute (NCCL for device tensors, gloo for
host tensors, and gloo through pinned host buffers for device tensors).
The math above the primitives is one copy for both, so a
``ProcessBackend`` job gives the stacked backend's bits.

The model axes (:class:`MeshAxis`: tensor and expert parallelism; its
case :class:`SeqAxis`: sequence parallelism) are :class:`RankAxis`es
too, over the shards of one data-parallel rank; see its docstring for
the convention.

The weighted combine ``w_self·x + Σ_c w_c·recv_c`` is accumulated in
float32 for low-precision payloads (``_accum_dtype``), in the same
association order as the JAX package (collectives.py:329-331).  It stays
plain torch: the JAX package leaves it to an XLA fusion (a Pallas version
was slower and deleted, collectives.py:324-328).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.topology.spec import (DynamicTopology, Topology,
                                             self_weights_of)

CommSpec = Union[Topology, DynamicTopology]

__all__ = [
    "RankAxis",
    "MeshAxis",
    "SeqAxis",
    "bind_axis",
    "bound_axis",
    "RankBackend",
    "StackedBackend",
    "ProcessBackend",
    "WireGenerator",
    "allreduce",
    "broadcast",
    "allgather",
    "allgatherv",
    "in_neighbor_lists",
    "neighbor_allgather",
    "neighbor_allgather_padded",
    "pair_gossip",
    "neighbor_allreduce",
    "neighbor_allreduce_buckets",
    "edge_structure",
    "class_recv_weights",
    "self_weight_vector",
    "wire_generator",
    "push_sum_structure",
    "push_sum_mix",
    "machine_groups",
    "validate_machine_decomposition",
    "hierarchical_neighbor_allreduce",
    "mix_compress_exchange",
    "mix_wire_bytes",
    "mix_mirror_slots",
]


def _tally_machine(x: torch.Tensor, local_size: int, size: int,
                   devices: int) -> None:
    """Count a machine mean as JAX's grouped all-reduce, its rank groups
    the machines."""
    if _exchange_tally is not None:
        _tally_exchange("all-reduce", _row_bytes(x, devices),
                        groups=machine_groups(size, local_size))


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


# Every exchange runs inside a profiler range of this name.
EXCHANGE = "bf.backend.exchange"

# The exchanges of a ``profile_step`` run by collective kind, ``{kind:
# {"count", "bytes", "payloads"}}`` (``payloads``: each exchange's bytes,
# in order; a grouped all-reduce also records its rank ``groups``):
# ``observe/stepprof.py`` sets a dict here for the run it profiles and
# reads it back; None (nothing counted) otherwise.
_exchange_tally: Optional[dict] = None


def _tally_exchange(kind: str, nbytes: int, groups=None) -> None:
    """Count one exchange of ``nbytes`` per device (the JAX package's
    per-device result bytes: one device's row for a permute or a sum,
    every rank's rows for a gather) while a profile counts; ``groups``
    (a grouped all-reduce's rank groups) is recorded once per distinct
    value."""
    tally = _exchange_tally
    if tally is not None:
        rec = tally.setdefault(kind, {"count": 0, "bytes": 0,
                                      "payloads": []})
        rec["count"] += 1
        rec["bytes"] += int(nbytes)
        rec["payloads"].append(int(nbytes))
        if groups is not None:
            seen = rec.setdefault("groups", [])
            groups = tuple(tuple(g) for g in groups)
            if groups not in seen:
                seen.append(groups)


def _row_bytes(x: torch.Tensor, devices: int = 1) -> int:
    """One device's bytes of rank-major ``x``: a rank's row, over the
    ``devices`` its dim 1 holds (a per-device bucket ``[n, D, ...]``)."""
    return x[:1].numel() * x.element_size() // int(devices)


class RankAxis:
    """The rank axis of the rank-major tensors one process holds: ranks
    ``first_rank .. first_rank + n_local - 1`` of a world of ``size``.
    This base is the stacked layout, every rank in one process: a permute
    is a gather along the axis and ``gather_ranks`` is the tensor itself.
    :class:`ProcessBackend` overrides the primitives."""

    def __init__(self, size: int, n_local: Optional[int] = None,
                 first_rank: int = 0):
        self.size = int(size)
        self.n_local = self.size if n_local is None else int(n_local)
        self.first_rank = int(first_rank)

    @property
    def ranks(self) -> range:
        """The global ranks of this process's rows."""
        return range(self.first_rank, self.first_rank + self.n_local)

    def owns(self, rank: int) -> bool:
        return self.first_rank <= rank < self.first_rank + self.n_local

    def own(self, v: torch.Tensor) -> torch.Tensor:
        """This process's rows of a per-rank ``[size, ...]`` tensor."""
        if self.n_local == self.size:
            return v
        return v[self.first_rank:self.first_rank + self.n_local]

    def permute(self, x: torch.Tensor, perm,
                devices: int = 1) -> torch.Tensor:
        """``lax.ppermute`` over global (src, dst) pairs on this process's
        rows ``x`` (``[n_local, ...]``; ``devices``: a per-device bucket
        ``[n_local, devices, ...]``, each device's row a permute of JAX's
        devices, counted as one device's bytes)."""
        with torch.profiler.record_function(EXCHANGE):
            _tally_exchange("collective-permute", _row_bytes(x, devices))
            return _permute(x, perm)

    def gather_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, ``[size, ...]``, in rank order."""
        return x

    def rank_row(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        """Global rank ``rank``'s row (``[1, ...]``) on every process."""
        r = rank - self.first_rank
        return x[r:r + 1]

    def all_sizes(self, sizes: Sequence[int]) -> List[int]:
        """Every rank's entry of a per-rank host list whose local
        entries are ``sizes`` (this process's ranks, in order)."""
        return [int(v) for v in sizes]

    def machine_mean(self, x: torch.Tensor, local_size: int,
                     dtype: torch.dtype, average: bool = True,
                     devices: int = 1) -> torch.Tensor:
        """:func:`_machine_mean` over the machines of ``local_size``
        consecutive global ranks, on this process's rows: JAX's grouped
        all-reduce (``devices``: as for :meth:`permute`)."""
        _tally_machine(x, local_size, self.size, devices)
        return _machine_mean(x, local_size, dtype, average)


class MeshAxis(RankAxis):
    """A named mesh axis besides the rank axis ``"bf"``: the counterpart
    of an axis that ``shard_map`` binds by name (``"sp"``, ``"tp"``,
    ``"ep"``), over ``size`` shards.

    The convention: every shard of one data-parallel rank lives in one
    process, on one device, stacked SHARD-MAJOR along a leading axis: a
    per-shard tensor ``[size, ...]`` holds shard ``s``'s value at
    ``[s]``, what device ``s`` of the JAX mesh holds.  A value that JAX
    keeps REPLICATED over the axis (an identical copy on every device) is
    held ONCE, without the leading axis.  The object is the one place
    that holds the axis size, as the JAX mesh does; a config names it
    (``LlamaConfig.sp_axis``/``tp_axis``/``ep_axis``) and
    ``build_train_step(sp_axis=, mesh_axes=)`` or ``llama_generate(mesh=)``
    binds it (:func:`bind_axis`) for the duration of each forward and
    backward, as ``shard_map`` binds its axis names.  A model called with
    the name unbound raises, as ``lax.axis_index`` does outside
    ``shard_map``.

    * :meth:`index`: each shard's index, ``lax.axis_index``;
    * :meth:`permute` (a gather along the leading axis, the base
      class's) and :meth:`shift`, ``lax.ppermute`` and the ring's hop;
    * :meth:`all_to_all`: ``lax.all_to_all(..., tiled=True)``;
    * :meth:`psum`, :meth:`pmax`: ``lax.psum``/``lax.pmax`` of per-shard
      values, the result replicated (held once);
    * :meth:`all_gather`: ``lax.all_gather(..., tiled=True)`` of
      per-shard blocks, the result replicated;
    * :meth:`psum_scatter`: ``lax.psum_scatter(..., tiled=True)``, the
      result per shard.

    Because a replicated value is held once, a sum over the shard axis
    and a broadcast along it are conjugate under autograd: the backward
    of :meth:`psum` hands every shard the one cotangent (Megatron's ``g``:
    psum forward, identity backward), and a replicated input read by
    every shard collects the sum of the shards' cotangents (``f``:
    identity forward, psum backward).  :meth:`all_gather` and
    :meth:`psum_scatter` are each other's backward in the same way.  So
    every method is plain differentiable torch, and the gradients equal
    JAX's through its custom-VJP pairs.  Sequence, tensor and expert
    parallelism move data only through these methods, so an axis whose
    shards span processes can override them alone."""

    def __init__(self, name: str, size: int):
        if int(size) < 1:
            raise ValueError(f"axis size must be >= 1, got {size}")
        super().__init__(int(size))
        self.name = str(name)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r}, {self.size})"

    def index(self, device=None) -> torch.Tensor:
        """``lax.axis_index``: the index of each shard this process
        holds, int64 ``[n_local]`` on ``device`` (made there, no host
        copy)."""
        return torch.arange(self.first_rank, self.first_rank + self.n_local,
                            device=device)

    def _shards(self, x: torch.Tensor, what: str) -> None:
        if x.dim() == 0 or x.shape[0] != self.size:
            raise ValueError(f"{what} over {self!r} takes [{self.size}, "
                             f"...] shard-major tensors, got "
                             f"{tuple(x.shape)}")

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """The ring's hop: shard ``i``'s rows go to shard ``(i + 1) %
        size`` (``lax.ppermute`` with ``[(i, (i + 1) % n)]``).
        Differentiable: the backward is the reverse hop, as JAX
        transposes a ``ppermute``."""
        n = self.size
        return self.permute(x, [(i, (i + 1) % n) for i in range(n)])

    def all_to_all(self, x: torch.Tensor, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """``lax.all_to_all(x, name, split_axis, concat_axis,
        tiled=True)`` on shard-major ``x`` (``[size, ...]``; the axes
        count in a shard's own dims, as in JAX): each shard splits its
        ``split_axis`` into ``size`` chunks, sends chunk ``j`` to shard
        ``j``, and concatenates what it receives along ``concat_axis`` in
        the senders' order.  Differentiable: the backward is the reverse
        all-to-all."""
        n = self.size
        self._shards(x, "all_to_all")
        a = split_axis + 1
        if x.shape[a] % n:
            raise ValueError(f"axis {split_axis} of size {x.shape[a]} "
                             f"does not split into {n} chunks")
        with torch.profiler.record_function(EXCHANGE):
            _tally_exchange("all-to-all", _row_bytes(x))
            y = x.unflatten(a, (n, x.shape[a] // n)).movedim(a, 0)
            # [dst, src, ...]: the senders join the concat axis, outermost
            y = y.movedim(1, 1 + concat_axis)
            return y.flatten(1 + concat_axis, 2 + concat_axis).contiguous()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum``: the sum of the shards' values ``x [size, ...]``
        in shard order, replicated (``[...]``, held once)."""
        self._shards(x, "psum")
        with torch.profiler.record_function(EXCHANGE):
            _tally_exchange("all-reduce", _row_bytes(x))
            out = x[0]
            for s in range(1, self.size):
                out = out + x[s]
            return out

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.pmax``: the shards' elementwise maximum, replicated."""
        self._shards(x, "pmax")
        with torch.profiler.record_function(EXCHANGE):
            _tally_exchange("all-reduce", _row_bytes(x))
            return x.amax(dim=0)

    def all_gather(self, x: torch.Tensor, axis: int = 0,
                   tiled: bool = True) -> torch.Tensor:
        """``lax.all_gather(x, name, axis=axis, tiled=True)``: the shards'
        blocks ``x [size, ...]`` concatenated along their dim ``axis`` in
        shard order, replicated (``[...]``, that dim ``size`` times
        longer)."""
        if not tiled:
            raise NotImplementedError("all_gather(tiled=False): the port's "
                                      "model axes gather tiled")
        self._shards(x, "all_gather")
        with torch.profiler.record_function(EXCHANGE):
            _tally_exchange("all-gather", x.numel() * x.element_size())
            return x.movedim(0, axis).flatten(axis, axis + 1)

    def psum_scatter(self, x: torch.Tensor, scatter_dimension: int = 0,
                     tiled: bool = True) -> torch.Tensor:
        """``lax.psum_scatter(x, name, scatter_dimension=d, tiled=True)``:
        the sum of the shards' values ``x [size, ...]``, each shard
        keeping its block of dim ``d``: ``[size, ..., x_d / size, ...]``,
        per shard."""
        if not tiled:
            raise NotImplementedError("psum_scatter(tiled=False): the "
                                      "port's model axes scatter tiled")
        n = self.size
        self._shards(x, "psum_scatter")
        d = scatter_dimension
        if x.shape[d + 1] % n:
            raise ValueError(f"dim {d} of size {x.shape[d + 1]} does not "
                             f"scatter over {n} shards")
        with torch.profiler.record_function(EXCHANGE):
            _tally_exchange("reduce-scatter", _row_bytes(x) // n)
            out = x[0]
            for s in range(1, n):
                out = out + x[s]
            return out.unflatten(d, (n, out.shape[d] // n)).movedim(d, 0)


class SeqAxis(MeshAxis):
    """A sequence-parallel axis (:class:`MeshAxis`): a sequence split
    into ``size`` shards of ``T / size`` positions, stacked shard-major.
    ``build_train_step(sp_axis=)`` takes it; ring and Ulysses attention
    move data only through its :meth:`~MeshAxis.shift`,
    :meth:`~MeshAxis.permute` and :meth:`~MeshAxis.all_to_all`."""


# The axes bound by name (``bind_axis``): process-wide, not per thread, so
# a recompute that autograd runs on its own thread finds them too.
_bound_axes: Dict[str, MeshAxis] = {}


@contextlib.contextmanager
def bind_axis(axis: MeshAxis):
    """Bind ``axis`` under ``axis.name`` for the ``with`` block, as
    ``shard_map`` binds its mesh axis names: the forward and the backward
    of a sequence-, tensor- or expert-parallel model must run inside it
    (a remat recompute looks the axis up again)."""
    if not isinstance(axis, MeshAxis):
        raise TypeError(f"bind_axis takes a SeqAxis or a MeshAxis, got "
                        f"{type(axis).__name__}")
    prev = _bound_axes.get(axis.name)
    _bound_axes[axis.name] = axis
    try:
        yield axis
    finally:
        if prev is None:
            _bound_axes.pop(axis.name, None)
        else:
            _bound_axes[axis.name] = prev


def bound_axis(name) -> MeshAxis:
    """The :class:`MeshAxis` bound under ``name`` (an axis is returned
    as it is); ``NameError`` when none is, as ``lax.axis_index`` outside
    ``shard_map``."""
    if isinstance(name, MeshAxis):
        return name
    axis = _bound_axes.get(name)
    if axis is None:
        raise NameError(
            f"unbound axis name: {name!r}; run inside bind_axis("
            f"MeshAxis({name!r}, size)) or under build_train_step("
            f"sp_axis=SeqAxis({name!r}, size)) / build_train_step("
            f"mesh_axes=(MeshAxis({name!r}, size),))")
    return axis


def _axis(comm: Optional[RankAxis], x: torch.Tensor) -> RankAxis:
    """``comm``, or the stacked axis of every rank of ``x``."""
    return comm if comm is not None else RankAxis(x.shape[0])


def _check_rows(ax: RankAxis, x: torch.Tensor, size: int, what: str):
    if ax.size != size:
        raise ValueError(f"rank-major tensor has {ax.size} ranks, {what} "
                         f"{size}")
    if x.shape[0] != ax.n_local:
        raise ValueError(f"this process holds {ax.n_local} ranks, the "
                         f"tensor {x.shape[0]}")


def _fused_pairs(classes):
    """The sorted (src, dst) pairs of a round's shift classes when every
    src and every dst appears once across all of them (each rank has at
    most one in-edge: the round fuses into ONE permute with mixed shifts,
    as the JAX package fuses it into one collective-permute), else
    ``None``."""
    if len(classes) <= 1:
        return None
    pairs = [p for cls in classes for p in cls.perm]
    if (len({s for s, _ in pairs}) == len(pairs)
            and len({d for _, d in pairs}) == len(pairs)):
        return tuple(sorted(pairs))
    return None


def _fused_recv_weights(classes, class_weights, size, dtype, device):
    """The per-destination weight of a fused round: the classes' weight
    rows summed (each destination has at most one nonzero among them), on
    the host from the spec, or from runtime ``class_weights`` through a
    mask of each class's destinations."""
    if class_weights is None:
        return np.sum([cls.recv_weights for cls in classes], axis=0)
    masks = tuple(tuple(1.0 if d in {p[1] for p in cls.perm} else 0.0
                        for d in range(size)) for cls in classes)
    return (class_weights.to(device=device, dtype=dtype)
            * _device_const(masks, device, dtype)).sum(0)


# base seed of the stochastic-rounding wire: the JAX package's
# ``PRNGKey(0x51EED)``, folded with the step and the bucket index
_WIRE_SEED = 0x51EED


class WireGenerator:
    """The uniform draws of the stochastic-rounding wire of bucket
    ``bucket`` at train step ``step``: one ``torch.Generator`` per GLOBAL
    rank, seeded from ``(0x51EED, step, bucket, rank)`` as the JAX
    package folds ``PRNGKey(0x51EED)`` with the step and then the bucket,
    and for a per-device bucket one per (rank, device), seeded from
    ``(0x51EED, step, bucket, rank, device)``.  A rank's draws do not
    depend on which process holds it, so a :class:`ProcessBackend` job
    rounds as the stacked backend does.  They are not the JAX package's
    bits (another generator)."""

    def __init__(self, device, step: int, bucket: int = 0):
        self.device = torch.device(device)
        self.step, self.bucket = int(step), int(bucket)

    def generator(self, rank: int,
                  device: Optional[int] = None) -> torch.Generator:
        key = [_WIRE_SEED, self.step, self.bucket, int(rank)]
        if device is not None:
            key.append(int(device))
        seed = int(np.random.SeedSequence(key).generate_state(
            1, np.uint64)[0] >> np.uint64(1))
        return torch.Generator(device=self.device).manual_seed(seed)

    def uniform(self, like: torch.Tensor, first_rank: int = 0,
                per_device: bool = False) -> torch.Tensor:
        """U[0, 1) shaped like the rank-major ``like``, row ``i`` from
        global rank ``first_rank + i``'s stream; with ``per_device``
        (``like`` is ``[n, D, ...]``) row ``(i, d)`` from that rank's
        device ``d``'s stream."""
        if not per_device:
            return torch.stack([
                torch.rand(like.shape[1:], generator=self.generator(
                    first_rank + i), device=like.device, dtype=like.dtype)
                for i in range(like.shape[0])])
        return torch.stack([torch.stack([
            torch.rand(like.shape[2:], generator=self.generator(
                first_rank + i, d), device=like.device, dtype=like.dtype)
            for d in range(like.shape[1])]) for i in range(like.shape[0])])


def wire_generator(device, step: int, bucket: int = 0) -> WireGenerator:
    """The :class:`WireGenerator` of bucket ``bucket`` at train step
    ``step``: deterministic per (step, bucket, rank)."""
    return WireGenerator(device, step, bucket)


def _wire_quantize_int8(x: torch.Tensor,
                        generator: Optional[WireGenerator] = None,
                        first_rank: int = 0, per_device: bool = False):
    """Per-tensor (per rank) absmax int8 quantization of the payload, or
    with ``per_device`` (``x`` is ``[n, D, ...]``) per (rank, device), as
    each JAX device quantizes what it holds.  Without ``generator`` it
    rounds to nearest (half to even, as ``jnp.round``): deterministic but
    biased, so in iterated averaging the snaps can build a consensus
    floor.  With ``generator`` it rounds stochastically, ``floor(y + u)``
    with u ~ U[0, 1) drawn per rank (per rank and device) from its stream
    (row ``i`` is global rank ``first_rank + i``), so E[q] = y.  Returns
    (q int8 like ``x``, scale f32 [n] or [n, D])."""
    x32 = x.float()
    lead = tuple(x.shape[:2 if per_device else 1])
    scale = x32.abs().reshape(lead + (-1,)).amax(dim=-1) / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    y = x32 / safe.reshape(lead + (1,) * (x.dim() - len(lead)))
    if generator is None:
        q = torch.round(y)
    else:
        q = torch.floor(y + generator.uniform(y, first_rank, per_device))
    q = torch.clamp(q, -127, 127).to(torch.int8)
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
    generator: Optional[WireGenerator] = None,
    comm: Optional[RankAxis] = None,
    per_device: bool = False,
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
    as the JAX package fuses them into one collective-permute.

    ``generator`` (int8 only) switches the wire to unbiased stochastic
    rounding (the JAX package's ``wire_key``; see
    :func:`wire_generator`).  ``comm`` is the rank axis ``x`` lies on
    (default: every rank stacked in ``x``).  ``per_device``: ``x`` is a
    per-device bucket ``[n, D, ...]`` (``optim.fusion.DeviceLayout``),
    each (rank, device) row its own int8 scale and stochastic-rounding
    stream, each permute counted as one device's bytes."""
    if compress not in (None, "int8", "bf16"):
        raise ValueError(f"unknown compress mode {compress!r}")
    if generator is not None and compress != "int8":
        raise ValueError("generator= requires compress='int8'")
    ax = _axis(comm, x)
    _check_rows(ax, x, spec.size, "the topology")
    acc = _accum_dtype(x.dtype)
    dev = x.device
    bshape = _rank_shape(x)
    D = x.shape[1] if per_device else 1
    self_w = ax.own(_as_weights(self_weights_of(spec) if self_weights is None
                                else self_weights, acc, dev)).reshape(bshape)
    classes = spec.shift_classes

    def recv_w(c, cls):
        if class_weights is None:
            w = _as_weights(cls.recv_weights, acc, dev)
        else:
            w = class_weights[c].to(device=dev, dtype=acc)
        return ax.own(w).reshape(bshape)

    def wire(perm):
        if compress == "int8":
            return (ax.permute(q, perm, D).float()
                    * ax.permute(scale, perm, D).reshape(sshape))
        if compress == "bf16" and x.dtype != torch.bfloat16:
            return ax.permute(x.to(torch.bfloat16), perm, D)
        return ax.permute(x, perm, D)

    if compress == "int8":
        q, scale = _wire_quantize_int8(x, generator, ax.first_rank,
                                       per_device)
        sshape = tuple(scale.shape) + (1,) * (x.dim() - scale.dim())
    merged = _fused_pairs(classes)
    if merged is not None:
        w_fused = ax.own(_as_weights(_fused_recv_weights(
            classes, class_weights, spec.size, acc, dev), acc, dev))
        out = (x.to(acc) * self_w
               + wire(merged).to(acc) * w_fused.reshape(bshape))
        return out.to(x.dtype)

    out = x.to(acc) * self_w
    for c, cls in enumerate(classes):
        # out + recv * w, one pass (the JAX package's multiply-add chain)
        out.addcmul_(wire(cls.perm).to(acc), recv_w(c, cls))
    return out.to(x.dtype)


def neighbor_allreduce_buckets(
    buffers: Sequence[torch.Tensor],
    spec: CommSpec,
    compress: Optional[str] = None,
    wire_step: Optional[int] = None,
    hierarchical_local_size: Optional[int] = None,
    class_weights: Optional[torch.Tensor] = None,
    self_weights: Optional[torch.Tensor] = None,
    comm: Optional[RankAxis] = None,
    per_device: bool = False,
) -> list:
    """One weighted neighbor combine per bucket buffer: the data plane of
    ``build_train_step(overlap="bucketed")``.  Each bucket is an
    independent exchange over the same topology.

    ``wire_step`` (with ``compress="int8"``) switches to stochastic
    rounding, bucket ``i`` drawing from ``wire_generator(device,
    wire_step, i)``; ``hierarchical_local_size`` routes the buckets
    through the machine-level combine (``spec`` and the weights are then
    machine-level, compression on the DCN leg only).  Per element the
    numerics are those of one ``neighbor_allreduce`` per leaf, except the
    int8 absmax scale, which is per bucket (per bucket and device for
    ``per_device`` buckets ``[n, D, ...]``)."""
    outs = []
    for i, buf in enumerate(buffers):
        gen = (wire_generator(buf.device, wire_step, i)
               if wire_step is not None else None)
        if hierarchical_local_size is not None:
            outs.append(hierarchical_neighbor_allreduce(
                buf, spec, hierarchical_local_size, compress=compress,
                class_weights=class_weights, self_weights=self_weights,
                generator=gen, comm=comm, per_device=per_device))
        else:
            outs.append(neighbor_allreduce(
                buf, spec, compress=compress, class_weights=class_weights,
                self_weights=self_weights, generator=gen, comm=comm,
                per_device=per_device))
    return outs


def push_sum_structure(spec: CommSpec):
    """(out_degrees, filtered perms): only edges with nonzero combine
    weight count as push-sum out-edges (a 0.0-weight edge of a
    DynamicTopology is declared but carries nothing)."""
    deg = np.zeros(spec.size, dtype=np.int64)
    perms = []
    for cls in spec.shift_classes:
        pairs = tuple((src, dst) for src, dst in cls.perm
                      if cls.recv_weights[dst] != 0.0)
        if not pairs:
            continue
        perms.append(pairs)
        for src, _ in pairs:
            deg[src] += 1
    return deg, perms


def push_sum_mix(tree, ps_weight: torch.Tensor, spec: CommSpec,
                 comm: Optional[RankAxis] = None):
    """One push-sum round: column-stochastic mixing of the extended
    payload.  Every rank j scales its payload (each rank-major leaf of
    ``tree``, a list/tuple/dict, and its entry of ``ps_weight`` [n]) by
    ``a_j = 1 / (out_degree_j + 1)`` and pushes it along every out-edge;
    receivers sum what arrives plus their own scaled payload.  Columns of
    the mixing matrix sum to 1, so ``sum(ps_weight) == n`` is kept.  Only
    the edge STRUCTURE is used (the reference's push-sum optimizer).
    Mixing runs in the accumulation dtype and is returned in it.

    Returns ``(mixed_tree, mixed_ps)``, still biased: de-bias with
    ``z = x / ps``."""
    ax = _axis(comm, ps_weight)
    _check_rows(ax, ps_weight, spec.size, "the topology")
    deg, perms = push_sum_structure(spec)
    a = ax.own(_device_const(tuple(float(v) for v in 1.0 / (deg + 1.0)),
                             ps_weight.device, torch.float32))

    def mix_leaf(x):
        scaled = x.to(_accum_dtype(x.dtype)) * a.reshape(_rank_shape(x))
        acc = scaled
        for perm in perms:
            acc = acc + ax.permute(scaled, perm)
        return acc

    if isinstance(tree, dict):
        mixed = {k: mix_leaf(v) for k, v in tree.items()}
    else:
        mixed = type(tree)(mix_leaf(v) for v in tree)
    return mixed, mix_leaf(ps_weight)


def machine_groups(size: int, local_size: int) -> list:
    """Partition ranks [0, size) into machines of ``local_size`` ranks."""
    local_size = int(local_size)
    if local_size < 1:
        raise ValueError(f"local_size must be >= 1, got {local_size}")
    if size % local_size != 0:
        raise ValueError(
            f"rank count {size} is not divisible by local_size {local_size}")
    return [list(range(m * local_size, (m + 1) * local_size))
            for m in range(size // local_size)]


def validate_machine_decomposition(n_ranks: int, local_size: int,
                                   machine_specs: Sequence[CommSpec] = ()
                                   ) -> list:
    """The rank count must tile into machines of ``local_size``, and every
    machine-level spec must be sized to the MACHINE count.  Returns the
    intra-machine rank groups."""
    groups = machine_groups(n_ranks, local_size)
    m = len(groups)
    for s in machine_specs:
        if s.size != m:
            raise ValueError(
                f"machine schedule of size {s.size} does not match "
                f"{m} machines ({n_ranks} ranks / local_size "
                f"{int(local_size)})")
    return groups


def _machine_mean(x: torch.Tensor, local_size: int,
                  dtype: torch.dtype, average: bool = True) -> torch.Tensor:
    """The exact intra-machine mean (or, without ``average``, sum) of
    rank-major ``x`` in ``dtype``, broadcast back to every rank of the
    machine (``[n, ...]``): the JAX package's grouped ``psum`` over each
    machine, then ``/ local_size``."""
    n = x.shape[0]
    grouped = x.to(dtype).reshape((n // local_size, local_size)
                                  + tuple(x.shape[1:]))
    total = grouped.sum(dim=1, keepdim=True)
    if average:
        total = total / local_size
    return total.expand_as(grouped).reshape(x.shape)


def _expand_pairs(perm, local_size: int):
    """Machine edge (ms, md) -> rank pairs (ms*L + j, md*L + j): every
    rank talks to its counterpart on the neighbor machine."""
    return tuple((ms * local_size + j, md * local_size + j)
                 for (ms, md) in perm for j in range(local_size))


def _unit_weights(w, unit, acc, device) -> torch.Tensor:
    """Per-rank weights from per-unit ones (``unit`` = rank // L): host
    values become a cached device constant, runtime tensors are gathered
    on the device."""
    if not isinstance(w, torch.Tensor):
        w = np.asarray(w, np.float64)
        return _device_const(tuple(float(w[u]) for u in unit), device, acc)
    w = w.to(device=device, dtype=acc)
    return w.index_select(0, _device_const(tuple(unit), device))


def hierarchical_neighbor_allreduce(
    x: torch.Tensor,
    machine_spec: CommSpec,
    local_size: int,
    compress: Optional[str] = None,
    class_weights: Optional[torch.Tensor] = None,
    self_weights: Optional[torch.Tensor] = None,
    generator: Optional[WireGenerator] = None,
    comm: Optional[RankAxis] = None,
    per_device: bool = False,
) -> torch.Tensor:
    """Machine-level neighbor averaging, ``W_machine ⊗ exact-local-mean``:
    (1) the exact mean over each machine's ``local_size`` ranks (full
    precision), (2) the machine means mixed over ``machine_spec``, every
    rank exchanging with its counterpart on the neighbor machine, so every
    rank of a machine ends with the machine's result.

    ``compress`` ("int8"/"bf16") and ``generator`` (stochastic rounding)
    apply to the inter-machine leg only.  ``class_weights``
    ([n_machine_classes, n_machines]) and ``self_weights`` ([n_machines])
    supply machine-level weights as runtime tensors.  With
    ``local_size == 1`` it is :func:`neighbor_allreduce`, bit for bit.
    ``per_device``: as for :func:`neighbor_allreduce` (each device's
    machine mean over the same device of the machine's ranks)."""
    if compress not in (None, "int8", "bf16"):
        raise ValueError(f"unknown compress mode {compress!r}")
    if generator is not None and compress != "int8":
        raise ValueError("generator= requires compress='int8'")
    L = int(local_size)
    n = machine_spec.size * L
    validate_machine_decomposition(n, L, (machine_spec,))
    ax = _axis(comm, x)
    _check_rows(ax, x, n, "the machine schedule covers")
    acc = _accum_dtype(x.dtype)
    dev = x.device
    bshape = _rank_shape(x)
    unit = [r // L for r in ax.ranks]
    D = x.shape[1] if per_device else 1
    local_mean = ax.machine_mean(x, L, acc, devices=D)
    self_w = _unit_weights(self_weights_of(machine_spec)
                           if self_weights is None else self_weights,
                           unit, acc, dev).reshape(bshape)
    # the machine mean goes on the wire in the payload dtype (exact at
    # local_size 1), or compressed; the self term keeps full precision
    wire_x = local_mean.to(x.dtype)
    if compress == "int8":
        q, scale = _wire_quantize_int8(wire_x, generator, ax.first_rank,
                                       per_device)
        sshape = tuple(scale.shape) + (1,) * (x.dim() - scale.dim())

    def wire(perm):
        if compress == "int8":
            return (ax.permute(q, perm, D).float()
                    * ax.permute(scale, perm, D).reshape(sshape))
        if compress == "bf16" and x.dtype != torch.bfloat16:
            return ax.permute(wire_x.to(torch.bfloat16), perm, D)
        return ax.permute(wire_x, perm, D)

    def recv_w(c, cls):
        w = cls.recv_weights if class_weights is None else class_weights[c]
        return _unit_weights(w, unit, acc, dev).reshape(bshape)

    classes = machine_spec.shift_classes
    merged = _fused_pairs(classes)
    if merged is not None:
        w_fused = _unit_weights(_fused_recv_weights(
            classes, class_weights, machine_spec.size, acc, dev),
            unit, acc, dev)
        out = (local_mean * self_w + wire(_expand_pairs(merged, L)).to(acc)
               * w_fused.reshape(bshape))
        return out.to(x.dtype)

    out = local_mean * self_w
    for c, cls in enumerate(classes):
        out.addcmul_(wire(_expand_pairs(cls.perm, L)).to(acc),
                     recv_w(c, cls))
    return out.to(x.dtype)


# ------------------------------------------------------------------ #
# error-feedback compressed mixing: sparse deltas on the wire
# ------------------------------------------------------------------ #
def mix_wire_bytes(numel: int, k: int, values: str = "int8") -> int:
    """Bytes of one compressed-mixing wire buffer (per rank, per bucket,
    per permute): ``k`` values (1 byte under int8, 4 under ``"none"``),
    the packed keep-mask (8 entries a byte) and, under int8, the 4-byte
    f32 scale."""
    numel, k = int(numel), int(k)
    mask_bytes = (numel + 7) // 8
    if values in ("int8", "int8_sr"):
        return k + mask_bytes + 4
    return 4 * k + mask_bytes


def mix_mirror_slots(spec: CommSpec) -> int:
    """Receiver-side mirror rows one round of ``spec`` needs: 1 when its
    shift classes fuse into a single permute (every src and dst unique
    across all classes), else one per class."""
    classes = spec.shift_classes
    if len(classes) <= 1:
        return max(len(classes), 1)
    return 1 if _fused_pairs(classes) is not None else len(classes)


_BIT_SHIFTS: dict = {}


def _bit_shifts(device) -> torch.Tensor:
    key = str(device)
    t = _BIT_SHIFTS.get(key)
    if t is None:
        t = _BIT_SHIFTS[key] = torch.arange(7, -1, -1, dtype=torch.uint8,
                                            device=device)
    return t


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """``np.packbits`` of each row of a bool ``[n, numel]`` mask (first
    entry in the high bit): ``[n, ceil(numel / 8)]`` uint8."""
    n, numel = mask.shape
    bits = torch.nn.functional.pad(mask.to(torch.uint8),
                                   (0, (-numel) % 8)).reshape(n, -1, 8)
    return (bits << _bit_shifts(mask.device)).sum(dim=2, dtype=torch.uint8)


def _unpack_bits(packed: torch.Tensor, count: int) -> torch.Tensor:
    """The inverse of :func:`_pack_bits`: bool ``[n, count]``."""
    n = packed.shape[0]
    bits = (packed.unsqueeze(2) >> _bit_shifts(packed.device)) & 1
    return bits.reshape(n, -1)[:, :count].bool()


def _mix_decode_wire(wire: torch.Tensor, numel: int, k: int,
                     values: str) -> torch.Tensor:
    """Dense f32 ``[n, numel]`` deltas from wire rows ``[n, bytes]``.  A
    rank that received nothing holds zero bytes: the zero mask decodes to
    an exactly-zero delta."""
    from bluefog_tpu_torch.compressor import topk_mask_decode

    n = wire.shape[0]
    mask_bytes = (numel + 7) // 8
    if values in ("int8", "int8_sr"):
        q = wire[:, :k].contiguous().view(torch.int8)
        packed = wire[:, k:k + mask_bytes]
        # a copy: a one-row slice is contiguous at an odd byte offset,
        # which no float view accepts
        scale = wire[:, k + mask_bytes:k + mask_bytes + 4].reshape(
            -1).clone().view(torch.float32)
        vals = q.float() * scale.reshape(n, 1)
    else:
        vals = wire[:, :4 * k].reshape(-1).clone().view(
            torch.float32).reshape(n, k)
        packed = wire[:, 4 * k:4 * k + mask_bytes]
    return topk_mask_decode(_unpack_bits(packed, numel), vals)


def _mix_encode_wire(target: torch.Tensor, k: int, k_live: torch.Tensor,
                     values: str, generator: Optional[WireGenerator],
                     first_rank: int = 0, devices: int = 0):
    """(wire uint8 [n, mix_wire_bytes], own delta f32 [n, numel]): top-k
    select each row's delta, quantize the kept values, pack everything
    into ONE byte row per rank, and decode it back, so the sender's own
    delta is bit for bit what every receiver decodes.  ``devices`` > 0:
    the rows are (rank, device) pairs, rank-major, each its own
    selection, scale and stochastic-rounding stream."""
    from bluefog_tpu_torch.compressor import topk_mask_encode

    n, numel = target.shape
    mask, vals = topk_mask_encode(target, k, k_live)
    packed = _pack_bits(mask)
    if values in ("int8", "int8_sr"):
        if devices:
            q, scale = _wire_quantize_int8(
                vals.reshape(n // devices, devices, k), generator,
                first_rank, per_device=True)
            q, scale = q.reshape(n, k), scale.reshape(n)
        else:
            q, scale = _wire_quantize_int8(vals, generator, first_rank)
        wire = torch.cat([q.view(torch.uint8), packed,
                          scale.contiguous().view(torch.uint8).reshape(n, 4)],
                         dim=1)
    else:
        wire = torch.cat([vals.float().contiguous().view(torch.uint8),
                          packed], dim=1)
    return wire, _mix_decode_wire(wire, numel, k, values)


def mix_compress_exchange(
    x: torch.Tensor,
    spec: CommSpec,
    *,
    ref_row: torch.Tensor,
    mirrors: torch.Tensor,
    err: torch.Tensor,
    ratio: torch.Tensor,
    k: int,
    values: str = "int8",
    error_feedback: bool = True,
    class_weights: Optional[torch.Tensor] = None,
    self_weights: Optional[torch.Tensor] = None,
    generator: Optional[WireGenerator] = None,
    hierarchical_local_size: Optional[int] = None,
    comm: Optional[RankAxis] = None,
    per_device: bool = False,
):
    """ONE round of error-feedback compressed neighbor averaging of the
    rank-major bucket ``x`` ([n, ...]).

    The wire carries ``compress(x - ref + e)``: each rank keeps a
    reference copy ``ref`` of what it has told this round's receivers
    and an error accumulator ``e``; the payload is the top-k-by-magnitude
    sparsification of the delta (packed keep-mask and int8 or f32 kept
    values, :func:`mix_wire_bytes`), the residual goes into ``e``, and
    every receiver rebuilds the sender's state as ``mirror + delta``.
    The combine is the ordinary weighted average of those full-precision
    reconstructions.

    State (f32, rank-major): ``ref_row`` [n, numel] (this round's
    cumulative sent deltas), ``mirrors`` [n, mix_mirror_slots(spec),
    numel], ``err`` [n, numel], ``ratio`` [n] (each rank's LIVE ratio:
    ``k_live = clip(floor(ratio * numel), 1, k)``).  ``values``:
    ``"int8"``, ``"int8_sr"`` (stochastic rounding from ``generator``)
    or ``"none"``.  Under ``hierarchical_local_size`` the exact machine
    mean is exchanged and the state lives at machine-mean granularity.
    ``per_device``: ``x`` is a per-device bucket ``[n, D, numel]``
    (``optim.fusion.DeviceLayout``) and the state holds one row per
    device, shard-major (``ref_row``/``err`` [n, D * numel], ``mirrors``
    [n, slots, D * numel]): each (rank, device) row has its own top-k
    selection, ``k_live``, int8 scale and stochastic-rounding stream,
    and one permute moves every device's wire (counted as one
    device's bytes).

    Returns ``(out, new_ref_row, new_mirrors, new_err)``.  A rank with no
    out-edge this round keeps ``ref``/``err``; one with no in-edge
    receives zero bytes and keeps its mirror."""
    if values not in ("int8", "int8_sr", "none"):
        raise ValueError(f"unknown mix values mode {values!r}")
    if generator is not None and values != "int8_sr":
        raise ValueError("generator= requires values='int8_sr'")
    if values == "int8_sr" and generator is None:
        raise ValueError("values='int8_sr' needs a generator")
    shape, dtype = x.shape, x.dtype
    n = shape[0]
    dev = x.device
    D = shape[1] if per_device else 1
    # rows [n, D, numel] (D = 1 without per_device), the state viewed so
    xf = x.reshape(n, D, -1)
    nb = xf.shape[2]
    ref3 = ref_row.reshape(n, D, nb)
    err3 = err.reshape(n, D, nb)
    f32 = torch.float32
    ax = _axis(comm, x)
    L = 1 if hierarchical_local_size is None else int(
        hierarchical_local_size)
    if hierarchical_local_size is not None:
        validate_machine_decomposition(spec.size * L, L, (spec,))
    _check_rows(ax, x, spec.size * L, "the spec covers")
    base = (xf.float() if hierarchical_local_size is None
            else ax.machine_mean(xf, L, f32, devices=D))
    unit = [r // L for r in ax.ranks]
    self_w = _unit_weights(self_weights_of(spec) if self_weights is None
                           else self_weights, unit, f32,
                           dev).reshape(n, 1, 1)
    classes = spec.shift_classes
    if not classes:
        return (base * self_w).to(dtype).reshape(shape), ref_row, mirrors, err

    # sender: encode the delta once per round (one wire to every
    # out-edge), fold the residual into e, advance ref, for ranks with
    # an out-edge this round only
    target = base - ref3 + err3
    k_live = torch.clamp(torch.floor(ratio * nb).to(torch.int32), 1, k)
    if per_device:
        k_live = k_live.repeat_interleave(D)
    wire, d_own = _mix_encode_wire(target.reshape(n * D, nb), k, k_live,
                                   values, generator, ax.first_rank,
                                   D if per_device else 0)
    wire = wire.reshape(n, D, -1)
    d_own = d_own.reshape(n, D, nb)
    has_out_unit = [False] * spec.size
    for cls in classes:
        for (s, _) in cls.perm:
            has_out_unit[s] = True
    has_out = _device_const(tuple(has_out_unit[u] for u in unit), dev,
                            torch.bool).reshape(n, 1, 1)
    # the new err and ref in the storage of target and d_own, which are
    # not read again (a bucket at 8B width is gigabytes)
    new_err = err3
    if error_feedback:
        new_err = torch.where(has_out, target.sub_(d_own), err3, out=target)
    new_ref = torch.where(has_out, d_own.add_(ref3), ref3, out=d_own)

    def recv_w(w):
        return _unit_weights(w, unit, f32, dev).reshape(n, 1, 1)

    def received(perm):
        got = ax.permute(wire if per_device else wire[:, 0], perm, D)
        return _mix_decode_wire(got.reshape(n * D, -1), nb, k,
                                values).reshape(n, D, nb)

    # receiver: the class-fusion rule of the dense exchange; a fused or
    # single-class round permutes the one wire once into one mirror row,
    # a multi-class round permutes it per class into per-slot rows
    merged = _fused_pairs(classes)
    new_mirrors = mirrors.reshape(n, -1, D, nb).clone()
    if merged is not None or len(classes) == 1:
        if merged is not None:
            perm = _expand_pairs(merged, L)
            w = recv_w(_fused_recv_weights(classes, class_weights,
                                           spec.size, f32, dev))
        else:
            perm = _expand_pairs(classes[0].perm, L)
            w = recv_w(classes[0].recv_weights if class_weights is None
                       else class_weights[0])
        new_mirrors[:, 0] += received(perm)
        acc = base * self_w + new_mirrors[:, 0] * w
    else:
        acc = base * self_w
        for c, cls in enumerate(classes):
            new_mirrors[:, c] += received(_expand_pairs(cls.perm, L))
            w = recv_w(cls.recv_weights if class_weights is None
                       else class_weights[c])
            acc = acc + new_mirrors[:, c] * w
    return (acc.to(dtype).reshape(shape), new_ref.reshape(ref_row.shape),
            new_mirrors.reshape(mirrors.shape), new_err.reshape(err.shape))


def allreduce(x: torch.Tensor, average: bool = True,
              local_size: Optional[int] = None,
              comm: Optional[RankAxis] = None) -> torch.Tensor:
    """Every rank receives the sum (or mean) over ranks, accumulated in
    f32 for low-precision payloads (reference mpi_controller.cc:169) and
    summed in rank order over every rank's rows.  With ``local_size``,
    over each machine of that many ranks only (the eager
    ``is_hierarchical_local`` allreduce)."""
    ax = _axis(comm, x)
    acc = _accum_dtype(x.dtype)
    if local_size is not None:
        validate_machine_decomposition(ax.size, local_size)
        return ax.machine_mean(x, int(local_size), acc,
                               average).to(x.dtype)
    _tally_exchange("all-reduce", _row_bytes(x))
    total = ax.gather_ranks(x).to(acc).sum(0, keepdim=True)
    if average:
        total = total / ax.size
    return total.to(x.dtype).expand_as(x).clone()


def broadcast(x: torch.Tensor, root_rank: int,
              comm: Optional[RankAxis] = None) -> torch.Tensor:
    """Every rank receives ``root_rank``'s value, exactly
    (reference mpi_controller.cc:193)."""
    ax = _axis(comm, x)
    if not 0 <= root_rank < ax.size:
        raise ValueError(f"root rank {root_rank} outside 0..{ax.size - 1}")
    return ax.rank_row(x, root_rank).expand_as(x).clone()


def allgather(x: torch.Tensor, comm: Optional[RankAxis] = None
              ) -> torch.Tensor:
    """Every rank receives all ranks' tensors concatenated along dim 0:
    ``[n, d0, ...] -> [n, n * d0, ...]`` (reference mpi_controller.cc:136;
    equal per-rank shapes, as the JAX package's ``all_gather``)."""
    ax = _axis(comm, x)
    _tally_exchange("all-gather", ax.size * _row_bytes(x))
    full = ax.gather_ranks(x)
    flat = full.reshape((1, ax.size * x.shape[1]) + tuple(x.shape[2:]))
    return flat.expand((x.shape[0],) + tuple(flat.shape[1:])).clone()


def allgatherv(x: torch.Tensor, sizes: Sequence[int],
               comm: Optional[RankAxis] = None) -> torch.Tensor:
    """Variable-size allgather (reference allgatherv,
    mpi_controller.cc:136-168): rank r's payload arrives padded to
    ``max(sizes)`` rows (``x`` is ``[n, pad, ...]``) and ``sizes`` are the
    true per-rank row counts of every rank.  Every rank receives the
    exact ragged concatenation ``[sum(sizes), ...]``: one row gather drops
    the pad rows (the displacements, computed on the host once per
    ``sizes``)."""
    ax = _axis(comm, x)
    sizes = [int(s) for s in sizes]
    pad = x.shape[1]
    if any(s > pad for s in sizes):
        raise ValueError(f"sizes {sizes} exceed the padded row count {pad}")
    rows = tuple(int(i) for r, s in enumerate(sizes)
                 for i in range(r * pad, r * pad + s))
    _tally_exchange("all-gather", ax.size * _row_bytes(x))
    flat = ax.gather_ranks(x).reshape((ax.size * pad,) + tuple(x.shape[2:]))
    out = flat.index_select(0, _device_const(rows, x.device, torch.long))
    return out.unsqueeze(0).expand((x.shape[0],) + tuple(out.shape)).clone()


def in_neighbor_lists(spec: CommSpec) -> list:
    """Sorted in-neighbor lists per rank, derived from the shift classes
    (edges with nonzero recv weight).  Host-side."""
    lists: list = [[] for _ in range(spec.size)]
    for cls in spec.shift_classes:
        for dst in range(spec.size):
            if cls.recv_weights[dst] != 0.0:
                lists[dst].append((dst - cls.shift) % spec.size)
    for lst in lists:
        lst.sort()
    return lists


def _gather_into(out: torch.Tensor, x: torch.Tensor, ax: RankAxis,
                 triples) -> None:
    """``out[dst, col] = x[src]`` for each (src, dst, col) of one shift
    class whose ``dst`` this process owns: one permute of the class's
    pairs, then one indexed write."""
    recv = ax.permute(x, tuple(sorted((s, d) for s, d, _ in triples)))
    mine = [(d - ax.first_rank, c) for _, d, c in triples if ax.owns(d)]
    if not mine:
        return
    dst = _device_const(tuple(d for d, _ in mine), x.device)
    col = _device_const(tuple(c for _, c in mine), x.device)
    out.index_put_((dst, col), recv.index_select(0, dst))


def neighbor_allgather(x: torch.Tensor, spec: CommSpec,
                       comm: Optional[RankAxis] = None) -> torch.Tensor:
    """In-neighbor values in a dense per-source buffer: ``[n, n, ...]``,
    ``out[dst, src]`` holding rank src's value where (src -> dst) is an
    edge and zeros elsewhere (the JAX package's dense layout,
    collectives.py:387).  :func:`neighbor_allgather_padded` is the
    in-degree-bounded form the eager layer uses."""
    ax = _axis(comm, x)
    _check_rows(ax, x, spec.size, "the topology")
    out = torch.zeros((x.shape[0], spec.size) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    for cls in spec.shift_classes:
        triples = [(s, d, s) for s, d in cls.perm
                   if cls.recv_weights[d] != 0.0]
        if triples:
            _gather_into(out, x, ax, triples)
    return out


def _slot_pairs(spec: CommSpec, in_lists) -> list:
    """Per shift class, the ``(src, dst, slot)`` triples of its edges with
    nonzero recv weight: ``slot`` is the source's position in ``dst``'s
    sorted in-neighbor list ``in_lists[dst]``."""
    n = spec.size
    out = []
    for cls in spec.shift_classes:
        out.append([((d - cls.shift) % n, d,
                     in_lists[d].index((d - cls.shift) % n))
                    for d in range(n) if cls.recv_weights[d] != 0.0])
    return out


def neighbor_allgather_padded(x: torch.Tensor, spec: CommSpec,
                              comm: Optional[RankAxis] = None
                              ) -> torch.Tensor:
    """In-degree-sized neighbor gather: ``[n, d_max, ...]``, slot ``k`` of
    rank ``dst`` holding the value of its k-th smallest in-neighbor
    (zeros beyond the rank's own in-degree; ``d_max`` the largest
    in-degree).  Memory is O(n * d_max * |x|), never the dense
    O(n^2 * |x|); for a graph of uniform in-degree the result reshaped to
    ``[n, d * d0, ...]`` is the reference's concat-by-source-rank layout
    (torch/mpi_ops.py:440-476).  One permute per shift class."""
    ax = _axis(comm, x)
    _check_rows(ax, x, spec.size, "the topology")
    lists = in_neighbor_lists(spec)
    d_max = max((len(lst) for lst in lists), default=0)
    out = torch.zeros((x.shape[0], d_max) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    for triples in _slot_pairs(spec, lists):
        if triples:
            _gather_into(out, x, ax, triples)
    return out


def pair_gossip(x: torch.Tensor, target_ranks: Sequence[int],
                self_weight: Optional[float] = None,
                pair_weight: Optional[float] = None,
                comm: Optional[RankAxis] = None) -> torch.Tensor:
    """Randomized two-node averaging: ``out = self_weight * x +
    pair_weight * x[target]``, in the accumulation dtype.
    ``target_ranks[i]`` is rank i's pair (an involution, as the
    reference's simultaneous Sendrecv needs, torch/mpi_ops.py:883-907); a
    rank paired with itself keeps its value."""
    self_weight = 0.5 if self_weight is None else self_weight
    pair_weight = 0.5 if pair_weight is None else pair_weight
    targets = [int(t) for t in target_ranks]
    ax = _axis(comm, x)
    _check_rows(ax, x, len(targets), "target_ranks")
    perm = tuple((i, t) for i, t in enumerate(targets) if t != i)
    if len({d for _, d in perm}) != len(perm):
        raise ValueError(f"target_ranks {targets} send two ranks' values "
                         "to one rank")
    acc = _accum_dtype(x.dtype)
    xa = x.to(acc)
    out = self_weight * xa + pair_weight * ax.permute(x, perm).to(acc)
    is_self = _device_const(tuple(targets[r] == r for r in ax.ranks),
                            x.device, torch.bool).reshape(_rank_shape(x))
    return torch.where(is_self, xa, out).to(x.dtype)


def _attribute_failure(name: str, exc: Exception) -> Exception:
    """A ``BluefogError`` for an exchange whose transport failed, naming
    the processes the liveness heartbeats judge dead (reference
    operations.cc:388-433 names the missing ranks): it reports this
    process's failure in the store, then watches the heartbeats for up to
    three stall windows, long enough for a dead process's sequence
    number to go stale.  A process that reported a failure of its own was
    alive to see it; its heartbeat may stop when it exits, so it is not
    named."""
    import time

    from bluefog_tpu_torch import config as bfconfig
    from bluefog_tpu_torch.context import BluefogError, _heartbeat
    from bluefog_tpu_torch.logging_util import get_logger

    window = bfconfig.stall_warning_time()
    stale: list = []
    _heartbeat.report_failure()
    if window > 0:
        deadline = time.monotonic() + 3 * window
        while not stale and time.monotonic() < deadline:
            stale = [p for p in _heartbeat.stale_processes(0.7 * window)
                     if not _heartbeat.reported_failure(p)]
            if not stale:
                time.sleep(min(0.25, window / 4))
    if not stale:
        return BluefogError(
            f"Operation '{name}' failed ({exc}); no stale heartbeat "
            "names a dead process (heartbeats are off without "
            "BLUEFOG_STALL_WARNING_TIME, or every process still beats).")
    msg = (f"Operation '{name}' failed on missing process(es) {stale} — "
           "their liveness heartbeat is stale or absent (reference "
           f"operations.cc:388-433): {exc}")
    get_logger().warning(msg)
    return BluefogError(msg)


class RankBackend(RankAxis):
    """The collectives ``build_train_step``, the eager API and the
    wrappers call, on this process's rows of rank-major tensors (leading
    axis ``n_local``) on ``device``.  One copy of the math for every
    backend: each method is the module function over this rank axis."""

    device: torch.device

    def rank_major(self, tree: dict) -> dict:
        """A copy of every leaf of ``{name: tensor}`` for each rank this
        process holds, stacked along a new leading axis on the device:
        every rank starts from the same point."""
        return {k: v.detach().to(self.device).unsqueeze(0)
                .repeat((self.n_local,) + (1,) * v.dim())
                for k, v in tree.items()}

    def neighbor_allreduce(self, x, spec, compress=None, class_weights=None,
                           self_weights=None, generator=None,
                           per_device=False):
        return neighbor_allreduce(x, spec, compress=compress,
                                  class_weights=class_weights,
                                  self_weights=self_weights,
                                  generator=generator, comm=self,
                                  per_device=per_device)

    def neighbor_allreduce_buckets(self, buffers, spec, compress=None,
                                   wire_step=None,
                                   hierarchical_local_size=None,
                                   class_weights=None, self_weights=None,
                                   per_device=False):
        return neighbor_allreduce_buckets(
            buffers, spec, compress=compress, wire_step=wire_step,
            hierarchical_local_size=hierarchical_local_size,
            class_weights=class_weights, self_weights=self_weights,
            comm=self, per_device=per_device)

    def hierarchical_neighbor_allreduce(self, x, machine_spec, local_size,
                                        compress=None, class_weights=None,
                                        self_weights=None, generator=None,
                                        per_device=False):
        return hierarchical_neighbor_allreduce(
            x, machine_spec, local_size, compress=compress,
            class_weights=class_weights, self_weights=self_weights,
            generator=generator, comm=self, per_device=per_device)

    def push_sum_mix(self, tree, ps_weight, spec):
        return push_sum_mix(tree, ps_weight, spec, comm=self)

    def mix_compress_exchange(self, x, spec, **kw):
        return mix_compress_exchange(x, spec, comm=self, **kw)

    def allreduce(self, x, average: bool = True, local_size=None):
        return allreduce(x, average=average, local_size=local_size,
                         comm=self)

    def broadcast(self, x, root_rank: int):
        return broadcast(x, root_rank, comm=self)

    def allgather(self, x):
        return allgather(x, comm=self)

    def allgatherv(self, x, sizes):
        return allgatherv(x, sizes, comm=self)

    def neighbor_allgather(self, x, spec):
        return neighbor_allgather(x, spec, comm=self)

    def neighbor_allgather_padded(self, x, spec):
        return neighbor_allgather_padded(x, spec, comm=self)

    def pair_gossip(self, x, target_ranks, self_weight=None,
                    pair_weight=None):
        return pair_gossip(x, target_ranks, self_weight, pair_weight,
                           comm=self)

    def barrier(self) -> None:
        """Wait for every rank's work so far (the device's queue here)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class StackedBackend(RankBackend):
    """``n_ranks`` ranks stacked on one device: the port's counterpart of
    the JAX package's one-axis ``Mesh`` on one process.  Every rank-major
    tensor it handles has a leading ``[n_ranks]`` axis on ``device``;
    forward and backward of a train step run rank after rank, so only
    one rank's activations are alive at a time.

    ``device`` defaults to ``"cuda"`` and raises without CUDA unless
    ``"cpu"`` is passed."""

    def __init__(self, n_ranks: int,
                 device: Union[str, torch.device] = "cuda"):
        if n_ranks < 1:
            raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
        super().__init__(int(n_ranks))
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return f"StackedBackend(n_ranks={self.size}, device={self.device})"


class ProcessBackend(RankBackend):
    """``ranks_per_process`` consecutive global ranks per process of the
    default ``torch.distributed`` group: process ``p`` holds ranks
    ``p·k .. p·k + k - 1`` stacked on ``device``, and every rank-major
    tensor it handles is ``[k, ...]``.

    The wire follows the group's backend: NCCL moves device tensors
    (its work is ordered on the current stream, the host never waits);
    gloo moves host tensors, and device tensors through pinned host
    buffers (gloo's send and receive take no CUDA pointers; the current
    stream is synchronized before a send).  Every payload goes as bytes,
    so any dtype crosses.  Each exchange runs inside a
    ``bf.backend.exchange`` profiler range, and its waits run under the
    stall watchdog and the op timeout (``context.timed_wait``)."""

    EXCHANGE = EXCHANGE

    def __init__(self, ranks_per_process: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "ProcessBackend needs an initialized torch.distributed "
                "default group (bluefog_tpu_torch.init() under bfrun "
                "creates one)")
        k = int(ranks_per_process)
        if k < 1:
            raise ValueError(f"ranks_per_process must be >= 1, got {k}")
        self.process_count = dist.get_world_size()
        self.process_index = dist.get_rank()
        super().__init__(self.process_count * k, k, self.process_index * k)
        self.device = resolve_device(device)
        self.wire = str(dist.get_backend()).lower()
        if self.wire == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL group moves device tensors: pass a "
                             "cuda device, or use a gloo group for cpu")
        self._staged = self.wire != "nccl" and self.device.type == "cuda"

    def __repr__(self) -> str:
        return (f"ProcessBackend(process {self.process_index} of "
                f"{self.process_count}, ranks {self.first_rank}.."
                f"{self.first_rank + self.n_local - 1}, device="
                f"{self.device}, wire={self.wire})")

    # -- the wire ---------------------------------------------------------
    def _bytes(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as flat bytes where the wire reads them: on the device
        for NCCL and host tensors, in a pinned host buffer otherwise."""
        b = t.contiguous().reshape(-1).view(torch.uint8)
        if not self._staged:
            return b
        host = torch.empty(b.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(b, non_blocking=True)
        return host

    def _empty(self, nbytes: int) -> torch.Tensor:
        if self._staged:
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return torch.empty(nbytes, dtype=torch.uint8, device=self.device)

    def _tensor(self, b: torch.Tensor, dtype, shape) -> torch.Tensor:
        t = b.view(dtype).reshape(shape)
        return t.to(self.device, non_blocking=True) if self._staged else t

    def _ready(self) -> None:
        """Staged sends read host buffers the current stream fills."""
        if self._staged:
            torch.cuda.current_stream(self.device).synchronize()

    def _wait(self, works) -> None:
        """NCCL's ``wait`` orders the calling thread's current stream
        after the work (the host goes on); gloo's blocks the host, under
        the stall watchdog and the op timeout.  A transport that fails
        (gloo sees a dead peer's socket close at once) raises through
        :func:`_attribute_failure`."""
        from bluefog_tpu_torch.context import BluefogError, timed_wait

        works = [w for w in works if w is not None]
        try:
            if self.wire == "nccl":
                for w in works:
                    w.wait()
            elif works:
                timed_wait(self.EXCHANGE,
                           lambda: [w.wait() for w in works])
        except BluefogError:
            raise
        except RuntimeError as exc:
            raise _attribute_failure(self.EXCHANGE, exc) from exc

    # -- the primitives ---------------------------------------------------
    def permute(self, x: torch.Tensor, perm,
                devices: int = 1) -> torch.Tensor:
        import torch.distributed as dist

        _tally_exchange("collective-permute", _row_bytes(x, devices))
        k, first = self.n_local, self.first_rank
        pairs = sorted(perm)
        local = tuple((s - first, d - first) for s, d in pairs
                      if self.owns(s) and self.owns(d))
        sends: dict = {}
        recvs: dict = {}
        for s, d in pairs:
            if self.owns(s) and not self.owns(d):
                sends.setdefault(d // k, []).append(s - first)
            elif self.owns(d) and not self.owns(s):
                recvs.setdefault(s // k, []).append(d - first)
        out = _permute(x, local)
        if not sends and not recvs:
            return out
        row = tuple(x.shape[1:])
        nbytes = x[:1].numel() * x.element_size()
        with torch.profiler.record_function(self.EXCHANGE):
            ops, inbox = [], []
            for q, rows in sorted(sends.items()):
                buf = self._bytes(x.index_select(
                    0, _device_const(tuple(rows), x.device)))
                ops.append(dist.P2POp(dist.isend, buf, q))
            for q, rows in sorted(recvs.items()):
                buf = self._empty(len(rows) * nbytes)
                ops.append(dist.P2POp(dist.irecv, buf, q))
                inbox.append((rows, buf))
            self._ready()
            self._wait(dist.batch_isend_irecv(ops))
            for rows, buf in inbox:
                out.index_copy_(0, _device_const(tuple(rows), x.device),
                                self._tensor(buf, x.dtype,
                                             (len(rows),) + row))
        return out

    def gather_ranks(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        with torch.profiler.record_function(self.EXCHANGE):
            b = self._bytes(x)
            self._ready()
            if self.wire == "nccl":
                got = self._empty(self.process_count * b.numel())
                self._wait([dist.all_gather_into_tensor(got, b,
                                                        async_op=True)])
            else:
                parts = [self._empty(b.numel())
                         for _ in range(self.process_count)]
                self._wait([dist.all_gather(parts, b, async_op=True)])
                got = torch.cat(parts)
            return self._tensor(got, x.dtype,
                                (self.size,) + tuple(x.shape[1:]))

    def rank_row(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        import torch.distributed as dist

        with torch.profiler.record_function(self.EXCHANGE):
            if self.owns(rank):
                b = self._bytes(super().rank_row(x, rank))
            else:
                b = self._empty(x[:1].numel() * x.element_size())
            self._ready()
            self._wait([dist.broadcast(b, src=rank // self.n_local,
                                       async_op=True)])
            return self._tensor(b, x.dtype, (1,) + tuple(x.shape[1:]))

    def all_sizes(self, sizes: Sequence[int]) -> List[int]:
        import torch.distributed as dist

        mine = [int(v) for v in sizes]
        if self.process_count == 1:
            return mine
        got: list = [None] * self.process_count
        dist.all_gather_object(got, mine)
        return [v for part in got for v in part]

    def machine_mean(self, x, local_size, dtype, average=True, devices=1):
        _tally_machine(x, local_size, self.size, devices)
        if self.n_local % int(local_size) == 0:
            # every machine lies inside one process
            return _machine_mean(x, local_size, dtype, average)
        return self.own(_machine_mean(self.gather_ranks(x), local_size,
                                      dtype, average))

    def barrier(self) -> None:
        import torch.distributed as dist

        super().barrier()
        self._wait([dist.barrier(async_op=True)])

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


def wire_generator(device, step: int, bucket: int = 0) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for the stochastic-rounding
    wire of bucket ``bucket`` at train step ``step``: one seed per (step,
    bucket), mixed from ``(0x51EED, step, bucket)`` as the JAX package
    folds ``PRNGKey(0x51EED)`` with the step and then the bucket.  The
    draws are deterministic per (step, bucket); they are not the JAX
    package's bits (another generator)."""
    seed = int(np.random.SeedSequence(
        [_WIRE_SEED, int(step), int(bucket)]).generate_state(
            1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(seed)


def _wire_quantize_int8(x: torch.Tensor,
                        generator: Optional[torch.Generator] = None):
    """Per-tensor (per rank) absmax int8 quantization of the payload.
    Without ``generator`` it rounds to nearest (half to even, as
    ``jnp.round``): deterministic but biased, so in iterated averaging the
    snaps can build a consensus floor.  With ``generator`` it rounds
    stochastically, ``floor(y + u)`` with u ~ U[0, 1) drawn for the whole
    ``[n, ...]`` payload at once (each rank's row its own stream), so
    E[q] = y.  Returns (q int8 [n, ...], scale f32 [n])."""
    x32 = x.float()
    n = x.shape[0]
    scale = x32.abs().reshape(n, -1).amax(dim=1) / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    y = x32 / safe.reshape(_rank_shape(x))
    if generator is None:
        q = torch.round(y)
    else:
        q = torch.floor(y + torch.rand(y.shape, generator=generator,
                                       device=y.device, dtype=y.dtype))
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
    generator: Optional[torch.Generator] = None,
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
    :func:`wire_generator`)."""
    if compress not in (None, "int8", "bf16"):
        raise ValueError(f"unknown compress mode {compress!r}")
    if generator is not None and compress != "int8":
        raise ValueError("generator= requires compress='int8'")
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
        q, scale = _wire_quantize_int8(x, generator)
    merged = _fused_pairs(classes)
    if merged is not None:
        w_fused = _as_weights(_fused_recv_weights(
            classes, class_weights, spec.size, acc, dev), acc, dev)
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
    int8 absmax scale, which is per bucket."""
    outs = []
    for i, buf in enumerate(buffers):
        gen = (wire_generator(buf.device, wire_step, i)
               if wire_step is not None else None)
        if hierarchical_local_size is not None:
            outs.append(hierarchical_neighbor_allreduce(
                buf, spec, hierarchical_local_size, compress=compress,
                class_weights=class_weights, self_weights=self_weights,
                generator=gen))
        else:
            outs.append(neighbor_allreduce(
                buf, spec, compress=compress, class_weights=class_weights,
                self_weights=self_weights, generator=gen))
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


def push_sum_mix(tree, ps_weight: torch.Tensor, spec: CommSpec):
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
    deg, perms = push_sum_structure(spec)
    a = _device_const(tuple(float(v) for v in 1.0 / (deg + 1.0)),
                      ps_weight.device, torch.float32)

    def mix_leaf(x):
        scaled = x.to(_accum_dtype(x.dtype)) * a.reshape(_rank_shape(x))
        acc = scaled
        for perm in perms:
            acc = acc + _permute(scaled, perm)
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
    generator: Optional[torch.Generator] = None,
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
    ``local_size == 1`` it is :func:`neighbor_allreduce`, bit for bit."""
    if compress not in (None, "int8", "bf16"):
        raise ValueError(f"unknown compress mode {compress!r}")
    if generator is not None and compress != "int8":
        raise ValueError("generator= requires compress='int8'")
    L = int(local_size)
    n = machine_spec.size * L
    validate_machine_decomposition(n, L, (machine_spec,))
    if x.shape[0] != n:
        raise ValueError(f"rank-major tensor has {x.shape[0]} ranks, the "
                         f"machine schedule covers {n}")
    acc = _accum_dtype(x.dtype)
    dev = x.device
    bshape = _rank_shape(x)
    unit = [r // L for r in range(n)]
    local_mean = _machine_mean(x, L, acc)
    self_w = _unit_weights(self_weights_of(machine_spec)
                           if self_weights is None else self_weights,
                           unit, acc, dev).reshape(bshape)
    # the machine mean goes on the wire in the payload dtype (exact at
    # local_size 1), or compressed; the self term keeps full precision
    wire_x = local_mean.to(x.dtype)
    if compress == "int8":
        q, scale = _wire_quantize_int8(wire_x, generator)

    def wire(perm):
        if compress == "int8":
            return (_permute(q, perm).float()
                    * _permute(scale, perm).reshape(bshape))
        if compress == "bf16" and x.dtype != torch.bfloat16:
            return _permute(wire_x.to(torch.bfloat16), perm)
        return _permute(wire_x, perm)

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
        scale = wire[:, k + mask_bytes:k + mask_bytes + 4].contiguous(
        ).view(torch.float32)
        vals = q.float() * scale.reshape(n, 1)
    else:
        vals = wire[:, :4 * k].contiguous().view(torch.float32)
        packed = wire[:, 4 * k:4 * k + mask_bytes]
    return topk_mask_decode(_unpack_bits(packed, numel), vals)


def _mix_encode_wire(target: torch.Tensor, k: int, k_live: torch.Tensor,
                     values: str, generator: Optional[torch.Generator]):
    """(wire uint8 [n, mix_wire_bytes], own delta f32 [n, numel]): top-k
    select each row's delta, quantize the kept values, pack everything
    into ONE byte row per rank, and decode it back, so the sender's own
    delta is bit for bit what every receiver decodes."""
    from bluefog_tpu_torch.compressor import topk_mask_encode

    n, numel = target.shape
    mask, vals = topk_mask_encode(target, k, k_live)
    packed = _pack_bits(mask)
    if values in ("int8", "int8_sr"):
        q, scale = _wire_quantize_int8(vals, generator)
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
    generator: Optional[torch.Generator] = None,
    hierarchical_local_size: Optional[int] = None,
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
    xf = x.reshape(n, -1)
    nb = xf.shape[1]
    f32 = torch.float32
    if hierarchical_local_size is not None:
        L = int(hierarchical_local_size)
        validate_machine_decomposition(spec.size * L, L, (spec,))
        base = _machine_mean(xf, L, f32)
    else:
        L = 1
        base = xf.float()
    if spec.size * L != n:
        raise ValueError(f"rank-major tensor has {n} ranks, the spec "
                         f"covers {spec.size * L}")
    unit = [r // L for r in range(n)]
    self_w = _unit_weights(self_weights_of(spec) if self_weights is None
                           else self_weights, unit, f32, dev).reshape(n, 1)
    classes = spec.shift_classes
    if not classes:
        return (base * self_w).to(dtype).reshape(shape), ref_row, mirrors, err

    # sender: encode the delta once per round (one wire to every
    # out-edge), fold the residual into e, advance ref, for ranks with
    # an out-edge this round only
    target = base - ref_row + err
    k_live = torch.clamp(torch.floor(ratio * nb).to(torch.int32), 1, k)
    wire, d_own = _mix_encode_wire(target, k, k_live, values, generator)
    has_out_unit = [False] * spec.size
    for cls in classes:
        for (s, _) in cls.perm:
            has_out_unit[s] = True
    has_out = _device_const(tuple(has_out_unit[u] for u in unit), dev,
                            torch.bool).reshape(n, 1)
    new_ref = torch.where(has_out, ref_row + d_own, ref_row)
    new_err = (torch.where(has_out, target - d_own, err) if error_feedback
               else err)

    def recv_w(w):
        return _unit_weights(w, unit, f32, dev).reshape(n, 1)

    # receiver: the class-fusion rule of the dense exchange; a fused or
    # single-class round permutes the one wire once into one mirror row,
    # a multi-class round permutes it per class into per-slot rows
    merged = _fused_pairs(classes)
    acc = base * self_w
    new_mirrors = mirrors.clone()
    if merged is not None or len(classes) == 1:
        if merged is not None:
            perm = _expand_pairs(merged, L)
            w = recv_w(_fused_recv_weights(classes, class_weights,
                                           spec.size, f32, dev))
        else:
            perm = _expand_pairs(classes[0].perm, L)
            w = recv_w(classes[0].recv_weights if class_weights is None
                       else class_weights[0])
        rd = _mix_decode_wire(_permute(wire, perm), nb, k, values)
        new_mirrors[:, 0] += rd
        acc = acc + new_mirrors[:, 0] * w
    else:
        for c, cls in enumerate(classes):
            rd = _mix_decode_wire(_permute(wire, _expand_pairs(cls.perm, L)),
                                  nb, k, values)
            new_mirrors[:, c] += rd
            w = recv_w(cls.recv_weights if class_weights is None
                       else class_weights[c])
            acc = acc + new_mirrors[:, c] * w
    return acc.to(dtype).reshape(shape), new_ref, new_mirrors, new_err


def allreduce(x: torch.Tensor, average: bool = True,
              local_size: Optional[int] = None) -> torch.Tensor:
    """Every rank receives the sum (or mean) over ranks, accumulated in
    f32 for low-precision payloads (reference mpi_controller.cc:169).
    With ``local_size``, over each machine of that many ranks only (the
    eager ``is_hierarchical_local`` allreduce)."""
    acc = _accum_dtype(x.dtype)
    if local_size is not None:
        validate_machine_decomposition(x.shape[0], local_size)
        return _machine_mean(x, int(local_size), acc, average).to(x.dtype)
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


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Every rank receives all ranks' tensors concatenated along dim 0:
    ``[n, d0, ...] -> [n, n * d0, ...]`` (reference mpi_controller.cc:136;
    equal per-rank shapes, as the JAX package's ``all_gather``)."""
    n = x.shape[0]
    flat = x.reshape((1, n * x.shape[1]) + tuple(x.shape[2:]))
    return flat.expand((n,) + tuple(flat.shape[1:])).clone()


def allgatherv(x: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """Variable-size allgather (reference allgatherv,
    mpi_controller.cc:136-168): rank r's payload arrives padded to
    ``max(sizes)`` rows (``x`` is ``[n, pad, ...]``) and ``sizes`` are the
    true per-rank row counts.  Every rank receives the exact ragged
    concatenation ``[sum(sizes), ...]``: one row gather drops the pad
    rows (the displacements, computed on the host once per ``sizes``)."""
    sizes = [int(s) for s in sizes]
    n, pad = x.shape[0], x.shape[1]
    if any(s > pad for s in sizes):
        raise ValueError(f"sizes {sizes} exceed the padded row count {pad}")
    rows = tuple(int(i) for r, s in enumerate(sizes)
                 for i in range(r * pad, r * pad + s))
    flat = x.reshape((n * pad,) + tuple(x.shape[2:]))
    out = flat.index_select(0, _device_const(rows, x.device, torch.long))
    return out.unsqueeze(0).expand((n,) + tuple(out.shape)).clone()


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


def neighbor_allgather(x: torch.Tensor, spec: CommSpec) -> torch.Tensor:
    """In-neighbor values in a dense per-source buffer: ``[n, n, ...]``,
    ``out[dst, src]`` holding rank src's value where (src -> dst) is an
    edge and zeros elsewhere (the JAX package's dense layout,
    collectives.py:387).  :func:`neighbor_allgather_padded` is the
    in-degree-bounded form the eager layer uses."""
    n = spec.size
    out = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    for cls in spec.shift_classes:
        pairs = [(s, d) for s, d in cls.perm if cls.recv_weights[d] != 0.0]
        if not pairs:
            continue
        src = _device_const(tuple(s for s, _ in pairs), x.device)
        dst = _device_const(tuple(d for _, d in pairs), x.device)
        out.index_put_((dst, src), x.index_select(0, src))
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


def neighbor_allgather_padded(x: torch.Tensor, spec: CommSpec
                              ) -> torch.Tensor:
    """In-degree-sized neighbor gather: ``[n, d_max, ...]``, slot ``k`` of
    rank ``dst`` holding the value of its k-th smallest in-neighbor
    (zeros beyond the rank's own in-degree; ``d_max`` the largest
    in-degree).  Memory is O(n * d_max * |x|), never the dense
    O(n^2 * |x|); for a graph of uniform in-degree the result reshaped to
    ``[n, d * d0, ...]`` is the reference's concat-by-source-rank layout
    (torch/mpi_ops.py:440-476).  One gather per shift class."""
    lists = in_neighbor_lists(spec)
    d_max = max((len(lst) for lst in lists), default=0)
    out = torch.zeros((x.shape[0], d_max) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    for triples in _slot_pairs(spec, lists):
        if not triples:
            continue
        src = _device_const(tuple(t[0] for t in triples), x.device)
        dst = _device_const(tuple(t[1] for t in triples), x.device)
        slot = _device_const(tuple(t[2] for t in triples), x.device)
        out.index_put_((dst, slot), x.index_select(0, src))
    return out


def pair_gossip(x: torch.Tensor, target_ranks: Sequence[int],
                self_weight: Optional[float] = None,
                pair_weight: Optional[float] = None) -> torch.Tensor:
    """Randomized two-node averaging: ``out = self_weight * x +
    pair_weight * x[target]``, in the accumulation dtype.
    ``target_ranks[i]`` is rank i's pair (an involution, as the
    reference's simultaneous Sendrecv needs, torch/mpi_ops.py:883-907); a
    rank paired with itself keeps its value."""
    self_weight = 0.5 if self_weight is None else self_weight
    pair_weight = 0.5 if pair_weight is None else pair_weight
    targets = [int(t) for t in target_ranks]
    n = len(targets)
    if x.shape[0] != n:
        raise ValueError(f"rank-major tensor has {x.shape[0]} ranks, "
                         f"target_ranks {n}")
    perm = tuple((i, t) for i, t in enumerate(targets) if t != i)
    if len({d for _, d in perm}) != len(perm):
        raise ValueError(f"target_ranks {targets} send two ranks' values "
                         "to one rank")
    acc = _accum_dtype(x.dtype)
    xa = x.to(acc)
    out = self_weight * xa + pair_weight * _permute(x, perm).to(acc)
    is_self = _device_const(tuple(t == i for i, t in enumerate(targets)),
                            x.device, torch.bool).reshape(_rank_shape(x))
    return torch.where(is_self, xa, out).to(x.dtype)


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
                           self_weights=None, generator=None):
        return neighbor_allreduce(x, spec, compress=compress,
                                  class_weights=class_weights,
                                  self_weights=self_weights,
                                  generator=generator)

    def neighbor_allreduce_buckets(self, buffers, spec, compress=None,
                                   wire_step=None,
                                   hierarchical_local_size=None,
                                   class_weights=None, self_weights=None):
        return neighbor_allreduce_buckets(
            buffers, spec, compress=compress, wire_step=wire_step,
            hierarchical_local_size=hierarchical_local_size,
            class_weights=class_weights, self_weights=self_weights)

    def hierarchical_neighbor_allreduce(self, x, machine_spec, local_size,
                                        compress=None, class_weights=None,
                                        self_weights=None, generator=None):
        return hierarchical_neighbor_allreduce(
            x, machine_spec, local_size, compress=compress,
            class_weights=class_weights, self_weights=self_weights,
            generator=generator)

    def push_sum_mix(self, tree, ps_weight, spec):
        return push_sum_mix(tree, ps_weight, spec)

    def mix_compress_exchange(self, x, spec, **kw):
        return mix_compress_exchange(x, spec, **kw)

    def allreduce(self, x, average: bool = True, local_size=None):
        return allreduce(x, average=average, local_size=local_size)

    def broadcast(self, x, root_rank: int):
        return broadcast(x, root_rank)

    def allgather(self, x):
        return allgather(x)

    def allgatherv(self, x, sizes):
        return allgatherv(x, sizes)

    def neighbor_allgather(self, x, spec):
        return neighbor_allgather(x, spec)

    def neighbor_allgather_padded(self, x, spec):
        return neighbor_allgather_padded(x, spec)

    def pair_gossip(self, x, target_ranks, self_weight=None,
                    pair_weight=None):
        return pair_gossip(x, target_ranks, self_weight, pair_weight)

"""Flat BlueFog-compatible op API of the port.

Port of ``bluefog_tpu/api.py`` (itself mirroring ``bluefog.torch``'s
public surface, reference bluefog/torch/__init__.py:34-110,
bluefog/torch/mpi_ops.py, bluefog/common/basics.py) on rank-major
tensors: every tensor argument and result has a leading axis of the
ranks this process holds on the context's device (``[size, ...]`` when
one process holds every rank), slice i being rank ``rank() + i``'s
tensor.  Nonblocking variants return an int handle;
``synchronize(handle)`` waits for the op's CUDA event and gives the
result.

    import bluefog_tpu_torch as bf
    bf.init(size=4)                      # 4 ranks stacked on the card
    x = bf.from_rank_values(lambda r: np.full(3, float(r), np.float32))
    x = bf.neighbor_allreduce(x)         # one gossip round

Under ``bfrun`` (``python -m bluefog_tpu_torch.run -np P ...``) ``init``
joins the ``torch.distributed`` job the launcher describes: one process
per card, NCCL between cards (gloo on the CPU), each process holding
``BLUEFOG_TPU_RANKS_PER_PROCESS`` ranks (default 1).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from bluefog_tpu_torch import config as bfconfig
from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch import timeline as timeline_mod
from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.context import (BluefogContext, BluefogError,
                                       WeightArg, get_context)
from bluefog_tpu_torch.parallel import collectives as C
from bluefog_tpu_torch.topology.graphs import ExponentialGraph
from bluefog_tpu_torch.topology.spec import DynamicTopology
from bluefog_tpu_torch.windows import (WindowManager, win_lock_ctx,
                                       win_mutex_ctx)

_win_manager: Optional[WindowManager] = None
# the torch.distributed job init() joined: its store (for the
# heartbeats) and whether init() created the group (shutdown destroys
# only a group it created)
_job: dict = {}


# ------------------------------------------------------------------ #
# lifecycle (reference basics.py:49-76)
# ------------------------------------------------------------------ #
def _store_for(coordinator: str, process_id: int, num_processes: int,
               timeout):
    """The c10d store of ``--coordinator``: ``file://path`` is a file
    store, ``host:port`` a TCP store that process 0 serves."""
    import torch.distributed as dist

    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], num_processes)
    host, _, port = coordinator.rpartition(":")
    if not port.isdigit():
        raise BluefogError(f"BLUEFOG_TPU_COORDINATOR {coordinator!r} is "
                           "neither host:port nor file://path")
    return dist.TCPStore(host or "127.0.0.1", int(port), num_processes,
                         process_id == 0, timeout=timeout)


def _default_store():
    """The default group's store, for the heartbeats of a group init()
    adopted (None where this torch does not expose it)."""
    try:
        from torch.distributed import distributed_c10d

        return distributed_c10d._get_default_store()
    except Exception:  # noqa: BLE001 - heartbeats are optional
        return None


def _group_exists() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _in_job() -> bool:
    """Whether this process belongs to a multi-process job: bfrun's
    variables are set, or a default group exists."""
    return bool(bfconfig.coordinator()) or _group_exists()


def _maybe_init_distributed(device: torch.device) -> None:
    """Join the ``torch.distributed`` job of this process, after the JAX
    package's ``_maybe_init_distributed`` (api.py:43-64): adopt a default
    group that already exists, else create one from the
    BLUEFOG_TPU_{COORDINATOR,NUM_PROCESSES,PROCESS_ID} variables bfrun
    sets: NCCL when the process's device is a card, gloo when it is the
    CPU."""
    import datetime

    import torch.distributed as dist

    if _group_exists():
        _job.update(created=False, store=_default_store())
        return
    if not dist.is_available():
        raise BluefogError("BLUEFOG_TPU_COORDINATOR is set, but this torch "
                           "has no torch.distributed")
    coord = bfconfig.coordinator()
    nproc = bfconfig.num_processes()
    pid = bfconfig.process_id()
    if pid is None:
        if nproc > 1:
            raise BluefogError(
                "BLUEFOG_TPU_COORDINATOR and BLUEFOG_TPU_NUM_PROCESSES are "
                "set but BLUEFOG_TPU_PROCESS_ID is missing; every process "
                "must export its id (bfrun sets all three).")
        pid = 0
    timeout = datetime.timedelta(seconds=bfconfig.process_group_timeout())
    store = _store_for(coord, pid, nproc, timeout)
    if device.type == "cuda":
        # NCCL binds a process's communicators to its current card
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, rank=pid, world_size=nproc,
                            timeout=timeout)
    _job.update(created=True, store=store)


def _job_device(device) -> torch.device:
    """The device of this process in a job: ``device`` as passed, else
    ``cuda:{local index}`` (the process's index on its host), or the
    CPU under BLUEFOG_OPS_ON_CPU."""
    if device is not None:
        return resolve_device(device)
    if bfconfig.ops_on_cpu():
        return torch.device("cpu")
    resolve_device("cuda")   # raises without CUDA: no silent CPU path
    local = bfconfig.local_process_id()
    if local >= torch.cuda.device_count():
        raise BluefogError(
            f"process {local} of this host has no card of its own "
            f"({torch.cuda.device_count()} visible); pass device=")
    return torch.device("cuda", local)


def init(topology_fn=None, is_weighted: bool = False, *,
         size: Optional[int] = None,
         device: Union[str, torch.device, None] = None,
         local_size: Optional[int] = None) -> None:
    """Initialize the global context: ``size`` ranks (default 1, one rank
    per card, as the JAX package's default of one rank per device)
    stacked on ``device`` (default ``"cuda"``, which raises without CUDA;
    ``BLUEFOG_OPS_ON_CPU=1`` asks for ``"cpu"`` when ``device`` is not
    passed).  ``local_size`` groups the ranks into machines for the
    hierarchical ops (default: one machine).

    In a multi-process job (bfrun's BLUEFOG_TPU_* variables, or a default
    ``torch.distributed`` group the caller created) the context is a
    ``ProcessBackend``'s: this process holds ``size / processes`` ranks
    (default BLUEFOG_TPU_RANKS_PER_PROCESS, 1) on ``device`` (default
    ``cuda:<local index>``), a machine is a process unless
    ``local_size`` says otherwise, and the liveness heartbeats start when
    the stall watchdog is on.

    ``topology_fn``: callable returning the virtual topology; called with
    the world size if it accepts an argument (reference basics.py:49-69 —
    default ExponentialGraph).
    """
    global _win_manager
    if _in_job():
        import torch.distributed as dist

        job_device = _job_device(device)
        _maybe_init_distributed(job_device)
        k = bfconfig.ranks_per_process()
        if size is not None:
            if size % dist.get_world_size():
                raise BluefogError(
                    f"size {size} is not a multiple of the job's "
                    f"{dist.get_world_size()} processes")
            k = size // dist.get_world_size()
        ctx = BluefogContext(local_size=local_size,
                             backend=C.ProcessBackend(k, job_device))
    else:
        if device is None:
            device = "cpu" if bfconfig.ops_on_cpu() else "cuda"
        ctx = BluefogContext(1 if size is None else size, device=device,
                             local_size=local_size)
    ctx_mod.set_context(ctx)
    _win_manager = WindowManager(ctx)
    if topology_fn is not None:
        try:
            topo = topology_fn(ctx.size())
        except TypeError:
            topo = topology_fn()
    else:
        topo = ExponentialGraph(ctx.size())
    if not ctx.set_topology(topo, is_weighted):
        raise BluefogError("Failed to set initial topology.")
    backend = ctx.backend
    process = getattr(backend, "process_index", 0)
    tl_path = bfconfig.timeline_path()
    if tl_path:
        ctx.timeline = timeline_mod.start_timeline(tl_path, rank=process)
    count = getattr(backend, "process_count", 1)
    if count > 1 and bfconfig.stall_warning_time() > 0 \
            and _job.get("store") is not None:
        # liveness beacons for the watchdog's process attribution
        # (reference operations.cc:388-433 names the missing ranks);
        # pointless when the watchdog, their only consumer, is off
        interval = max(1.0, bfconfig.stall_warning_time() / 4)
        ctx_mod._heartbeat.start(interval, _job["store"], process, count)


def shutdown() -> None:
    """Leave the job: stop the heartbeats and the timeline, and destroy
    the ``torch.distributed`` group if ``init`` created it (an adopted
    group belongs to the caller)."""
    global _win_manager
    ctx_mod._heartbeat.stop()
    timeline_mod.stop_timeline()
    _win_manager = None
    ctx_mod.set_context(None)
    if _job.pop("created", False) and _group_exists():
        import torch.distributed as dist

        dist.destroy_process_group()
    _job.clear()


def is_initialized() -> bool:
    return ctx_mod.is_initialized()


def _wm() -> WindowManager:
    if _win_manager is None:
        raise BluefogError("BlueFog is not initialized; call init() first.")
    return _win_manager


# ------------------------------------------------------------------ #
# introspection (reference basics.py:78-265)
# ------------------------------------------------------------------ #
def size() -> int:
    return get_context().size()


def local_size() -> int:
    return get_context().local_size()


def rank() -> int:
    return get_context().rank()


def local_rank() -> int:
    return get_context().local_rank()


def machine_size() -> int:
    return get_context().machine_size()


def machine_rank() -> int:
    return get_context().machine_rank()


def is_homogeneous() -> bool:
    return get_context().is_homogeneous()


def load_topology():
    return get_context().load_topology()


def is_topo_weighted() -> bool:
    return get_context().is_topo_weighted()


def set_topology(topology=None, is_weighted: bool = False) -> bool:
    return get_context().set_topology(topology, is_weighted)


def load_machine_topology():
    return get_context().load_machine_topology()


def is_machine_topo_weighted() -> bool:
    return get_context().is_machine_topo_weighted()


def set_machine_topology(topology, is_weighted: bool = False) -> bool:
    return get_context().set_machine_topology(topology, is_weighted)


def in_neighbor_ranks(rank: Optional[int] = None) -> List[int]:
    return get_context().in_neighbor_ranks(rank)


def out_neighbor_ranks(rank: Optional[int] = None) -> List[int]:
    return get_context().out_neighbor_ranks(rank)


def in_neighbor_machine_ranks(machine_rank: Optional[int] = None) -> List[int]:
    return get_context().in_neighbor_machine_ranks(machine_rank)


def out_neighbor_machine_ranks(machine_rank: Optional[int] = None) -> List[int]:
    return get_context().out_neighbor_machine_ranks(machine_rank)


def suspend():
    get_context().suspend()


def resume():
    get_context().resume()


def set_skip_negotiate_stage(value: bool):
    get_context().set_skip_negotiate_stage(value)


def get_skip_negotiate_stage() -> bool:
    return get_context().get_skip_negotiate_stage()


def mpi_threads_supported() -> bool:
    """Parity shim — there is no MPI; dispatch is thread-safe."""
    return True


def unified_mpi_window_model_supported() -> bool:
    """Parity shim (reference basics.py unified window check)."""
    return True


def nccl_built() -> bool:
    """Whether this torch can move data between cards with NCCL (the
    process backend's wire for device tensors)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_nccl_available()


# ------------------------------------------------------------------ #
# rank-major tensor helpers
# ------------------------------------------------------------------ #
def rank_sharded(array) -> torch.Tensor:
    return get_context().rank_sharded(array)


def from_rank_values(values) -> torch.Tensor:
    return get_context().from_rank_values(values)


def to_rank_values(tensor) -> List[np.ndarray]:
    return get_context().to_rank_values(tensor)


# ------------------------------------------------------------------ #
# collectives (reference mpi_ops.py)
# ------------------------------------------------------------------ #
def allreduce(tensor, average: bool = True, name: Optional[str] = None,
              is_hierarchical_local: bool = False) -> torch.Tensor:
    return synchronize(
        allreduce_nonblocking(tensor, average, name, is_hierarchical_local)
    )


def allreduce_nonblocking(tensor, average: bool = True,
                          name: Optional[str] = None,
                          is_hierarchical_local: bool = False) -> int:
    ctx = get_context()
    if is_hierarchical_local:
        local = ctx.local_size()
        out = ctx.run_op(
            ("allreduce_local", average, local),
            lambda x: ctx.backend.allreduce(x, average, local_size=local),
            tensor)
    else:
        out = ctx.run_op(("allreduce", average),
                         lambda x: ctx.backend.allreduce(x, average), tensor)
    return ctx.register_handle(name, "allreduce", out)


def allreduce_(tensor, average: bool = True,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place spelling: writes the result into ``tensor`` (a rank-major
    tensor on the context's device) and returns it."""
    return tensor.copy_(allreduce(tensor, average, name))


def allreduce_nonblocking_(tensor, average: bool = True,
                           name: Optional[str] = None) -> int:
    return allreduce_nonblocking(tensor, average, name)


def broadcast(tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    return synchronize(broadcast_nonblocking(tensor, root_rank, name))


def broadcast_nonblocking(tensor, root_rank: int,
                          name: Optional[str] = None) -> int:
    ctx = get_context()
    out = ctx.run_op(("broadcast", root_rank),
                     lambda x: ctx.backend.broadcast(x, root_rank), tensor)
    return ctx.register_handle(name, "broadcast", out)


def broadcast_(tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place spelling: writes root's value into every rank's slice of
    ``tensor`` and returns it."""
    return tensor.copy_(broadcast(tensor, root_rank, name))


def broadcast_nonblocking_(tensor, root_rank: int,
                           name: Optional[str] = None) -> int:
    return broadcast_nonblocking(tensor, root_rank, name)


def allgather(tensor, name: Optional[str] = None) -> torch.Tensor:
    return synchronize(allgather_nonblocking(tensor, name))


def allgather_nonblocking(tensor, name: Optional[str] = None) -> int:
    """Concatenate all ranks' tensors along dim 0.

    Equal per-rank shapes take the direct path.  Variable dim-0 sizes
    (reference allgatherv, mpi_controller.cc:136-168) are accepted as a
    list/tuple of per-rank arrays (every rank's, or this process's
    ranks'): payloads are padded to the max row count, gathered, and the
    pad rows dropped on the device by one row gather
    (``collectives.allgatherv``).
    """
    ctx = get_context()
    if isinstance(tensor, (list, tuple)):
        parts = [torch.as_tensor(t) for t in tensor]
        if len(parts) == ctx.size() != ctx.n_local():
            parts = [parts[r] for r in ctx.backend.ranks]
        if len(parts) != ctx.n_local():
            raise BluefogError(
                f"variable-size allgather needs one tensor per rank "
                f"({ctx.size()}), got {len(parts)}")
        if any(p.dim() < 1 for p in parts):
            raise BluefogError(
                "variable-size allgather needs at least rank-1 tensors "
                "(the concat axis is dim 0)")
        trailing = {tuple(p.shape[1:]) for p in parts}
        if len(trailing) != 1:
            raise BluefogError(
                f"variable-size allgather: trailing dims must match, "
                f"got {sorted(trailing)}")
        dtypes = {p.dtype for p in parts}
        if len(dtypes) != 1:
            raise BluefogError(
                f"variable-size allgather: dtypes must match, "
                f"got {sorted(str(d) for d in dtypes)}")
        sizes = tuple(ctx.backend.all_sizes([p.shape[0] for p in parts]))
        pad = max(sizes) if sizes else 0
        padded = torch.zeros((len(parts), pad) + tuple(parts[0].shape[1:]),
                             dtype=parts[0].dtype, device=ctx.device)
        for r, p in enumerate(parts):
            padded[r, :p.shape[0]] = p.to(ctx.device)
        out = ctx.run_op(("allgatherv", sizes),
                         lambda x: ctx.backend.allgatherv(x, sizes), padded)
    else:
        out = ctx.run_op(("allgather",), ctx.backend.allgather, tensor)
    return ctx.register_handle(name, "allgather", out)


def neighbor_allreduce(tensor, *, self_weight=None, src_weights=None,
                       dst_weights=None, enable_topo_check: bool = True,
                       compress: Optional[str] = None,
                       name: Optional[str] = None) -> torch.Tensor:
    return synchronize(neighbor_allreduce_nonblocking(
        tensor, self_weight=self_weight, src_weights=src_weights,
        dst_weights=dst_weights, enable_topo_check=enable_topo_check,
        compress=compress, name=name))


def neighbor_allreduce_nonblocking(tensor, *, self_weight=None,
                                   src_weights=None, dst_weights=None,
                                   enable_topo_check: bool = True,
                                   compress: Optional[str] = None,
                                   name: Optional[str] = None) -> int:
    ctx = get_context()
    spec, _dynamic = ctx.resolve_neighbor_spec(
        self_weight, src_weights, dst_weights,
        enable_topo_check=enable_topo_check)
    # The cache key is the edge STRUCTURE only; the combine weights enter
    # as device tensors, so a schedule that varies weight values every
    # step reuses one entry and its device index tables.
    if isinstance(spec, DynamicTopology):
        key = ("neighbor_allreduce", spec.size, spec.edges, compress)
        structure = C.edge_structure(spec)
    else:
        key = ("neighbor_allreduce", spec.digest(), compress)
        structure = spec
    out = ctx.run_op(
        key,
        lambda x, wv, sw: ctx.backend.neighbor_allreduce(
            x, structure, compress=compress, class_weights=wv,
            self_weights=sw),
        tensor, *ctx.spec_weights(spec))
    return ctx.register_handle(name, "neighbor_allreduce", out)


def hierarchical_neighbor_allreduce(tensor, *, self_weight=None,
                                    src_machine_weights=None,
                                    dst_machine_weights=None,
                                    enable_topo_check: bool = False,
                                    name: Optional[str] = None
                                    ) -> torch.Tensor:
    return synchronize(hierarchical_neighbor_allreduce_nonblocking(
        tensor, self_weight=self_weight,
        src_machine_weights=src_machine_weights,
        dst_machine_weights=dst_machine_weights,
        enable_topo_check=enable_topo_check, name=name))


def hierarchical_neighbor_allreduce_nonblocking(
        tensor, *, self_weight=None, src_machine_weights=None,
        dst_machine_weights=None, enable_topo_check: bool = False,
        name: Optional[str] = None) -> int:
    ctx = get_context()
    if ctx.load_machine_topology() is None and (
            self_weight is None and src_machine_weights is None):
        raise BluefogError(
            "hierarchical_neighbor_allreduce needs set_machine_topology() "
            "or explicit machine weights."
        )
    spec, _dynamic = ctx.resolve_neighbor_spec(
        self_weight, src_machine_weights, dst_machine_weights,
        machine_level=True)
    local = ctx.local_size()
    if isinstance(spec, DynamicTopology):
        key = ("hierarchical_neighbor_allreduce", spec.size, spec.edges,
               local)
        structure = C.edge_structure(spec)
    else:
        key = ("hierarchical_neighbor_allreduce", spec.digest(), local)
        structure = spec
    out = ctx.run_op(
        key,
        lambda x, wv, sw: ctx.backend.hierarchical_neighbor_allreduce(
            x, structure, local, class_weights=wv, self_weights=sw),
        tensor, *ctx.spec_weights(spec))
    return ctx.register_handle(name, "hierarchical_neighbor_allreduce", out)


def neighbor_allgather(tensor, *, src_ranks=None, dst_ranks=None,
                       enable_topo_check: bool = True,
                       name: Optional[str] = None):
    """Concatenate in-neighbor tensors along dim 0 (reference
    torch/mpi_ops.py:400-476).  Returns a rank-major tensor
    ``[size, in_degree * d0, ...]`` when every rank has the same in-degree,
    otherwise a list of per-rank tensors (ragged; this process's ranks
    under bfrun)."""
    return synchronize(neighbor_allgather_nonblocking(
        tensor, src_ranks=src_ranks, dst_ranks=dst_ranks,
        enable_topo_check=enable_topo_check, name=name))


def neighbor_allgather_nonblocking(tensor, *, src_ranks=None, dst_ranks=None,
                                   enable_topo_check: bool = True,
                                   name: Optional[str] = None) -> int:
    ctx = get_context()
    n = ctx.size()
    if (src_ranks is None) != (dst_ranks is None):
        raise ValueError(
            "Arguments src_ranks and dst_ranks should be presented at the "
            "same time")
    if src_ranks is None:
        spec = ctx.topology_spec()
    else:
        src_per = WeightArg.per_rank(src_ranks, n, "src")
        dst_per = WeightArg.per_rank(dst_ranks, n, "dst")
        edge_weights = {}
        for dstr in range(n):
            entry = src_per[dstr] or []
            srcs = list(entry.keys()) if isinstance(entry, dict) else list(entry)
            for s in srcs:
                if int(s) == dstr:
                    raise BluefogError(
                        f"neighbor_allgather src_ranks for rank {dstr} "
                        "contains itself; self values are not gathered.")
                edge_weights[(int(s), dstr)] = 1.0
        # cross-check like enable_topo_check
        if enable_topo_check:
            for srcr in range(n):
                entry = dst_per[srcr] or []
                dsts = list(entry.keys()) if isinstance(entry, dict) else list(entry)
                for d in dsts:
                    if (srcr, int(d)) not in edge_weights:
                        raise BluefogError(
                            "Send and recv neighbors mismatch in "
                            "neighbor_allgather dynamic mode.")
        spec = DynamicTopology.from_edges(n, edge_weights)
    # slots are ordered by the spec-derived sorted in-neighbor lists, the
    # layout of the padded gather
    in_lists = C.in_neighbor_lists(spec)
    padded = ctx.run_op(("neighbor_allgather_padded", spec.digest()),
                        lambda x: ctx.backend.neighbor_allgather_padded(
                            x, spec),
                        tensor)
    if len({len(lst) for lst in in_lists}) == 1:
        # [n, d, d0, ...] -> [n, d*d0, ...]: already the reference's
        # concat-by-source layout
        out = padded.reshape((padded.shape[0],
                              padded.shape[1] * padded.shape[2])
                             + tuple(padded.shape[3:]))
        return ctx.register_handle(name, "neighbor_allgather", out)
    # ragged: each rank's first in-degree slots, on the device (this
    # process's ranks)
    per_rank = [padded[i, :len(in_lists[r])].reshape(
        (-1,) + tuple(padded.shape[3:]))
        for i, r in enumerate(ctx.backend.ranks)]
    return ctx.register_handle(name, "neighbor_allgather", per_rank)


def pair_gossip(tensor, target_rank, self_weight: Optional[float] = None,
                pair_weight: Optional[float] = None,
                name: Optional[str] = None) -> torch.Tensor:
    return synchronize(pair_gossip_nonblocking(
        tensor, target_rank, self_weight, pair_weight, name))


def pair_gossip_nonblocking(tensor, target_rank,
                            self_weight: Optional[float] = None,
                            pair_weight: Optional[float] = None,
                            name: Optional[str] = None) -> int:
    """``target_rank``: length-``size`` sequence, entry r = rank r's pair
    (reference per-rank scalar arg, torch/mpi_ops.py:883-945)."""
    ctx = get_context()
    targets = tuple(int(t) for t in target_rank)
    if len(targets) != ctx.size():
        raise ValueError(
            f"target_rank must list every rank's pair (length {ctx.size()})")
    out = ctx.run_op(
        ("pair_gossip", targets, self_weight, pair_weight),
        lambda x: ctx.backend.pair_gossip(x, targets, self_weight,
                                          pair_weight),
        tensor)
    return ctx.register_handle(name, "pair_gossip", out)


def barrier():
    get_context().barrier()


def synchronize(handle: int):
    return get_context().synchronize(handle)


def wait(handle: int):
    return synchronize(handle)


def poll(handle: int) -> bool:
    return get_context().poll(handle)


# ------------------------------------------------------------------ #
# windows (reference mpi_ops.py:1014-1503)
# ------------------------------------------------------------------ #
def win_create(tensor, name: str, zero_init: bool = False) -> bool:
    return _wm().create(tensor, name, zero_init)


def win_free(name: Optional[str] = None) -> bool:
    return _wm().free(name)


def win_update(name: str, self_weight: Optional[float] = None,
               neighbor_weights: Optional[Dict[int, float]] = None,
               reset: bool = False, clone: bool = False,
               require_mutex: bool = False) -> torch.Tensor:
    return _wm().update(name, self_weight, neighbor_weights, reset, clone,
                        require_mutex)


def win_update_then_collect(name: str,
                            require_mutex: bool = True) -> torch.Tensor:
    ctx = get_context()
    n = ctx.size()
    neighbor_weights = [
        {r: 1.0 for r in ctx.in_neighbor_ranks(dst)} for dst in range(n)
    ]
    return win_update(name, self_weight=1.0,
                      neighbor_weights=neighbor_weights, reset=True,
                      require_mutex=require_mutex)


def win_put_nonblocking(tensor, name: str, self_weight: Optional[float] = None,
                        dst_weights=None, require_mutex: bool = False) -> int:
    return _wm().put(tensor, name, self_weight, dst_weights, require_mutex,
                     accumulate=False)


def win_put(tensor, name: str, self_weight: Optional[float] = None,
            dst_weights=None, require_mutex: bool = False) -> bool:
    return win_wait(win_put_nonblocking(tensor, name, self_weight,
                                        dst_weights, require_mutex))


def win_accumulate_nonblocking(tensor, name: str,
                               self_weight: Optional[float] = None,
                               dst_weights=None,
                               require_mutex: bool = False) -> int:
    return _wm().put(tensor, name, self_weight, dst_weights, require_mutex,
                     accumulate=True)


def win_accumulate(tensor, name: str, self_weight: Optional[float] = None,
                   dst_weights=None, require_mutex: bool = False) -> bool:
    return win_wait(win_accumulate_nonblocking(tensor, name, self_weight,
                                               dst_weights, require_mutex))


def win_get_nonblocking(name: str, src_weights=None,
                        require_mutex: bool = False) -> int:
    return _wm().get(name, src_weights, require_mutex)


def win_get(name: str, src_weights=None, require_mutex: bool = False) -> bool:
    return win_wait(win_get_nonblocking(name, src_weights, require_mutex))


def win_set_value(name: str, tensor) -> None:
    """Replace the window's base tensor (the reference mutates the
    registered torch tensor in place, mpi_win_ops.cc:83-105; the port
    keeps its own window tensor and rebinds it explicitly)."""
    _wm().set_value(name, tensor)


def win_wait(handle: int) -> bool:
    return _wm().wait(handle)


def win_poll(handle: int) -> bool:
    return _wm().poll(handle)


@contextmanager
def win_mutex(name: str, for_self: bool = False,
              ranks: Optional[List[int]] = None):
    with win_mutex_ctx(_wm(), name, for_self, ranks):
        yield


@contextmanager
def win_lock(name: str):
    with win_lock_ctx(_wm(), name):
        yield


def win_unlock(name: str):
    _wm().window(name)  # validate; epochs are implicit in stream order


def win_fence(name: str):
    """Block until the window's value and mailbox are written (everything
    enqueued before the call has run on the device)."""
    win = _wm().window(name)
    if win.value.device.type == "cuda":
        ctx_mod.timed_wait(f"win_fence.{name}",
                           lambda: torch.cuda.synchronize(win.value.device))


def get_win_version(name: str, rank: Optional[int] = None) -> Dict[int, int]:
    return _wm().versions_of(name, rank)


def get_current_created_window_names() -> List[str]:
    return _wm().names()


def win_associated_p(name: str, rank: Optional[int] = None) -> float:
    return _wm().associated_p(name, rank)


def turn_on_win_ops_with_associated_p():
    get_context().win_ops_with_associated_p = True


def turn_off_win_ops_with_associated_p():
    get_context().win_ops_with_associated_p = False


# ------------------------------------------------------------------ #
# timeline (reference basics.py:456-546)
# ------------------------------------------------------------------ #
def timeline_start_activity(tensor_name: str, activity_name: str) -> bool:
    tl = timeline_mod.get_timeline()
    if tl is None:
        return False
    tl.start_activity(tensor_name, activity_name)
    return True


def timeline_end_activity(tensor_name: str) -> bool:
    tl = timeline_mod.get_timeline()
    if tl is None:
        return False
    tl.end_activity(tensor_name)
    return True


@contextmanager
def timeline_context(tensor_name: str, activity_name: str):
    timeline_start_activity(tensor_name, activity_name)
    try:
        yield
    finally:
        timeline_end_activity(tensor_name)

"""Global BlueFog context of the port: ranks, topology state, eager op layer.

Port of ``bluefog_tpu/context.py`` over the stacked backend
(:class:`~bluefog_tpu_torch.parallel.collectives.StackedBackend`).  The
JAX context holds a device mesh whose positions are the ranks, and user
code works on *rank-major global arrays* ``[size, ...]``, slice ``r``
being rank r's tensor (a single-controller program).  Here the same
rank-major tensors live on ONE device, ``size`` ranks stacked along the
leading axis: every op is a handful of gathers and reductions along
that axis on the card.

``*_nonblocking`` ops enqueue their work on the current CUDA stream and
return an int handle backed by a CUDA event recorded after it:
``synchronize`` waits on the event (under the stall watchdog and the op
timeout), ``poll`` is ``event.query()``.  No op reads a device value on
the host before ``synchronize``: gather indices are cached on the device
per edge structure, and dynamic weight values reach the card through
pinned, non-blocking copies.

Multi-process jobs (one process per card, the ``bfrun`` launcher) and
the liveness heartbeats of ``_Heartbeat`` wait for the process backend
(ROADMAP.md Queue 1, item 6).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from bluefog_tpu_torch import config as bfconfig
from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.logging_util import get_logger
from bluefog_tpu_torch.parallel import collectives as C
from bluefog_tpu_torch.topology.graphs import DiGraph, ExponentialGraph
from bluefog_tpu_torch.topology.spec import (DynamicTopology, Topology,
                                             uniform_topology_spec)

logger = get_logger()

PROCESS_BACKEND_ITEM = "ROADMAP.md Queue 1, item 6 (the process backend)"


class BluefogError(RuntimeError):
    pass


class _Heartbeat:
    """Liveness beacons of a multi-process job: the JAX package's
    heartbeats ride the ``jax.distributed`` key-value store, which has no
    counterpart in one process.  One process has nothing to attribute a
    stall to (``stale_processes`` is empty, as the JAX one is for a
    single process); starting the beacons waits for the process
    backend."""

    def start(self, interval: float):
        raise NotImplementedError(
            "liveness heartbeats of a multi-process job are not ported to "
            f"bluefog_tpu_torch yet; see {PROCESS_BACKEND_ITEM}")

    def stop(self):
        pass

    def observe(self) -> None:
        pass

    def stale_processes(self, threshold: float) -> List[int]:
        return []


_heartbeat = _Heartbeat()


class StallWatchdog:
    """Warns when a blocking wait runs longer than
    BLUEFOG_STALL_WARNING_TIME (reference stall watchdog: rank 0 prints
    tensors waiting >60 s, operations.cc:388-433).  One scanning thread
    for the whole process; waits register/unregister in a dict, so the
    per-op cost is a lock + dict write."""

    def __init__(self):
        self._lock = threading.Lock()
        self._waits: Dict[int, Tuple[str, float, int]] = {}
        self._next = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()

    def stop(self):
        """Stop the scanner thread (Event.set wakes it immediately) and join
        it, so a later watch() reliably restarts a fresh one."""
        self._stop.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)

    def _loop(self):
        import time

        while not self._stop.wait(
                min(5.0, max(0.05, bfconfig.stall_warning_time() / 4))):
            threshold = bfconfig.stall_warning_time()
            if threshold <= 0:
                continue
            now = time.monotonic()
            stalled = []
            with self._lock:
                has_waits = bool(self._waits)
                for token, (name, start, warned) in list(self._waits.items()):
                    elapsed = now - start
                    if elapsed > threshold * (warned + 1):
                        stalled.append((name, elapsed))
                        self._waits[token] = (name, start, warned + 1)
            if has_waits:
                _heartbeat.observe()
            # log OUTSIDE the lock: a slow log handler must not block the
            # register/unregister fast path of every wait
            if stalled:
                stale = _heartbeat.stale_processes(threshold * 0.7)
            for name, elapsed in stalled:
                if stale:
                    logger.warning(
                        "Stall detected: op '%s' has been waiting for "
                        "%.1f s on missing process(es) %s — their liveness "
                        "heartbeat is stale or absent (reference "
                        "operations.cc:388-433).", name, elapsed, stale)
                else:
                    logger.warning(
                        "Stall detected: op '%s' has been waiting for "
                        "%.1f s. One or more processes/devices may be "
                        "stuck or dead (reference operations.cc:388-433).",
                        name, elapsed)

    def watch(self, name: str):
        from contextlib import contextmanager

        @contextmanager
        def ctx():
            import time

            if bfconfig.stall_warning_time() <= 0:
                yield
                return
            with self._lock:
                token = self._next
                self._next += 1
                self._waits[token] = (name, time.monotonic(), 0)
            self._ensure_thread()
            try:
                yield
            finally:
                with self._lock:
                    self._waits.pop(token, None)

        return ctx()


_watchdog = StallWatchdog()


def timed_wait(name: str, wait_fn: Callable[[], Any]):
    """Run a blocking wait under the stall watchdog AND the hard op
    timeout (BLUEFOG_OP_TIMEOUT).

    With the timeout disabled (the default) this is ``wait_fn()`` under a
    watchdog registration — stalls only warn.  With a timeout set, the
    wait runs on a helper thread; if it has not completed within the
    budget, a :class:`BluefogError` is raised naming the op (and the
    stale processes, where heartbeats can attribute the hang).  The
    helper thread cannot be interrupted and is leaked as a daemon; the
    point of a hard timeout is to turn a silent hang into a crash an
    orchestrator can restart."""
    timeout = bfconfig.op_timeout()
    if timeout <= 0:
        with _watchdog.watch(name):
            return wait_fn()
    box: Dict[str, Any] = {}
    done = threading.Event()

    def run():
        try:
            box["value"] = wait_fn()
        except BaseException as exc:  # noqa: BLE001 - relayed to caller
            box["error"] = exc
        finally:
            done.set()

    thread = threading.Thread(target=run, daemon=True,
                              name=f"bf-wait-{name}")
    with _watchdog.watch(name):
        thread.start()
        finished = done.wait(timeout)
    if not finished:
        stale = _heartbeat.stale_processes(timeout * 0.7)
        if stale:
            raise BluefogError(
                f"Operation '{name}' exceeded BLUEFOG_OP_TIMEOUT="
                f"{timeout:g} s; liveness heartbeats report stale/absent "
                f"process(es) {stale} — they are presumed dead or wedged.")
        raise BluefogError(
            f"Operation '{name}' exceeded BLUEFOG_OP_TIMEOUT={timeout:g} s "
            "with no stale heartbeat detected — the device queue itself "
            "may be wedged (or this is a single-process job, where "
            "liveness cannot be attributed).")
    if "error" in box:
        raise box["error"]
    return box.get("value")


def host_fetch(tensor) -> np.ndarray:
    """A rank-major tensor on the host as numpy (bfloat16 widened to
    float32: numpy has no bfloat16).  Waits for the card."""
    if not isinstance(tensor, torch.Tensor):
        return np.asarray(tensor)
    t = tensor.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class WeightArg:
    """Normalized per-rank weight arguments for dynamic-topology calls.

    The reference takes per-rank ``self_weight: float``, ``src_weights:
    {src: w}``, ``dst_weights: {dst: w} | [dst]`` (reference
    torch/mpi_ops.py:545-660).  The world view accepts either one value
    used for all ranks, or a length-``size`` sequence of per-rank values.
    """

    @staticmethod
    def per_rank(value, size: int, kind: str) -> List:
        if value is None:
            return [None] * size
        if kind == "self":
            if isinstance(value, (int, float)):
                return [float(value)] * size
            value = list(value)
            if len(value) != size:
                raise ValueError(
                    f"per-rank self_weight needs length {size}, got {len(value)}"
                )
            return [float(v) for v in value]
        # src/dst weight maps: dict applies to every rank; a sequence gives
        # one entry per rank (each a dict, list, or None).
        if isinstance(value, dict):
            return [dict(value)] * size
        value = list(value)
        if len(value) != size:
            raise ValueError(
                f"per-rank {kind}_weights needs length {size}, got {len(value)}"
            )
        return [None if v is None else v for v in value]


class _Handle:
    """One in-flight op: its result and the CUDA event recorded after it
    (``None`` on the CPU, where the op has run when the call returns)."""

    __slots__ = ("key", "value", "event")

    def __init__(self, key: str, value, event):
        self.key, self.value, self.event = key, value, event

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return self.value


def record_event(device: torch.device):
    """A CUDA event recorded on the current stream of ``device`` (None on
    the CPU): what a nonblocking op's handle waits on."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class BluefogContext:
    """World state for one logical BlueFog job of ``size`` ranks stacked
    on one device (``device``, default ``"cuda"``; raises without CUDA
    unless ``"cpu"`` is passed).  ``local_size`` groups the ranks into
    machines of that many ranks (default: one machine), as the JAX
    package's test fixture fakes machines (reference
    test/torch_hierarchical_test.py:49-63)."""

    def __init__(self, size: int = 1,
                 device: Union[str, torch.device] = "cuda",
                 local_size: Optional[int] = None):
        self.backend = C.StackedBackend(int(size), device=device)
        self.device = self.backend.device
        self._size = self.backend.size
        if local_size is None:
            local_size = self._size
        if local_size < 1 or self._size % local_size != 0:
            raise BluefogError(
                f"local_size {local_size} must divide world size {self._size}"
            )
        self._local_size = int(local_size)

        self._graph: Optional[DiGraph] = None
        self._is_weighted = False
        self._topology: Optional[Topology] = None  # resolved combine weights
        self._machine_graph: Optional[DiGraph] = None
        self._machine_is_weighted = False
        self._machine_topology: Optional[Topology] = None

        self._op_cache: Dict[Tuple, Callable] = {}
        self._weight_cache: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}
        self._handle_lock = threading.Lock()
        self._handle_map: Dict[int, _Handle] = {}
        self._inflight_names: set = set()
        self._timeline_open: Dict = {}  # span key -> tracer it began on
        self._next_handle = 0

        self.windows: Dict[str, Any] = {}  # name -> Window (windows.py)
        self.win_ops_with_associated_p = False
        self._skip_negotiate = bfconfig.skip_negotiate_default()
        self._suspended = False
        self.timeline = None  # attached by api.init when enabled

    # ------------------------------------------------------------------ #
    # introspection (reference basics.py:78-265)
    # ------------------------------------------------------------------ #
    def size(self) -> int:
        return self._size

    def local_size(self) -> int:
        return self._local_size

    def rank(self) -> int:
        return 0  # one process drives every rank

    def local_rank(self) -> int:
        return 0

    def machine_size(self) -> int:
        return self._size // self._local_size

    def machine_rank(self) -> int:
        return 0

    def is_homogeneous(self) -> bool:
        return True  # every machine has local_size ranks

    # ------------------------------------------------------------------ #
    # topology management (reference basics.py:267-419)
    # ------------------------------------------------------------------ #
    def load_topology(self) -> DiGraph:
        return self._graph

    def is_topo_weighted(self) -> bool:
        return self._is_weighted

    def set_topology(self, topology: Optional[DiGraph] = None,
                     is_weighted: bool = False) -> bool:
        if topology is None:
            topology = ExponentialGraph(self._size)
        if not isinstance(topology, DiGraph):
            logger.error("topology must be a bluefog_tpu_torch DiGraph "
                         "object.")
            return False
        if topology.number_of_nodes() != self._size:
            logger.error(
                "topology must have %d nodes, got %d.",
                self._size,
                topology.number_of_nodes(),
            )
            return False
        if self.windows:
            logger.error(
                "Cannot change topology with already registered windows: %s. "
                "Unregister them first.",
                list(self.windows),
            )
            return False
        self._graph = topology
        self._is_weighted = is_weighted
        self._topology = (Topology.from_graph(topology) if is_weighted
                          else uniform_topology_spec(topology))
        return True

    def load_machine_topology(self) -> DiGraph:
        return self._machine_graph

    def is_machine_topo_weighted(self) -> bool:
        return self._machine_is_weighted

    def set_machine_topology(self, topology: Optional[DiGraph],
                             is_weighted: bool = False) -> bool:
        if topology is None:
            logger.error("machine topology cannot be None.")
            return False
        if not isinstance(topology, DiGraph):
            logger.error("machine topology must be a bluefog_tpu_torch "
                         "DiGraph object.")
            return False
        if topology.number_of_nodes() != self.machine_size():
            logger.error(
                "machine topology must have machine_size %d nodes, got %d.",
                self.machine_size(),
                topology.number_of_nodes(),
            )
            return False
        self._machine_graph = topology
        self._machine_is_weighted = is_weighted
        self._machine_topology = (Topology.from_graph(topology)
                                  if is_weighted
                                  else uniform_topology_spec(topology))
        return True

    def in_neighbor_ranks(self, rank: Optional[int] = None) -> List[int]:
        if self._graph is None:
            return []
        rank = self.rank() if rank is None else rank
        return sorted(s for s in self._graph.predecessors(rank) if s != rank)

    def out_neighbor_ranks(self, rank: Optional[int] = None) -> List[int]:
        if self._graph is None:
            return []
        rank = self.rank() if rank is None else rank
        return sorted(d for d in self._graph.successors(rank) if d != rank)

    def in_neighbor_machine_ranks(self, machine_rank: Optional[int] = None
                                  ) -> List[int]:
        if self._machine_graph is None:
            return []
        m = self.machine_rank() if machine_rank is None else machine_rank
        return sorted(s for s in self._machine_graph.predecessors(m) if s != m)

    def out_neighbor_machine_ranks(self, machine_rank: Optional[int] = None
                                   ) -> List[int]:
        if self._machine_graph is None:
            return []
        m = self.machine_rank() if machine_rank is None else machine_rank
        return sorted(d for d in self._machine_graph.successors(m) if d != m)

    def topology_spec(self) -> Topology:
        if self._topology is None:
            raise BluefogError("No topology set. Call bf.init() first.")
        return self._topology

    def machine_topology_spec(self) -> Topology:
        if self._machine_topology is None:
            raise BluefogError(
                "No machine topology set. Call bf.set_machine_topology() first."
            )
        return self._machine_topology

    # ------------------------------------------------------------------ #
    # rank-major tensor helpers
    # ------------------------------------------------------------------ #
    def rank_sharded(self, array) -> torch.Tensor:
        """A ``[size, ...]`` tensor on this context's device (a tensor
        already there is returned as it is; numpy and other devices are
        copied)."""
        t = torch.as_tensor(array, device=self.device)
        if t.dim() == 0 or t.shape[0] != self._size:
            raise BluefogError(
                f"rank-major arrays need leading dim {self._size}, "
                f"got {tuple(t.shape)}")
        return t

    def from_rank_values(self, values) -> torch.Tensor:
        """Build a rank-major tensor from a callable ``rank -> array`` or
        a sequence of per-rank arrays."""
        if callable(values):
            values = [values(r) for r in range(self._size)]
        if all(isinstance(v, torch.Tensor) for v in values):
            return self.rank_sharded(torch.stack(
                [v.to(self.device) for v in values]))
        return self.rank_sharded(np.stack([np.asarray(v) for v in values]))

    def to_rank_values(self, tensor) -> List[np.ndarray]:
        return list(host_fetch(tensor))

    def device_weights(self, *arrays) -> Tuple[torch.Tensor, ...]:
        """Host weight tensors on this device without a host sync: a
        pinned staging copy, then a non-blocking copy on the current
        stream (a pageable copy would wait for the card)."""
        if self.device.type != "cuda":
            return arrays
        return tuple(a.pin_memory().to(self.device, non_blocking=True)
                     for a in arrays)

    def spec_weights(self, spec: Union[Topology, DynamicTopology]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(class_weights [n_classes, n], self_weights [n])`` float64 of
        ``spec`` on this device.  A static spec's pair is cached by its
        digest; a dynamic spec's (new values every round) is copied."""
        if isinstance(spec, Topology):
            key = spec.digest()
            cached = self._weight_cache.get(key)
            if cached is None:
                cached = self._weight_cache[key] = tuple(
                    t.to(self.device) for t in (C.class_recv_weights(spec),
                                                C.self_weight_vector(spec)))
            return cached
        return self.device_weights(C.class_recv_weights(spec),
                                   C.self_weight_vector(spec))

    # ------------------------------------------------------------------ #
    # eager op execution
    # ------------------------------------------------------------------ #
    def _op_tracer(self):
        """Where op spans go (``observe.tracer.effective_tracer``)."""
        from bluefog_tpu_torch.observe.tracer import effective_tracer

        return effective_tracer(self.timeline)

    def run_op(self, key: Tuple, kernel: Callable, x, *aux) -> torch.Tensor:
        """Dispatch one eager collective.  ``kernel(x, *aux)`` runs on the
        rank-major ``x``; the first kernel of each ``key`` is kept and
        reused (``key`` names the op and its edge STRUCTURE; weights come
        in ``aux`` as tensors, so new weight values reuse the entry).
        Records the reference's ENQUEUE_<OP> span around the dispatch
        (reference torch/mpi_ops.cc:178-488) into the observe tracer and
        counts the dispatch in ``bf_ops_total{op=}``."""
        from bluefog_tpu_torch.observe import registry as obs_registry

        x = self.rank_sharded(x)
        op = str(key[0])
        if obs_registry.enabled():
            obs_registry.get_registry().counter(
                "bf_ops_total", "eager collective dispatches",
                op=op).inc()
        fn = self._op_cache.get(key)
        if fn is None:
            fn = self._op_cache[key] = kernel
        tr = self._op_tracer()
        if tr is None:
            return fn(x, *aux)
        tr.begin(op, f"ENQUEUE_{op.upper()}")
        try:
            return fn(x, *aux)
        finally:
            tr.end(op)

    # ------------------------------------------------------------------ #
    # handles (reference torch/handle_manager.{h,cc} + mpi_ops.py:947-1005)
    # ------------------------------------------------------------------ #
    def register_handle(self, name: Optional[str], op: str, value) -> int:
        event = record_event(self.device)
        with self._handle_lock:
            handle = self._next_handle
            self._next_handle += 1
            key = name if name is not None else f"{op}.noname.{handle}"
            if key in self._inflight_names:
                raise BluefogError(
                    f"Duplicate op name '{key}' is already in flight. "
                    "Use distinct names (reference common.h:181-185)."
                )
            self._inflight_names.add(key)
            self._handle_map[handle] = _Handle(key, value, event)
        # Per-tensor COMMUNICATE span with the data-plane op nested inside
        # (reference mpi_controller.cc:333,445); it runs from dispatch
        # until completion is observed at synchronize.
        tr = self._op_tracer()
        if tr is not None:
            tr.begin(key, "COMMUNICATE")
            tr.begin(key, f"CUDA_{op.upper()}")
            self._timeline_open[key] = tr
        return handle

    def synchronize(self, handle: int):
        with self._handle_lock:
            if handle not in self._handle_map:
                raise BluefogError(f"Unknown handle {handle}")
            entry = self._handle_map.pop(handle)
            self._inflight_names.discard(entry.key)
        try:
            return timed_wait(entry.key, entry.wait)
        finally:
            # close spans even when the wait fails: the trace must stay
            # B/E-balanced precisely in the failure case
            tr = self._timeline_open.pop(entry.key, None)
            if tr is not None:
                tr.end(entry.key)  # CUDA_<OP>
                tr.end(entry.key)  # COMMUNICATE

    def poll(self, handle: int) -> bool:
        """Whether the op behind ``handle`` has completed; never blocks."""
        with self._handle_lock:
            if handle not in self._handle_map:
                raise BluefogError(f"Unknown handle {handle}")
            entry = self._handle_map[handle]
        return entry.ready()

    def barrier(self):
        """Block the host until all work dispatched to the device
        completes (reference mpi_controller.cc:1185 /
        mpi_ops.py:1002-1005)."""
        if self.device.type == "cuda":
            timed_wait("barrier",
                       lambda: torch.cuda.synchronize(self.device))

    # ------------------------------------------------------------------ #
    # weight resolution for neighbor ops
    # ------------------------------------------------------------------ #
    def resolve_neighbor_spec(
        self,
        self_weight,
        src_weights,
        dst_weights,
        machine_level: bool = False,
        enable_topo_check: bool = False,
    ) -> Tuple[Union[Topology, DynamicTopology], bool]:
        """Mirror of the reference's weight-resolution ladder
        (torch/mpi_ops.py:484-535).  Returns (spec, dynamic_enabled).

        With ``enable_topo_check`` in dynamic mode, edges declared on only
        one side (a src_weights entry without the matching sender-side
        dst_weights entry, or vice versa) raise — the reference's collective
        send/recv pattern validation (mpi_controller.cc:364-417)."""
        n = self.machine_size() if machine_level else self._size
        graph = self._machine_graph if machine_level else self._graph
        static_spec = (
            self._machine_topology if machine_level else self._topology
        )

        if self_weight is None and src_weights is None and dst_weights is None:
            if static_spec is None:
                raise BluefogError("No topology set; call set_topology first.")
            return static_spec, False
        if (self_weight is None) != (src_weights is None):
            raise ValueError(
                "Arguments self_weight and src_weights have to be presented "
                "at the same time"
            )
        if self_weight is None and dst_weights is not None:
            raise ValueError(
                "Arguments self_weight and src_weights should be presented "
                "if enabling dynamic topology."
            )

        self_w = WeightArg.per_rank(self_weight, n, "self")
        src_w = WeightArg.per_rank(src_weights, n, "src")
        dst_w = WeightArg.per_rank(dst_weights, n, "dst")

        # Normalize dst entries to {dst: weight} (list => 1.0 weights,
        # reference torch/mpi_ops.py:497-500).
        dst_maps: List[Dict[int, float]] = []
        for r, entry in enumerate(dst_w):
            if entry is None:
                dst_maps.append({})
            elif isinstance(entry, dict):
                dst_maps.append({int(k): float(v) for k, v in entry.items()})
            else:
                lst = [int(v) for v in entry]
                if len(set(lst)) != len(lst):
                    raise ValueError(
                        "Argument dst_weights should only contain the unique ranks."
                    )
                dst_maps.append({v: 1.0 for v in lst})

        dynamic = dst_weights is not None
        weight_matrix = None
        if graph is not None and any(sw is None for sw in src_w):
            weight_matrix = graph.to_numpy()
        edge_weights: Dict[Tuple[int, int], float] = {}
        claimed_recv_edges = set()
        for dst in range(n):
            sw = src_w[dst]
            if sw is None:
                if weight_matrix is None:
                    raise BluefogError("No topology set; call set_topology first.")
                sw = {
                    int(s): float(weight_matrix[s, dst])
                    for s in np.nonzero(weight_matrix[:, dst])[0]
                    if s != dst
                }
            if not isinstance(sw, dict):
                raise ValueError(
                    "Argument src_weights has to be a dictionary map from the "
                    "(in-)neighbor rank to the weights."
                )
            for src, w in sw.items():
                src = int(src)
                scale = 1.0
                if dynamic:
                    if src >= len(dst_maps):
                        raise ValueError(f"src rank {src} out of range")
                    claimed_recv_edges.add((src, dst))
                    if dst not in dst_maps[src]:
                        if enable_topo_check:
                            raise BluefogError(
                                f"Send and recv neighbors mismatch: rank {dst} "
                                f"expects from {src}, but {src} does not list "
                                f"{dst} in dst_weights "
                                "(reference mpi_controller.cc:364-417)."
                            )
                        continue  # src does not send to dst this round
                    scale = dst_maps[src][dst]
                edge_weights[(src, dst)] = float(w) * scale
        if dynamic and enable_topo_check:
            for src, dmap in enumerate(dst_maps):
                for dst in dmap:
                    if (src, int(dst)) not in claimed_recv_edges:
                        raise BluefogError(
                            f"Send and recv neighbors mismatch: rank {src} "
                            f"sends to {dst}, but {dst} does not list {src} "
                            "in src_weights "
                            "(reference mpi_controller.cc:364-417)."
                        )
        selfs = [
            (sw if sw is not None else 0.0) for sw in self_w
        ]
        spec = DynamicTopology.from_edges(n, edge_weights, selfs)
        return spec, dynamic

    # ------------------------------------------------------------------ #
    # misc parity shims
    # ------------------------------------------------------------------ #
    def suspend(self):
        self._suspended = True

    def resume(self):
        self._suspended = False

    def set_skip_negotiate_stage(self, value: bool):
        # There is no negotiation stage on the stacked backend; kept for
        # API parity (reference operations.cc:1149-1183).
        self._skip_negotiate = bool(value)

    def get_skip_negotiate_stage(self) -> bool:
        return self._skip_negotiate


_global_context: Optional[BluefogContext] = None


def get_context() -> BluefogContext:
    if _global_context is None:
        raise BluefogError(
            "BlueFog has not been initialized; call "
            "bluefog_tpu_torch.init() first."
        )
    return _global_context


def set_context(ctx: Optional[BluefogContext]):
    global _global_context
    _global_context = ctx


def is_initialized() -> bool:
    return _global_context is not None

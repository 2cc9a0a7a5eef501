"""One-sided ("window") gossip ops — the port's mailbox subsystem.

Port of ``bluefog_tpu/windows.py`` over the stacked backend.  The
reference implements windows with MPI RMA (reference
bluefog/common/mpi_controller.cc:795-1392) or an NCCL emulation; its
*Python-visible* state is per-in-neighbor receive buffers
(``WinTorchStorageManager``, reference torch/mpi_win_ops.cc:83-105), and
that is what this module keeps, as rank-major tensors on the device:

* ``value``     [n, *shape]      rank-major window tensors
* ``mailbox``   [n, d, *shape]   slot [dst, k] = what dst's k-th (sorted)
  in-neighbor last sent (d = max in-degree: in-degree-bounded, never a
  dense [n, n, ...] buffer)
* ``versions``  [n, d] int32     bumped on put/get/accumulate, cleared on update
* ``p``         [n] float64      associated push-sum scalar (init 1.0)
* ``p_mailbox`` [n, d] float64   mailbox for p

A put over one shift class of the destination set is one gather along
the rank axis (the senders' rows) written into the receivers' slots for
those senders; ``win_update`` is a local weighted combine.  Payloads are
scaled and combined in float32, as the JAX kernels do.  The index tables
(who sends, who receives, into which slot) are built on the host once per
(window, edge structure) and cached on the device; the per-edge and self
weights are runtime tensors, so a schedule that varies weights every
step reuses the tables and makes no host sync.

Every op is enqueued on the current stream, in program order, so the
reference's distributed mutex (mpi_controller.cc:1594-1663) is not
needed; ``win_mutex``/``win_lock`` are kept as no-ops for API parity.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bluefog_tpu_torch.context import (BluefogContext, BluefogError,
                                       WeightArg, host_fetch, record_event,
                                       timed_wait)
from bluefog_tpu_torch.parallel import collectives as C
from bluefog_tpu_torch.topology.spec import DynamicTopology

P_DTYPE = torch.float64  # associated p: [n] scalars, float64 on every device


class Window:
    """Device-resident state for one named window.

    Mailboxes are IN-DEGREE-BOUNDED: per rank the receive buffer has
    ``max_in_degree`` slots ordered by sorted in-neighbor rank (exactly
    the reference's WinTorchStorageManager, which allocates one local
    tensor per in-neighbor, mpi_win_ops.cc:83-105)."""

    def __init__(self, ctx: BluefogContext, name: str, value: torch.Tensor,
                 zero_init: bool):
        n = ctx.size()
        dev = value.device
        self.name = name
        self.ctx = ctx
        self.shape = tuple(value.shape[1:])
        self.dtype = value.dtype
        self.value = value
        # The topology is pinned while windows are alive (reference
        # basics.py refuses set_topology with registered windows).
        self.in_neighbors = {r: ctx.in_neighbor_ranks(r) for r in range(n)}
        self.out_neighbors = {r: ctx.out_neighbor_ranks(r) for r in range(n)}
        self.in_lists = [sorted(self.in_neighbors[r]) for r in range(n)]
        self.d_max = max((len(lst) for lst in self.in_lists), default=0) or 1
        # Mailbox init: each slot holds its in-neighbor's value (a fresh
        # put's no-op state), or zeros (reference
        # torch/mpi_win_ops.cc:88-100 RegisterWinName).
        self.mailbox = torch.zeros((n, self.d_max) + self.shape,
                                   dtype=value.dtype, device=dev)
        if not zero_init:
            filled = ctx.backend.neighbor_allgather_padded(
                value, ctx.topology_spec())
            self.mailbox[:, :filled.shape[1]] = filled
        self.versions = torch.zeros((n, self.d_max), dtype=torch.int32,
                                    device=dev)
        self.p = torch.ones((n,), dtype=P_DTYPE, device=dev)
        self.p_mailbox = torch.zeros((n, self.d_max), dtype=P_DTYPE,
                                     device=dev)

    def nbytes(self) -> int:
        """Bytes of the window's device state (value, mailbox, versions,
        p and p's mailbox)."""
        return sum(t.numel() * t.element_size() for t in
                   (self.value, self.mailbox, self.versions, self.p,
                    self.p_mailbox))


class _Edges:
    """The device index tables of one (window, edge structure): per shift
    class (in the order of the ``[n_classes, n]`` weight rows), the
    sources, destinations and destination slots of its edges."""

    __slots__ = ("classes",)

    def __init__(self, structure: DynamicTopology, in_lists, device):
        n = structure.size
        self.classes = []
        for cls in structure.shift_classes:
            dst = [d for d in range(n) if cls.recv_weights[d] != 0.0]
            src = [(d - cls.shift) % n for d in dst]
            slot = [in_lists[d].index(s) for s, d in zip(src, dst)]
            self.classes.append(tuple(
                torch.tensor(v, dtype=torch.long, device=device)
                for v in (src, dst, slot)))


def _rows(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-row vector shaped to broadcast against ``ndim``-dim rows."""
    return w.reshape((-1,) + (1,) * (ndim - 1))


class WindowManager:
    """All windows of a context, and the index tables of their ops."""

    def __init__(self, ctx: BluefogContext):
        self.ctx = ctx
        self._lock = threading.Lock()
        self._win_handle_map: Dict[int, Tuple[str, object]] = {}
        self._next_handle = 0

    # -------------------------------------------------------------- #
    # lifecycle
    # -------------------------------------------------------------- #
    def create(self, tensor, name: str, zero_init: bool = False) -> bool:
        ctx = self.ctx
        if name in ctx.windows:
            return False
        value = ctx.rank_sharded(tensor).clone()
        ctx.windows[name] = Window(ctx, name, value, zero_init)
        return True

    def free(self, name: Optional[str] = None) -> bool:
        if name is None:
            self.ctx.windows.clear()
            return True
        if name not in self.ctx.windows:
            return False
        del self.ctx.windows[name]
        return True

    def names(self) -> List[str]:
        return sorted(self.ctx.windows)

    def window(self, name: str) -> Window:
        if name not in self.ctx.windows:
            raise BluefogError(f"Window '{name}' does not exist.")
        return self.ctx.windows[name]

    # -------------------------------------------------------------- #
    # handles (reference win_handle_manager, torch/mpi_win_ops.cc)
    # -------------------------------------------------------------- #
    def _register(self, name: str) -> int:
        event = record_event(self.ctx.device)
        with self._lock:
            handle = self._next_handle
            self._next_handle += 1
            self._win_handle_map[handle] = (name, event)
            return handle

    def wait(self, handle: int) -> bool:
        with self._lock:
            entry = self._win_handle_map.pop(handle, None)
        if entry is None:
            return False
        name, event = entry
        if event is not None:
            timed_wait(f"win.{name}", event.synchronize)
        return True

    def poll(self, handle: int) -> bool:
        with self._lock:
            entry = self._win_handle_map.get(handle)
        if entry is None:
            raise BluefogError(f"Unknown window handle {handle}")
        return entry[1] is None or entry[1].query()

    # -------------------------------------------------------------- #
    # weight resolution
    # -------------------------------------------------------------- #
    def _resolve_dst(self, win: Window, dst_weights) -> DynamicTopology:
        """Edges (src -> dst) with sender-side weights for put/accumulate.
        Default: all out-neighbors with weight 1.0
        (reference torch/mpi_ops.py:1190-1196)."""
        n = self.ctx.size()
        per_rank = WeightArg.per_rank(dst_weights, n, "dst")
        edge_weights: Dict[Tuple[int, int], float] = {}
        for src in range(n):
            entry = per_rank[src]
            if entry is None:
                entry = {d: 1.0 for d in win.out_neighbors[src]}
            elif not isinstance(entry, dict):
                entry = {int(d): 1.0 for d in entry}
            for dst, w in entry.items():
                dst = int(dst)
                if dst not in win.out_neighbors[src]:
                    raise ValueError(
                        "The key of dst_weights should only contain ranks "
                        "that belong to out-neighbors (self-rank is not "
                        "allowed)."
                    )
                edge_weights[(src, dst)] = float(w)
        return DynamicTopology.from_edges(n, edge_weights)

    def _resolve_src(self, win: Window, src_weights) -> DynamicTopology:
        """Edges (src -> dst) with receiver-side weights for get.
        Default: all in-neighbors with weight 1.0
        (reference torch/mpi_ops.py:1249-1258)."""
        n = self.ctx.size()
        per_rank = WeightArg.per_rank(src_weights, n, "src")
        edge_weights: Dict[Tuple[int, int], float] = {}
        for dst in range(n):
            entry = per_rank[dst]
            if entry is None:
                entry = {s: 1.0 for s in win.in_neighbors[dst]}
            elif not isinstance(entry, dict):
                entry = {int(s): 1.0 for s in entry}
            for src, w in entry.items():
                src = int(src)
                if src not in win.in_neighbors[dst]:
                    raise ValueError(
                        "The key of src_weights should only contain ranks "
                        "that belong to in-neighbors."
                    )
                edge_weights[(src, dst)] = float(w)
        return DynamicTopology.from_edges(n, edge_weights)

    def _program(self, op: str, win: Window, spec: DynamicTopology
                 ) -> _Edges:
        """The cached index tables of ``op`` over ``spec``'s edge
        STRUCTURE (weights never enter the key: a dynamic schedule that
        varies weights every step reuses one entry)."""
        key = (op, win.name, spec.edges)
        edges = self.ctx._op_cache.get(key)
        if edges is None:
            edges = self.ctx._op_cache[key] = _Edges(
                C.edge_structure(spec), win.in_lists, win.value.device)
        return edges

    def _weights(self, spec: DynamicTopology, self_weights=None):
        """(class weights [n_classes, n], self weights [n] or None),
        float64 on the device, without a host sync."""
        wv = C.class_recv_weights(spec)
        if self_weights is None:
            return self.ctx.device_weights(wv)[0], None
        sw = torch.tensor(np.asarray(self_weights, np.float64))
        return self.ctx.device_weights(wv, sw)

    # -------------------------------------------------------------- #
    # ops
    # -------------------------------------------------------------- #
    def put(self, tensor, name: str, self_weight: Optional[float] = None,
            dst_weights=None, require_mutex: bool = False,
            accumulate: bool = False) -> int:
        """win_put / win_accumulate.  Sends ``tensor[src] * w(src->dst)``
        into dst's slot for src (replace for put, add for accumulate), bumps
        the version, then scales the local window tensor by ``self_weight``
        (reference torch/mpi_ops.py:1161-1199; wire
        mpi_controller.cc:952-1035).  Returns a handle."""
        ctx = self.ctx
        win = self.window(name)
        x = ctx.rank_sharded(tensor)
        if self_weight is None:
            self_weight = 1.0
        spec = self._resolve_dst(win, dst_weights)
        associated_p = ctx.win_ops_with_associated_p
        edges = self._program("win_put", win, spec)
        wv, sw = self._weights(
            spec, WeightArg.per_rank(self_weight, ctx.size(), "self"))
        # the payload and p scale by the f32-rounded weights, as the JAX
        # kernels cast them
        wv, sw = wv.float(), sw.float()
        xf = x.float()
        for c, (src, dst, slot) in enumerate(edges.classes):
            w = wv[c].index_select(0, dst)
            sent = (xf.index_select(0, src) * _rows(w, xf.dim())
                    ).to(x.dtype)
            win.mailbox.index_put_((dst, slot), sent, accumulate=accumulate)
            win.versions.index_put_((dst, slot),
                                    torch.ones_like(src, dtype=torch.int32),
                                    accumulate=True)
            if associated_p:
                p_sent = win.p.index_select(0, src) * w.to(P_DTYPE)
                win.p_mailbox.index_put_((dst, slot), p_sent,
                                         accumulate=accumulate)
        win.value = (xf * _rows(sw, xf.dim())).to(x.dtype)
        if associated_p:
            win.p = win.p * sw.to(P_DTYPE)
        return self._register(name)

    def get(self, name: str, src_weights=None,
            require_mutex: bool = False) -> int:
        """win_get: fetch src's *window tensor* scaled by the receiver-side
        weight into my slot for src (reference torch/mpi_ops.py:1229-1261;
        wire mpi_controller.cc:1122-1183)."""
        ctx = self.ctx
        win = self.window(name)
        spec = self._resolve_src(win, src_weights)
        associated_p = ctx.win_ops_with_associated_p
        edges = self._program("win_get", win, spec)
        wv = self._weights(spec)[0].float()
        xf = win.value.float()
        for c, (src, dst, slot) in enumerate(edges.classes):
            w = wv[c].index_select(0, dst)
            fetched = (xf.index_select(0, src) * _rows(w, xf.dim())
                       ).to(win.dtype)
            win.mailbox.index_put_((dst, slot), fetched)
            win.versions.index_put_((dst, slot),
                                    torch.ones_like(src, dtype=torch.int32),
                                    accumulate=True)
            if associated_p:
                win.p_mailbox.index_put_(
                    (dst, slot), win.p.index_select(0, src) * w.to(P_DTYPE))
        return self._register(name)

    def update(self, name: str, self_weight: Optional[float] = None,
               neighbor_weights=None, reset: bool = False,
               clone: bool = False,
               require_mutex: bool = False) -> torch.Tensor:
        """win_update: weighted combine of the window tensor with the
        mailbox slots (reference torch/mpi_ops.py:1081-1153 +
        torch/mpi_win_ops.cc:345-426).  Returns the new rank-major tensor
        (also stored as the window value unless ``clone``)."""
        ctx = self.ctx
        win = self.window(name)
        n = ctx.size()

        if (self_weight is None) != (neighbor_weights is None):
            raise ValueError(
                "Arguments self_weight and neighbor_weights have to be "
                "presented at the same time"
            )
        # Resolve per-rank combine weights (reference mpi_ops.py:1123-1148).
        if self_weight is None:
            self_w = []
            edge_weights = {}
            weight_matrix = (ctx.load_topology().to_numpy()
                             if ctx.is_topo_weighted() else None)
            for dst in range(n):
                if weight_matrix is not None:
                    s = float(weight_matrix[dst, dst])
                    nbrs = {
                        int(src): float(weight_matrix[src, dst])
                        for src in win.in_neighbors[dst]
                    }
                else:
                    nbr_list = win.in_neighbors[dst]
                    s = 1.0 / (len(nbr_list) + 1)
                    nbrs = {r: s for r in nbr_list}
                self_w.append(s)
                for src, w in nbrs.items():
                    edge_weights[(src, dst)] = float(w)
        else:
            selfs = WeightArg.per_rank(self_weight, n, "self")
            nbrs_per = WeightArg.per_rank(neighbor_weights, n, "src")
            self_w = [s if s is not None else 0.0 for s in selfs]
            edge_weights = {}
            for dst in range(n):
                entry = nbrs_per[dst] or {}
                if not isinstance(entry, dict):
                    raise ValueError(
                        "Argument neighbor_weights has to be a dictionary "
                        "map from the (in-)neighbor rank to the weights."
                    )
                for src, w in entry.items():
                    src = int(src)
                    if src not in win.in_neighbors[dst]:
                        raise ValueError(
                            "The key of weights should only contain the "
                            "ranks that belong to in-neighbors and self rank."
                        )
                    edge_weights[(src, dst)] = float(w)
        spec = DynamicTopology.from_edges(n, edge_weights, self_w)
        associated_p = ctx.win_ops_with_associated_p
        edges = self._program("win_update", win, spec)
        wv, sw = self._weights(spec, spec.self_weight_values)

        # the payload combines in f32; p in f64 with the f32-rounded self
        # weight and float64 neighbor weights, as the JAX kernel does
        sw = sw.float()
        acc = win.value.float() * _rows(sw, win.value.dim())
        new_p = win.p * sw.to(P_DTYPE) if associated_p else win.p
        for c, (src, dst, slot) in enumerate(edges.classes):
            w = wv[c].index_select(0, dst)
            cur = win.mailbox[dst, slot].float()
            acc.index_add_(0, dst, cur * _rows(w.float(), cur.dim()))
            if associated_p:
                new_p = new_p.index_add(
                    0, dst, win.p_mailbox[dst, slot] * w)
            # the slots this update consumed (a declared 0.0-weight edge
            # still counts as read): versions clear; under reset the
            # slots clear too
            win.versions.index_put_((dst, slot), torch.zeros_like(
                src, dtype=torch.int32))
            if reset:
                win.mailbox.index_put_((dst, slot), torch.zeros(
                    (), dtype=win.dtype, device=win.mailbox.device))
                if associated_p:
                    win.p_mailbox.index_put_((dst, slot), torch.zeros(
                        (), dtype=P_DTYPE, device=win.mailbox.device))
        new_value = acc.to(win.dtype)
        win.p = new_p
        if not clone:
            win.value = new_value
        return new_value

    def set_value(self, name: str, tensor):
        """Rebind the window tensor (the reference mutates the registered
        torch tensor in place; callers of the port set it explicitly)."""
        win = self.window(name)
        win.value = self.ctx.rank_sharded(tensor)

    def versions_of(self, name: str, rank: Optional[int] = None
                    ) -> Dict[int, int]:
        win = self.window(name)
        r = self.ctx.rank() if rank is None else rank
        vers = host_fetch(win.versions)
        return {s: int(vers[r, win.in_lists[r].index(s)])
                for s in win.in_neighbors[r]}

    def associated_p(self, name: str, rank: Optional[int] = None) -> float:
        win = self.window(name)
        r = self.ctx.rank() if rank is None else rank
        return float(host_fetch(win.p)[r])


@contextmanager
def win_mutex_ctx(manager: WindowManager, name: str, for_self=False,
                  ranks=None):
    """Distributed-mutex parity shim: stream order already serializes
    window reads/writes (reference mutex: mpi_controller.cc:1594-1663)."""
    manager.window(name)  # validate
    yield


@contextmanager
def win_lock_ctx(manager: WindowManager, name: str):
    """RMA-epoch parity shim (reference mpi_ops.py win_lock)."""
    manager.window(name)  # validate
    yield

"""Expert dispatch: the compiled all-to-all on the wire.

Port of ``bluefog_tpu/moe/dispatch.py``.  ``compile_all_to_all`` emits
rounds as ``DynamicTopology`` specs; :func:`dispatch_plan` lowers them
to the permute groups the compiler's ``predicted_collectives`` states,
under the same fusion rule:

  * a round whose union pair list has all-unique srcs AND dsts fuses
    into ONE permute carrying the full per-destination shard;
  * otherwise the round issues one permute per rank-space shift class
    (each pair's payload depends only on the pair: src sends the shard
    addressed to dst).

:func:`all_to_all_dispatch` runs a plan over a rank backend
(``parallel/collectives.py``): every byte moves through the backend's
``permute``, one call per group, the JAX package's ``lax.ppermute``.  It
runs unchanged on ``StackedBackend`` (a gather along the rank axis of
one device) and ``ProcessBackend`` (point-to-point sends between
processes).  The permutes are differentiable: the backward of a permute
is the permute of the reversed pairs, as the transpose of
``lax.ppermute`` is, so a loss over the dispatched tokens gives each
rank the gradient JAX's SPMD program gives it.

Resilience is DATA, not structure: the wire schedule is static for the
pod shape, and an expert machine's death only rewrites the
``(route_table, capacity_mask)`` operands (:func:`heal_route_table`), so
a kill -> heal cycle runs on the same step object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from bluefog_tpu_torch.parallel.collectives import _device_const

# This module legitimately constructs weight tables from scratch: the
# analysis lint's weight-matrix-bypass rule treats it as an authority
# (everywhere else, tables must come from the shared helpers here).
_WEIGHT_AUTHORITY = True

__all__ = [
    "DispatchPlan",
    "dispatch_plan",
    "all_to_all_dispatch",
    "naive_all_to_all",
    "expert_owner",
    "default_route_table",
    "heal_route_table",
    "capacity_mask_of",
]

Pair = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """The host-side lowering plan of one all-to-all schedule: per
    round, the permute groups (pair tuples) the dispatch issues, in
    emission order.  ``transpose()`` is the RETURN path: the same
    groups with every pair reversed, rounds in reverse order, so the
    combine retraces the dispatch wire exactly."""

    n: int
    rounds: Tuple[Tuple[Tuple[Pair, ...], ...], ...]

    @property
    def permutes_per_period(self) -> int:
        return sum(len(groups) for groups in self.rounds)

    def transpose(self) -> "DispatchPlan":
        return DispatchPlan(
            n=self.n,
            rounds=tuple(
                tuple(tuple((d, s) for (s, d) in group)
                      for group in groups)
                for groups in reversed(self.rounds)))


def dispatch_plan(schedule: Sequence) -> DispatchPlan:
    """Lower a compiled a2a schedule (``DynamicTopology`` rounds, e.g.
    ``CompiledAllToAll.schedule``) to its permute groups under the
    compiler's fusion rule.  Pure host-side."""
    if not schedule:
        raise ValueError("dispatch_plan needs at least one round")
    n = schedule[0].size
    rounds = []
    for r in schedule:
        pairs = [p for cls in r.shift_classes for p in cls.perm]
        srcs = [s for s, _ in pairs]
        dsts = [d for _, d in pairs]
        if (len(set(srcs)) == len(srcs)
                and len(set(dsts)) == len(dsts)):
            groups = (tuple(sorted(pairs)),)
        else:
            groups = tuple(tuple(cls.perm) for cls in r.shift_classes)
        rounds.append(groups)
    return DispatchPlan(n=n, rounds=tuple(rounds))


def _group_tables(group: Sequence[Pair],
                  n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static send/recv tables of one permute group: ``send[r]`` is
    rank r's destination (-1 when r does not send this group),
    ``recv[r]`` the rank whose shard lands here (-1 when none)."""
    send = np.full((n,), -1, np.int64)
    recv = np.full((n,), -1, np.int64)
    for s, d in group:
        send[s] = d
        recv[d] = s
    return send, recv


class _Permute(torch.autograd.Function):
    """``backend.permute(x, perm)`` with its transpose as the backward:
    the cotangent of what ``dst`` received goes back to ``src``."""

    @staticmethod
    def forward(ctx, x, perm, backend):
        ctx.perm, ctx.backend = perm, backend
        return backend.permute(x, perm)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return ctx.backend.permute(g.contiguous(), back), None, None


def _permute(x: torch.Tensor, perm, backend) -> torch.Tensor:
    if x.requires_grad:
        return _Permute.apply(x, perm, backend)
    return backend.permute(x, perm)


def _local_table(table, backend, device) -> torch.Tensor:
    """Rows of a global ``[n]`` table for the ranks ``backend`` holds, a
    device constant built once (a copy per call would stall the
    stream)."""
    return _device_const(tuple(int(table[r]) for r in backend.ranks),
                         device)


def all_to_all_dispatch(x: torch.Tensor, plan: DispatchPlan, backend,
                        wire_dtype: Optional[str] = None) -> torch.Tensor:
    """Run the compiled all-to-all over ``backend``'s ranks.

    ``x [n_local, n, ...]`` is rank-major: row ``d`` of a rank's slice is
    its shard addressed to rank ``d``.  The result has the same shape;
    slot ``s`` of a rank's slice holds the shard rank ``s`` addressed
    to it.  The self shard never touches the wire; every other shard
    moves through ``backend.permute``, one call per group of the plan.

    ``wire_dtype="int8"`` sends each permute's payload as a per-rank
    absmax int8 code (``scale = max|payload| / 127``, round half to
    even), the scale riding a second permute, as in the JAX package.
    Only the scale's permute carries a gradient (the codes are integers,
    as JAX's ``astype(int8)`` stops the payload's)."""
    if wire_dtype not in (None, "int8"):
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    n = plan.n
    if x.shape[0] != backend.n_local or x.shape[1] != n:
        raise ValueError(
            f"all_to_all_dispatch takes [n_local={backend.n_local}, n={n}, "
            f"...] shards, got {tuple(x.shape)}")
    dev = x.device
    k = backend.n_local
    me = _local_table(range(n), backend, dev)
    # the self shard: x[i, me_i] stays, every other slot starts at zero
    self_slot = (torch.arange(n, device=dev)[None, :] == me[:, None])
    self_slot = self_slot.reshape(self_slot.shape + (1,) * (x.dim() - 2))
    y = torch.where(self_slot, x, torch.zeros((), dtype=x.dtype,
                                               device=dev))
    tail = (1,) * (x.dim() - 2)
    # slots addressed as rows of the [k * n, ...] view: row i * n + d;
    # index_select / index_add keep the forward and its backward free of
    # host syncs
    flat_x = x.reshape(k * n, *x.shape[2:])
    base = _device_const(tuple(i * n for i in range(k)), dev)
    for groups in plan.rounds:
        for group in groups:
            send, recv = _group_tables(group, n)
            dst = _local_table(send, backend, dev)
            src = _local_table(recv, backend, dev)
            payload = flat_x.index_select(0, base + dst.clamp(0, n - 1))
            payload = torch.where((dst >= 0).reshape(-1, *tail), payload,
                                  torch.zeros((), dtype=x.dtype,
                                              device=dev))
            perm = [(int(s), int(d)) for s, d in group]
            if wire_dtype == "int8":
                # max|payload| / 127 as XLA compiles it: a product with
                # the f32 reciprocal (bit-equal to the JAX package's codes)
                scale = payload.abs().reshape(k, -1).amax(
                    dim=1) * (1.0 / 127.0)
                scale = torch.where(scale > 0, scale,
                                    torch.ones_like(scale))
                q = torch.clamp(torch.round(
                    payload / scale.reshape(-1, *tail)), -127, 127
                ).to(torch.int8)
                q = backend.permute(q, perm)
                s_in = _permute(scale, perm, backend)
                out = q.to(x.dtype) * s_in.to(x.dtype).reshape(-1, *tail)
            else:
                out = _permute(payload, perm, backend)
            out = torch.where((src >= 0).reshape(-1, *tail), out,
                              torch.zeros((), dtype=out.dtype, device=dev))
            y = y.reshape(k * n, *x.shape[2:]).index_add(
                0, base + src.clamp(0, n - 1), out).reshape(x.shape)
    return y


def naive_all_to_all(x: torch.Tensor, backend) -> torch.Tensor:
    """The baseline: the swap of the two rank axes of ``x [n_local, n,
    ...]`` (``lax.all_to_all(split_axis=0, concat_axis=0)``), every
    rank's rows gathered first when the ranks span processes.  The
    reference :func:`all_to_all_dispatch` must equal."""
    full = backend.gather_ranks(x)
    return backend.own(full.transpose(0, 1)).contiguous()


# ------------------------------------------------------------------ #
# expert placement + resilience data
# ------------------------------------------------------------------ #
def expert_owner(rank: int, n_experts: int) -> int:
    """Which expert a rank hosts: round-robin, so expert ``e``'s
    replica set is every rank ``r`` with ``r % n_experts == e``."""
    return rank % n_experts


def default_route_table(n: int, n_experts: int) -> np.ndarray:
    """``[n, n_experts] int32``: the replica of expert ``e`` that rank
    ``src`` dispatches to; sources fan out round-robin across the
    expert's replicas, so no replica is a hot spot by construction."""
    if not 1 <= n_experts <= n:
        raise ValueError(
            f"need 1 <= n_experts <= n, got {n_experts} experts on "
            f"{n} ranks")
    route = np.zeros((n, n_experts), np.int32)
    for e in range(n_experts):
        replicas = [r for r in range(n) if r % n_experts == e]
        for src in range(n):
            route[src, e] = replicas[src % len(replicas)]
    return route


def heal_route_table(route, dead_mask, n_experts: int) -> np.ndarray:
    """Reroute every dispatch entry pointing at a dead rank to a
    surviving replica of the same expert (round-robin over survivors,
    so the dead rank's load spreads).  Host-side and shape-preserving:
    the healed table is the same ``[n, n_experts]`` batch operand.  An
    expert with no surviving replica is unroutable, so it raises.  A
    heal with any dead rank records a ``moe``/``replan`` decision in the
    flight recorder (``observe.blackbox``)."""
    route = np.array(route, np.int32, copy=True)
    n = route.shape[0]
    dead = np.asarray(dead_mask, bool).reshape(n)
    for e in range(n_experts):
        live = [r for r in range(n)
                if r % n_experts == e and not dead[r]]
        if not live:
            raise ValueError(
                f"expert {e} has no surviving replica — cannot heal")
        k = 0
        for src in range(n):
            if dead[route[src, e]]:
                route[src, e] = live[k % len(live)]
                k += 1
    if dead.any():
        from bluefog_tpu_torch.observe import blackbox as _blackbox

        _blackbox.record_decision(
            "moe", "replan", step=-1,
            telemetry={"dead": [int(i) for i in np.flatnonzero(dead)],
                       "n_experts": int(n_experts), "size": int(n)})
    return route


def capacity_mask_of(dead_mask) -> np.ndarray:
    """``[n] float32``: 1.0 for ranks accepting expert traffic, 0.0
    for dead ones: the multiplier that zeroes contributions from (and
    to) dead slots without touching the wire schedule."""
    dead = np.asarray(dead_mask, bool).reshape(-1)
    return (1.0 - dead.astype(np.float32)).astype(np.float32)

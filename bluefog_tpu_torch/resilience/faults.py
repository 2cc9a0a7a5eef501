"""Deterministic serving fault plans — the chaos harness's serving half.

Port of the serving part of ``bluefog_tpu/resilience/faults.py``
(:class:`ServingFault`, :class:`ServingFaultPlan`), copied unchanged (it
is numpy-free host bookkeeping).  The training plans (``FaultPlan``,
``corrupt_batch``) come with their first caller, the resilient training
runner of ROADMAP.md Queue 1, item 12.

A plan is a pure host-side schedule: at engine step S, replica r dies,
stalls its host loop, or refuses admission.  Injection wraps
``ServingEngine.step`` and ``submit`` from outside, so no fault pattern
changes what the engine computes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

__all__ = ["ServingFault", "ServingFaultPlan", "REPLICA_DEATH",
           "REPLICA_STALL", "SUBMIT_REJECT"]

REPLICA_DEATH = "replica_death"
REPLICA_STALL = "replica_stall"
SUBMIT_REJECT = "submit_reject"
_SERVING_KINDS = (REPLICA_DEATH, REPLICA_STALL, SUBMIT_REJECT)


# ------------------------------------------------------------------ #
# serving-side chaos: the same deterministic-schedule idiom, over
# replicas and engine steps instead of ranks and train steps
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class ServingFault:
    """One scheduled serving fault.

    ``step``: first ENGINE step (per-replica step counter, not wall
    time) the fault is active.  ``replica_death`` is permanent from its
    onset: the replica stops stepping entirely — its gauges go stale and
    the router's staleness guard excises it, the in-process stand-in for
    a lost serving host.  ``replica_stall`` sleeps ``stall_seconds`` of
    host time per active step for ``duration`` steps (a GC pause / noisy
    neighbor — the replica is *slow*, not gone).  ``submit_reject``
    makes the replica refuse admission (``RequestRejected``) for every
    submit landing during ``[step, step + duration)`` of its step count
    — the transient-overload input the router's retry/backoff path must
    absorb."""

    step: int
    replica: int
    kind: str
    duration: int = 1
    stall_seconds: float = 0.0

    def __post_init__(self):
        if self.kind not in _SERVING_KINDS:
            raise ValueError(f"unknown serving fault kind {self.kind!r}; "
                             f"one of {_SERVING_KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.duration < 1:
            raise ValueError(
                f"fault duration must be >= 1, got {self.duration}")


class ServingFaultPlan:
    """An immutable, deterministic schedule of faults over ``size``
    serving replicas.

    Injection is pure host-side control flow wrapped AROUND
    ``ServingEngine.step`` (:class:`bluefog_tpu_torch.serving.FaultyReplica`):
    a dead replica simply stops calling ``step``, a stalled one sleeps
    before it, a rejecting one raises before ``submit`` reaches the
    scheduler.  Nothing enters the jitted programs — the resident
    program set and jit cache sizes are identical under every fault
    pattern (the serving zero-recompile contract).
    """

    def __init__(self, size: int, faults: Sequence[ServingFault] = ()):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        for f in faults:
            if not 0 <= f.replica < size:
                raise ValueError(
                    f"fault replica {f.replica} outside fleet of "
                    f"size {size}")
        self.size = size
        self.faults: Tuple[ServingFault, ...] = tuple(
            sorted(faults, key=lambda f: (f.step, f.replica)))

    # ------------------------------------------------------------- #
    # constructors for the common chaos scenarios
    # ------------------------------------------------------------- #
    @staticmethod
    def healthy(size: int) -> "ServingFaultPlan":
        return ServingFaultPlan(size, ())

    @staticmethod
    def replica_death(size: int, replica: int,
                      step: int) -> "ServingFaultPlan":
        return ServingFaultPlan(
            size, [ServingFault(step, replica, REPLICA_DEATH)])

    @staticmethod
    def replica_stall(size: int, replica: int, step: int, duration: int,
                      stall_seconds: float) -> "ServingFaultPlan":
        return ServingFaultPlan(
            size, [ServingFault(step, replica, REPLICA_STALL, duration,
                                stall_seconds=stall_seconds)])

    @staticmethod
    def submit_rejection(size: int, replica: int, step: int,
                         duration: int = 1) -> "ServingFaultPlan":
        return ServingFaultPlan(
            size, [ServingFault(step, replica, SUBMIT_REJECT, duration)])

    def merged(self, other: "ServingFaultPlan") -> "ServingFaultPlan":
        if other.size != self.size:
            raise ValueError("cannot merge plans over different sizes")
        return ServingFaultPlan(self.size, self.faults + other.faults)

    # ------------------------------------------------------------- #
    # queries
    # ------------------------------------------------------------- #
    def active(self, step: int) -> List[ServingFault]:
        """Faults live at ``step`` (death = live forever after onset)."""
        out = []
        for f in self.faults:
            if f.kind == REPLICA_DEATH:
                live = step >= f.step
            else:
                live = f.step <= step < f.step + f.duration
            if live:
                out.append(f)
        return out

    def is_dead(self, replica: int, step: int) -> bool:
        return any(f.replica == replica for f in self.faults
                   if f.kind == REPLICA_DEATH and step >= f.step)

    def dead_replicas(self, step: int) -> List[int]:
        return sorted({f.replica for f in self.faults
                       if f.kind == REPLICA_DEATH and step >= f.step})

    def stall_seconds(self, replica: int, step: int) -> float:
        return float(sum(f.stall_seconds for f in self.active(step)
                         if f.kind == REPLICA_STALL
                         and f.replica == replica))

    def rejects_submit(self, replica: int, step: int) -> bool:
        return any(f.replica == replica for f in self.active(step)
                   if f.kind == SUBMIT_REJECT)

    def last_onset(self) -> int:
        """The latest fault onset step (0 for an empty plan) — a chaos
        run should serve past this to observe recovery."""
        return max((f.step for f in self.faults), default=0)

    def __repr__(self):
        return (f"ServingFaultPlan(size={self.size}, "
                f"faults={list(self.faults)})")

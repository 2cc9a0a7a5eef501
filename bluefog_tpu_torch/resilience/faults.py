"""Deterministic fault injection — the chaos harness.

Port of ``bluefog_tpu/resilience/faults.py``, copied whole but for
:meth:`FaultPlan.corrupt_batch`, whose lazy ``jax.tree.map`` becomes
torch's pytree map and which poisons the rows on the batch's own device.

The paper's core claim is that decentralized neighbor averaging
tolerates imperfect communication; proving the *system* tolerates it
needs faults that are reproducible enough to assert exact outcomes
against.  A :class:`FaultPlan` is a pure host-side schedule: at step S,
rank r emits NaN/Inf gradients (a burst of ``duration`` steps), goes
dead (emits garbage forever — the in-process simulation of a lost device,
whose slot keeps executing but whose contribution must be excluded), is
preempted for a while, or stalls the host loop.

Injection is SHAPE-STABLE by construction: faults enter the guarded
train step only through its *inputs* (the batch rows of the faulted
rank are poisoned before the step), so one step serves every fault
pattern.  :class:`ServingFaultPlan` is the same idiom over serving
replicas and engine steps (:mod:`bluefog_tpu_torch.serving.resilience`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Fault", "FaultPlan", "NAN", "INF", "DEAD", "STALL", "PREEMPT",
           "CONGEST", "ServingFault", "ServingFaultPlan", "REPLICA_DEATH",
           "REPLICA_STALL", "SUBMIT_REJECT"]

NAN, INF, DEAD, STALL, PREEMPT = "nan", "inf", "dead", "stall", "preempt"
CONGEST = "congest"
_KINDS = (NAN, INF, DEAD, STALL, PREEMPT, CONGEST)

REPLICA_DEATH = "replica_death"
REPLICA_STALL = "replica_stall"
SUBMIT_REJECT = "submit_reject"
_SERVING_KINDS = (REPLICA_DEATH, REPLICA_STALL, SUBMIT_REJECT)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    ``step``: first step the fault is active.  ``duration``: steps a
    nan/inf burst — or a ``stall``, or a ``preempt`` — lasts (ignored
    for ``dead``, which is permanent).  A ``preempt`` is
    duration-limited death: the rank emits NaN like a dead rank for
    ``[step, step + duration)`` and computes healthily again after —
    the deterministic, replayable input of a preempt -> rejoin cycle
    (elastic membership; the returning rank is ``rejoinable_ranks``'s
    answer, not automatically live).  ``stall_seconds``: host-loop
    sleep injected PER ACTIVE STEP by a ``stall`` fault (exercises the
    watchdog / op timeout / straggler detector, not the numerics); a
    multi-step stall on one rank is the injected-straggler scenario.

    A ``congest`` fault degrades the directed LINK ``rank -> dst`` by
    ``factor`` (time per byte, not correctness) for ``duration`` steps
    — the fault class the topology control plane exists to route
    around.  It corrupts nothing and stalls nothing by itself; a chaos
    harness reads :meth:`FaultPlan.congested_links` each step and
    charges the active schedule's use of the slowed link (virtual
    per-edge seconds fed into ``bf_edge_seconds_total`` and the
    per-rank step-time vector)."""

    step: int
    rank: int
    kind: str
    duration: int = 1
    stall_seconds: float = 0.0
    dst: int = -1
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {_KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.duration < 1:
            raise ValueError(
                f"fault duration must be >= 1, got {self.duration}")
        if self.kind == CONGEST:
            if self.dst < 0:
                raise ValueError("a congest fault names a directed link "
                                 "— dst must be a valid rank")
            if self.factor < 1.0:
                raise ValueError(f"congestion factor must be >= 1 "
                                 f"(a slowdown), got {self.factor}")


class FaultPlan:
    """An immutable, deterministic schedule of faults over ``size`` ranks.

    The plan answers two questions per step: which ranks' gradients are
    corrupted (``corrupt_codes`` / ``corrupt_batch``) and how long the
    host loop should stall (``stall_seconds``).  A ``dead`` rank is
    modeled as a permanent NaN emitter from its death step on — the
    in-process stand-in for a lost device: the guard skips it every
    step, the detector's consecutive-skip count crosses the death
    threshold, and healing excises it from the mixing matrix.
    """

    def __init__(self, size: int, faults: Sequence[Fault] = ()):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        for f in faults:
            if not 0 <= f.rank < size:
                raise ValueError(
                    f"fault rank {f.rank} outside world of size {size}")
            if f.kind == CONGEST and not 0 <= f.dst < size:
                raise ValueError(
                    f"congest dst {f.dst} outside world of size {size}")
        self.size = size
        self.faults: Tuple[Fault, ...] = tuple(
            sorted(faults, key=lambda f: (f.step, f.rank)))

    # ------------------------------------------------------------- #
    # constructors for the common chaos scenarios
    # ------------------------------------------------------------- #
    @staticmethod
    def healthy(size: int) -> "FaultPlan":
        return FaultPlan(size, ())

    @staticmethod
    def nan_burst(size: int, rank: int, step: int,
                  duration: int = 1) -> "FaultPlan":
        return FaultPlan(size, [Fault(step, rank, NAN, duration)])

    @staticmethod
    def rank_death(size: int, rank: int, step: int) -> "FaultPlan":
        return FaultPlan(size, [Fault(step, rank, DEAD)])

    @staticmethod
    def straggler(size: int, rank: int, step: int, duration: int,
                  stall_seconds: float) -> "FaultPlan":
        """One rank runs ``stall_seconds`` slow for ``duration``
        consecutive steps — the injected-straggler scenario the
        ``observe.fleet.StragglerDetector`` must name (chaos bench:
        detection latency is a machine-checked claim)."""
        return FaultPlan(size, [Fault(step, rank, STALL, duration,
                                      stall_seconds=stall_seconds)])

    @staticmethod
    def preempt(size: int, rank: int, step: int,
                duration: int) -> "FaultPlan":
        """Duration-limited death: ``rank`` is a NaN emitter for
        ``[step, step + duration)`` and healthy after — a preemptible
        host losing and regaining its slot.  Pick ``duration`` past the
        guard's death threshold so the detector actually declares the
        rank dead mid-window; once the window ends the rank shows up in
        :meth:`rejoinable_ranks`, which is the default admission signal
        of ``run_resilient(elastic=...)`` — the full preempt -> heal ->
        bootstrap -> rejoin cycle from one deterministic plan."""
        return FaultPlan(size, [Fault(step, rank, PREEMPT, duration)])

    @staticmethod
    def persistent_straggler(size: int, rank: int, step: int,
                             stall_seconds: float,
                             duration: int = 1_000_000) -> "FaultPlan":
        """One rank runs ``stall_seconds`` slow from ``step`` ON — the
        open-ended straggler that never recovers on its own (a bad
        host, a thermally-throttled chip).  Where :meth:`straggler`
        models a transient the detector merely names, a persistent
        straggler is a standing degradation signal the topology
        control plane must eventually re-plan around.  ``duration``
        defaults far past any bench horizon."""
        return FaultPlan(size, [Fault(step, rank, STALL, duration,
                                      stall_seconds=stall_seconds)])

    @staticmethod
    def congest_link(size: int, src: int, dst: int, factor: float,
                     start: int, duration: int) -> "FaultPlan":
        """The directed link ``src -> dst`` carries bytes ``factor``x
        slower for ``[start, start + duration)`` — an injected DCN
        congestion event.  Purely a cost-model fault: nothing is
        corrupted and the host loop is not stalled; the chaos harness
        reads :meth:`congested_links` per step and charges whatever
        the ACTIVE schedule ships across the slowed link, which is
        exactly the signal (``bf_edge_seconds_total`` deltas) the
        topology control plane re-plans from."""
        return FaultPlan(size, [Fault(start, src, CONGEST, duration,
                                      dst=dst, factor=factor)])

    def merged(self, other: "FaultPlan") -> "FaultPlan":
        if other.size != self.size:
            raise ValueError("cannot merge plans over different sizes")
        return FaultPlan(self.size, self.faults + other.faults)

    # ------------------------------------------------------------- #
    # queries
    # ------------------------------------------------------------- #
    def active(self, step: int) -> List[Fault]:
        """Faults live at ``step`` (dead = live forever after onset)."""
        out = []
        for f in self.faults:
            if f.kind == DEAD:
                live = step >= f.step
            else:
                live = f.step <= step < f.step + f.duration
            if live:
                out.append(f)
        return out

    def corrupt_codes(self, step: int) -> np.ndarray:
        """Per-rank corruption codes at ``step``: 0 healthy, 1 NaN,
        2 Inf.  Dead ranks read as 1 (permanent NaN emitters)."""
        codes = np.zeros((self.size,), np.int8)
        for f in self.active(step):
            if f.kind in (NAN, DEAD, PREEMPT):
                codes[f.rank] = 1
            elif f.kind == INF:
                codes[f.rank] = 2
        return codes

    def dead_ranks(self, step: int) -> List[int]:
        return sorted({f.rank for f in self.faults
                       if f.kind == DEAD and step >= f.step})

    def preempted_ranks(self, step: int) -> List[int]:
        """Ranks inside an active preempt window at ``step`` — dead for
        now, but scheduled to come back."""
        return sorted({f.rank for f in self.active(step)
                       if f.kind == PREEMPT})

    def rejoinable_ranks(self, step: int) -> List[int]:
        """Ranks whose preempt window has ENDED by ``step`` and that no
        other fault currently holds — the deterministic admission
        signal for elastic membership (``run_resilient(elastic=...)``
        polls this when no explicit ``admit`` callable is given).  A
        rank re-preempted by a later fault drops out again until that
        window too has passed."""
        ended = {f.rank for f in self.faults
                 if f.kind == PREEMPT and step >= f.step + f.duration}
        held = {f.rank for f in self.active(step)}
        return sorted(ended - held)

    def stall_seconds(self, step: int) -> float:
        return float(sum(f.stall_seconds for f in self.active(step)
                         if f.kind == STALL))

    def stall_seconds_by_rank(self, step: int) -> np.ndarray:
        """Per-rank injected stall at ``step`` — the ``[n]`` vector a
        per-rank step-time synthesizer adds on top of the measured
        wall time (``run_resilient(step_times_fn=...)``)."""
        out = np.zeros(self.size, np.float64)
        for f in self.active(step):
            if f.kind == STALL:
                out[f.rank] += f.stall_seconds
        return out

    def congested_links(self, step: int) -> dict:
        """Directed links degraded at ``step``: ``{(src, dst):
        factor}``, overlapping congestions multiplying.  The virtual
        cost-model input of the adaptive-topology chaos bench: a
        harness multiplies each active edge's nominal transfer time by
        the link's factor before billing ``bf_edge_seconds_total``."""
        out: dict = {}
        for f in self.active(step):
            if f.kind == CONGEST:
                key = (f.rank, f.dst)
                out[key] = out.get(key, 1.0) * f.factor
        return out

    def last_onset(self) -> int:
        """The latest fault onset step (0 for an empty plan) — a chaos
        run should train past this to observe recovery."""
        return max((f.step for f in self.faults), default=0)

    def corrupt_batch(self, batch: Any, step: int,
                      ranks: Optional[Sequence[int]] = None) -> Any:
        """Poison the faulted ranks' rows of a rank-major batch.

        Every floating leaf (a tensor on any device, or a numpy array)
        must carry the leading rank axis; faulted ranks' rows are
        overwritten with NaN/Inf on the leaf's own device, which the
        backward pass turns into non-finite gradients on exactly those
        ranks — faults enter the step as its *inputs*, never as new
        shapes.  ``ranks``: the global ranks the rows hold, in order
        (default all ``size`` ranks; a ``ProcessBackend`` process holds
        ``backend.ranks``).  Healthy steps return ``batch`` unchanged (no
        copies); a poisoned leaf is a copy, the input is not mutated."""
        from torch.utils import _pytree as pytree

        codes = self.corrupt_codes(step)
        rows = (np.arange(self.size) if ranks is None
                else np.asarray(list(ranks), np.int64))
        codes = codes[rows]
        if not codes.any():
            return batch

        def poison(leaf):
            if isinstance(leaf, torch.Tensor):
                if not leaf.is_floating_point():
                    return leaf
                if leaf.dim() < 1 or leaf.shape[0] != len(rows):
                    raise ValueError(
                        f"corrupt_batch needs rank-major leaves with "
                        f"leading dim {len(rows)}, got shape "
                        f"{tuple(leaf.shape)}")
                out = leaf.clone()
                for code, value in ((1, float("nan")), (2, float("inf"))):
                    hit = np.flatnonzero(codes == code)
                    if len(hit):
                        out[torch.as_tensor(hit, device=out.device)] = value
                return out
            arr = np.asarray(leaf)
            if not np.issubdtype(arr.dtype, np.floating):
                return leaf
            if arr.ndim < 1 or arr.shape[0] != len(rows):
                raise ValueError(
                    f"corrupt_batch needs rank-major leaves with leading "
                    f"dim {len(rows)}, got shape {arr.shape}")
            arr = arr.copy()
            arr[codes == 1] = np.nan
            arr[codes == 2] = np.inf
            return arr

        return pytree.tree_map(poison, batch)

    def __repr__(self):
        return f"FaultPlan(size={self.size}, faults={list(self.faults)})"


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

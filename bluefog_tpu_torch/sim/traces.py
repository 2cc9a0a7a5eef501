"""Trace layer: request traces and churn schedules for fleet sims.

Port of ``bluefog_tpu/sim/traces.py``, copied unchanged.  Arrival
*time* generation lives in :mod:`bluefog_tpu_torch.benchutil`
(``poisson_arrivals`` / ``diurnal_arrivals`` / ``flash_crowd_arrivals``
— seeded, property-tested); this module shapes those timestamps into
full request traces (prompt lengths, decode budgets, deadlines) and
turns fault semantics into explicit membership churn schedules.

Churn rides the repo's existing fault vocabulary rather than inventing
one: :meth:`ChurnSchedule.from_fault_plan` derives ``die`` actions from
``FaultPlan.dead_ranks`` deltas and ``admit``/``promote`` rejoin
actions for ``rejoinable_ranks``, so the same deterministic plan object
that drives a real chaos run drives the simulated membership
controller.  Everything is a pure function of its seed/plan — no
wall-clock reads, no unseeded randomness.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["RequestTrace", "ChurnAction", "ChurnSchedule"]


@dataclasses.dataclass(frozen=True)
class RequestTrace:
    """A seeded request workload: ``arrivals[i]`` virtual seconds,
    ``prompt_lens[i]`` prompt tokens, ``budgets[i]`` max new tokens
    (and optional absolute ``deadlines[i]``)."""

    arrivals: np.ndarray
    prompt_lens: np.ndarray
    budgets: np.ndarray
    deadlines: Optional[np.ndarray] = None

    def __post_init__(self):
        n = self.arrivals.shape[0]
        for name in ("prompt_lens", "budgets"):
            a = getattr(self, name)
            if a.shape[0] != n:
                raise ValueError(f"{name} has {a.shape[0]} entries for "
                                 f"{n} arrivals")
        if self.deadlines is not None and self.deadlines.shape[0] != n:
            raise ValueError("deadlines length mismatch")

    @property
    def n(self) -> int:
        return int(self.arrivals.shape[0])

    @classmethod
    def build(cls, arrivals, *, seed: int,
              prompt_len: Tuple[int, int] = (4, 16),
              new_tokens: Tuple[int, int] = (4, 16),
              deadline_slack: Optional[float] = None) -> "RequestTrace":
        """Draw lengths/budgets from ``RandomState(seed)`` uniformly in
        the inclusive ranges (the shape the serving benches use); with
        ``deadline_slack`` each request gets an absolute deadline
        ``arrival + slack``."""
        arrivals = np.asarray(arrivals, np.float64)
        rs = np.random.RandomState(seed)
        n = arrivals.shape[0]
        lens = rs.randint(prompt_len[0], prompt_len[1] + 1,
                          n).astype(np.int64)
        budgets = rs.randint(new_tokens[0], new_tokens[1] + 1,
                             n).astype(np.int64)
        deadlines = (arrivals + float(deadline_slack)
                     if deadline_slack is not None else None)
        return cls(arrivals=arrivals, prompt_lens=lens,
                   budgets=budgets, deadlines=deadlines)


@dataclasses.dataclass(frozen=True, order=True)
class ChurnAction:
    """One membership transition at a virtual step: ``die`` (LIVE →
    DEAD through ``mark_dead``), ``admit`` (DEAD → JOINING), or
    ``promote`` (JOINING → LIVE) — the real controller's verbs."""

    step: int
    rank: int
    action: str

    _ACTIONS = ("die", "admit", "promote")

    def __post_init__(self):
        if self.action not in self._ACTIONS:
            raise ValueError(f"unknown churn action {self.action!r} "
                             f"(one of {self._ACTIONS})")


class ChurnSchedule:
    """A deterministic, step-indexed list of membership transitions."""

    def __init__(self, actions: Sequence[ChurnAction] = ()):
        self.actions: Tuple[ChurnAction, ...] = tuple(
            sorted(actions))

    def at(self, step: int) -> List[ChurnAction]:
        """Actions due exactly at ``step`` (drivers apply them before
        the step's control-plane tick — membership transitions are
        structural, they bypass patience)."""
        return [a for a in self.actions if a.step == step]

    @property
    def ranks(self) -> List[int]:
        return sorted({a.rank for a in self.actions})

    @classmethod
    def from_fault_plan(cls, plan, steps: int, *,
                        admit_after: int = 0,
                        promote_after: int = 16) -> "ChurnSchedule":
        """Derive churn from a :class:`~bluefog_tpu_torch.resilience.faults
        .FaultPlan`: a rank entering ``dead_ranks``/``preempted_ranks``
        at step *s* dies at *s*; the first step a rank shows up in
        ``rejoinable_ranks`` (its preempt window ended, nothing else
        holds it) it is admitted ``admit_after`` steps later and
        promoted ``promote_after`` steps after that — the sim ticks the
        controller's bootstrap anneal in between.  One admission per
        rank (re-preemption after a rejoin emits a fresh ``die`` but no
        second rejoin — keep plans simple enough to read)."""
        actions: List[ChurnAction] = []
        prev: set = set()
        admitted: set = set()
        for s in range(steps):
            down = set(int(r) for r in plan.dead_ranks(s))
            down |= set(int(r) for r in plan.preempted_ranks(s))
            for r in sorted(down - prev):
                actions.append(ChurnAction(s, r, "die"))
            for r in sorted(set(int(r) for r in
                                plan.rejoinable_ranks(s)) - admitted):
                s_admit = s + int(admit_after)
                s_promote = s_admit + int(promote_after)
                if s_admit < steps:
                    actions.append(ChurnAction(s_admit, r, "admit"))
                if s_promote < steps:
                    actions.append(ChurnAction(s_promote, r, "promote"))
                admitted.add(r)
            prev = down
        return cls(actions)

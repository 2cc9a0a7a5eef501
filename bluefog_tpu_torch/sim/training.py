"""Simulated training fleet: the REAL control plane at virtual scale.

Port of ``bluefog_tpu/sim/training.py``, copied unchanged over the
port's control plane, membership controller and straggler detector.

The training-side actor owns no model and no optimizer — what it
drives per virtual step is exactly the control-plane stack a real
``run_resilient`` loop drives, unmodified:

* the :class:`~bluefog_tpu_torch.sim.wire.LinkWire` bills the live round's
  healed active edges into ``bf_edge_seconds_total`` (the telemetry
  feed) and returns the bottleneck-link charge;
* the :class:`~bluefog_tpu_torch.observe.fleet.StragglerDetector` folds the
  per-rank virtual step-time vector (base + wire + injected stalls);
* the :class:`~bluefog_tpu_torch.topology.TopologyControlPlane` runs its
  window/patience/margin/probation state machine over those windowed
  deltas and the straggler z snapshot — triggers, synthesizes over the
  calibrated pod, hot-swaps, commits;
* the :class:`~bluefog_tpu_torch.elastic.MembershipController` takes churn
  (``mark_dead``/``admit``/``tick``/``promote``) and re-renders the
  healed + bootstrap-annealed comm weights after every transition and
  every swap — the same ``healing``/``bootstrap`` re-planning a live
  fleet re-delivers to its compiled step.

The step clock is the calibrated cost model: one step costs
``train_step_s`` of device compute plus the wire's bottleneck charge
in virtual seconds, and the fleet advances at the slowest LIVE rank's
pace (lockstep with stalls, the straggler's signature).  Every control
event lands in the shared :class:`~bluefog_tpu_torch.sim.engine.EventLog`
with scalar detail only — byte-stable, digestible.

This is what makes n=1024 claims checkable on one CPU: the eigvals in
``score_active`` are ~0.9 s at 1024 ranks, so a scenario with a
handful of re-plan triggers runs in seconds while every decision —
degraded-window detection, candidate scoring, swap, membership
round-trip — is made by the production code path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.sim.clock import VirtualClock
from bluefog_tpu_torch.sim.cost import CostModel
from bluefog_tpu_torch.sim.engine import EventLog, Simulation
from bluefog_tpu_torch.sim.traces import ChurnSchedule
from bluefog_tpu_torch.sim.wire import LinkWire

__all__ = ["SimTrainingFleet"]

_SCALARS = (int, float, str, bool, np.integer, np.floating, np.bool_)


class SimTrainingFleet:
    """Virtual-time lockstep training fleet over real control parts.

    Args:
      control: a real :class:`TopologyControlPlane` (typically
        ``synchronous=True`` with a ``candidates_fn`` menu at large n).
      wire: the :class:`LinkWire` billing the control plane's registry;
        its ``schedule_fn`` should close over
        ``control.active_schedule()`` so post-swap billing follows the
        swap — the closed loop.
      membership: optional real :class:`MembershipController`; churn
        actions route through it and weight re-renders come from
        ``comm_weight_arrays()`` (healed + annealed, the real paths).
      straggler: optional real :class:`StragglerDetector` fed the
        per-rank virtual step-time vector each step.
      fault_plan: optional :class:`FaultPlan` supplying per-rank stall
        seconds (congestion enters through the wire's
        ``congestion_fn``, churn through ``churn``).
      churn: optional :class:`ChurnSchedule`; without a membership
        controller ``die`` actions only flip the fleet's dead mask.
      params_fn: optional ``step -> params`` proxy for the control
        plane's probation health checks (``None`` ⇒ probation commits
        on schedule, the r16 default for healthy swaps).
    """

    def __init__(self, *, control, wire: Optional[LinkWire] = None,
                 membership=None, straggler=None, fault_plan=None,
                 churn: Optional[ChurnSchedule] = None,
                 cost: Optional[CostModel] = None,
                 sim: Optional[Simulation] = None,
                 params_fn=None):
        self.control = control
        self.wire = wire
        self.membership = membership
        self.straggler = straggler
        self.fault_plan = fault_plan
        self.churn = churn if churn is not None else ChurnSchedule()
        self.cost = cost if cost is not None else CostModel()
        self.sim = sim if sim is not None else Simulation()
        self.clock: VirtualClock = self.sim.clock
        self.log: EventLog = self.sim.log
        self.params_fn = params_fn
        self.n = control.pod.size
        self._dead = np.zeros(self.n, bool)
        self.step_times: List[Tuple[int, float]] = []
        self.events: List[Tuple[str, int, dict]] = []
        self.weight_renders = 0
        self.step = 0

    # -- views ---------------------------------------------------------- #
    def dead_mask(self) -> np.ndarray:
        if self.membership is not None:
            return np.asarray(self.membership.effective_dead_mask(),
                              bool)
        return self._dead.copy()

    def _record(self, kind: str, step: int, detail: dict,
                actor: str = "") -> None:
        self.events.append((kind, step, detail))
        scalars = {k: v for k, v in detail.items()
                   if isinstance(v, _SCALARS)}
        self.log.record(self.clock.t, kind, actor, step=step,
                        **scalars)

    def _render_weights(self) -> None:
        """Re-deliver comm weights the way a live fleet would: the
        membership controller's healed + bootstrap-annealed render
        when elastic, the plane's healed swap weights otherwise — both
        REAL re-planning paths, counted so scenarios can assert they
        ran."""
        if self.membership is not None:
            self.membership.comm_weight_arrays()
        else:
            from bluefog_tpu_torch.topology.control import swap_comm_weights

            swap_comm_weights(self.control, self.dead_mask())
        self.weight_renders += 1

    def _apply_churn(self, step: int) -> None:
        if self.membership is not None:
            # stamp the virtual step so membership decisions land at
            # the right step in the flight recorder's causal chains
            self.membership.current_step = step
        for a in self.churn.at(step):
            if self.membership is not None:
                if a.action == "die":
                    self.membership.mark_dead(a.rank)
                elif a.action == "admit":
                    self.membership.admit(a.rank)
                elif a.action == "promote":
                    self.membership.promote(a.rank)
            if a.action == "die":
                self._dead[a.rank] = True
            elif a.action == "promote":
                self._dead[a.rank] = False
            self._record(f"membership_{a.action}", step,
                         {"rank": a.rank})
            self._render_weights()

    # -- the loop ------------------------------------------------------- #
    def run(self, steps: int) -> dict:
        for _ in range(steps):
            step = self.step
            self.sim.run(until=self.clock.t)
            self._apply_churn(step)
            if self.membership is not None:
                self.membership.tick()
            dead = self.dead_mask()
            charge = self.wire.bill(step) if self.wire is not None \
                else 0.0
            base = self.cost.train_step_s + self.cost.wire_s(charge)
            per_rank = np.full(self.n, base, np.float64)
            if self.fault_plan is not None:
                per_rank += self.fault_plan.stall_seconds_by_rank(step)
            if self.straggler is not None:
                for r in self.straggler.observe(per_rank):
                    self._record("straggler", step, {"rank": int(r)})
            # the real loop (run_resilient) advances its step counter
            # BEFORE consulting the plane: on_step runs at the step
            # BOUNDARY, so the window that closes at a boundary holds
            # exactly the bills of the steps before it.  Mirror that —
            # it is what makes sim and real trigger on the same step.
            boundary = step + 1
            params = (self.params_fn(boundary)
                      if self.params_fn is not None else None)
            for kind, detail in self.control.on_step(
                    boundary, dead_mask=dead, params=params):
                self._record(kind, boundary, detail)
                if kind in ("topology_swap", "topology_rollback"):
                    if self.membership is not None:
                        self.membership.reschedule(
                            self.control.active_schedule())
                    self._render_weights()
            live = ~dead
            step_s = float(per_rank[live].max()) if live.any() \
                else base
            self.clock.advance(step_s)
            self.step_times.append((step, step_s))
            self.step += 1
        return self.summary()

    # -- claims --------------------------------------------------------- #
    def p50_step_s(self, lo: int, hi: int) -> float:
        """Median virtual step seconds over complete wire periods in
        ``[lo, hi)`` (falls back to a plain median without a wire)."""
        period = self.wire.period if self.wire is not None else 1
        by_step = dict(self.step_times)
        means = []
        first = (lo + period - 1) // period
        for p in range(first, hi // period):
            steps = range(p * period, (p + 1) * period)
            if all(s in by_step for s in steps):
                means.append(float(np.mean([by_step[s]
                                            for s in steps])))
        return float(np.median(means)) if means else float("nan")

    def detect_to_swap(self, onset_step: int) -> dict:
        """Latency from a degradation's onset to the control plane's
        hot-swap: steps and virtual seconds (NaN/None when no swap
        followed the onset)."""
        swap = next((s for k, s, _ in self.events
                     if k == "topology_swap" and s >= onset_step), None)
        if swap is None:
            return {"swap_step": None, "steps": None,
                    "virtual_seconds": float("nan")}
        secs = sum(t for s, t in self.step_times
                   if onset_step <= s <= swap)
        return {"swap_step": int(swap),
                "steps": int(swap - onset_step),
                "virtual_seconds": float(secs)}

    def summary(self) -> dict:
        kinds: Dict[str, int] = {}
        for k, _, _ in self.events:
            kinds[k] = kinds.get(k, 0) + 1
        return {
            "ranks": self.n,
            "steps": self.step,
            "virtual_seconds": self.clock.t,
            "dead": int(self.dead_mask().sum()),
            "active_schedule": self.control.active_name(),
            "weight_renders": self.weight_renders,
            "event_counts": dict(sorted(kinds.items())),
            "events": self.log.n,
            "event_digest": self.log.digest(),
        }

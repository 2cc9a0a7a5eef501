"""Closed-loop topology control plane: detect, re-plan, hot-swap.

Port of ``bluefog_tpu/topology/control.py``: the host-side state machine
is the JAX package's numpy, copied, so the two planes take the same
decisions on the same telemetry.  What differs: the probation health
signal (:func:`_consensus_distance`) reads the port's rank-major tensors
on their own device in float64 with one host transfer; the delivered
tables are :func:`~bluefog_tpu_torch.resilience.healing.
healed_comm_weights`' float64 tensors; and a hot swap is new weight DATA
for the one guarded step object the loop built, where the JAX package
counts zero recompiles.

``compile_topology`` (the TACCL-style sketch-guided synthesis) is a
one-shot planner: it prices links once and emits a schedule.  A fleet
is not one-shot — a DCN link congests, a rank turns into a persistent
straggler, an elastic shrink removes a quarter of the machines — and a
stale plan keeps mixing over exactly the links that telemetry says got
expensive.  This module closes the loop:

* **detect** — every ``window`` steps the plane reads windowed DELTAS of
  the per-edge timing counters (:class:`~bluefog_tpu_torch.observe.fleet.
  TrafficDeltas` over ``bf_edge_seconds_total``; lifetime totals would
  drown a new hotspot in history), the
  :meth:`~bluefog_tpu_torch.observe.fleet.StragglerDetector.z_scores`
  snapshot, and the live-set.  An edge is DEGRADED when its measured
  seconds-per-activation, normalized by its nominal link cost, exceeds
  the fleet-wide median by ``degrade_ratio`` — a relative test, so the
  units of the counters cancel and uniformly busy links never trip it.
  Degradation must persist ``patience`` consecutive windows before
  anything happens (debounce); a membership transition is structural
  and triggers immediately.

* **re-plan** — a trigger launches synthesis in a background thread
  (``synchronous=True`` runs it inline for deterministic tests):
  the pod is re-priced from the window's telemetry
  (:meth:`PodSpec.calibrated` over the seconds deltas, plus synthetic
  load on every edge incident to a flagged straggler), and candidates
  come from ``compile_topology`` (flat and, when the pod has >= 2
  machines, ``hierarchical=True`` flattened to rank rounds), the fixed
  menu, and structured live-machine rings.  Every candidate is
  *projected* onto the carrier and re-scored under the current dead
  mask; the winner is accepted only if its cost-to-consensus beats the
  re-scored incumbent by ``margin`` (hysteresis: a tie is noise, and
  swapping on noise flaps).

* **hot-swap** — the compiled train step's edge STRUCTURE is baked (the
  declared shift classes fix every table shape), so a candidate is
  deliverable only if each of its rounds' edges is a subset of the
  carrier round it lands on; projection re-expresses it over the
  carrier's declared edges with zero weight on the unused ones.  The
  swap is then pure weight DATA — ``(class_weights, self_weights)``
  pairs from :func:`~bluefog_tpu_torch.resilience.healing.
  healed_comm_weights` over the projected specs, composed with the
  CURRENT dead mask — and the step object never changes.  A fresh
  swap is on probation: the plane
  tracks the params consensus distance and rolls back to the incumbent
  if it worsens past the pre-swap level; ``probation`` clean steps
  commit the candidate.  ``cooldown`` steps must pass between swaps.

All the hysteresis knobs default from ``BLUEFOG_TOPOLOGY_REPLAN_*``
(:mod:`bluefog_tpu_torch.config`).  The one sanctioned place live
weight tables are produced for a running step is
:func:`swap_comm_weights`.

When the train step was built with error-feedback compressed mixing
(``compress="topk"``), the plane also owns the live compression ratio:
``mix_ratios`` is a strictly descending ladder whose first rung is the
BUILD ratio (the static ``k``; every other rung must be below it, since
the live ratio only masks a prefix of the baked wire slots).  The same
windowed degradation signal that triggers a re-plan first tries the
cheaper lever — step one rung DOWN the ladder (fewer wire bytes, pure
data for the same step) — and only synthesizes a new topology
once the ladder is exhausted.  A ratio step is on probation exactly
like a topology swap (consensus health watched, rollback past
tolerance, commit after clean steps), and ``mix_recover_windows``
consecutive clean windows step back UP toward the build ratio, so a
transient congestion event does not permanently coarsen the mixing.
The one sanctioned producer of the live ratio is
:func:`swap_mix_ratio`, feeding ``train_step.set_mix_ratio`` at the
same step boundary ``swap_comm_weights`` delivers weight tables.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

# healing and observability are imported inside the functions that need
# them, as in the JAX package (the resilience package imports the train
# step, which imports the topology package)
from bluefog_tpu_torch import _tree
from bluefog_tpu_torch import config as _config
from bluefog_tpu_torch.topology.compiler import (CompiledAllToAll, PodSpec,
                                                 Sketch, compile_all_to_all,
                                                 compile_topology,
                                                 expand_machine_pairs,
                                                 menu_schedules)
from bluefog_tpu_torch.topology.spec import DynamicTopology
from bluefog_tpu_torch.topology.torus import rounds_from_contraction

__all__ = ["TopologyControlPlane", "swap_comm_weights", "swap_mix_ratio"]

# state machine (docs/topology.md draws it): STEADY watches windows,
# SYNTHESIZING has a re-plan in flight, CANDIDATE_READY holds an
# accepted plan awaiting its step boundary, PROBATION watches a fresh
# swap's health before committing it
STEADY = "steady"
SYNTHESIZING = "synthesizing"
CANDIDATE_READY = "candidate_ready"
PROBATION = "probation"


def swap_comm_weights(plane: "TopologyControlPlane", dead_mask) -> tuple:
    """The sanctioned step-boundary delivery: the ACTIVE (projected)
    schedule healed under the CURRENT dead mask, as operand
    ``(class_weights, self_weights)`` float64 tensor pairs, carrier-
    shaped.  Swap and heal compose through this one helper — re-plan
    from the pristine spec, then re-apply the mask."""
    from bluefog_tpu_torch.resilience.healing import healed_comm_weights

    return healed_comm_weights(plane.active_schedule(), dead_mask)


def swap_mix_ratio(plane: "TopologyControlPlane") -> float:
    """The sanctioned step-boundary delivery for the live compression
    ratio: the plane's active rung of the ``mix_ratios`` ladder, to be
    fed straight into ``train_step.set_mix_ratio`` after a
    ``mix_ratio_swap`` / ``mix_ratio_rollback`` event.  The ratio is
    data for the same step (the static top-k ``k`` was sized for the
    BUILD ratio — the ladder's first rung — and every lower rung only
    masks a prefix of those slots)."""
    return plane.mix_ratio()


def _consensus_distance(params, live: np.ndarray) -> float:
    """Max deviation of the LIVE ranks' rows from their mean, over every
    rank-major leaf — the health signal probation watches.  Leaves
    without a leading rank axis are ignored.  Computed in float64 on
    each leaf's own device, with ONE host transfer at the end (the JAX
    package copies every leaf to the host)."""
    live = np.asarray(live, bool).reshape(-1)
    n = live.shape[0]
    worst = []
    for _, leaf in _tree.leaves(params):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(leaf)
        if not isinstance(leaf, torch.Tensor) or leaf.dim() < 1 \
                or leaf.shape[0] != n:
            continue
        idx = torch.as_tensor(np.flatnonzero(live), device=leaf.device)
        rows = leaf.index_select(0, idx).to(torch.float64)
        if rows.numel() == 0:
            continue
        worst.append((rows - rows.mean(dim=0)).abs().max().to(
            worst[0].device if worst else rows.device))
    if not worst:
        return 0.0
    return float(torch.stack(worst).max().cpu())


def _local_ring_round(machines: int, local: int) -> Optional[DynamicTopology]:
    """One intra-machine mixing round: each chip averages with the next
    chip of its own machine's ICI ring (pure ICI, the cheap round the
    structured candidates interleave between DCN rounds)."""
    if local < 2:
        return None
    n = machines * local
    ew: Dict[Tuple[int, int], float] = {}
    for m in range(machines):
        for j in range(local):
            src = m * local + j
            dst = m * local + (j + 1) % local
            if src != dst:
                ew[(src, dst)] = 0.5
    return DynamicTopology.from_edges(n, ew, [0.5] * n)


def _machine_ring_round(pod: PodSpec, members: Sequence[int],
                        direction: int) -> Optional[DynamicTopology]:
    """One DCN mixing round: a directed ring over ``members`` (machine
    ids, cyclic in the given order and direction), expanded to the
    counterpart rank pairs the hierarchical exchange wires.  Ranks on
    machines outside ``members`` keep self weight 1.0 (they receive
    nothing — healing covers whether they are dead or merely skipped)."""
    k = len(members)
    if k < 2:
        return None
    order = list(members) if direction >= 0 else list(reversed(members))
    mpairs = [(order[i], order[(i + 1) % k]) for i in range(k)]
    pairs = expand_machine_pairs(mpairs, pod.chips_per_machine)
    sw = [1.0] * pod.size
    ew = {}
    for (s, d) in pairs:
        ew[(s, d)] = 0.5
        sw[d] = 0.5
    return DynamicTopology.from_edges(pod.size, ew, sw)


class TopologyControlPlane:
    """See the module docstring.  Drive it from a training loop by
    calling :meth:`on_step` once per completed step (``run_resilient``
    does this when given ``control=``); deliver weights through
    :func:`swap_comm_weights` / :meth:`healed_weights`.

    ``carrier`` is the schedule the train step was COMPILED over — the
    declared edge structure every candidate must project into.
    ``pod`` is the uncalibrated physical cost model; telemetry
    re-prices it per window.  ``registry``/``straggler`` are the
    telemetry sources (both optional; without them only membership
    transitions trigger).  ``candidates_fn(pod, dead_mask)`` overrides
    candidate generation (yields ``(name, schedule)`` pairs).
    ``health_fn(params, live_mask)`` overrides the probation health
    signal.  ``mix_ratios`` (strictly descending, first rung = the
    BUILD ratio) arms the compression-ratio ladder described in the
    module docstring; ``mix_recover_windows`` clean windows step the
    ratio back up toward the build rung."""

    def __init__(self, pod: PodSpec, carrier: Sequence[DynamicTopology], *,
                 sketch: Optional[Sketch] = None,
                 registry=None,
                 straggler=None,
                 contention: float = 3.0,
                 z_threshold: float = 3.0,
                 window: Optional[int] = None,
                 patience: Optional[int] = None,
                 degrade_ratio: Optional[float] = None,
                 margin: Optional[float] = None,
                 cooldown: Optional[int] = None,
                 probation: Optional[int] = None,
                 rollback_tolerance: float = 1.2,
                 eps: float = 1e-3,
                 synchronous: bool = False,
                 use_compiler: bool = True,
                 candidates_fn: Optional[Callable] = None,
                 health_fn: Optional[Callable] = None,
                 initial: Optional[Sequence[DynamicTopology]] = None,
                 mix_ratios: Optional[Sequence[float]] = None,
                 mix_recover_windows: int = 2,
                 blackbox=None):
        carrier = tuple(carrier)
        if not carrier:
            raise ValueError("control plane needs a non-empty carrier "
                             "schedule (the compiled step's rounds)")
        n = carrier[0].size
        if pod.size != n:
            raise ValueError(
                f"pod of size {pod.size} does not match the carrier "
                f"schedule's {n} ranks")
        self.pod = pod
        self.carrier = carrier
        self.sketch = sketch
        self._registry = registry
        self._straggler = straggler
        self._contention = float(contention)
        self._z_threshold = float(z_threshold)
        self.window = int(window if window is not None
                          else _config.topology_replan_window())
        self.patience = int(patience if patience is not None
                            else _config.topology_replan_patience())
        self.degrade_ratio = float(
            degrade_ratio if degrade_ratio is not None
            else _config.topology_replan_degrade_ratio())
        self.margin = float(margin if margin is not None
                            else _config.topology_replan_margin())
        self.cooldown = int(cooldown if cooldown is not None
                            else _config.topology_replan_cooldown())
        self.probation = int(probation if probation is not None
                             else _config.topology_replan_probation())
        self.rollback_tolerance = float(rollback_tolerance)
        self.eps = float(eps)
        self.synchronous = bool(synchronous)
        self.use_compiler = bool(use_compiler)
        self._candidates_fn = candidates_fn
        self._health_fn = health_fn or _consensus_distance
        if mix_ratios is not None:
            ladder = tuple(float(r) for r in mix_ratios)
            if len(ladder) < 2:
                raise ValueError(
                    "mix_ratios needs at least two rungs (the build "
                    "ratio plus one fallback) to be a ladder")
            if any(r <= 0.0 for r in ladder):
                raise ValueError("mix_ratios must all be positive")
            if any(b >= a for a, b in zip(ladder, ladder[1:])):
                raise ValueError(
                    "mix_ratios must be strictly descending — the "
                    "first rung is the BUILD ratio (it sized the "
                    "static k) and every later rung must fit inside "
                    "its wire slots")
            mix_ratios = ladder
        self.mix_ratios = mix_ratios
        self.mix_recover_windows = int(mix_recover_windows)

        from bluefog_tpu_torch.observe.fleet import TrafficDeltas

        self._seconds = TrafficDeltas(registry, metric="bf_edge_seconds_total")
        self._bytes = TrafficDeltas(registry, metric="bf_edge_bytes_total")

        self._lock = threading.Lock()
        self._state = STEADY
        # ``initial`` is the plan actually RUNNING at startup (a carrier
        # usually declares a richer edge set than any one plan uses, so
        # alternatives stay expressible); it must project like any
        # candidate.  Default: the carrier's own weights.
        self._active: Tuple[DynamicTopology, ...] = (
            carrier if initial is None else self.project(initial))
        self._active_name = "carrier" if initial is None else "initial"
        self._previous: Optional[Tuple[DynamicTopology, ...]] = None
        self._previous_name = ""
        self._pending = None  # (name, projected specs, score, ready event)
        self._dead = np.zeros(n, bool)
        self._degraded_streak = 0
        self._membership_pending = False
        self._cooldown_until = 0
        self._probation_end = 0
        self._preswap_health: Optional[float] = None
        self._steps_seen = 0
        self._thread: Optional[threading.Thread] = None
        self._async_events: List[Tuple[str, dict]] = []
        # mix-ratio ladder position: index 0 = the build ratio.  A
        # pending probation mirrors the topology machine's fields but
        # stays independent of ``self._state`` (the topology machine
        # keeps STEADY while a ratio step is on probation).
        self._mix_index = 0
        self._mix_prev_index: Optional[int] = None
        self._mix_probation_end: Optional[int] = None
        self._mix_preswap_health: Optional[float] = None
        self._mix_clean_windows = 0
        # a2a (expert-dispatch) planning state: the last telemetry-
        # calibrated pod a trigger produced, and the a2a schedule
        # compiled against it.  Invalidated whenever a fresh
        # calibration lands, so plan_all_to_all() re-prices lazily.
        self._last_calibrated_pod: Optional[PodSpec] = None
        self._a2a_plan: Optional[CompiledAllToAll] = None
        self.swaps = 0
        self.rollbacks = 0
        self.triggers = 0
        self.mix_swaps = 0
        self.mix_rollbacks = 0
        self.a2a_replans = 0
        self.last_scores: Dict[str, float] = {}
        # decision flight recorder (observe.blackbox).  ``None``
        # records to the process-global ring gated by BLUEFOG_BLACKBOX;
        # an explicit BlackBox records unconditionally; ``False``
        # disables recording (the transparency-check "off" arm).
        # The ``*_event`` fields thread the causal chain: a trigger
        # parents its synthesis, an accepted candidate parents its
        # swap, a swap parents its probation verdict.
        self._blackbox = blackbox
        self._trigger_event = None
        self._swap_event = None
        self._mix_event = None

    # ------------------------------------------------------------ #
    # read-side surface
    # ------------------------------------------------------------ #
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def active_schedule(self) -> Tuple[DynamicTopology, ...]:
        """The schedule currently LIVE in the step — the incumbent, or
        a swapped-in candidate under probation.  Always carrier-shaped
        (same declared edges per round), so its healed weight tables
        fit the compiled step."""
        with self._lock:
            return self._active

    def active_name(self) -> str:
        with self._lock:
            return self._active_name

    def healed_weights(self, dead_mask) -> tuple:
        """:func:`swap_comm_weights` on the active schedule."""
        return swap_comm_weights(self, dead_mask)

    def mix_ratio(self) -> float:
        """The ACTIVE rung of the ``mix_ratios`` ladder (raises when
        the plane was built without one)."""
        if self.mix_ratios is None:
            raise ValueError(
                "this control plane has no mix_ratios ladder — pass "
                "mix_ratios=(build_ratio, ...) to let it drive the "
                "live compression ratio")
        with self._lock:
            return self.mix_ratios[self._mix_index]

    def plan_all_to_all(self, sketch: Optional[Sketch] = None,
                        ) -> CompiledAllToAll:
        """The expert-dispatch all-to-all schedule priced against the
        CURRENT network view: the last telemetry-calibrated pod when a
        trigger has re-priced one, the nominal pod before any window
        fired.  Lazy and cached — each fresh calibration invalidates
        the cache, so the first call after a trigger re-plans (counted
        in ``a2a_replans``) and later calls are free.  The emitted
        rounds feed ``moe.dispatch_plan`` exactly like a cold compile;
        whether a re-planned wire is worth a rebuild is the caller's
        trade, the plane only prices it."""
        with self._lock:
            cached = self._a2a_plan
            pod = self._last_calibrated_pod or self.pod
        if cached is not None:
            return cached
        plan = compile_all_to_all(pod, sketch or self.sketch)
        with self._lock:
            self._a2a_plan = plan
            self.a2a_replans += 1
            self._decide(
                "a2a", "replan", step=self._steps_seen,
                parent=self._trigger_event,
                winner=getattr(plan, "name", None),
                calibrated=pod is not self.pod,
                replans=self.a2a_replans)
        return plan

    # ------------------------------------------------------------ #
    # projection: candidate -> carrier-shaped specs
    # ------------------------------------------------------------ #
    def project(self, schedule: Sequence[DynamicTopology],
                ) -> Tuple[DynamicTopology, ...]:
        """Re-express ``schedule`` over the carrier's declared edges:
        carrier round ``t`` plays candidate round ``t % len(schedule)``
        with the candidate's weights on its own edges and zero on every
        other declared edge.  The declared edge tuples (hence the shift
        classes, hence every table shape the compiled step baked) are
        untouched — that is what makes the swap data for the same
        step.  Raises ``ValueError`` when a candidate edge is not declared by the
        carrier round it lands on (the candidate is unexpressible and
        must be rejected, not silently dropped)."""
        schedule = list(schedule)
        if not schedule:
            raise ValueError("cannot project an empty schedule")
        n = self.carrier[0].size
        out = []
        for t, base in enumerate(self.carrier):
            cand = schedule[t % len(schedule)]
            if cand.size != n:
                raise ValueError(
                    f"candidate round over {cand.size} ranks cannot be "
                    f"projected onto a {n}-rank carrier")
            declared = set(base.edges)
            w = dict(zip(cand.edges, cand.edge_weight_values))
            missing = sorted(e for e, v in w.items()
                             if v != 0.0 and e not in declared)
            if missing:
                raise ValueError(
                    f"candidate round {t % len(schedule)} uses edges "
                    f"{missing[:4]} the carrier round {t} never "
                    f"declared — unexpressible without a rebuild")
            vals = tuple(float(w.get(e, 0.0)) for e in base.edges)
            out.append(DynamicTopology(
                n, base.edges, vals,
                tuple(float(x) for x in cand.self_weight_values)))
        return tuple(out)

    # ------------------------------------------------------------ #
    # scoring: what actually plays, under the actual dead mask
    # ------------------------------------------------------------ #
    def score_active(self, specs: Sequence[DynamicTopology], dead_mask,
                     pod: Optional[PodSpec] = None) -> Dict[str, float]:
        """Cost-to-consensus of a carrier-shaped schedule AS DELIVERED:
        each round healed under ``dead_mask``, per-round cost = the pod
        cost of its remaining nonzero-weight edges (zero-weight edges
        push nothing), contraction measured on the live sub-matrix.
        The incumbent and every candidate are compared through this one
        function, so the margin gate is apples-to-apples."""
        from bluefog_tpu_torch.resilience.healing import (heal_spec,
                                                          mixing_matrix)

        pod = pod or self.pod
        dead = np.asarray(dead_mask, bool).reshape(-1)
        live = ~dead
        k = int(live.sum())
        if k == 0:
            raise ValueError("no live ranks to score")
        healed = [heal_spec(s, dead) for s in specs]
        costs = []
        for h in healed:
            pairs = [e for e, v in zip(h.edges, h.edge_weight_values)
                     if v != 0.0]
            costs.append(pod.round_cost(pairs))
        if k == 1:
            sigma = 0.0
        else:
            P = np.eye(k)
            for h in healed:
                M = mixing_matrix(h)[np.ix_(live, live)]
                P = M @ P
            dev = P - np.full((k, k), 1.0 / k)
            sigma = float(np.max(np.abs(np.linalg.eigvals(dev))))
        r2c = rounds_from_contraction(sigma, len(healed), self.eps)
        mean_cost = float(np.mean(costs)) if costs else 0.0
        return {
            "mean_round_cost": mean_cost,
            "max_round_cost": float(np.max(costs)) if costs else 0.0,
            "sigma": sigma,
            "rounds_to_consensus": r2c,
            "cost_to_consensus": mean_cost * r2c,
        }

    # ------------------------------------------------------------ #
    # candidate generation
    # ------------------------------------------------------------ #
    def _default_candidates(self, pod: PodSpec, dead: np.ndarray):
        """(name, schedule) candidates: synthesized (flat + flattened
        hierarchical), the fixed menu, and structured live-machine
        rings with 1 or 2 ICI rounds per DCN round (a smaller live
        fleet needs less DCN mixing per unit contraction, and the
        scorer — not this generator — decides whether that pays)."""
        out: List[Tuple[str, List[DynamicTopology]]] = []
        L = pod.chips_per_machine
        dead_m = dead.reshape(pod.machines, L).all(axis=1)
        live_machines = [m for m in range(pod.machines) if not dead_m[m]]
        ici = _local_ring_round(pod.machines, L)
        for direction in (+1, -1):
            ring = _machine_ring_round(pod, live_machines, direction)
            if ring is None:
                continue
            tag = "+1" if direction > 0 else "-1"
            if ici is not None:
                out.append((f"ring:{tag}:ici1", [ici, ring]))
                out.append((f"ring:{tag}:ici2", [ici, ici, ring]))
            else:
                out.append((f"ring:{tag}", [ring]))
        for name, sched in menu_schedules(pod).items():
            out.append((f"menu:{name}", list(sched)))
        if self.use_compiler:
            try:
                flat = compile_topology(pod, self.sketch, eps=self.eps)
                out.append((f"synth:{flat.name}", list(flat.schedule)))
            except ValueError:
                pass
            if pod.machines >= 2:
                try:
                    hier = compile_topology(pod, self.sketch, eps=self.eps,
                                            hierarchical=True)
                    rounds: List[DynamicTopology] = []
                    for mr in hier.machine_schedule:
                        if ici is not None:
                            rounds.append(ici)
                        pairs = expand_machine_pairs(list(mr.edges), L)
                        mw = dict(zip(mr.edges, mr.edge_weight_values))
                        ew = {}
                        sw = [0.0] * pod.size
                        for m in range(pod.machines):
                            for j in range(L):
                                sw[m * L + j] = float(
                                    mr.self_weight_values[m])
                        for (ms, md) in mr.edges:
                            for j in range(L):
                                ew[(ms * L + j, md * L + j)] = float(
                                    mw[(ms, md)])
                        rounds.append(DynamicTopology.from_edges(
                            pod.size, ew, sw))
                    if rounds:
                        out.append((f"synth:{hier.name}", rounds))
                except ValueError:
                    pass
        return out

    # ------------------------------------------------------------ #
    # telemetry window
    # ------------------------------------------------------------ #
    def _edge_activations(self) -> Dict[Tuple[int, int], int]:
        counts: Dict[Tuple[int, int], int] = {}
        for spec in self._active:
            for e, v in zip(spec.edges, spec.edge_weight_values):
                if v != 0.0:
                    counts[e] = counts.get(e, 0) + 1
        return counts

    def _window_degraded(self, secs: Dict[tuple, float],
                         z: Dict[int, float]) -> Tuple[bool, float]:
        """(degraded, worst_pressure): pressure of an edge = measured
        seconds per activation / nominal link cost, divided by the
        fleet-wide median of the same quantity.  Relative, so counter
        units cancel; > ``degrade_ratio`` marks the window degraded.
        A straggler z at/over threshold degrades the window too."""
        norms = {}
        counts = self._edge_activations()
        for e, s in secs.items():
            c = counts.get(e)
            if not c or s <= 0.0:
                continue
            nominal = self.pod.round_cost([e])
            if nominal <= 0.0:
                continue
            norms[e] = (s / c) / nominal
        worst = 0.0
        if len(norms) >= 2:
            med = float(np.median(list(norms.values())))
            if med > 0.0:
                worst = max(v / med for v in norms.values())
        z_hot = max(z.values(), default=0.0) >= self._z_threshold
        return (worst >= self.degrade_ratio or z_hot), worst

    def _calibration_traffic(self, secs: Dict[tuple, float],
                             z: Dict[int, float],
                             ) -> Dict[Tuple[int, int], float]:
        """The per-edge traffic the window's re-pricing feeds into
        :meth:`PodSpec.calibrated`: seconds deltas, plus synthetic load
        on every active edge incident to a flagged straggler (slow
        rank => expensive links => synthesis routes around it).  Pure
        given ``(secs, z)`` and the current active edge set — the
        decision recorder snapshots this dict so replay never has to
        reconstruct the activation state."""
        n = self.pod.size
        traffic = {k: float(v) for k, v in secs.items()
                   if 0 <= k[0] < n and 0 <= k[1] < n}
        hot = [r for r, v in z.items() if v >= self._z_threshold]
        if hot:
            base = max(traffic.values(), default=1.0)
            for e in self._edge_activations():
                for r in hot:
                    if r in e:
                        traffic[e] = (traffic.get(e, 0.0)
                                      + base * z[r] / self._z_threshold)
        return traffic

    def _pod_from_traffic(self, traffic: Dict[Tuple[int, int], float],
                          ) -> PodSpec:
        if not traffic:
            return self.pod
        return self.pod.calibrated(traffic, contention=self._contention)

    def _calibrated_pod(self, secs: Dict[tuple, float],
                        z: Dict[int, float]) -> PodSpec:
        """The window's re-priced pod (see
        :meth:`_calibration_traffic`)."""
        return self._pod_from_traffic(self._calibration_traffic(secs, z))

    # ------------------------------------------------------------ #
    # decision flight recorder
    # ------------------------------------------------------------ #
    def _decide(self, plane: str, kind: str, *, step: int, parent=None,
                telemetry=None, candidates=None, winner=None,
                winner_cost=None, margin=None, **detail):
        """The one blackbox emission seam of this plane.  Returns the
        recorded event or ``None`` when the recorder is off — callers
        thread ``None`` parents through."""
        from bluefog_tpu_torch.observe import blackbox as _blackbox

        return _blackbox.record_decision(
            plane, kind, step=step, parent=parent, telemetry=telemetry,
            candidates=candidates, winner=winner,
            winner_cost=winner_cost, margin=margin,
            blackbox=self._blackbox, detail=detail or None)

    def _telemetry_snapshot(self, reason: str,
                            secs: Dict[tuple, float],
                            z: Dict[int, float],
                            dead: np.ndarray,
                            traffic: Dict[Tuple[int, int], float],
                            ) -> dict:
        """The canonical (digestable, replayable) record of everything
        a trigger saw: windowed edge-seconds deltas, straggler
        z-scores, the dead set, the derived calibration traffic, and
        the incumbent's name.  Keys are strings so the snapshot
        round-trips through JSONL dumps unchanged."""
        return {
            "reason": str(reason),
            "incumbent": self._active_name,
            "secs": {f"{a}-{b}": float(v)
                     for (a, b), v in sorted(secs.items())},
            "z": {str(r): float(v) for r, v in sorted(z.items())},
            "dead": [int(i) for i in np.flatnonzero(dead)],
            "traffic": {f"{a}-{b}": float(v)
                        for (a, b), v in sorted(traffic.items())},
        }

    def replay_decision(self, event, schedules) -> Dict[str, object]:
        """Re-derive a recorded ``synthesize`` decision from its OWN
        telemetry snapshot: rebuild the calibrated pod from the
        recorded traffic, re-project and re-score every recorded
        candidate (``schedules`` maps candidate/incumbent names back to
        their schedules), and return the winner/cost/margin that fall
        out.  The fleet-sim replay-verification pass machine-checks
        these against the event's recorded fields — "the fleet's
        decisions are reproducible from its own audit log"."""
        tele = event.telemetry
        traffic = {tuple(int(x) for x in k.split("-")): float(v)
                   for k, v in tele.get("traffic", {}).items()}
        pod = self._pod_from_traffic(traffic)
        dead = np.zeros(self.pod.size, bool)
        for i in tele.get("dead", ()):
            dead[int(i)] = True
        inc_name = tele.get("incumbent")
        costs: Dict[str, float] = {}
        for key in (event.candidates or {}):
            name = inc_name if key == "incumbent" else key
            proj = self.project(schedules[name])
            costs[key] = self.score_active(
                proj, dead, pod)["cost_to_consensus"]
        ranked = [k for k in costs if k != "incumbent"]
        if not ranked:
            return {"winner": None, "winner_cost": None,
                    "margin": None, "costs": costs}
        best = ranked[0]
        for k in ranked[1:]:
            if costs[k] < costs[best]:
                best = k
        inc = costs.get("incumbent")
        margin = (1.0 - costs[best] / inc
                  if inc is not None and inc > 0.0 else None)
        return {"winner": best, "winner_cost": costs[best],
                "margin": margin, "costs": costs}

    def replay_mix_decision(self, event) -> Dict[str, object]:
        """Re-derive a recorded mix-ladder move from its telemetry:
        the ladder is a fixed menu, so the "scoring" is the rung
        arithmetic — ``degraded`` steps down (coarser, fewer wire
        bytes), anything else steps up toward the build ratio."""
        tele = event.telemetry
        ladder = [float(r) for r in tele.get("ladder", ())]
        frm = int(tele["from_index"])
        to = frm + 1 if tele.get("reason") == "degraded" else frm - 1
        if not 0 <= to < len(ladder):
            return {"winner": None, "winner_cost": None, "to_index": to}
        return {"winner": format(ladder[to], ".9g"),
                "winner_cost": ladder[to], "to_index": to}

    # ------------------------------------------------------------ #
    # synthesis (background or inline)
    # ------------------------------------------------------------ #
    def _synthesize(self, pod: PodSpec, dead: np.ndarray,
                    step: Optional[int] = None,
                    telemetry: Optional[dict] = None,
                    trigger_ev=None) -> None:
        gen = self._candidates_fn or self._default_candidates
        incumbent = self.score_active(self._active, dead, pod)
        inc_cost = incumbent["cost_to_consensus"]
        scored: Dict[str, float] = {"incumbent": inc_cost}
        best = None
        for name, sched in gen(pod, dead):
            try:
                proj = self.project(sched)
            except ValueError:
                continue
            sc = self.score_active(proj, dead, pod)
            if not math.isfinite(sc["cost_to_consensus"]):
                continue
            scored[name] = sc["cost_to_consensus"]
            if best is None or (sc["cost_to_consensus"]
                                < best[2]["cost_to_consensus"]):
                best = (name, proj, sc)
        achieved = (1.0 - best[2]["cost_to_consensus"] / inc_cost
                    if best is not None and inc_cost > 0.0 else None)
        step = self._steps_seen if step is None else step
        with self._lock:
            self.last_scores = {
                "incumbent": inc_cost,
                "candidate": (best[2]["cost_to_consensus"]
                              if best else float("inf")),
            }
            synth_ev = self._decide(
                "topology", "synthesize", step=step, parent=trigger_ev,
                telemetry=telemetry, candidates=scored,
                winner=best[0] if best else None,
                winner_cost=best[2]["cost_to_consensus"] if best else None,
                margin=achieved)
            bar = inc_cost * (1.0 - self.margin)
            if best is not None and best[2]["cost_to_consensus"] < bar:
                ready_ev = self._decide(
                    "topology", "candidate_ready", step=step,
                    parent=synth_ev, winner=best[0],
                    winner_cost=best[2]["cost_to_consensus"])
                self._pending = (best[0], best[1], best[2], ready_ev)
                self._state = CANDIDATE_READY
            else:
                self._decide(
                    "topology", "reject", step=step, parent=synth_ev,
                    winner=best[0] if best else None,
                    winner_cost=(best[2]["cost_to_consensus"]
                                 if best else None),
                    margin=achieved, bar=bar)
                self._async_events.append(("topology_reject", {
                    "reason": "margin",
                    "incumbent": inc_cost,
                    "best": (best[2]["cost_to_consensus"]
                             if best else None),
                    "candidate": best[0] if best else None,
                }))
                self._state = STEADY
                self._degraded_streak = 0
                self._cooldown_until = self._steps_seen + self.cooldown

    def force_candidate(self, schedule: Sequence[DynamicTopology],
                        name: str = "forced") -> None:
        """Queue ``schedule`` for the next step boundary, bypassing the
        margin gate (projection is still enforced — an unexpressible
        plan raises).  The chaos bench uses this to inject a known-bad
        candidate and machine-check that probation rolls it back.
        The forced path records the same trigger→synthesize→
        candidate_ready chain a telemetry trigger would, so the audit
        trail of the injected swap reads like any other."""
        proj = self.project(schedule)
        with self._lock:
            step = self._steps_seen
            incumbent = self.score_active(self._active, self._dead)
            sc = self.score_active(proj, self._dead)
            inc_cost = incumbent["cost_to_consensus"]
            achieved = (1.0 - sc["cost_to_consensus"] / inc_cost
                        if inc_cost > 0.0 else None)
            self.last_scores = {
                "incumbent": inc_cost,
                "candidate": sc["cost_to_consensus"],
            }
            tele = self._telemetry_snapshot(
                "forced", {}, {}, self._dead, {})
            trig_ev = self._decide(
                "topology", "trigger", step=step, telemetry=tele)
            synth_ev = self._decide(
                "topology", "synthesize", step=step, parent=trig_ev,
                telemetry=tele,
                candidates={"incumbent": inc_cost,
                            name: sc["cost_to_consensus"]},
                winner=name, winner_cost=sc["cost_to_consensus"],
                margin=achieved)
            ready_ev = self._decide(
                "topology", "candidate_ready", step=step,
                parent=synth_ev, winner=name,
                winner_cost=sc["cost_to_consensus"])
            self._trigger_event = trig_ev
            self._pending = (name, proj, sc, ready_ev)
            self._state = CANDIDATE_READY

    # ------------------------------------------------------------ #
    # the per-step boundary hook
    # ------------------------------------------------------------ #
    def on_step(self, step: int, *, dead_mask=None,
                params=None) -> List[Tuple[str, dict]]:
        """Advance the control loop at a step boundary.  Returns
        ``(kind, detail)`` events — ``topology_trigger`` /
        ``topology_reject`` / ``topology_swap`` / ``topology_commit`` /
        ``topology_rollback``.  After a ``topology_swap`` or
        ``topology_rollback`` the caller must re-deliver weights
        (:func:`swap_comm_weights`); ``run_resilient`` does both."""
        events: List[Tuple[str, dict]] = []
        n = self.pod.size
        dead = (np.zeros(n, bool) if dead_mask is None
                else np.asarray(dead_mask, bool).reshape(-1))
        with self._lock:
            self._steps_seen = step
            events.extend(self._async_events)
            self._async_events = []
            if not np.array_equal(dead, self._dead):
                self._dead = dead.copy()
                self._membership_pending = True
            state = self._state
            # probation verdict first: a bad swap must not linger
            if state == PROBATION:
                if params is not None:
                    health = self._health_fn(params, ~dead)
                    if self._preswap_health is None:
                        self._preswap_health = health
                    elif health > (self._preswap_health
                                   * self.rollback_tolerance) + 1e-12:
                        self._active = self._previous
                        self._active_name = self._previous_name
                        self._previous = None
                        self._state = STEADY
                        self._degraded_streak = 0
                        self._cooldown_until = step + self.cooldown
                        self.rollbacks += 1
                        self._count("rollback")
                        self._decide(
                            "topology", "rollback", step=step,
                            parent=self._swap_event,
                            winner=self._active_name,
                            health=health,
                            preswap_health=self._preswap_health)
                        self._swap_event = None
                        events.append(("topology_rollback", {
                            "restored": self._active_name,
                            "health": health,
                            "preswap_health": self._preswap_health,
                        }))
                        return events
                if step >= self._probation_end:
                    self._previous = None
                    self._state = STEADY
                    self._degraded_streak = 0
                    self._cooldown_until = step + self.cooldown
                    self._count("commit")
                    self._decide(
                        "topology", "commit", step=step,
                        parent=self._swap_event,
                        winner=self._active_name)
                    self._swap_event = None
                    events.append(("topology_commit",
                                   {"schedule": self._active_name}))
                return events
            # mix-ratio probation verdict: mirrors the topology
            # machine's, but independently of ``self._state`` (which
            # stays STEADY while a ratio step is on probation)
            if self._mix_probation_end is not None:
                if params is not None:
                    health = self._health_fn(params, ~dead)
                    if self._mix_preswap_health is None:
                        self._mix_preswap_health = health
                    elif health > (self._mix_preswap_health
                                   * self.rollback_tolerance) + 1e-12:
                        restored = self._mix_prev_index
                        bad = self._mix_index
                        preswap = self._mix_preswap_health
                        self._mix_index = restored
                        self._mix_prev_index = None
                        self._mix_probation_end = None
                        self._mix_preswap_health = None
                        self._cooldown_until = step + self.cooldown
                        self.mix_rollbacks += 1
                        self._count("mix_rollback")
                        self._decide(
                            "mix", "rollback", step=step,
                            parent=self._mix_event,
                            winner=format(self.mix_ratios[restored],
                                          ".9g"),
                            health=health, preswap_health=preswap)
                        self._mix_event = None
                        events.append(("mix_ratio_rollback", {
                            "restored": self.mix_ratios[restored],
                            "ratio": self.mix_ratios[bad],
                            "health": health,
                            "preswap_health": preswap,
                        }))
                        return events
                if step >= self._mix_probation_end:
                    self._mix_prev_index = None
                    self._mix_probation_end = None
                    self._mix_preswap_health = None
                    self._cooldown_until = step + self.cooldown
                    self._count("mix_commit")
                    self._decide(
                        "mix", "commit", step=step,
                        parent=self._mix_event,
                        winner=format(self.mix_ratios[self._mix_index],
                                      ".9g"))
                    self._mix_event = None
                    events.append(("mix_ratio_commit", {
                        "ratio": self.mix_ratios[self._mix_index]}))
                return events
            if state == CANDIDATE_READY and self._pending is not None:
                name, proj, sc, ready_ev = self._pending
                self._pending = None
                self._previous = self._active
                self._previous_name = self._active_name
                self._active = proj
                self._active_name = name
                self._preswap_health = (
                    self._health_fn(params, ~dead)
                    if params is not None else None)
                self._state = PROBATION
                self._probation_end = step + self.probation
                self.swaps += 1
                self._count("swap")
                self._swap_event = self._decide(
                    "topology", "swap", step=step, parent=ready_ev,
                    winner=name,
                    winner_cost=sc["cost_to_consensus"])
                events.append(("topology_swap", {
                    "schedule": name,
                    "cost_to_consensus": sc["cost_to_consensus"],
                    "incumbent": self.last_scores.get("incumbent"),
                }))
                return events
            if state != STEADY:
                return events
            # STEADY: window bookkeeping + trigger decision
            if step < self._cooldown_until:
                return events
            membership = self._membership_pending
            window_due = (self.window > 0 and step > 0
                          and step % self.window == 0)
            if not membership and not window_due:
                return events
            secs = self._seconds.take() if window_due else {}
            self._bytes.take()  # keep the byte marker fresh too
            z = (self._straggler.z_scores()
                 if self._straggler is not None else {})
            reason = None
            if membership:
                reason = "membership"
                self._membership_pending = False
            elif window_due:
                degraded, worst = self._window_degraded(secs, z)
                if degraded:
                    self._degraded_streak += 1
                    self._mix_clean_windows = 0
                else:
                    self._degraded_streak = 0
                    self._mix_clean_windows += 1
                    # recovery: clean windows step the ratio back UP
                    # toward the build rung (compression costs mixing
                    # fidelity, so run the finest ratio the network
                    # affords); the step is on probation like any other
                    if (self.mix_ratios is not None
                            and self._mix_index > 0
                            and self._mix_clean_windows
                            >= self.mix_recover_windows):
                        self._mix_ladder_step(
                            step, self._mix_index - 1, "recover",
                            dead, params, events)
                        return events
                if self._degraded_streak >= self.patience:
                    # the cheap lever first: a rung DOWN the ladder is
                    # data for the same step; synthesis only once exhausted
                    if (self.mix_ratios is not None
                            and self._mix_index
                            < len(self.mix_ratios) - 1):
                        self._mix_ladder_step(
                            step, self._mix_index + 1, "degraded",
                            dead, params, events)
                        return events
                    reason = "degraded"
            if reason is None:
                return events
            self._degraded_streak = 0
            self._state = SYNTHESIZING
            traffic = self._calibration_traffic(secs, z)
            pod_w = self._pod_from_traffic(traffic)
            # the a2a planner prices against the same window's costs;
            # stale any cached dispatch schedule so it re-plans lazily
            self._last_calibrated_pod = pod_w
            self._a2a_plan = None
            dead_now = self._dead.copy()
            self.triggers += 1
            self._count("trigger")
            tele = self._telemetry_snapshot(
                reason, secs, z, dead_now, traffic)
            trig_ev = self._decide(
                "topology", "trigger", step=step, telemetry=tele)
            self._trigger_event = trig_ev
            events.append(("topology_trigger", {"reason": reason}))
        if self.synchronous:
            self._synthesize(pod_w, dead_now, step, tele, trig_ev)
        else:
            self._thread = threading.Thread(
                target=self._synthesize,
                args=(pod_w, dead_now, step, tele, trig_ev),
                name="bf-topology-replan", daemon=True)
            self._thread.start()
        return events

    def _mix_ladder_step(self, step: int, to_index: int, reason: str,
                         dead: np.ndarray, params, events) -> None:
        """Move the ladder to ``to_index`` and open probation on the
        step (caller holds the lock).  The new rung is live the moment
        the caller delivers it through :func:`swap_mix_ratio`."""
        prev = self._mix_index
        self._mix_prev_index = prev
        self._mix_index = to_index
        self._mix_probation_end = step + self.probation
        self._mix_preswap_health = (
            self._health_fn(params, ~dead)
            if params is not None else None)
        self._mix_clean_windows = 0
        self._degraded_streak = 0
        self.mix_swaps += 1
        self._count("mix_swap")
        self._mix_event = self._decide(
            "mix", "swap", step=step,
            telemetry={"reason": reason, "from_index": prev,
                       "to_index": to_index,
                       "ladder": [float(r) for r in self.mix_ratios]},
            candidates={format(r, ".9g"): float(r)
                        for r in self.mix_ratios},
            winner=format(self.mix_ratios[to_index], ".9g"),
            winner_cost=float(self.mix_ratios[to_index]))
        events.append(("mix_ratio_swap", {
            "ratio": self.mix_ratios[to_index],
            "previous": self.mix_ratios[prev],
            "reason": reason,
        }))

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for an in-flight background synthesis (tests)."""
        t = self._thread
        if t is not None:
            t.join(timeout)

    @staticmethod
    def _count(kind: str) -> None:
        from bluefog_tpu_torch import observe

        if observe.enabled():
            observe.get_registry().counter(
                "bf_topology_replan_total",
                "topology control-plane transitions", kind=kind).inc()

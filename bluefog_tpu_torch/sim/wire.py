"""Link-cost actor: the virtual wire, priced by the pod's torus.

Port of ``bluefog_tpu/sim/wire.py``, copied unchanged over the port's
``observe.fleet.record_edge_timing``, ``resilience.heal_spec`` and
``topology.torus.link_loads``.

Each simulated step the ACTIVE (nonzero-weight, healed) edges of the
live mixing round are routed onto the ``PodSpec`` torus; the step's
charge is the bottleneck link's ``load * link_cost * congestion_factor``
— two rank pairs sharing a DCN link serialize, exactly the contention
model ``PodSpec.round_cost`` prices — and every active edge is billed
its own ``pod.round_cost([edge]) * factor * wire_unit`` seconds into the
metrics registry via :func:`~bluefog_tpu_torch.observe.fleet
.record_edge_timing`.  That registry feed is the point: the REAL
:class:`~bluefog_tpu_torch.topology.TopologyControlPlane` reads its windowed
``bf_edge_seconds_total`` deltas from it, so the control plane under
simulation consumes the same telemetry a hardware fleet would emit.

The congestion source is an injected ``congestion_fn(step) -> {pair:
factor}`` — typically ``FaultPlan.congested_links`` — instead of a
bound fault plan, and the schedule period for :meth:`p50` is a
constructor argument.  At n=1024 the per-edge billing groups edges by
equal charge into one ``record_edge_timing`` call per value (the
counters land identically; a uniform ring bills in O(distinct costs)
registry calls instead of O(edges)).

The p50 claims are over PERIODS: the mean charge of each complete
``period``-step schedule cycle is one sample (a per-step median of an
alternating cheap-ICI/expensive-DCN series is a knife-edge — whichever
side has one extra sample wins).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["LinkWire"]


class LinkWire:
    """Per-step virtual transport over a ``PodSpec`` torus.

    Args:
      pod: the :class:`~bluefog_tpu_torch.topology.PodSpec` whose torus
        and link costs price the wire.
      registry: the :class:`~bluefog_tpu_torch.observe.MetricsRegistry` the
        per-edge seconds land in (the control plane's telemetry feed).
      schedule_fn: ``step -> DynamicTopology`` — the live round the
        compiled step would play at ``step`` (callers close over their
        control plane's ``active_schedule()``).
      dead_fn: ``() -> dead_mask`` — edges touching dead ranks are
        healed away before billing, like the real exchange.
      congestion_fn: optional ``step -> {(src, dst): factor}`` slowdown
        map (``FaultPlan.congested_links`` has this exact shape).
      wire_unit: virtual seconds per unit of pod cost billed per edge.
      period: schedule period (rounds per cycle) for :meth:`p50`.
    """

    def __init__(self, pod, registry,
                 schedule_fn: Callable[[int], object],
                 dead_fn: Callable[[], object], *,
                 congestion_fn: Optional[Callable[[int], Dict]] = None,
                 wire_unit: float = 1e-3, period: int = 1):
        if period < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        self.pod = pod
        self.registry = registry
        self.schedule_fn = schedule_fn
        self.dead_fn = dead_fn
        self.congestion_fn = congestion_fn
        self.wire_unit = float(wire_unit)
        self.period = int(period)
        self.charges: List[Tuple[int, float]] = []  # (step, cost units)

    def _round_charge(self, pairs, cong) -> float:
        """Bottleneck-link charge of one round: route the active pairs
        onto the torus, scale each link by the worst congestion factor
        of any pair crossing it, take the max ``load * cost * factor``."""
        from bluefog_tpu_torch.topology.torus import link_loads

        loads = link_loads(pairs, self.pod.torus)
        if not loads:
            return 0.0
        fac: Dict = {}
        for p, f in cong.items():
            for k in link_loads([p], self.pod.torus):
                fac[k] = max(fac.get(k, 1.0), float(f))
        return max(load * self.pod.link_cost(k) * fac.get(k, 1.0)
                   for k, load in loads.items())

    def bill(self, step: int) -> float:
        """Bill step ``step``: per-edge seconds into the registry,
        bottleneck charge into ``charges``.  Returns the charge in pod
        cost units (scale by ``wire_unit`` for virtual seconds)."""
        from bluefog_tpu_torch.observe.fleet import record_edge_timing
        from bluefog_tpu_torch.resilience import heal_spec

        spec = heal_spec(self.schedule_fn(step), self.dead_fn())
        cong = (self.congestion_fn(step)
                if self.congestion_fn is not None else {})
        pairs = [e for e, v in zip(spec.edges, spec.edge_weight_values)
                 if v != 0.0]
        # group edges billing the same seconds into one registry call —
        # identical counter values, O(distinct costs) calls
        by_cost: Dict[float, List] = {}
        for e in pairs:
            t = self.pod.round_cost([e]) * cong.get(e, 1.0)
            by_cost.setdefault(t, []).append(e)
        for t, edges in by_cost.items():
            record_edge_timing(None, t * self.wire_unit,
                               registry=self.registry, pairs=edges)
        charge = self._round_charge(pairs, cong)
        self.charges.append((step, charge))
        return charge

    def p50(self, lo: int, hi: int) -> float:
        """Median per-step charge over the complete schedule periods
        inside ``[lo, hi)`` (cost units)."""
        by_step = dict(self.charges)
        period_means = []
        first = (lo + self.period - 1) // self.period
        for p in range(first, hi // self.period):
            steps = range(p * self.period, (p + 1) * self.period)
            if all(s in by_step for s in steps):
                period_means.append(
                    float(np.mean([by_step[s] for s in steps])))
        return (float(np.median(period_means)) if period_means
                else float("nan"))

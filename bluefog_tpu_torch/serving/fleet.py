"""Decentralized multi-replica request routing over gossiped gauges.

Port of ``bluefog_tpu/serving/fleet.py`` (the whole module), copied
because importing anything under ``bluefog_tpu`` loads jax: host-side
control flow over the port's engines, registries, gossip
(:mod:`bluefog_tpu_torch.observe.fleet`), seeded backoff and flight
recorder.

A fleet of :class:`~bluefog_tpu_torch.serving.ServingEngine` replicas needs a
way to spread load, and the paper's whole premise is that coordination
does not require a center: just as training averages parameters by
push-sum over a sparse topology instead of an allreduce, the fleet
spreads requests by GOSSIPING each replica's serving gauges — slot
occupancy, queue depth, TTFT p50 — through
:class:`bluefog_tpu_torch.observe.fleet.FleetAggregator` and letting every
participant rank replicas from its own converged view.  There is no
load-balancer process to deploy, scale, or lose.

The per-replica signals survive the mean-reducing gossip through the
ONE-HOT BLOCK layout: replica *i* contributes a ``[n*k]`` row that is
zero outside its own ``k``-wide block.  Push-sum converges every column
to its live mean, so column ``i*k + m`` lands at ``signal[i, m] /
n_live`` everywhere — multiplying back by the live count recovers the
full ``[n, k]`` signal matrix at EVERY rank, exactly (the de-biased
push-sum fixed point), at the cost of gossiping ``n*k`` scalars instead
of ``k``.  Fine for fleet-sized ``n``.

Routing is then pure local arithmetic on the snapshot: replicas are
ranked by a weighted score (queue depth dominates, then occupancy, then
normalized TTFT; index breaks ties) and :meth:`FleetRouter.submit`
walks that order, letting each replica's own
:class:`~bluefog_tpu_torch.serving.RequestRejected` backpressure stand — a
replica never takes a request its queue cannot hold.  When every
replica refuses, :class:`FleetSaturated` (a ``RequestRejected``
subclass, so existing client backoff code keeps working) carries all
the per-replica depths.

Determinism: routing decisions are a pure function of the snapshot, and
the snapshot is a pure function of the registries and the topology
schedule — no RNG, no wall clock — so two routers over the same state
route identically (property-tested).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from bluefog_tpu_torch import config as bfconfig
from bluefog_tpu_torch.observe.fleet import FleetAggregator
from bluefog_tpu_torch.serving.scheduler import RequestRejected

__all__ = ["FleetRouter", "FleetSaturated", "RouterSnapshot",
           "collect_serving_signals", "SIGNAL_NAMES"]

# gossiped per-replica serving signals, in block order
SIGNAL_NAMES = ("occupancy", "queue_depth", "ttft_p50")


def collect_serving_signals(registry) -> Dict[str, float]:
    """Scrape one replica's routing signals out of its (isolated)
    metrics registry: the ``bf_serving_slot_occupancy`` /
    ``bf_serving_queue_depth`` gauges the engine sets every step and the
    ``bf_serving_ttft_seconds`` windowed-histogram p50.  Zeros where the
    engine has not published yet — a fresh replica looks maximally
    attractive, which is the right cold-start bias.  ``last_step_ts``
    is the replica's liveness heartbeat (``bf_serving_last_step_ts``,
    engine-clock seconds; -1.0 before the first step) — the staleness
    guard's input, so the router never scores a replica on gauges it
    stopped updating."""
    occupancy = 0.0
    queue_depth = 0.0
    ttft_p50 = 0.0
    last_step_ts = -1.0
    for name, kind, _help, _labels, m in registry.collect():
        if name == "bf_serving_slot_occupancy" and kind == "gauge":
            occupancy = float(m.value)
        elif name == "bf_serving_queue_depth" and kind == "gauge":
            queue_depth = float(m.value)
        elif name == "bf_serving_ttft_seconds" and kind == "histogram":
            ttft_p50 = float(m.percentile(50))
        elif name == "bf_serving_last_step_ts" and kind == "gauge":
            last_step_ts = float(m.value)
    return {"occupancy": occupancy, "queue_depth": queue_depth,
            "ttft_p50": ttft_p50, "last_step_ts": last_step_ts}


class FleetSaturated(RequestRejected):
    """Every live replica refused the request.  ``queue_depths[i]`` is
    the depth each rejecting replica reported — the fleet-wide
    backpressure picture, for clients that scale their backoff.
    ``causes`` keeps the walk's evidence: ``(replica_index, exception)``
    per refusal, across every retry attempt — an operator debugging a
    saturation event sees WHICH replica said WHAT instead of a bare
    count."""

    def __init__(self, queue_depths: Sequence[int], max_queue: int,
                 causes: Optional[Sequence] = None):
        depths = [int(d) for d in queue_depths]
        super().__init__(
            f"all {len(depths)} replicas at capacity "
            f"(queue depths {depths})",
            queue_depth=max(depths) if depths else 0,
            max_queue=max_queue)
        self.queue_depths = depths
        self.causes = list(causes or [])


@dataclasses.dataclass(frozen=True)
class RouterSnapshot:
    """One routing view: ``signals[i]`` is replica *i*'s
    ``(occupancy, queue_depth, ttft_p50)`` as recovered from gossip,
    ``scores`` the router's ranking key (lower routes first), ``order``
    the resulting replica preference, and ``rounds``/``spread`` the
    gossip's convergence record (0/0.0 for a single replica, which
    bypasses gossip entirely).  ``ages[i]`` is seconds since replica
    *i* last published a step heartbeat (-1.0 if it never has);
    ``suspect[i]`` is the staleness verdict — age beyond
    ``BLUEFOG_REPLICA_STALE_S`` — that excised the replica from this
    snapshot's scoring."""

    signals: np.ndarray
    scores: np.ndarray
    order: tuple
    rounds: int
    spread: float
    ages: tuple = ()
    suspect: tuple = ()

    def as_dict(self) -> Dict[str, List[float]]:
        out = {name: [float(v) for v in self.signals[:, m]]
               for m, name in enumerate(SIGNAL_NAMES)}
        out["ages"] = [float(a) for a in self.ages]
        return out


class FleetRouter:
    """Spread requests over ``engines`` by their gossiped gauges.

    Args:
      engines: the replica :class:`ServingEngine` list.  Each replica
        should carry its OWN metrics registry (``ServingEngine(...,
        registry=MetricsRegistry())``) — the router scrapes signals
        per-replica, and a shared global registry would alias them.
      registries: the per-replica registries to scrape.  Defaults to
        each engine's ``metrics`` registry.
      schedule: gossip topology schedule (anything
        :class:`FleetAggregator` accepts).  Defaults to the static
        exponential-two graph over ``len(engines)`` ranks — the same
        default sparse topology the training side mixes over.  Ignored
        (no gossip at all) for a single replica.
      rank: which replica's converged view this router reads and
        publishes.  Any rank works — convergence makes the views agree
        to ``tol`` — but a real deployment runs one router per replica,
        each reading its own rank.
      registry: where :meth:`publish` lands ``bf_fleet_serving_*``
        gauges (default: the global registry via the aggregator).
      weights: score weights for ``(occupancy, queue_depth, ttft_p50)``.
        Queue depth dominates by default: a queued request waits a full
        drain, occupancy only predicts the NEXT rejection, and TTFT is
        a tiebreaker-grade signal (normalized by the fleet max).
      stale_after: staleness window in seconds (default
        ``BLUEFOG_REPLICA_STALE_S``; 0 disables).  A replica whose last
        step heartbeat is older than this is *suspect*: its gossip row
        is masked and its score pinned to +inf, exactly the dead-mask
        path — and it is re-admitted the moment it steps again.
        Replicas that have NEVER stepped are exempt (cold replicas must
        stay routable).
      retries: extra full-fleet submit walks after the first exhausts
        every live replica (default ``BLUEFOG_ROUTER_RETRIES`` = 0, the
        historical single-walk behavior), separated by seeded
        exponential backoff and a fresh poll.
      retry_base_s: backoff base delay (default
        ``BLUEFOG_ROUTER_RETRY_BASE_S``).
      cooldown_s: after ``cooldown_after`` consecutive rejections from
        one replica, demote it to the BACK of the walk for this long
        (default ``BLUEFOG_ROUTER_COOLDOWN_S`` = 0, off).  Cooldown
        only re-orders — a cooling replica is still tried last, so it
        can never manufacture a ``FleetSaturated`` by itself.
      seed: backoff determinism seed (delays derive from
        ``(seed, request.rid, attempt)``).
      clock: staleness/cooldown clock.  Defaults to the first engine's
        injected clock, so virtual-time fleets age virtually.
      sleep: backoff sleep callable (default ``time.sleep``; the
        virtual-time bench passes its clock's advance).
    """

    def __init__(self, engines: Sequence, *,
                 registries: Optional[Sequence] = None,
                 schedule=None, rank: int = 0,
                 tol: float = 1e-13, registry=None,
                 weights: Sequence[float] = (1.0, 4.0, 0.5),
                 stale_after: Optional[float] = None,
                 retries: Optional[int] = None,
                 retry_base_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 cooldown_after: int = 3, seed: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 blackbox=None):
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        self.engines = list(engines)
        if registries is None:
            registries = [e.metrics._registry for e in self.engines]
            if any(r is None for r in registries):
                raise ValueError(
                    "replica engines share the global registry; build "
                    "each with its own (ServingEngine(..., "
                    "registry=MetricsRegistry())) or pass registries=")
        if len(registries) != len(self.engines):
            raise ValueError(
                f"{len(registries)} registries for "
                f"{len(self.engines)} engines")
        self.registries = list(registries)
        self.rank = int(rank)
        if not (0 <= self.rank < len(self.engines)):
            raise ValueError(f"rank {rank} outside fleet of "
                             f"{len(self.engines)}")
        if len(weights) != len(SIGNAL_NAMES):
            raise ValueError(f"need {len(SIGNAL_NAMES)} score weights")
        self.weights = tuple(float(w) for w in weights)
        n = len(self.engines)
        self._agg = None
        if n > 1:
            if schedule is None:
                from bluefog_tpu_torch.topology import (
                    ExponentialTwoGraph, uniform_topology_spec)

                schedule = uniform_topology_spec(ExponentialTwoGraph(n))
            self._agg = FleetAggregator(schedule, tol=tol,
                                        rank=self.rank,
                                        registry=registry)
            if self._agg.size != n:
                raise ValueError(
                    f"gossip schedule of size {self._agg.size} against "
                    f"{n} replicas")
        self._registry = registry
        self.stale_after = float(bfconfig.replica_stale_s()
                                 if stale_after is None else stale_after)
        self.retries = int(bfconfig.router_retries()
                           if retries is None else retries)
        self.retry_base_s = float(bfconfig.router_retry_base_s()
                                  if retry_base_s is None
                                  else retry_base_s)
        self.cooldown_s = float(bfconfig.router_cooldown_s()
                                if cooldown_s is None else cooldown_s)
        self.cooldown_after = int(cooldown_after)
        self.seed = int(seed)
        self._clock = (clock if clock is not None
                       else getattr(self.engines[0], "clock",
                                    time.monotonic))
        self._sleep = sleep if sleep is not None else time.sleep
        self._fail_count = [0] * n
        self._cooldown_until = [float("-inf")] * n
        self.n_routed = 0
        self.n_saturated = 0
        # decision flight recorder: poll count is the router's "step"
        # (it has no training step), excision events parent their
        # eventual readmission, and only CHANGES record — a steady
        # excised set costs nothing per poll.
        self.blackbox = blackbox
        self._n_polls = 0
        self._excised_prev = np.zeros(n, bool)
        self._excise_events: Dict[int, object] = {}

    def _decide(self, kind: str, *, parent=None, telemetry=None,
                winner=None, **detail):
        """The one blackbox emission seam of the router plane (the
        ``decision-outside-recorder`` lint rule holds excision,
        cooldown, and saturation decisions to it)."""
        from bluefog_tpu_torch.observe import blackbox as _blackbox

        return _blackbox.record_decision(
            "router", kind, step=self._n_polls, parent=parent,
            telemetry=telemetry, winner=winner, blackbox=self.blackbox,
            detail=detail or None)

    # -- gossip --------------------------------------------------------- #
    def _scrape(self):
        rows = [collect_serving_signals(r) for r in self.registries]
        local = np.array([[row[name] for name in SIGNAL_NAMES]
                          for row in rows], np.float64)
        heartbeats = np.array([row["last_step_ts"] for row in rows],
                              np.float64)
        return local, heartbeats

    def _local_signals(self) -> np.ndarray:
        return self._scrape()[0]

    def poll(self, dead_mask=None,
             now: Optional[float] = None) -> RouterSnapshot:
        """Scrape every replica's local gauges, gossip them through the
        one-hot block layout, and rank replicas from rank ``rank``'s
        converged view.  ``dead_mask`` excises replicas exactly the way
        the training-side gossip excises dead ranks — their signals
        vanish and their scores come back ``+inf`` (never routed to).
        The staleness guard feeds the same path implicitly: a replica
        whose step heartbeat is older than ``stale_after`` is excised
        like a dead one (and re-admitted once it steps again)."""
        n, k = len(self.engines), len(SIGNAL_NAMES)
        local, heartbeats = self._scrape()
        now = self._clock() if now is None else now
        ages = np.where(heartbeats >= 0.0, now - heartbeats, -1.0)
        suspect = np.zeros(n, bool)
        if self.stale_after > 0:
            # never-published replicas (heartbeat -1) stay routable:
            # cold replicas must look attractive, not dead
            suspect = (heartbeats >= 0.0) & (ages > self.stale_after)
        dead = (np.zeros(n, bool) if dead_mask is None
                else np.asarray(dead_mask, bool).reshape(-1))
        excised = dead | suspect
        if self._agg is None:
            signals = local
            rounds, spread = 0, 0.0
        else:
            # one-hot block: replica i's row is zero outside block i,
            # so the converged column means are signal/n_live — exactly
            # invertible at every rank
            x = np.zeros((n, n * k))
            for i in range(n):
                x[i, i * k:(i + 1) * k] = local[i]
            agg = self._agg.aggregate(
                x, dead_mask=excised if excised.any() else dead_mask)
            n_live = int((~np.isnan(agg.per_rank[:, 0])).sum())
            view = agg.per_rank[self.rank] * n_live
            signals = view.reshape(n, k)
            rounds, spread = agg.rounds, agg.spread
        scores = self._score(signals)
        scores = np.where(excised, np.inf, scores)
        self._n_polls += 1
        if not np.array_equal(excised, self._excised_prev):
            for i in np.flatnonzero(excised & ~self._excised_prev):
                i = int(i)
                ev = self._decide(
                    "excise", winner=str(i),
                    telemetry={"replica": i, "dead": bool(dead[i]),
                               "suspect": bool(suspect[i]),
                               "age": float(ages[i])})
                if ev is not None:
                    self._excise_events[i] = ev
            for i in np.flatnonzero(self._excised_prev & ~excised):
                i = int(i)
                self._decide(
                    "readmit", winner=str(i),
                    parent=self._excise_events.pop(i, None),
                    telemetry={"replica": i})
            self._excised_prev = excised.copy()
        order = tuple(int(i) for i in np.lexsort(
            (np.arange(n), scores)))  # score, then index — deterministic
        return RouterSnapshot(signals=signals, scores=scores,
                              order=order, rounds=rounds, spread=spread,
                              ages=tuple(float(a) for a in ages),
                              suspect=tuple(bool(s) for s in suspect))

    def _score(self, signals: np.ndarray) -> np.ndarray:
        occ, depth, ttft = (signals[:, 0], signals[:, 1], signals[:, 2])
        t_max = float(np.max(ttft)) if np.max(ttft) > 0 else 1.0
        w = self.weights
        return w[0] * occ + w[1] * depth + w[2] * (ttft / t_max)

    # -- routing -------------------------------------------------------- #
    def route(self, snapshot: Optional[RouterSnapshot] = None) -> int:
        """Index of the replica a request should go to next (the head of
        the snapshot's preference order).  Pass a held snapshot to
        amortize one gossip over a batch of decisions."""
        snap = snapshot if snapshot is not None else self.poll()
        return snap.order[0]

    def _walk(self, snap: RouterSnapshot, now: float) -> List[int]:
        """The submit candidate list: live (finite-score) replicas in
        preference order, with replicas inside a rejection cooldown
        demoted to the back — still tried, just last, so cooldown alone
        can never manufacture a :class:`FleetSaturated`."""
        live = [i for i in snap.order if np.isfinite(snap.scores[i])]
        if self.cooldown_s <= 0:
            return live
        hot = [i for i in live if self._cooldown_until[i] <= now]
        cooling = [i for i in live if self._cooldown_until[i] > now]
        return hot + cooling

    def submit(self, request,
               snapshot: Optional[RouterSnapshot] = None,
               dead_mask=None):
        """Submit ``request`` to the best replica, falling through the
        preference order on per-replica :class:`RequestRejected`
        backpressure.  With ``retries`` > 0, a walk that exhausts every
        live replica sleeps one seeded-backoff delay, re-polls, and
        walks again — transient rejection windows (GC pauses, admission
        bursts) are absorbed instead of surfaced.  Returns
        ``(replica_index, request)``; raises :class:`FleetSaturated`
        (with per-replica ``causes``) only after every attempt's walk
        exhausted the live fleet."""
        snap = snapshot if snapshot is not None else self.poll(
            dead_mask=dead_mask)
        depths: List[int] = []
        causes: List[tuple] = []
        max_queue = 0
        for attempt in range(self.retries + 1):
            if attempt > 0:
                from bluefog_tpu_torch.serving.resilience import (
                    backoff_sleep)

                backoff_sleep(attempt - 1, base=self.retry_base_s,
                              seed=self.seed,
                              salt=int(getattr(request, "rid", 0)),
                              sleep=self._sleep)
                snap = self.poll(dead_mask=dead_mask)
            now = self._clock()
            for i in self._walk(snap, now):
                try:
                    self.engines[i].submit(request)
                except RequestRejected as e:
                    depths.append(e.queue_depth)
                    max_queue = max(max_queue, e.max_queue)
                    causes.append((i, e))
                    self._fail_count[i] += 1
                    if (self.cooldown_s > 0 and self._fail_count[i]
                            >= self.cooldown_after):
                        if self._fail_count[i] == self.cooldown_after:
                            self._decide(
                                "cooldown", winner=str(i),
                                telemetry={"replica": i,
                                           "fails": self._fail_count[i]})
                        self._cooldown_until[i] = now + self.cooldown_s
                    continue
                self._fail_count[i] = 0
                self.n_routed += 1
                return i, request
        self.n_saturated += 1
        self._decide(
            "saturated",
            telemetry={"depths": [int(d) for d in depths],
                       "max_queue": int(max_queue)},
            rejections=len(causes))
        raise FleetSaturated(depths, max_queue, causes=causes)

    # -- observability -------------------------------------------------- #
    def publish(self, snapshot: Optional[RouterSnapshot] = None
                ) -> RouterSnapshot:
        """Land the local view as ``bf_fleet_serving_<signal>[replica]``
        gauges (plus the routed/saturated counters), so the same
        Prometheus scrape that serves training fleet metrics shows the
        serving fleet too."""
        snap = snapshot if snapshot is not None else self.poll()
        reg = self._registry
        if reg is None:
            from bluefog_tpu_torch.observe import registry as obs_registry

            reg = (obs_registry.get_registry()
                   if obs_registry.enabled() else None)
        if reg is not None:
            for i in range(len(self.engines)):
                for m, name in enumerate(SIGNAL_NAMES):
                    v = snap.signals[i, m]
                    if np.isfinite(v):
                        reg.gauge(f"bf_fleet_serving_{name}",
                                  "gossiped replica serving signal",
                                  replica=str(i)).set(float(v))
            for i in range(len(self.engines)):
                s = (snap.suspect[i] if i < len(snap.suspect) else False)
                reg.gauge("bf_replica_suspect",
                          "1 while the staleness guard excises the "
                          "replica", replica=str(i)).set(1.0 if s
                                                         else 0.0)
            reg.gauge("bf_fleet_serving_best_replica",
                      "router's current first choice").set(snap.order[0])
            reg.counter("bf_fleet_serving_routed_total",
                        "requests routed").inc(0)
        return snap

    def summary(self) -> dict:
        return {
            "n_replicas": len(self.engines),
            "n_routed": self.n_routed,
            "n_saturated": self.n_saturated,
        }

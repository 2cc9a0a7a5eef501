"""Fleet telemetry: decentralized cross-rank metric aggregation.

Port of ``bluefog_tpu/observe/fleet.py`` (the whole module), copied
because importing anything under ``bluefog_tpu`` loads jax: numpy on the
host over the port's registry, ``parallel.collectives`` and
``topology.spec``.

The registry and tracer are strictly process-local; the quantities that
decide whether *decentralized* training is healthy — consensus distance
between neighbor replicas, per-edge exchange volume, rank-to-rank
step-time skew — only exist as fleet-level facts.  The paper's premise
is that state is averaged over a digraph rather than centralized, so
telemetry travels the same way: this module aggregates metrics over the
EXISTING neighbor topology via push-sum gossip (the same
column-stochastic structure as ``parallel.collectives.push_sum_mix`` /
``push_sum_structure``) instead of assuming a metrics server every rank
can reach.  Three pieces:

* :class:`FleetAggregator` — exact weighted means of per-rank scalars
  by iterated push-sum over a topology schedule, no central collector:
  the pair ``(x, w)`` mixes through the column-stochastic matrices, the
  sums ``Σx`` and ``Σw`` are INVARIANTS, so when every rank's de-biased
  estimate ``z_i = x_i / w_i`` agrees it equals the true mean *exactly*
  (the finite-round residual is the measured ``spread``).  Dead ranks
  are excised exactly like ``resilience.healing`` excises them from the
  mixing weights — zeroed edges drop out of the push-sum structure —
  and a hierarchical intra-host/inter-host mode (HiCCL-style,
  arXiv:2408.05962) reduces each machine exactly first and gossips
  machine sums inter-host.
* per-edge traffic accounting — ``bf_edge_bytes_total{src,dst}``
  counter families derived from the topology's shift classes
  (:func:`edge_list`); the train-step wrappers and the gossip itself
  publish through :func:`record_edge_traffic`.
* :class:`StragglerDetector` — flags ranks whose gossiped step-time
  z-score (robust: median/MAD across ranks) stays above a threshold
  for ``patience`` consecutive observations; feeds
  the resilient runner's failure detector
  (``resilience.run_resilient(straggler=...)``) so a slow rank is
  *named* instead of only tripping the blunt ``BLUEFOG_OP_TIMEOUT``.

Aggregated values land back in the local
:class:`~bluefog_tpu_torch.observe.registry.MetricsRegistry` under
``bf_fleet_*`` gauges, so every exporter in ``observe.export``
(Prometheus text, JSONL, snapshot) serves fleet metrics unchanged.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from bluefog_tpu_torch.observe import registry as _registry_mod
from bluefog_tpu_torch.parallel.collectives import (
    push_sum_structure, validate_machine_decomposition)
from bluefog_tpu_torch.topology.spec import DynamicTopology, Topology

CommSpec = Union[Topology, DynamicTopology]

__all__ = [
    "edge_list",
    "gossip_edge_list",
    "record_edge_traffic",
    "record_edge_timing",
    "traffic_snapshot",
    "TrafficDeltas",
    "push_sum_matrix",
    "FleetAggregate",
    "FleetAggregator",
    "StragglerDetector",
    "collect_local",
]

_EDGE_BYTES_HELP = "per-edge neighbor-exchange payload (logical bytes)"
_EDGE_SECONDS_HELP = "per-edge exchange wall time (measured seconds)"

# the aggregator's per-dead-mask matrix cache is LRU-bounded: elastic
# membership churns the mask in BOTH directions (die -> heal -> rejoin
# -> grow), and an unbounded dict would retain every pattern ever seen
_MATS_CACHE_MAX = 32


def _resolve_dead_mask(dead_mask, size: int) -> np.ndarray:
    """Normalize a dead-mask argument: ``None`` (nobody dead), a bool
    array, or any object with an ``effective_dead_mask()`` method — the
    duck-typed hook the JAX package's ``elastic.MembershipController``
    satisfies, so the gossip layer heals and RE-GROWS in lockstep with
    the data plane's membership (a JOINING rank is still excised: it is
    not yet read from)."""
    if dead_mask is None:
        return np.zeros(size, bool)
    eff = getattr(dead_mask, "effective_dead_mask", None)
    if callable(eff):
        dead_mask = eff()
    return np.asarray(dead_mask, bool).reshape(-1)


def edge_list(spec: CommSpec) -> List[tuple]:
    """The spec's declared edges ``(src, dst)``, sorted — derived from
    the shift-class decomposition (the compile-time skeleton), so the
    traffic account indexes exactly the ppermutes the data plane
    issues.  ``neighbor_allreduce`` ppermutes every DECLARED edge
    (weights are traced operands, a 0.0 weight still moves bytes);
    for the push-sum wire behavior use :func:`gossip_edge_list`."""
    return sorted(p for cls in spec.shift_classes for p in cls.perm)


def gossip_edge_list(spec: CommSpec) -> List[tuple]:
    """The spec's edges that actually carry push-sum payload — the
    weight-FILTERED structure (``push_sum_structure``): a declared
    0.0-weight edge pushes nothing, matching ``push_sum_mix``'s wire
    behavior (it only ppermutes the filtered perms), so a healed spec's
    zeroed edges are billed nothing."""
    _, perms = push_sum_structure(spec)
    return sorted(p for perm in perms for p in perm)


def record_edge_traffic(spec: CommSpec, payload_bytes: float,
                        registry=None, pairs=None,
                        link: Optional[str] = None) -> None:
    """Add ``payload_bytes`` to ``bf_edge_bytes_total{src,dst}`` for
    every declared edge of ``spec`` (one exchange round) — or for the
    explicit ``pairs`` (e.g. :func:`gossip_edge_list` for push-sum
    wires).  Logical payload bytes — wire compression is not folded
    in.

    ``link`` ("ici"/"dcn") tags the counters with the fabric LEG the
    bytes crossed — the hierarchical exchange bills its two legs
    separately so :func:`traffic_snapshot` can hand the compiler's
    ``PodSpec.from_telemetry`` only the expensive inter-machine load.
    Unlabeled counters (flat exchanges, old recorders) stay the
    back-compat family."""
    reg = registry if registry is not None else (
        _registry_mod.get_registry() if _registry_mod.enabled() else None)
    if reg is None:
        return
    extra = {} if link is None else {"link": link}
    for (src, dst) in (edge_list(spec) if pairs is None else pairs):
        reg.counter("bf_edge_bytes_total", _EDGE_BYTES_HELP,
                    src=src, dst=dst, **extra).inc(payload_bytes)


def record_edge_timing(spec: CommSpec, seconds: float,
                       registry=None, pairs=None,
                       link: Optional[str] = None) -> None:
    """Add ``seconds`` of measured exchange wall time to
    ``bf_edge_seconds_total{src,dst}`` for every declared edge of
    ``spec`` (or the explicit ``pairs``) — the TIMING twin of
    :func:`record_edge_traffic`.  A congested link carries the same
    bytes but more seconds, so the control plane prices links by the
    seconds counters where they exist: byte volume alone cannot see a
    link that got slow."""
    reg = registry if registry is not None else (
        _registry_mod.get_registry() if _registry_mod.enabled() else None)
    if reg is None:
        return
    extra = {} if link is None else {"link": link}
    for (src, dst) in (edge_list(spec) if pairs is None else pairs):
        reg.counter("bf_edge_seconds_total", _EDGE_SECONDS_HELP,
                    src=src, dst=dst, **extra).inc(seconds)


def traffic_snapshot(registry=None,
                     link: Optional[str] = None,
                     since: Optional[Dict[tuple, float]] = None,
                     metric: str = "bf_edge_bytes_total"
                     ) -> Dict[tuple, float]:
    """The accumulated per-edge exchange traffic, read back OUT of the
    registry: ``{(src, dst): bytes}`` from every
    ``bf_edge_bytes_total{src,dst}`` counter — the feed the topology
    compiler's ``PodSpec.calibrated`` cost model consumes (the JAX
    package's ``topology.compiler``), so synthesized schedules adapt to the link
    traffic the fleet actually measured (train-step exchanges + gossip
    wire cost, everything :func:`record_edge_traffic` billed).  Empty
    when observability is off or nothing was recorded.

    ``link=None`` sums every family (labeled or not — the whole-fleet
    view); ``link="dcn"``/``link="ici"`` selects ONLY the counters
    tagged with that leg by a hierarchical recorder, which is what
    hierarchical ``PodSpec.from_telemetry`` calibration reads so cheap
    intra-machine traffic never masquerades as DCN load.

    ``since`` turns the lifetime totals into a WINDOWED delta: pass a
    previous snapshot (same ``registry``/``link``/``metric``) and only
    the traffic accumulated after it comes back, edges that moved
    nothing omitted.  Lifetime counters are monotonic, so a long-lived
    fleet's history drowns any new hotspot — calibrating from totals
    prices links by what they carried LAST WEEK; the delta prices what
    they carry NOW (the stale-calibration fix, unit-tested in
    tests/test_fleet.py).  :class:`TrafficDeltas` packages the marker
    bookkeeping.  ``metric`` selects the counter family —
    ``bf_edge_seconds_total`` reads the timing leg
    (:func:`record_edge_timing`) through the same machinery."""
    reg = registry if registry is not None else (
        _registry_mod.get_registry() if _registry_mod.enabled() else None)
    if reg is None:
        return {}
    out: Dict[tuple, float] = {}
    for name, kind, _help, labels, m in reg.collect():
        if name != metric or kind != "counter":
            continue
        if link is not None and labels.get("link") != link:
            continue
        try:
            key = (int(labels["src"]), int(labels["dst"]))
        except (KeyError, ValueError):
            continue
        out[key] = out.get(key, 0.0) + float(m.value)
    if since is not None:
        out = {k: v - since.get(k, 0.0) for k, v in out.items()
               if v - since.get(k, 0.0) > 0.0}
    return out


class TrafficDeltas:
    """Windowed per-edge traffic reader: every :meth:`take` returns
    what moved SINCE the previous take and advances the marker — the
    handle the topology control plane holds so each telemetry window
    prices recent load, never lifetime monotonic totals.

    Construction snapshots the current counters, so the first
    :meth:`take` already excludes everything that happened before the
    watcher existed (the stale-calibration case)."""

    def __init__(self, registry=None, link: Optional[str] = None,
                 metric: str = "bf_edge_bytes_total"):
        self._registry = registry
        self._link = link
        self._metric = metric
        self._mark = traffic_snapshot(registry, link=link, metric=metric)

    def take(self) -> Dict[tuple, float]:
        """Per-edge traffic since the previous take (or construction):
        ``{(src, dst): amount}``, quiet edges omitted."""
        cur = traffic_snapshot(self._registry, link=self._link,
                               metric=self._metric)
        out = {k: v - self._mark.get(k, 0.0) for k, v in cur.items()
               if v - self._mark.get(k, 0.0) > 0.0}
        self._mark = cur
        return out

    def peek(self) -> Dict[tuple, float]:
        """The delta :meth:`take` would return, without advancing."""
        return traffic_snapshot(self._registry, link=self._link,
                                since=self._mark, metric=self._metric)


def push_sum_matrix(spec: CommSpec, dead_mask=None) -> np.ndarray:
    """The column-stochastic push-sum matrix of ``spec``'s edge
    structure, receiver-major (``A[dst, src]``): every rank scales by
    ``1/(out_degree+1)`` and pushes along its nonzero-weight out-edges
    — numerically THE matrix one round of
    ``collectives.push_sum_mix`` applies (parity-tested in
    tests/test_fleet.py).

    ``dead_mask`` excises ranks the same way a
    ``resilience.healing.heal_spec`` re-plan does: their edges drop
    from the structure (a healed spec's zeroed weights produce the
    identical matrix) and the dead rank keeps its own (zero) mass via
    ``A[d, d] = 1`` — columns stay stochastic, so the LIVE sums remain
    invariant."""
    n = spec.size
    dead = (np.zeros(n, bool) if dead_mask is None
            else np.asarray(dead_mask, bool).reshape(-1))
    if dead.shape[0] != n:
        raise ValueError(f"dead mask of length {dead.shape[0]} does not "
                         f"match topology size {n}")
    _, perms = push_sum_structure(spec)
    pairs = [(s, d) for perm in perms for (s, d) in perm
             if not (dead[s] or dead[d])]
    deg = np.zeros(n, np.int64)
    for (s, _) in pairs:
        deg[s] += 1
    a = 1.0 / (deg + 1.0)
    A = np.zeros((n, n), np.float64)
    A[np.arange(n), np.arange(n)] = a
    for (s, d) in pairs:
        A[d, s] += a[s]
    A[dead, dead] = 1.0
    return A


@dataclasses.dataclass(frozen=True)
class FleetAggregate:
    """One gossip result: ``per_rank[i, j]`` is rank *i*'s converged
    estimate of metric *j*'s fleet mean (dead rows are NaN), ``mean``
    the live ranks' average view, ``rounds`` the gossip rounds run, and
    ``spread`` the final relative disagreement across live ranks — the
    honest residual of a finite-round decentralized protocol."""

    names: tuple
    per_rank: np.ndarray
    mean: np.ndarray
    rounds: int
    spread: float

    def as_dict(self) -> Dict[str, float]:
        return {n: float(v) for n, v in zip(self.names, self.mean)}


class FleetAggregator:
    """Decentralized aggregation of per-rank scalars by push-sum gossip
    over a topology schedule.

    ``schedule`` is the same object a train step communicates over (one
    spec, or the dynamic round list); gossip round *t* uses
    ``schedule[t % len(schedule)]``'s edge structure with the uniform
    column-stochastic push scales — metrics travel the edges the data
    plane already exercises.  ``aggregate`` iterates until the live
    ranks' de-biased estimates agree to ``tol`` (relative), which by
    the sum invariant means every estimate equals the centralized mean
    to that tolerance (≤1e-12 at n=32, dead-rank excision included, in
    tests/test_fleet.py and tests/test_torch_fleet.py).

    ``rank`` names the local rank whose converged view ``publish``
    lands in the registry (``bf_fleet_<metric>`` gauges) — in a real
    fleet every process runs its own aggregator and publishes its own
    view; the single-process test world simulates all of them at once.
    """

    def __init__(self, schedule, *, tol: float = 1e-13,
                 max_rounds: int = 10_000, rank: int = 0,
                 registry=None, record_traffic: bool = True):
        if isinstance(schedule, (Topology, DynamicTopology)):
            schedule = [schedule]
        if not schedule:
            raise ValueError("FleetAggregator needs a non-empty schedule")
        sizes = {s.size for s in schedule}
        if len(sizes) != 1:
            raise ValueError(f"schedule mixes topology sizes {sizes}")
        self.schedule = list(schedule)
        self.size = sizes.pop()
        self.tol = float(tol)
        self.max_rounds = int(max_rounds)
        self.rank = int(rank)
        self._registry = registry
        self.record_traffic = record_traffic
        # matrices cache: keyed by dead-mask bytes (flat gossip) or
        # (machine-schedule digests, machine-dead bytes) (hierarchical);
        # LRU-bounded — elastic membership churns the mask both ways
        self._mats: "OrderedDict[object, list]" = OrderedDict()

    # ------------------------------------------------------------- #
    # gossip core
    # ------------------------------------------------------------- #
    def _cache_put(self, key, mats: list) -> None:
        self._mats[key] = mats
        self._mats.move_to_end(key)
        while len(self._mats) > _MATS_CACHE_MAX:
            self._mats.popitem(last=False)

    def _cache_get(self, key):
        mats = self._mats.get(key)
        if mats is not None:
            self._mats.move_to_end(key)
        return mats

    def _matrices(self, dead: np.ndarray) -> list:
        key = dead.tobytes()
        mats = self._cache_get(key)
        if mats is None:
            mats = [push_sum_matrix(s, dead) for s in self.schedule]
            self._cache_put(key, mats)
        return mats

    @staticmethod
    def _fold_isolated(mats: list, dead: np.ndarray, rebuild) -> tuple:
        """Fold ISOLATED live ranks — no gossip edge in any round's
        matrix — into the effective dead mask (``rebuild(eff_dead)``
        supplies the re-excised matrices).  This is exactly what a
        ``healing.heal_spec`` re-plan produces when the caller passes
        the healed schedule WITHOUT a dead mask: the excised rank's
        edges are zero-weight, so it can neither reach nor be reached
        by the rest and would block convergence forever while
        polluting the mean with its stale value.  A single live rank
        (nothing to gossip with) is left alone — it trivially
        converges to its own value."""
        iso = ~dead
        for A in mats:
            off = A - np.diag(np.diag(A))
            touched = (off.sum(axis=0) > 0) | (off.sum(axis=1) > 0)
            iso &= ~touched
        if not iso.any():
            return dead, mats
        live = ~dead
        if not (live & ~iso).any():
            if live.sum() == 1:
                return dead, mats
            raise ValueError(
                "gossip schedule has no edges among live ranks")
        eff = dead | iso
        return eff, rebuild(eff)

    def _gossip(self, mats: list, x: np.ndarray, w: np.ndarray,
                live: np.ndarray) -> tuple:
        """Iterate push-sum rounds until the live ranks' de-biased
        estimates agree to ``tol`` (relative) — the shared core of the
        flat and hierarchical paths."""
        rounds = 0
        spread = np.inf
        while rounds < self.max_rounds:
            A = mats[rounds % len(mats)]
            x = A @ x
            w = A @ w
            rounds += 1
            z = x[live] / w[live, None]
            scale = max(np.abs(z).max(initial=0.0), 1.0)
            spread = float((z.max(axis=0) - z.min(axis=0)).max(initial=0.0)
                           / scale)
            if spread <= self.tol:
                break
        return x, w, rounds, spread

    def aggregate(self, values, dead_mask=None,
                  names: Optional[Sequence[str]] = None) -> FleetAggregate:
        """Gossip ``values`` (``[n, k]`` rank-major, or ``[n]`` for one
        metric) to every live rank's estimate of the live mean.

        Dead ranks (``dead_mask`` — a bool mask, or an elastic
        membership controller whose
        ``effective_dead_mask()`` is read live, so gossip shrinks AND
        grows with the data plane's membership) contribute nothing and
        receive nothing — their rows come back NaN; this matches a
        ``healing.heal_spec``-re-planned schedule exactly (the test
        asserts matrix equality).  A healed schedule passed WITHOUT a
        dead mask works too: ranks the re-plan fully excised (no edges
        left in any round) are detected and folded into the effective
        dead mask, so a fleet that healed its mixing weights gets
        consistent gossip for free either way."""
        x = np.asarray(values, np.float64)
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[0] != self.size:
            raise ValueError(f"values for {x.shape[0]} ranks against a "
                             f"size-{self.size} schedule")
        k = x.shape[1]
        names = tuple(names) if names is not None else tuple(
            f"m{j}" for j in range(k))
        dead = _resolve_dead_mask(dead_mask, self.size)
        if not (~dead).any():
            raise ValueError("no live ranks to aggregate over")
        dead, mats = self._fold_isolated(self._matrices(dead), dead,
                                         self._matrices)
        live = ~dead
        x = np.where(live[:, None], x, 0.0)
        w = live.astype(np.float64)
        x, w, rounds, spread = self._gossip(mats, x, w, live)
        per_rank = np.full((self.size, k), np.nan)
        per_rank[live] = x[live] / w[live, None]
        agg = FleetAggregate(names=names, per_rank=per_rank,
                             mean=per_rank[live].mean(axis=0),
                             rounds=rounds, spread=spread)
        self._record_gossip_traffic(self.schedule, rounds, k, dead)
        return agg

    def aggregate_hierarchical(self, values, local_size: int,
                               machine_schedule,
                               dead_mask=None,
                               names: Optional[Sequence[str]] = None
                               ) -> FleetAggregate:
        """Two-level aggregation in the spirit of HiCCL
        (arXiv:2408.05962): (1) each machine of ``local_size`` ranks
        reduces its LIVE members' sum + count exactly (the intra-host
        interconnect is assumed reliable and cheap), (2) the machine
        sums gossip by push-sum over ``machine_schedule`` with the
        weight initialized to the machine's live-rank COUNT — the
        de-biased fixed point is then the rank-weighted global mean,
        exactly, uneven machines included, (3) every rank reads its
        machine's converged view (the intra-host broadcast)."""
        x = np.asarray(values, np.float64)
        if x.ndim == 1:
            x = x[:, None]
        n, k = x.shape
        names = tuple(names) if names is not None else tuple(
            f"m{j}" for j in range(k))
        dead = _resolve_dead_mask(dead_mask, n)
        live = ~dead
        if isinstance(machine_schedule, (Topology, DynamicTopology)):
            machine_schedule = [machine_schedule]
        # the one shared machine-decomposition validator (also the
        # training exchange's — collectives.py is the source of truth)
        groups = validate_machine_decomposition(n, local_size,
                                                machine_schedule)
        m = len(groups)
        sums = np.zeros((m, k))
        counts = np.zeros(m)
        for mi, g in enumerate(groups):
            members = np.asarray(g)[live[np.asarray(g)]]
            counts[mi] = len(members)
            if len(members):
                sums[mi] = x[members].sum(axis=0)
        mdead = counts == 0
        if mdead.all():
            raise ValueError("no live ranks to aggregate over")

        # cached like aggregate()'s matrices: a steady-state telemetry
        # loop calls this every publish interval
        def machine_mats(md: np.ndarray) -> list:
            mkey = (tuple(s.digest() for s in machine_schedule),
                    md.tobytes())
            mats = self._cache_get(mkey)
            if mats is None:
                mats = [push_sum_matrix(s, md) for s in machine_schedule]
                self._cache_put(mkey, mats)
            return mats

        mdead, mats = self._fold_isolated(machine_mats(mdead), mdead,
                                          machine_mats)
        mlive = ~mdead
        xs = np.where(mlive[:, None], sums, 0.0)
        ws = np.where(mlive, counts, 0.0)
        xs, ws, rounds, spread = self._gossip(mats, xs, ws, mlive)
        per_rank = np.full((n, k), np.nan)
        filled = np.zeros(n, bool)
        for mi, g in enumerate(groups):
            if mlive[mi]:
                view = xs[mi] / ws[mi]
                for r in g:
                    if live[r]:
                        per_rank[r] = view
                        filled[r] = True
        # inter-host gossip wire cost, attributed to the machines'
        # LEADER ranks (machine m's counterpart link is rank
        # m*local_size -> m'*local_size) so the same bf_edge_bytes_total
        # family covers flat and hierarchical gossip
        self._record_gossip_traffic(
            machine_schedule, rounds, k, mdead,
            relabel=lambda s, d: (s * local_size, d * local_size),
            link="dcn")
        return FleetAggregate(names=names, per_rank=per_rank,
                              mean=per_rank[filled].mean(axis=0),
                              rounds=rounds, spread=spread)

    # ------------------------------------------------------------- #
    # registry integration
    # ------------------------------------------------------------- #
    def _reg(self):
        if self._registry is not None:
            return self._registry
        return (_registry_mod.get_registry()
                if _registry_mod.enabled() else None)

    def _record_gossip_traffic(self, schedule, rounds: int, k: int,
                               dead: np.ndarray, relabel=None,
                               link: Optional[str] = None) -> None:
        """The gossip's OWN wire cost, per edge: each round pushes the
        ``k`` metric scalars + the push-sum weight as f64.  Only edges
        that actually push are billed (:func:`gossip_edge_list` —
        zero-weight declared edges carry nothing); ``relabel`` maps
        schedule-level edges to rank-level labels (the hierarchical
        path's machine→leader-rank attribution), and ``link`` tags the
        leg like :func:`record_edge_traffic` (the hierarchical
        inter-machine gossip is DCN traffic)."""
        reg = self._reg()
        if reg is None or not self.record_traffic or rounds == 0:
            return
        payload = (k + 1) * 8
        totals: Dict[tuple, float] = {}
        n_specs = len(schedule)
        for si, spec in enumerate(schedule):
            # rounds r with r % n_specs == si
            uses = rounds // n_specs + (1 if rounds % n_specs > si else 0)
            if uses == 0:
                continue
            for (s, d) in gossip_edge_list(spec):
                if dead[s] or dead[d]:
                    continue
                key = (s, d) if relabel is None else relabel(s, d)
                totals[key] = totals.get(key, 0.0) + payload * uses
        extra = {} if link is None else {"link": link}
        for (s, d), b in totals.items():
            reg.counter("bf_edge_bytes_total", _EDGE_BYTES_HELP,
                        src=s, dst=d, **extra).inc(b)

    def publish(self, names: Sequence[str], values, dead_mask=None
                ) -> FleetAggregate:
        """Aggregate and land the LOCAL rank's converged view in the
        registry as ``bf_fleet_<name>`` gauges (plus
        ``bf_fleet_gossip_rounds`` / ``bf_fleet_gossip_spread``), so
        ``export.prometheus_text()`` / ``snapshot()`` serve fleet
        metrics with no exporter changes."""
        agg = self.aggregate(values, dead_mask=dead_mask, names=names)
        reg = self._reg()
        if reg is not None:
            view = agg.per_rank[self.rank]
            for name, v in zip(agg.names, view):
                if np.isfinite(v):
                    reg.gauge(f"bf_fleet_{name}",
                              "push-sum-gossiped fleet mean (local "
                              "rank's converged view)").set(float(v))
            reg.gauge("bf_fleet_gossip_rounds",
                      "gossip rounds to convergence").set(agg.rounds)
            reg.gauge("bf_fleet_gossip_spread",
                      "relative disagreement at stop").set(agg.spread)
        return agg


def collect_local(registry=None) -> Dict[str, float]:
    """The local registry scalars worth gossiping — step wall-time
    (p50 of ``bf_step_wall_seconds`` across loops), total guarded-step
    skips, and the serving queue depth.  Returns ``{}``-able floats (0
    where a subsystem never published), in a stable key order."""
    reg = registry if registry is not None else _registry_mod.get_registry()
    step_p50 = 0.0
    skips = 0.0
    queue = 0.0
    for name, kind, _help, _labels, m in reg.collect():
        if name == "bf_step_wall_seconds" and kind == "histogram":
            step_p50 = max(step_p50, m.percentile(50))
        elif name == "bf_resilience_skips_total" and kind == "counter":
            skips += m.value
        elif name == "bf_serving_queue_depth" and kind == "gauge":
            queue = m.value
    return {"step_time_p50": float(step_p50), "skips_total": float(skips),
            "queue_depth": float(queue)}


class StragglerDetector:
    """Names the slow rank from gossiped per-rank step times.

    Per observation (one fleet-aggregated step-time vector), computes a
    ROBUST z-score across ranks — ``(t - median) / sigma`` with
    ``sigma = max(1.4826·MAD, min_rel_spread·median)`` so one extreme
    straggler cannot hide itself by inflating a plain standard
    deviation, and microscopic jitter on an idle fleet never flags.  A
    rank above ``z_threshold`` for ``patience`` CONSECUTIVE
    observations is flagged (detection latency is therefore bounded by
    ``patience`` observations after onset — the machine-checked claim
    in benchmarks/chaos_resilience.py); dipping below the threshold
    clears the streak and the flag (a recovered rank is not a
    straggler).

    ``observe`` returns the NEWLY flagged ranks, which
    ``run_resilient`` feeds to ``FailureDetector.suspect`` and emits as
    ``straggler`` events; gauges ``bf_fleet_step_time_z{rank=}`` and
    ``bf_fleet_straggler{rank=}`` land in the registry each
    observation."""

    def __init__(self, size: int, z_threshold: Optional[float] = None,
                 patience: int = 3, min_rel_spread: float = 0.05,
                 registry=None):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        if z_threshold is None:
            from bluefog_tpu_torch import config as bfconfig

            z_threshold = bfconfig.straggler_z_threshold()
        self.size = size
        self.z_threshold = float(z_threshold)
        self.patience = int(patience)
        self.min_rel_spread = float(min_rel_spread)
        self._registry = registry
        self._above = np.zeros(size, np.int64)
        self._flagged = np.zeros(size, bool)
        self._z = np.zeros(size)
        self.n_observations = 0
        self._gauge_cache = None

    def _reg(self):
        if self._registry is not None:
            return self._registry
        return (_registry_mod.get_registry()
                if _registry_mod.enabled() else None)

    def _gauges(self, reg) -> list:
        """Per-rank ``(z_gauge, straggler_gauge)`` handles, cached per
        registry: ``observe`` runs once per training step in
        ``run_resilient``'s host loop, and 2·size labeled-family dict
        lookups per step is avoidable overhead — the handles are
        stable, only the values change."""
        cache = self._gauge_cache
        if cache is None or cache[0] is not reg:
            pairs = [
                (reg.gauge("bf_fleet_step_time_z",
                           "robust step-time z-score (gossiped)", rank=r),
                 reg.gauge("bf_fleet_straggler",
                           "1 while the rank is flagged as a straggler",
                           rank=r))
                for r in range(self.size)]
            cache = self._gauge_cache = (reg, pairs)
        return cache[1]

    def observe(self, step_times) -> List[int]:
        """Fold one per-rank step-time vector in; returns the ranks
        that JUST crossed into flagged state."""
        t = np.asarray(step_times, np.float64).reshape(-1)
        if t.shape[0] != self.size:
            raise ValueError(f"step-time vector of length {t.shape[0]} "
                             f"does not match world size {self.size}")
        med = float(np.median(t))
        mad = float(np.median(np.abs(t - med)))
        sigma = max(1.4826 * mad, self.min_rel_spread * max(med, 0.0),
                    1e-12)
        self._z = (t - med) / sigma
        above = self._z > self.z_threshold
        self._above = np.where(above, self._above + 1, 0)
        was = self._flagged
        self._flagged = self._above >= self.patience
        newly = self._flagged & ~was
        self.n_observations += 1
        reg = self._reg()
        if reg is not None:
            for r, (zg, fg) in enumerate(self._gauges(reg)):
                zg.set(float(self._z[r]))
                fg.set(1.0 if self._flagged[r] else 0.0)
        return [int(r) for r in np.nonzero(newly)[0]]

    def z_scores(self) -> Dict[int, float]:
        """Rank -> robust z snapshot of the LAST observation — the
        whole vector, not only threshold crossings, so the topology
        control plane (and an operator dashboard) can read
        sub-threshold drift before a rank is formally flagged.  A
        recovered rank's next observation recomputes its z near zero,
        so the snapshot clears with recovery (tested in
        tests/test_fleet.py); all-zero before the first observation."""
        return {int(r): float(z) for r, z in enumerate(self._z)}

    def flagged(self) -> List[int]:
        """Ranks currently flagged (clears when the streak breaks)."""
        return [int(r) for r in np.nonzero(self._flagged)[0]]

"""Simulated serving replicas + fleet driver around the REAL router.

Port of ``bluefog_tpu/sim/serving.py``, copied unchanged over the
port's ``FifoScheduler``, ``FleetRouter``, ``MetricsRegistry``, flight
recorder and ``percentile``.

The scale bottleneck in the serving benches is the model forward, not
the control plane — so :class:`SimReplica` keeps the
:class:`~bluefog_tpu_torch.serving.engine.ServingEngine`'s exact host
bookkeeping (the same :class:`~bluefog_tpu_torch.serving.scheduler
.FifoScheduler`, the same LIFO slot pool discipline, the same
admit → chunked-prefill → decode-horizon step order, the same metric
publication points) and deletes only the device work, charging the
calibrated :class:`~bluefog_tpu_torch.sim.cost.CostModel` instead.  Every
family lands in the replica's own
:class:`~bluefog_tpu_torch.observe.MetricsRegistry` under the names the real
:class:`~bluefog_tpu_torch.serving.metrics.ServingMetrics` uses —
``bf_serving_slot_occupancy``, ``bf_serving_queue_depth``,
``bf_serving_ttft_seconds``, ``bf_serving_last_step_ts``, … — which is
what makes the REAL :class:`~bluefog_tpu_torch.serving.fleet.FleetRouter`
drive simulated fleets unmodified: its gossip scrapes those exact
gauges.  With the same clock, trace, and router configuration, the
sim's routing decisions are BIT-EQUAL to a lockstep real-engine run
(``tests/test_torch_sim_serving.py`` asserts it at 3 replicas).

Unlike :class:`~bluefog_tpu_torch.serving.metrics.ServingMetrics`, the sim's
metrics shim keeps NO per-request records — per-request state lives on
the :class:`SimRequest` itself and percentile families are the
registry's windowed histograms — so a million-request trace holds
memory at O(fleet), not O(requests).

:class:`SimServingFleet` is the lockstep driver: every live replica
steps each tick (``cost.step_s`` virtual seconds), arrivals due by the
tick are routed through one held router snapshot (one gossip amortized
over the tick's admissions, the router's documented batch idiom), the
clock idle-jumps to the next arrival when the fleet drains, and
replica death evacuates residents token-exact through the router's
dead-masked walk — the same failover the chaos bench measures, at
fleet sizes it cannot reach.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.serving.scheduler import (FifoScheduler,
                                                 RequestRejected)
from bluefog_tpu_torch.sim.clock import VirtualClock
from bluefog_tpu_torch.sim.cost import CostModel
from bluefog_tpu_torch.sim.engine import EventLog, Simulation

__all__ = ["SimRequest", "SimReplica", "SimServingFleet"]

# request states — the serving engine's exact vocabulary
# (bluefog_tpu_torch/serving/engine.py), so event logs and ``retired_total``
# outcome labels read identically across sim and real runs
QUEUED, PREFILL, DECODE = "queued", "prefill", "decode"
COMPLETED, CANCELLED, REJECTED = "completed", "cancelled", "rejected"
FAILOVER = "failover"


class SimRequest:
    """One simulated request: the engine's host-visible request state
    without token values (lengths drive every control decision — the
    tokens themselves never influenced routing, admission, or
    retirement except through EOS, which a trace models as a budget)."""

    __slots__ = ("rid", "prompt_len", "max_new_tokens", "deadline",
                 "state", "slot", "n_tokens", "submit_t",
                 "first_token_t", "finish_t", "_prefill_pos", "_cancel")

    def __init__(self, rid, prompt_len: int, max_new_tokens: int,
                 deadline: Optional[float] = None):
        if prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.rid = rid
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline
        self.state = QUEUED
        self.slot: Optional[int] = None
        self.n_tokens = 0
        self.submit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self._prefill_pos = 0
        self._cancel = False

    @property
    def done(self) -> bool:
        return self.state in (COMPLETED, CANCELLED, REJECTED)


class _SimMetrics:
    """Record-free twin of :class:`~bluefog_tpu_torch.serving.metrics
    .ServingMetrics`: identical registry families (names, help text,
    labels), O(1) state.  Exposes ``_registry`` because that is the
    attribute :class:`FleetRouter` reads off ``engine.metrics``."""

    def __init__(self, registry):
        self._registry = registry
        self.n_rejected = 0
        self.n_failovers = 0
        self.last_step_ts: Optional[float] = None

    def on_submit(self, now: float):
        self._registry.counter("bf_serving_requests_total",
                               "requests submitted").inc()

    def on_reject(self, now: float):
        self.n_rejected += 1
        self._registry.counter(
            "bf_serving_rejected_total",
            "requests refused (backpressure or too long)").inc()

    def on_admit(self, now: float):
        pass  # the real shim's admit work is span bookkeeping only

    def on_first_token(self, req: SimRequest, now: float):
        self._registry.histogram("bf_serving_ttft_seconds",
                                 "submit -> first token").observe(
                                     now - req.submit_t)
        self._registry.counter("bf_serving_tokens_total",
                               "tokens generated").inc()

    def on_tokens(self, n: int):
        """Batch form of ``on_token`` — ``n`` non-first tokens this
        step (counters add; one inc per slot-step, not per token)."""
        if n > 0:
            self._registry.counter("bf_serving_tokens_total",
                                   "tokens generated").inc(n)

    def on_retire(self, req: SimRequest, now: float, outcome: str):
        req.finish_t = now
        self._registry.counter("bf_serving_retired_total",
                               "requests retired", outcome=outcome).inc()
        self._registry.histogram("bf_serving_latency_seconds",
                                 "submit -> retire").observe(
                                     now - req.submit_t)

    def on_failover(self, now: float):
        self.n_failovers += 1
        self._registry.counter(
            "bf_serving_failovers_total",
            "requests handed off to another replica").inc()

    def on_prefill_chunk(self):
        self._registry.counter("bf_serving_prefill_chunks_total",
                               "cold prefill chunks computed").inc()

    def on_step(self, occupancy: float, queue_depth: int,
                step_seconds: Optional[float] = None,
                now: Optional[float] = None):
        reg = self._registry
        reg.counter("bf_serving_steps_total", "engine steps").inc()
        reg.gauge("bf_serving_slot_occupancy",
                  "active slots / capacity, last step").set(occupancy)
        reg.gauge("bf_serving_queue_depth",
                  "queued requests, last step").set(queue_depth)
        if now is not None:
            self.last_step_ts = now
            reg.gauge("bf_serving_last_step_ts",
                      "engine-clock time of the last step").set(now)
        if step_seconds is not None:
            reg.histogram("bf_step_wall_seconds",
                          "train/engine step wall time",
                          loop="serving").observe(step_seconds)


class SimReplica:
    """One simulated serving replica — the engine's host bookkeeping
    with the device work replaced by the cost model (module docs)."""

    def __init__(self, name: str, *, capacity: int, max_len: int,
                 prefill_chunk: int = 32, decode_horizon: int = 1,
                 prefill_budget: int = 1, max_queue: int = 64,
                 clock: Optional[VirtualClock] = None,
                 cost: Optional[CostModel] = None,
                 registry=None):
        from bluefog_tpu_torch.observe import MetricsRegistry

        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = str(name)
        self.capacity = int(capacity)
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk)
        self.decode_horizon = int(decode_horizon)
        self.prefill_budget = int(prefill_budget)
        self.clock = clock if clock is not None else VirtualClock()
        self.cost = cost if cost is not None else CostModel()
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        self.metrics = _SimMetrics(self.registry)
        self.scheduler = FifoScheduler(max_queue=max_queue)
        # LIFO slot pool, identical discipline to KVSlotPool: initial
        # allocs ascend 0,1,2…; a freed slot is reused first
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._running: Dict[int, SimRequest] = {}
        self._admitting: Optional[SimRequest] = None
        self.dead = False
        self.reject_submits = False
        self.n_steps = 0

    # -- state views --------------------------------------------------- #
    @property
    def n_free(self) -> int:
        return len(self._free)

    def occupancy(self) -> float:
        return (self.capacity - len(self._free)) / self.capacity

    @property
    def busy(self) -> bool:
        return bool(self._running or self._admitting
                    or self.scheduler.queue_depth)

    # -- the engine surface the router uses ----------------------------- #
    def submit(self, request: SimRequest) -> SimRequest:
        """Mirror of ``ServingEngine.submit``: ``ValueError`` for a
        request no slot can ever hold, :class:`RequestRejected` for
        backpressure (and for a dead/fault-rejecting replica — the
        walk-through signal the router falls through on)."""
        total = request.prompt_len + request.max_new_tokens
        if total > self.max_len:
            request.state = REJECTED
            self.metrics.on_reject(self.clock())
            raise ValueError(
                f"request needs {total} cache positions but slots hold "
                f"{self.max_len} (prompt {request.prompt_len} + "
                f"max_new_tokens {request.max_new_tokens})")
        now = self.clock()
        if self.dead or self.reject_submits:
            self.metrics.on_reject(now)
            raise RequestRejected(
                "replica dead" if self.dead else "replica rejecting",
                queue_depth=self.scheduler.queue_depth,
                max_queue=self.scheduler.max_queue)
        try:
            self.scheduler.submit(request)
        except RequestRejected:
            request.state = REJECTED
            self.metrics.on_reject(now)
            raise
        request.state = QUEUED
        request.submit_t = now
        self.metrics.on_submit(now)
        return request

    # -- the serving loop ---------------------------------------------- #
    def step(self) -> bool:
        """One engine iteration, the real step's exact order: shed and
        cancel, admit + budgeted prefill chunks, decode one horizon for
        every active slot, publish the step gauges.  Device time is the
        DRIVER's to charge (``cost.step_s`` per lockstep tick)."""
        now = self.clock()
        # 1. deadline shedding in the queue
        for req in self.scheduler.expire(now):
            req.state = CANCELLED
            self.metrics.on_retire(req, now, CANCELLED)
        # 2. running cancellations (explicit or deadline)
        live = list(self._running.values())
        if self._admitting is not None:
            live.append(self._admitting)
        for req in live:
            if req._cancel or (req.deadline is not None
                               and now >= req.deadline):
                self._retire(req, CANCELLED, now)
        # 3+4. admission + chunked prefill under the per-step budget
        chunks = 0
        while chunks < self.prefill_budget:
            if self._admitting is None:
                if not self._free:
                    break
                req = self.scheduler.admit(now)
                if req is None:
                    break
                req.slot = self._free.pop()
                self.metrics.on_admit(now)
                n_ctx = req.prompt_len + req.n_tokens
                if n_ctx > 1:
                    req.state = PREFILL
                    self._admitting = req
                else:  # single-token prompt: straight to decode
                    req.state = DECODE
                    self._running[req.slot] = req
                    continue
            self._prefill_one_chunk(self._admitting)
            chunks += 1
        # 5. one decode horizon for every active slot
        decoding = [r for r in self._running.values()
                    if r.state == DECODE]
        if decoding:
            now2 = self.clock()
            for req in decoding:
                emitted = 0
                for _ in range(self.decode_horizon):
                    first = req.n_tokens == 0
                    req.n_tokens += 1
                    if first:
                        req.first_token_t = now2
                        self.metrics.on_first_token(req, now2)
                    else:
                        emitted += 1
                    if req.n_tokens >= req.max_new_tokens:
                        self._retire(req, COMPLETED, now2)
                        break
                self.metrics.on_tokens(emitted)
        self.n_steps += 1
        self.metrics.on_step(self.occupancy(),
                             self.scheduler.queue_depth,
                             self.cost.step_s, now=now)
        return self.busy

    def _prefill_one_chunk(self, req: SimRequest) -> None:
        n_prefill = req.prompt_len + req.n_tokens - 1
        valid = min(self.prefill_chunk, n_prefill - req._prefill_pos)
        self.metrics.on_prefill_chunk()
        req._prefill_pos += valid
        if req._prefill_pos < n_prefill:
            return
        self._admitting = None
        self._running[req.slot] = req
        req.state = DECODE

    def _retire(self, req: SimRequest, outcome: str,
                now: float) -> None:
        if req is self._admitting:
            self._admitting = None
        if req.slot is not None:
            self._running.pop(req.slot, None)
            self._free.append(req.slot)
            req.slot = None
        req.state = outcome
        self.metrics.on_retire(req, now, outcome)

    # -- failover ------------------------------------------------------- #
    def evacuate(self) -> List[SimRequest]:
        """Replica death: hand every unfinished resident (queued,
        prefilling, decoding) back to the driver with its emitted-token
        count intact — the token-exact failover contract.  Residents
        that held a slot retire here with outcome ``failover``; each
        departing request counts one ``bf_serving_failovers_total``."""
        now = self.clock()
        out: List[SimRequest] = []
        for req in self.scheduler.drain():
            req.state = FAILOVER
            self.metrics.on_failover(now)
            out.append(req)
        residents = list(self._running.values())
        if self._admitting is not None:
            residents.append(self._admitting)
        for req in residents:
            self.metrics.on_failover(now)
            self._retire(req, FAILOVER, now)
            req._prefill_pos = 0  # the inheriting replica replays
            # prefill over (prompt ‖ tokens)[:-1], like a real resume
            out.append(req)
        return out


class SimServingFleet:
    """Lockstep fleet driver around the real router (module docs)."""

    def __init__(self, replicas: Sequence[SimReplica], *,
                 cost: Optional[CostModel] = None,
                 sim: Optional[Simulation] = None,
                 fault_plan=None,
                 router=None, router_kwargs: Optional[dict] = None,
                 poll_every: int = 1, blackbox=None):
        from bluefog_tpu_torch.serving.fleet import FleetRouter

        if not replicas:
            raise ValueError("SimServingFleet needs >= 1 replica")
        if poll_every < 1:
            raise ValueError(f"poll_every must be >= 1, got {poll_every}")
        self.replicas = list(replicas)
        clocks = {id(r.clock) for r in self.replicas}
        if len(clocks) != 1:
            raise ValueError("replicas must share one VirtualClock")
        self.clock: VirtualClock = self.replicas[0].clock
        self.cost = cost if cost is not None else self.replicas[0].cost
        self.sim = sim if sim is not None else Simulation(
            clock=self.clock)
        if self.sim.clock is not self.clock:
            raise ValueError("simulation and replicas must share one "
                             "VirtualClock")
        self.log: EventLog = self.sim.log
        self.fault_plan = fault_plan
        if router is None:
            kw = dict(router_kwargs or {})
            kw.setdefault("clock", self.clock)
            # seeded-backoff sleeps burn VIRTUAL seconds
            kw.setdefault("sleep", self.clock.advance)
            kw.setdefault("blackbox", blackbox)
            router = FleetRouter(self.replicas, **kw)
        self.router = router
        # scrape cadence in ticks: 1 re-polls every arrival tick (the
        # bit-equal-lockstep default); >1 amortizes one gossip scrape
        # over that many ticks' admissions — the router's documented
        # batch idiom, and what makes a million-request trace cheap
        # (the scrape's percentile walk is the sim's hot path)
        self.poll_every = int(poll_every)
        self.blackbox = blackbox
        self.tick = 0
        self.polls = 0
        self.lost = 0
        self.failovers = 0

    def _decide(self, kind, **detail):
        from bluefog_tpu_torch.observe import blackbox as _blackbox

        return _blackbox.record_decision(
            "sim_serving", kind, step=self.tick,
            blackbox=self.blackbox, detail=detail or None)

    # -- fleet views ---------------------------------------------------- #
    def dead_mask(self) -> np.ndarray:
        return np.array([r.dead for r in self.replicas], bool)

    def _poll(self):
        snap = self.router.poll(dead_mask=self.dead_mask())
        self.polls += 1
        if self.cost.gossip_round_s:
            self.clock.advance(self.cost.poll_s(snap.rounds))
        return snap

    # -- fault-plan application ----------------------------------------- #
    def _apply_faults(self, tick: int) -> List[float]:
        """Apply ``ServingFaultPlan`` state for this tick: death
        transitions (with token-exact evacuation + re-route), revivals,
        submit-rejection windows.  Returns per-replica stall seconds —
        a stalled replica skips this tick's step (its heartbeat
        freezes; staleness is the router's to judge)."""
        stalls = [0.0] * len(self.replicas)
        plan = self.fault_plan
        if plan is None:
            return stalls
        for i, r in enumerate(self.replicas):
            dead = bool(plan.is_dead(i, tick))
            if dead and not r.dead:
                self._kill(i)
            elif r.dead and not dead:
                r.dead = False  # revived: empty, cold, routable again
                self.log.record(self.clock.t, "replica_up", r.name)
            r.reject_submits = bool(plan.rejects_submit(i, tick))
            stalls[i] = float(plan.stall_seconds(i, tick))
        return stalls

    def _kill(self, idx: int) -> None:
        r = self.replicas[idx]
        residents = r.evacuate()
        r.dead = True
        self.log.record(self.clock.t, "replica_down", r.name,
                        evacuated=len(residents))
        if not residents:
            return
        snap = self._poll()  # fresh dead-masked view for the re-route
        for req in residents:
            try:
                j, _ = self.router.submit(req, snapshot=snap,
                                          dead_mask=self.dead_mask())
            except RequestRejected:
                self.lost += 1
                self.log.record(self.clock.t, "lost", rid=req.rid)
                self._decide("lost", rid=int(req.rid), replica=r.name)
            else:
                self.failovers += 1
                self.log.record(self.clock.t, "failover",
                                self.replicas[j].name, rid=req.rid)
                self._decide("failover", rid=int(req.rid),
                             to=self.replicas[j].name)

    # -- the run loop --------------------------------------------------- #
    def run(self, trace, *, max_ticks: Optional[int] = None) -> dict:
        """Drive ``trace`` to completion (or ``max_ticks``): per tick —
        deliver due scheduled events, apply the fault plan, route every
        arrival due by now against ONE held router snapshot (refreshed
        at most every ``poll_every`` clock advances), then step every
        live unstalled replica in lockstep and advance the clock by the
        calibrated step cost.  An idle fleet jumps straight to the next
        arrival."""
        arrivals = trace.arrivals
        n = trace.n
        i = 0
        snap = None
        snap_age = self.poll_every  # the first arrival polls fresh
        while True:
            self.sim.run(until=self.clock.t)
            stalls = self._apply_faults(self.tick)
            if i < n and arrivals[i] <= self.clock.t:
                if snap is None or snap_age >= self.poll_every:
                    snap = self._poll()
                    snap_age = 0
                while i < n and arrivals[i] <= self.clock.t:
                    req = SimRequest(
                        i, int(trace.prompt_lens[i]),
                        int(trace.budgets[i]),
                        deadline=(float(trace.deadlines[i])
                                  if trace.deadlines is not None
                                  else None))
                    try:
                        j, _ = self.router.submit(
                            req, snapshot=snap,
                            dead_mask=self.dead_mask())
                    except RequestRejected:
                        self.lost += 1
                        self.log.record(self.clock.t, "lost", rid=i)
                        self._decide("lost", rid=int(i))
                    else:
                        self.log.record(self.clock.t, "route",
                                        self.replicas[j].name, rid=i)
                    i += 1
            if not any(r.busy for r in self.replicas if not r.dead):
                if i >= n:
                    break
                self.clock.jump_to(float(arrivals[i]))
                snap_age += 1
                continue
            # a stalled replica holds its work but skips the tick — its
            # heartbeat freezes while the stall window's ticks elapse
            for k, r in enumerate(self.replicas):
                if not r.dead and stalls[k] <= 0.0:
                    r.step()
            self.clock.advance(self.cost.step_s)
            snap_age += 1
            self.tick += 1
            if max_ticks is not None and self.tick >= max_ticks:
                break
        return self.summary()

    # -- summaries ------------------------------------------------------ #
    def _sum_counter(self, name: str, **labels) -> float:
        total = 0.0
        for r in self.replicas:
            for n_, kind, _h, lab, m in r.registry.collect():
                if n_ == name and kind == "counter" and all(
                        lab.get(k) == v for k, v in labels.items()):
                    total += m.value
        return total

    def _merged_percentile(self, name: str, q: float) -> float:
        from bluefog_tpu_torch.observe.registry import percentile

        values: List[float] = []
        for r in self.replicas:
            for n_, kind, _h, _lab, m in r.registry.collect():
                if n_ == name and kind == "histogram":
                    values.extend(m.window_values)
        return percentile(values, q)

    def summary(self) -> dict:
        """Fleet totals from the same registry families an exporter
        would scrape (percentiles are over the histograms' retained
        windows — recent-biased by design at million-request scale)."""
        t = self.clock.t
        tokens = self._sum_counter("bf_serving_tokens_total")
        return {
            "replicas": len(self.replicas),
            "ticks": self.tick,
            "virtual_seconds": t,
            "routed": self.router.n_routed,
            "saturated": self.router.n_saturated,
            "lost_requests": self.lost,
            "failovers": self.failovers,
            "polls": self.polls,
            "submitted": self._sum_counter("bf_serving_requests_total"),
            "completed": self._sum_counter("bf_serving_retired_total",
                                           outcome=COMPLETED),
            "cancelled": self._sum_counter("bf_serving_retired_total",
                                           outcome=CANCELLED),
            "tokens_total": tokens,
            "tokens_per_vsec": tokens / t if t > 0 else 0.0,
            "ttft_p50_vs": self._merged_percentile(
                "bf_serving_ttft_seconds", 50),
            "ttft_p99_vs": self._merged_percentile(
                "bf_serving_ttft_seconds", 99),
            "latency_p50_vs": self._merged_percentile(
                "bf_serving_latency_seconds", 50),
            "events": self.log.n,
            "event_digest": self.log.digest(),
        }

"""The port's fleet router (bluefog_tpu_torch/serving/fleet.py) on tiny
f32 Llama engines, mirroring the router tests of
tests/test_fleet_serving.py and tests/test_serving_resilience.py: signal
scraping, determinism and the preference for idle replicas, spreading
and ``FleetSaturated`` backpressure with its causes, dead-replica and
staleness excision with re-admission, seeded retries, cooldown and
publication; placements equal the JAX router's when both read registries
holding the same values; and a replica's death failed over through
``router.submit`` resumes every stream (greedy and sampled) bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bluefog_tpu import models as jm
from bluefog_tpu.observe.registry import MetricsRegistry as JRegistry
from bluefog_tpu.serving import fleet as jfleet
from bluefog_tpu.serving.scheduler import RequestRejected as JRejected
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.observe.registry import MetricsRegistry
from bluefog_tpu_torch.resilience import ServingFaultPlan
from bluefog_tpu_torch.serving import (FaultyReplica, FleetRouter,
                                       FleetSaturated, PrefixCache, Request,
                                       RequestRejected, ServingEngine,
                                       collect_serving_signals,
                                       failover_stranded, seeded_backoff)

MAX_LEN = 48


@pytest.fixture(scope="module")
def weights():
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    variables = jm.Llama(cfg).init(jax.random.PRNGKey(1),
                                   jnp.zeros((2, 4), jnp.int32))
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    model = bt.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_flax(
        jax.tree.map(np.asarray, variables), tcfg, device="cpu"))
    return tcfg, model


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _engine(weights, clock=None, prefix=None, **kw):
    tcfg, model = weights
    kw.setdefault("capacity", 2)
    kw.setdefault("max_queue", 2)
    return ServingEngine(model, tcfg, max_len=MAX_LEN, prefill_chunk=4,
                         clock=clock, registry=MetricsRegistry(),
                         prefix_cache=prefix if prefix is not None else False,
                         device="cpu", **kw)


def _fleet(weights, n, clock=None, engine_kw=None, **router_kw):
    engines = [_engine(weights, clock, **(engine_kw or {}))
               for _ in range(n)]
    regs = [e.metrics._registry for e in engines]
    return engines, regs, FleetRouter(engines, registries=regs, clock=clock,
                                      **router_kw)


def _req(rs, n=4, new=3, **kw):
    return Request(rs.randint(0, 256, (n,)).astype(np.int32), new, **kw)


def test_collect_serving_signals(weights):
    reg = MetricsRegistry()
    tcfg, model = weights
    eng = ServingEngine(model, tcfg, capacity=2, max_len=MAX_LEN,
                        prefill_chunk=4, registry=reg, device="cpu")
    assert collect_serving_signals(reg) == {
        "occupancy": 0.0, "queue_depth": 0.0, "ttft_p50": 0.0,
        "last_step_ts": -1.0}
    eng.submit(Request(np.arange(5, dtype=np.int32), 3))
    eng.run()
    sig = collect_serving_signals(reg)
    assert sig["ttft_p50"] >= 0.0 and sig["last_step_ts"] >= 0.0
    # the JAX scraper reads the same values out of a registry holding them
    jreg = JRegistry()
    _copy_gauges(reg, jreg)
    assert jfleet.collect_serving_signals(jreg) == sig


def _copy_gauges(reg, jreg):
    for name, kind, help_, labels, m in reg.collect():
        if kind == "gauge":
            jreg.gauge(name, help_, **labels).set(m.value)
        elif kind == "histogram":
            h = jreg.histogram(name, help_, **labels)
            for v in list(m._window):
                h.observe(v)


def test_router_is_deterministic_and_prefers_idle(weights):
    engines, regs, router = _fleet(weights, 3)
    rs = np.random.RandomState(5)
    engines[0].submit(_req(rs, 5, 6))
    engines[0].step()
    s1, s2 = router.poll(), router.poll()
    assert s1.order == s2.order
    np.testing.assert_array_equal(s1.scores, s2.scores)
    np.testing.assert_array_equal(s1.signals, s2.signals)
    assert s1.order[-1] == 0            # the busy replica ranks last
    assert s1.rounds > 0 and s1.spread <= 1e-10
    other = FleetRouter(engines, registries=regs, rank=2)
    np.testing.assert_allclose(other.poll().signals, s1.signals,
                               rtol=1e-9, atol=1e-12)
    _, _, router1 = _fleet(weights, 1)
    snap = router1.poll()
    assert snap.rounds == 0 and snap.order == (0,)


def test_router_spreads_and_saturates(weights):
    engines, _, router = _fleet(weights, 2, engine_kw=dict(capacity=1,
                                                            max_queue=1))
    rs = np.random.RandomState(6)
    picks = [router.submit(_req(rs))[0] for _ in range(2)]
    assert sorted(picks) == [0, 1]
    for e in engines:
        e.step()
    for _ in range(2):
        router.submit(_req(rs))
    with pytest.raises(FleetSaturated) as ei:
        router.submit(_req(rs))
    assert isinstance(ei.value, RequestRejected)
    assert ei.value.queue_depths == [1, 1]
    assert router.summary()["n_saturated"] == 1
    for e in engines:
        e.run()
    assert all(e.pool.n_active == 0 for e in engines)


def test_router_dead_replica_excised(weights):
    engines, _, router = _fleet(weights, 2)
    snap = router.poll(dead_mask=[False, True])
    assert snap.order[0] == 0 and not np.isfinite(snap.scores[1])
    idx, _ = router.submit(Request(np.arange(4, dtype=np.int32), 3),
                           snapshot=snap)
    assert idx == 0
    engines[0].run()


def test_router_publish_lands_fleet_gauges(weights):
    pub = MetricsRegistry()
    engines, _, router = _fleet(weights, 2, registry=pub)
    router.submit(Request(np.arange(5, dtype=np.int32), 3))
    for e in engines:
        e.run()
    router.publish()
    names = {n for n, *_ in pub.collect()}
    assert {"bf_fleet_serving_occupancy", "bf_fleet_serving_queue_depth",
            "bf_fleet_serving_ttft_p50", "bf_fleet_serving_best_replica",
            "bf_replica_suspect"} <= names


class _Stub:
    """A replica that takes a submit unless its queue is full."""

    def __init__(self, depth, max_queue, rejected):
        self.depth, self.max_queue, self._rejected = depth, max_queue, rejected

    def submit(self, req):
        if self.depth >= self.max_queue:
            raise self._rejected("queue full", queue_depth=self.depth,
                                 max_queue=self.max_queue)
        self.depth += 1
        return req


def test_placements_equal_the_jax_routers():
    """Both routers read registries holding the same gauges (occupancy,
    queue depth, TTFT windows, heartbeats), over 30 random fleets with
    dead masks, stale replicas and full queues: the same signals,
    scores, order, suspects and the same replica for every submit."""
    rng = np.random.default_rng(3)
    for trial in range(30):
        n = int(rng.integers(1, 6))
        clock = _Clock()
        clock.t = 10.0
        regs, jregs = [], []
        depths = rng.integers(0, 3, n)
        for i in range(n):
            occ = float(rng.integers(0, 5)) / 4
            ttfts = rng.exponential(0.2, int(rng.integers(0, 4)))
            beat = float(rng.choice([-1.0, 9.9, 8.0]))
            for R, lst in ((MetricsRegistry, regs), (JRegistry, jregs)):
                reg = R()
                reg.gauge("bf_serving_slot_occupancy").set(occ)
                reg.gauge("bf_serving_queue_depth").set(float(depths[i]))
                lst.append(reg)
                for v in ttfts:
                    reg.histogram("bf_serving_ttft_seconds").observe(v)
                if beat >= 0:
                    reg.gauge("bf_serving_last_step_ts").set(beat)
        dead = rng.random(n) < 0.2 if n > 1 else None
        if dead is not None and dead.all():
            dead[0] = False
        kw = dict(stale_after=1.0, clock=clock, rank=int(rng.integers(0, n)))
        ours = FleetRouter([_Stub(d, 2, RequestRejected) for d in depths],
                           registries=regs, **kw)
        theirs = jfleet.FleetRouter([_Stub(d, 2, JRejected) for d in depths],
                                    registries=jregs, **kw)
        s, js = ours.poll(dead_mask=dead), theirs.poll(dead_mask=dead)
        np.testing.assert_allclose(s.signals, js.signals, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_array_equal(s.scores, js.scores)
        assert (s.order, s.suspect, s.ages, s.rounds) == \
            (js.order, js.suspect, js.ages, js.rounds)
        for _ in range(3):
            try:
                got = ours.submit(object(), snapshot=s)[0]
            except FleetSaturated as e:
                got = ("saturated", e.queue_depths)
            try:
                want = theirs.submit(object(), snapshot=js)[0]
            except jfleet.FleetSaturated as e:
                want = ("saturated", e.queue_depths)
            assert got == want, trial


def test_staleness_guard_excises_and_readmits(weights):
    clock = _Clock()
    engines, _, router = _fleet(weights, 3, clock, stale_after=1.0)
    snap = router.poll()
    assert snap.suspect == (False, False, False)
    assert snap.ages == (-1.0, -1.0, -1.0)
    assert snap.as_dict()["ages"] == [-1.0, -1.0, -1.0]
    for e in engines:
        e.step()
    clock.advance(0.5)
    engines[0].step()
    engines[1].step()
    clock.advance(0.8)
    snap = router.poll()
    assert snap.suspect == (False, False, True)
    assert snap.ages[2] == pytest.approx(1.3)
    assert not np.isfinite(snap.scores[2])
    assert router.submit(Request(np.arange(5, dtype=np.int32), 2),
                         snapshot=snap)[0] != 2
    engines[2].step()
    snap = router.poll()
    assert snap.suspect == (False, False, False)
    assert np.isfinite(snap.scores[2])
    snap = router.poll(dead_mask=[False, True, False])
    assert not np.isfinite(snap.scores[1])
    assert router.submit(Request(np.arange(5, dtype=np.int32), 2),
                         snapshot=snap)[0] != 1
    snap = router.poll(dead_mask=[False, False, False])
    assert np.all(np.isfinite(snap.scores)) and 1 in snap.order


def test_fleet_saturated_carries_causes(weights):
    engines, _, router = _fleet(weights, 2, _Clock())
    for _ in range(2):
        for e in engines:
            e.submit(Request(np.arange(5, dtype=np.int32), 2))
    with pytest.raises(FleetSaturated) as ei:
        router.submit(Request(np.arange(5, dtype=np.int32), 2))
    exc = ei.value
    assert exc.queue_depths == [2, 2]
    assert [i for i, _ in exc.causes] == [0, 1]
    assert all(isinstance(c, RequestRejected) for _, c in exc.causes)
    assert "queue full" in str(exc.causes[0][1])


def test_router_retries_absorb_transient_rejection(weights):
    clock = _Clock()
    slept, reps = [], []

    def vsleep(dt):
        slept.append(dt)
        clock.advance(dt)
        for rep in reps:
            rep.step()

    engines, _, router = _fleet(weights, 2, clock, retries=2,
                                retry_base_s=0.01, sleep=vsleep, seed=3)
    plan = ServingFaultPlan.submit_rejection(2, 0, step=0, duration=1) \
        .merged(ServingFaultPlan.submit_rejection(2, 1, step=0, duration=1))
    reps[:] = [FaultyReplica(e, plan, i) for i, e in enumerate(engines)]
    router.engines = list(reps)
    req = Request(np.arange(5, dtype=np.int32), 2)
    i, _ = router.submit(req)
    assert i in (0, 1) and slept
    assert slept[0] == seeded_backoff(0, base=0.01, seed=3, salt=req.rid)
    engines2, _, router2 = _fleet(weights, 2, clock)
    plan2 = ServingFaultPlan.submit_rejection(2, 0, step=0, duration=9) \
        .merged(ServingFaultPlan.submit_rejection(2, 1, step=0, duration=9))
    router2.engines = [FaultyReplica(e, plan2, i)
                       for i, e in enumerate(engines2)]
    with pytest.raises(FleetSaturated) as ei:
        router2.submit(Request(np.arange(5, dtype=np.int32), 2))
    assert len(ei.value.causes) == 2


def test_cooldown_demotes_but_never_saturates(weights, monkeypatch):
    clock = _Clock()
    engines, _, router = _fleet(weights, 2, clock, cooldown_s=10.0,
                                cooldown_after=1)
    plan = ServingFaultPlan.submit_rejection(2, 0, step=0, duration=10 ** 6)
    router.engines = [FaultyReplica(engines[0], plan, 0), engines[1]]
    assert router.submit(Request(np.arange(5, dtype=np.int32), 2))[0] == 1
    assert router._cooldown_until[0] > clock()
    snap = router.poll()
    assert router._walk(snap, clock())[-1] == 0
    assert router.submit(Request(np.arange(5, dtype=np.int32), 2))[0] == 1
    # the knobs' env names and defaults are the JAX package's
    for name, value, attr in (("BLUEFOG_REPLICA_STALE_S", "2.5",
                               "stale_after"),
                              ("BLUEFOG_ROUTER_RETRIES", "4", "retries"),
                              ("BLUEFOG_ROUTER_RETRY_BASE_S", "0.2",
                               "retry_base_s"),
                              ("BLUEFOG_ROUTER_COOLDOWN_S", "7", "cooldown_s")):
        monkeypatch.setenv(name, value)
        assert getattr(FleetRouter(engines), attr) == float(value)
        monkeypatch.delenv(name)
    r = FleetRouter(engines)
    assert (r.stale_after, r.retries, r.retry_base_s, r.cooldown_s) == \
        (0.0, 0, 0.05, 0.0)


def test_failover_through_the_router_is_token_exact(weights):
    """Replica 1 of three dies mid-run; the staleness guard excises it,
    ``failover_stranded(resubmit=router.submit)`` moves its requests to
    the survivors sharing the prefix cache, and every output (greedy and
    sampled) equals an unfaulted single-engine run's bit for bit."""
    rs = np.random.RandomState(11)
    reqs = [Request(rs.randint(0, 256, (int(rs.randint(6, 14)),)).astype(
        np.int32), 6, temperature=(0.0, 0.9)[i % 2], seed=100 + i)
        for i in range(6)]

    def clone(r):
        return Request(r.prompt.copy(), r.max_new_tokens,
                       temperature=r.temperature, seed=r.seed)

    ref_eng = _engine(weights, max_queue=8)
    ref = [ref_eng.submit(clone(r)) for r in reqs]
    ref_eng.run()
    clock = _Clock()
    prefix = PrefixCache(4, 1 << 24)
    engines = [_engine(weights, clock, prefix=prefix, max_queue=8)
               for _ in range(3)]
    plan = ServingFaultPlan.replica_death(3, 1, step=8)
    reps = [FaultyReplica(e, plan, i) for i, e in enumerate(engines)]
    router = FleetRouter(reps, registries=[e.metrics._registry
                                           for e in engines],
                         clock=clock, stale_after=0.05)
    live, placed = [], []
    moved = None
    for _ in range(200):
        if len(live) < len(reqs):   # one arrival a round: the gauges move
            i, req = router.submit(clone(reqs[len(live)]))
            live.append(req)
            placed.append(i)
        clock.advance(0.01)
        for rep in reps:
            rep.step()
        snap = router.poll()
        if snap.suspect[1] and moved is None:
            assert reps[1].dead
            moved, expired = failover_stranded(reps[1], router.submit)
            assert expired == [] and moved
        if all(r.done for r in live):
            break
    assert moved is not None and sorted(set(placed)) == [0, 1, 2]
    assert not engines[1]._running and engines[1].scheduler.queue_depth == 0
    for r, want in zip(live, ref):
        assert r.state == "completed"
        np.testing.assert_array_equal(r.output(), want.output())
    assert sum(e.metrics.summary()["prefix_chunks_restored"]
               for e in engines) > 0

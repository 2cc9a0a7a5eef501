"""The port's fleet simulator (bluefog_tpu_torch/sim/, benchutil) against
the JAX package's on the CPU: the host-only tests of ``tests/test_sim.py``,
each run over both packages on the same seeds.

Both simulators are host numpy over their package's own router,
scheduler, registry and flight recorder, so every event log and digest
must be BYTE-equal, and the arrival generators bit-equal.  The source
scan at the end holds ``bluefog_tpu_torch/sim/`` to the JAX package's
``wallclock-in-sim`` contract: no wall-clock read anywhere in the
package (the one timed path, ``measure_step_cost``, takes an injected
timer).
"""

import ast
import types
from pathlib import Path

import numpy as np
import pytest

from bluefog_tpu import benchutil as JB
from bluefog_tpu import resilience as JR
from bluefog_tpu import sim as JS
from bluefog_tpu.serving.scheduler import RequestRejected as JRejected

from bluefog_tpu_torch import benchutil as TB
from bluefog_tpu_torch import resilience as R
from bluefog_tpu_torch import sim as TS
from bluefog_tpu_torch.serving.scheduler import RequestRejected

pytestmark = pytest.mark.sim

ROOT = Path(__file__).resolve().parents[1]
JAX = types.SimpleNamespace(S=JS, B=JB, R=JR)
PORT = types.SimpleNamespace(S=TS, B=TB, R=R)
SIDES = (JAX, PORT)


def test_sim_exports_jax_names():
    assert TS.__all__ == JS.__all__
    for name in JS.__all__:
        assert getattr(TS, name).__module__.startswith("bluefog_tpu_torch.")


# ------------------------------------------------------------------ #
# clock + event engine determinism
# ------------------------------------------------------------------ #
def test_virtual_clock_semantics():
    for ns in SIDES:
        c = ns.S.VirtualClock()
        assert c() == 0.0
        c.advance(1.5)
        assert c() == c.t == 1.5
        c.jump_to(1.0)
        assert c.t == 1.5
        c.jump_to(2.0)
        assert c.t == 2.0
        with pytest.raises(ValueError):
            c.advance(-0.1)


def test_event_heap_fires_in_time_then_insertion_order():
    logs = []
    for ns in SIDES:
        sim = ns.S.Simulation(seed=0)
        fired = []
        sim.at(2.0, "b", lambda s, t: fired.append("b"), actor="x", k=1)
        sim.at(1.0, "a", lambda s, t: fired.append("a"))
        sim.at(2.0, "c", lambda s, t: fired.append("c"), v=0.5)
        n = sim.run()
        assert n == 3 and fired == ["a", "b", "c"]
        assert sim.clock.t == 2.0
        sim.at(3.0, "d")
        sim.run(until=5.0)
        assert sim.clock.t == 5.0 and sim.pending == 0
        with pytest.raises(ValueError):
            sim.at(4.0, "past")
        logs.append(sim.log.lines)
    assert logs[1] == logs[0]


def _draws(ns, seed):
    sim = ns.S.Simulation(seed=seed)

    def emit(s, t):
        s.log.record(t, "draw", "actor-0", value=float(s.rng.rand()))
        if s.pending < 8:
            s.after(float(s.rng.exponential(0.5)), "tick", emit)

    sim.at(0.0, "tick", emit)
    sim.run(until=10.0)
    return sim


def test_event_log_byte_equal_same_seed():
    a, b, c = _draws(PORT, 7), _draws(PORT, 7), _draws(PORT, 8)
    assert a.log.lines == b.log.lines
    assert a.log.digest() == b.log.digest()
    assert a.log.n == b.log.n > 0
    assert a.log.digest() != c.log.digest()
    j = _draws(JAX, 7)
    assert a.log.lines == j.log.lines and a.log.digest() == j.log.digest()


def test_event_log_digest_only_mode_matches_kept_lines():
    out = []
    for ns in SIDES:
        kept = ns.S.EventLog(keep_lines=True)
        bare = ns.S.EventLog(keep_lines=False)
        for log in (kept, bare):
            log.record(0.25, "route", "replica-1", rid=3, ok=True)
            log.record(1.0, "lost", rid=4)
            log.record(1.5, "snap", "", d={"b": 1, "a": [1.0, 2]},
                       f=np.float32(0.1), i=np.int64(7))
        assert bare.lines is None and bare.n == kept.n == 3
        assert bare.digest() == kept.digest()
        assert kept.lines[0] == ns.S.format_event(0.25, "route", "replica-1",
                                                  rid=3, ok=True)
        assert "ok=1" in kept.lines[0] and "0.250000000" in kept.lines[0]
        out.append((kept.lines, kept.digest()))
    assert out[1] == out[0]


# ------------------------------------------------------------------ #
# arrival generators: bit-equal to the JAX package's, seeded, monotone
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name,kw", [
    ("poisson_arrivals", {}),
    ("diurnal_arrivals", dict(period=40.0, depth=0.6)),
    ("flash_crowd_arrivals", dict(at=10.0, factor=5.0, duration=4.0)),
])
def test_arrival_generators_seeded_and_monotone(name, kw):
    gen = getattr(TB, name)
    a = gen(50.0, 2000, 3, **kw)
    b = gen(50.0, 2000, 3, **kw)
    c = gen(50.0, 2000, 4, **kw)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a[0] == 0.0
    assert np.all(np.diff(a) >= 0.0)
    assert np.isfinite(a).all()
    for seed in (0, 3, 11):
        want = getattr(JB, name)(50.0, 2000, seed, **kw)
        got = gen(50.0, 2000, seed, **kw)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert gen(50.0, 0, 1, **kw).shape == (0,)
    with pytest.raises(ValueError):
        gen(0.0, 10, **kw)


def test_diurnal_rate_integral_and_modulation():
    rate, period, depth = 200.0, 20.0, 0.8
    t = TB.diurnal_arrivals(rate, 8000, seed=1, period=period, depth=depth)
    horizon = t[-1]
    w = 2.0 * np.pi / period
    amp = rate * depth / w
    expected = rate * horizon + amp * (1.0 - np.cos(w * horizon))
    assert abs(len(t) - expected) / expected < 0.05
    phase = np.mod(t, period) / period
    assert np.sum(phase < 0.5) > 1.5 * np.sum(phase >= 0.5)
    with pytest.raises(ValueError):
        TB.diurnal_arrivals(rate, 10, depth=1.0)
    assert t.tobytes() == JB.diurnal_arrivals(
        rate, 8000, seed=1, period=period, depth=depth).tobytes()


def test_flash_crowd_rate_integral():
    rate, at, factor, dur = 100.0, 5.0, 6.0, 2.0
    t = TB.flash_crowd_arrivals(rate, 4000, seed=2, at=at, factor=factor,
                                duration=dur)
    pre = np.sum(t < at)
    burst = np.sum((t >= at) & (t < at + dur))
    assert abs(pre - rate * at) / (rate * at) < 0.15
    assert abs(burst - rate * factor * dur) / (rate * factor * dur) < 0.15
    assert (burst / dur) / (pre / at) > factor * 0.7
    assert t.tobytes() == JB.flash_crowd_arrivals(
        rate, 4000, seed=2, at=at, factor=factor, duration=dur).tobytes()


# ------------------------------------------------------------------ #
# traces + churn schedules
# ------------------------------------------------------------------ #
def test_request_trace_build_deterministic():
    arr = TB.poisson_arrivals(100.0, 64, 0)
    a = TS.RequestTrace.build(arr, seed=5, prompt_len=(2, 9),
                              new_tokens=(1, 7), deadline_slack=0.5)
    b = TS.RequestTrace.build(arr, seed=5, prompt_len=(2, 9),
                              new_tokens=(1, 7), deadline_slack=0.5)
    assert np.array_equal(a.prompt_lens, b.prompt_lens)
    assert np.array_equal(a.budgets, b.budgets)
    assert a.n == 64
    assert (a.prompt_lens >= 2).all() and (a.prompt_lens <= 9).all()
    assert (a.budgets >= 1).all() and (a.budgets <= 7).all()
    assert np.allclose(a.deadlines, arr + 0.5)
    j = JS.RequestTrace.build(JB.poisson_arrivals(100.0, 64, 0), seed=5,
                              prompt_len=(2, 9), new_tokens=(1, 7),
                              deadline_slack=0.5)
    for f in ("arrivals", "prompt_lens", "budgets", "deadlines"):
        assert getattr(a, f).tobytes() == getattr(j, f).tobytes(), f
    with pytest.raises(ValueError):
        TS.RequestTrace(arrivals=arr, prompt_lens=a.prompt_lens[:3],
                        budgets=a.budgets)


def test_churn_schedule_from_fault_plan():
    plan = R.FaultPlan.preempt(8, 3, 4, 6)
    sched = TS.ChurnSchedule.from_fault_plan(plan, 40, admit_after=2,
                                             promote_after=5)
    assert sched.ranks == [3]
    assert sched.at(4) == [TS.ChurnAction(4, 3, "die")]
    assert sched.at(12) == [TS.ChurnAction(12, 3, "admit")]
    assert sched.at(17) == [TS.ChurnAction(17, 3, "promote")]
    assert len(sched.actions) == 3
    with pytest.raises(ValueError):
        TS.ChurnAction(0, 0, "resurrect")
    # a richer plan: deaths, preemptions and rejoins, JAX's schedule
    for make in (lambda m: m.FaultPlan.preempt(8, 3, 4, 6).merged(
                     m.FaultPlan.rank_death(8, 6, 9)).merged(
                     m.FaultPlan.preempt(8, 1, 2, 20)),
                 lambda m: m.FaultPlan.preempt(8, 5, 6, 8)):
        got = TS.ChurnSchedule.from_fault_plan(make(R), 40, admit_after=1,
                                               promote_after=4)
        want = JS.ChurnSchedule.from_fault_plan(make(JR), 40, admit_after=1,
                                                promote_after=4)
        assert [(a.step, a.rank, a.action) for a in got.actions] == \
            [(a.step, a.rank, a.action) for a in want.actions]


# ------------------------------------------------------------------ #
# cost model + calibration seam
# ------------------------------------------------------------------ #
def test_cost_model_validation_and_arithmetic():
    for ns in SIDES:
        cm = ns.S.CostModel(step_s=2e-3, gossip_round_s=1e-4,
                            wire_unit_s=1e-3, a2a_unit_s=2e-3)
        assert cm.poll_s(3) == pytest.approx(3e-4)
        assert cm.wire_s(2.5) == pytest.approx(2.5e-3)
        assert cm.a2a_s(2.5) == pytest.approx(5e-3)
        with pytest.raises(ValueError):
            ns.S.CostModel(step_s=-1.0)
        with pytest.raises(ValueError):
            ns.S.CostModel(train_step_s=float("nan"))
    assert TS.CostModel() == TS.CostModel(**{
        f: getattr(JS.CostModel(), f) for f in
        ("step_s", "prefill_chunk_s", "gossip_round_s", "train_step_s",
         "wire_unit_s", "a2a_unit_s")})


def test_measure_step_cost_requires_injected_timer():
    class _Eng:
        pass

    for ns in SIDES:
        with pytest.raises(ValueError, match="injected timer"):
            ns.S.measure_step_cost(_Eng(), [], timer=None)


# ------------------------------------------------------------------ #
# serving: sim fleet determinism + failover semantics, port vs JAX
# ------------------------------------------------------------------ #
def _sim_fleet(ns, trace, *, n_rep=3, fault_plan=None, seed=11,
               keep_lines=True, capacity=4, max_queue=64):
    cost = ns.S.CostModel(step_s=2e-3, gossip_round_s=0.0)
    clock = ns.S.VirtualClock()
    reps = [ns.S.SimReplica(f"replica-{i}", capacity=capacity, max_len=64,
                            prefill_chunk=8, max_queue=max_queue,
                            clock=clock, cost=cost)
            for i in range(n_rep)]
    sim = ns.S.Simulation(clock=clock,
                          log=ns.S.EventLog(keep_lines=keep_lines))
    fleet = ns.S.SimServingFleet(reps, cost=cost, sim=sim,
                                 fault_plan=fault_plan,
                                 router_kwargs=dict(seed=seed))
    return fleet, fleet.run(trace)


def _trace(ns, n=160, rate=400.0, seed=3):
    return ns.S.RequestTrace.build(ns.B.poisson_arrivals(rate, n, seed),
                                   seed=seed + 1, prompt_len=(2, 12),
                                   new_tokens=(2, 10))


def _both(run):
    (jf, js), (tf, ts) = run(JAX), run(PORT)
    assert tf.log.lines == jf.log.lines
    assert ts == js            # the whole summary, the digest included
    return tf, ts


def test_sim_serving_fleet_same_seed_byte_equal():
    tr = _trace(PORT)
    _, a = _sim_fleet(PORT, tr)
    _, b = _sim_fleet(PORT, tr)
    assert a == b
    assert a["completed"] == tr.n and a["lost_requests"] == 0
    _, c = _sim_fleet(PORT, _trace(PORT, seed=4))
    assert c["event_digest"] != a["event_digest"]
    _both(lambda ns: _sim_fleet(ns, _trace(ns)))
    # digest-only logging gives the same digest
    _, bare = _sim_fleet(PORT, tr, keep_lines=False)
    assert bare["event_digest"] == a["event_digest"]


def test_sim_serving_replica_death_token_exact_failover():
    def run(ns):
        tr = _trace(ns, n=120, rate=2000.0)
        return _sim_fleet(ns, tr, fault_plan=(
            ns.R.ServingFaultPlan.replica_death(3, 1, 5)))

    fleet, s = _both(run)
    tr = _trace(PORT, n=120, rate=2000.0)
    assert fleet.replicas[1].dead
    assert s["failovers"] > 0
    assert s["lost_requests"] == 0
    assert s["completed"] == tr.n
    assert s["tokens_total"] == float(tr.budgets.sum())


def test_sim_serving_backpressure_loses_at_saturation():
    def run(ns):
        return _sim_fleet(ns, _trace(ns, n=80, rate=1e6), n_rep=1,
                          capacity=1, max_queue=4)

    _, s = _both(run)
    assert s["lost_requests"] > 0
    assert s["lost_requests"] + s["completed"] == 80
    with pytest.raises(RequestRejected):
        rep = TS.SimReplica("r", capacity=1, max_len=8, max_queue=0)
        rep.submit(TS.SimRequest(0, 2, 2))
    with pytest.raises(JRejected):
        rep = JS.SimReplica("r", capacity=1, max_len=8, max_queue=0)
        rep.submit(JS.SimRequest(0, 2, 2))


# ------------------------------------------------------------------ #
# the wallclock-in-sim contract, held without porting analysis/
# ------------------------------------------------------------------ #
_WALL_CLOCK = {("time", "time"), ("time", "perf_counter"),
               ("time", "monotonic"), ("time", "time_ns"),
               ("time", "perf_counter_ns"), ("time", "monotonic_ns"),
               ("datetime", "now"), ("datetime", "utcnow")}


def test_sim_reads_no_wall_clock():
    files = sorted((ROOT / "bluefog_tpu_torch" / "sim").glob("*.py"))
    assert {p.name for p in files} >= {
        "clock.py", "cost.py", "engine.py", "serving.py", "traces.py",
        "training.py", "wire.py", "__init__.py"}
    hits = []
    for p in files:
        tree = ast.parse(p.read_text(), filename=str(p))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module in (
                    "time", "datetime"):
                hits.append((p.name, node.lineno, "from " + node.module))
            elif isinstance(node, ast.Attribute) and isinstance(
                    node.value, ast.Name) and (node.value.id,
                                               node.attr) in _WALL_CLOCK:
                hits.append((p.name, node.lineno, node.attr))
            elif isinstance(node, ast.Name) and node.id in (
                    "perf_counter", "monotonic"):
                hits.append((p.name, node.lineno, node.id))
    assert hits == []

"""The port's elastic membership (bluefog_tpu_torch/elastic/) against the
JAX package's on the CPU.

* ``grow(heal)`` round-trips byte-equal to a fresh heal (and to the
  pristine tables once everyone is back), and the bootstrap tables and
  the controller's renders equal JAX's byte for byte, over random specs,
  masks and anneal fractions.
* ``disagreement`` and the in-place row hygiene (``sanitize_rank_rows``,
  ``zero_rank_rows``) agree with JAX's functional ones on the same rows.
* ``run_resilient(elastic=...)`` over ``StackedBackend(8)``: the preempt
  -> heal -> rollback -> rejoin -> promote cycle, a rollback that kicks an
  in-flight joiner and one that demotes a promotion the restored step
  does not contain, each with the event list of JAX's ``run_resilient``
  on its 8-device mesh (JAX's ``tests/test_elastic.py`` model and plans).
* Phase 22's plan over ExponentialTwoGraph(4): at the default quarantine
  threshold neither package promotes the joiner, at phase 22's 2.0 both
  do, at the same step and reading.
* ``FleetAggregator`` heals and re-grows with the controller.
"""

import itertools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from bluefog_tpu import elastic as JE
from bluefog_tpu import resilience as JR
from bluefog_tpu import topology as JT
from bluefog_tpu.checkpoint import Checkpointer as JCheckpointer
from bluefog_tpu.optim import functional as JF

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import elastic as E
from bluefog_tpu_torch import resilience as R
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.checkpoint import Checkpointer
from bluefog_tpu_torch.observe.fleet import FleetAggregator

pytestmark = pytest.mark.elastic

N = 8


def _scheds(mod):
    return [[mod.uniform_topology_spec(mod.ExponentialTwoGraph(N))],
            list(mod.one_peer_dynamic_schedule(N))]


@pytest.mark.parametrize("seed", range(3))
def test_grow_heal_and_bootstrap_equal_jax(seed):
    rng = np.random.RandomState(seed)
    for jsched, tsched in zip(_scheds(JT), _scheds(TT)):
        for js, ts in zip(jsched, tsched):
            pristine = R.heal_weights(ts, np.zeros(N, bool))
            for _ in range(3):
                dead = rng.rand(N) < 0.4
                if not dead.any():
                    dead[seed] = True
                back = [int(r) for r in np.flatnonzero(dead)
                        if rng.rand() < 0.5] or [int(np.flatnonzero(dead)[0])]
                rest = dead.copy()
                rest[back] = False
                tg = E.grow_weights(ts, dead, back)
                jg = JE.grow_weights(js, dead, back)
                fresh = R.heal_weights(ts, rest)
                for a, b, c in zip(tg, jg, fresh):
                    assert a.tobytes() == b.tobytes() == c.tobytes()
                full = E.grow_weights(ts, dead, np.flatnonzero(dead))
                for a, b in zip(full, pristine):
                    assert a.tobytes() == b.tobytes()
                assert R.mixing_matrix(E.grow_spec(ts, dead, back)) \
                    .tobytes() == JR.mixing_matrix(
                        JE.grow_spec(js, dead, back)).tobytes()
                live = ~dead
                joiners = {r: float(rng.rand()) for r in back}
                for a, b in zip(E.bootstrap_weights(ts, live, joiners),
                                JE.bootstrap_weights(js, live, joiners)):
                    assert a.tobytes() == b.tobytes()
                # every bootstrap row sums to 1 (row-stochastic anneal)
                cw, sw = E.bootstrap_weights(ts, live, joiners)
                M = R.mixing_matrix_from_weights(ts, cw, sw)
                np.testing.assert_allclose(M.sum(axis=1), 1.0, atol=1e-12)
        dead = np.zeros(N, bool)
        dead[[1, 4]] = True
        for (tc, ts_), (jc, js_) in zip(
                E.grown_comm_weights(tsched, dead, [1]),
                JE.grown_comm_weights(jsched, dead, [1])):
            assert tc.dtype == torch.float64
            assert tc.numpy().tobytes() == np.asarray(jc).tobytes()
            assert ts_.numpy().tobytes() == np.asarray(js_).tobytes()
    with pytest.raises(ValueError, match="not dead"):
        E.grow_weights(tsched[0], np.zeros(N, bool), [2])
    for p in range(6):
        assert E.anneal_fraction(p, 4) == JE.anneal_fraction(p, 4)


def test_controller_renders_equal_jax():
    """The lifecycle on both controllers, step for step: states, masks,
    every round's weight tables (the anneal included) byte-equal."""
    jsched, tsched = _scheds(JT)[1], _scheds(TT)[1]
    jd, td = JR.FailureDetector(N), R.FailureDetector(N)
    jc = JE.MembershipController(jsched, bootstrap_rounds=3, detector=jd)
    tc = E.MembershipController(tsched, bootstrap_rounds=3, detector=td)

    def same():
        assert tc.states() == jc.states()
        np.testing.assert_array_equal(tc.effective_dead_mask(),
                                      jc.effective_dead_mask())
        for (a, b), (c, d) in zip(tc.comm_weights(), jc.comm_weights()):
            assert a.numpy().tobytes() == np.asarray(c).tobytes()
            assert b.numpy().tobytes() == np.asarray(d).tobytes()
        np.testing.assert_array_equal(tc.membership_mask().numpy(),
                                      np.asarray(jc.membership_mask()))
        np.testing.assert_array_equal(td.dead_mask(), jd.dead_mask())

    for op, arg in [("mark_dead", [2, 5]), ("admit", [2]), ("tick", None),
                    ("tick", None), ("admit", [5]), ("tick", None),
                    ("promote", [2]), ("kick", [5]), ("mark_dead", [2]),
                    ("admit", [2, 5]), ("tick", None), ("promote", [2, 5])]:
        for c in (jc, tc):
            getattr(c, op)(*([] if arg is None else [arg]))
        same()
    for c in (jc, tc):
        with pytest.raises(ValueError, match="not joining"):
            c.promote([0])


def test_disagreement_and_row_hygiene_equal_jax():
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(N, 3, 2), "b": rng.randn(N, 5)}
    live = np.ones(N, bool)
    live[[1, 6]] = False
    for r in (1, 6, 0):
        want = JE.disagreement(tree, r, live)
        got = E.disagreement({k: torch.from_numpy(v)
                              for k, v in tree.items()}, r, live)
        assert got == pytest.approx(want, rel=1e-12)
    bad = {k: v.copy() for k, v in tree.items()}
    bad["a"][1, 0, 0] = np.nan
    bad["b"][6, 2] = np.inf
    bad["b"][0, 1] = np.nan  # not masked: stays
    mask = np.zeros(N, bool)
    mask[[1, 6]] = True
    assert E.disagreement({k: torch.from_numpy(v) for k, v in bad.items()},
                          1, live) == float("inf")
    want = JE.sanitize_rank_rows(bad, mask)
    t = {k: torch.from_numpy(v.copy()) for k, v in bad.items()}
    a_before = t["a"]
    assert E.sanitize_rank_rows(t, mask) is t and t["a"] is a_before
    for k in tree:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(want[k]))
    want = JE.zero_rank_rows(tree, mask)
    # the optimizer's rows too, in place; a per-rank count is left alone
    p = torch.from_numpy(tree["a"].copy())
    opt = torch.optim.Adam([p])
    opt.state[p]["exp_avg"] = torch.from_numpy(tree["a"].copy())
    opt.state[p]["step"] = torch.full((N,), 7.0)
    E.zero_rank_rows(({"a": p}, opt), mask)
    np.testing.assert_array_equal(p.numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(),
                                  np.asarray(want["a"]))
    assert (opt.state[p]["step"] == 7.0).all()
    with pytest.raises(ValueError, match="rank-major"):
        E.zero_rank_rows({"x": torch.ones(3, 2)}, mask)


def test_fleet_aggregator_grows_with_membership():
    sched = TT.one_peer_dynamic_schedule(N)
    agg = FleetAggregator(sched, record_traffic=False)
    mc = E.MembershipController(sched, bootstrap_rounds=4)
    vals = np.random.default_rng(3).standard_normal((N, 2))
    mc.mark_dead(2)
    live = [r for r in range(N) if r != 2]
    res = agg.aggregate(vals, dead_mask=mc)
    assert np.isnan(res.per_rank[2]).all()
    np.testing.assert_allclose(
        res.per_rank[live],
        np.broadcast_to(vals[live].mean(axis=0), (len(live), 2)),
        atol=1e-12)
    mc.admit(2)  # quarantine: still excised
    assert np.isnan(agg.aggregate(vals, dead_mask=mc).per_rank[2]).all()
    mc.promote(2)
    np.testing.assert_allclose(
        agg.aggregate(vals, dead_mask=mc).per_rank,
        np.broadcast_to(vals.mean(axis=0), (N, 2)), atol=1e-12)
    for combo in itertools.islice(itertools.combinations(range(N), 2), 36):
        mask = np.zeros(N, bool)
        mask[list(combo)] = True
        agg.aggregate(vals, dead_mask=mask)
    assert len(agg._mats) <= 32


# ------------------------------------------------------------------ #
# the cycle through run_resilient, event for event against JAX
# ------------------------------------------------------------------ #
_DATA = None
_JSTEP = {}


def _data():
    global _DATA
    if _DATA is None:
        rng = np.random.RandomState(7)
        _DATA = (rng.randn(32, N, 4, 6), rng.randn(32, N, 4, 2))
    return _DATA


def _jrun(plan, steps, elastic, tmp):
    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))
    opt = optax.sgd(0.05, momentum=0.9)
    sched = JT.one_peer_dynamic_schedule(N)
    if "step" not in _JSTEP:
        def loss(params, batch):
            x, y = batch
            return jnp.mean((x @ params["w"] - y) ** 2)

        _JSTEP["step"] = JF.build_train_step(
            loss, opt, mesh, comm_mode="atc", schedule=sched,
            guard=JF.GuardConfig())
    params = JF.rank_major({"w": jnp.zeros((6, 2))}, mesh)
    opt_state = JF.rank_major(opt.init({"w": jnp.zeros((6, 2))}), mesh)
    ck = JCheckpointer(str(tmp / "j"))
    x, y = _data()
    res = JR.run_resilient(
        _JSTEP["step"], params, opt_state,
        lambda s: (x[s % 32], y[s % 32]), steps=steps, checkpointer=ck,
        mesh=mesh, schedule=sched,
        guard=JF.GuardConfig(max_consecutive_bad=3, backoff_base=0.0),
        fault_plan=plan(JR), checkpoint_every=4, sleep=lambda s: None,
        elastic=JE.ElasticConfig(**elastic))
    ck.close()
    return res


def _trun(plan, steps, elastic, tmp, adam=False):
    backend = bt.StackedBackend(N, device="cpu")
    params = {"w": torch.zeros(N, 6, 2, dtype=torch.float64)}
    opt = (torch.optim.Adam(params.values(), lr=0.01) if adam else
           torch.optim.SGD(params.values(), lr=0.05, momentum=0.9))
    sched = TT.one_peer_dynamic_schedule(N)
    step = bt.build_train_step(
        lambda p, b: ((b[0] @ p["w"] - b[1]) ** 2).mean(), opt, backend,
        comm_mode="atc", schedule=sched, guard=bt.GuardConfig())
    x, y = _data()
    return R.run_resilient(
        step, params, opt,
        lambda s: (torch.from_numpy(x[s % 32]), torch.from_numpy(y[s % 32])),
        steps=steps, checkpointer=Checkpointer(str(tmp / "t")),
        schedule=sched,
        guard=bt.GuardConfig(max_consecutive_bad=3, backoff_base=0.0),
        fault_plan=plan(R), checkpoint_every=4, sleep=lambda s: None,
        elastic=E.ElasticConfig(**elastic))


def _kinds(res):
    return [(e.kind, e.step, {k: v for k, v in e.detail.items()
                              if k != "disagreement"}) for e in res.events]


_CYCLES = {
    # preempt past the death window: dead, heal, rollback, rejoin, promote
    "preempt_rejoin": (lambda m: m.FaultPlan.preempt(N, rank=2, step=6,
                                                     duration=6), 30,
                       dict(bootstrap_rounds=4, max_quarantine_steps=16)),
    # a rollback strands the in-flight joiner (reason "rollback")
    "rollback_kicks_joiner": (
        lambda m: m.FaultPlan.preempt(N, rank=2, step=4, duration=4)
        .merged(m.FaultPlan(N, [m.Fault(12, 5, "dead")])), 36,
        dict(bootstrap_rounds=10, max_quarantine_steps=24)),
    # a promotion inside rank 5's bad window is rolled back
    "promotion_rolled_back": (
        lambda m: m.FaultPlan.preempt(N, rank=2, step=4, duration=4)
        .merged(m.FaultPlan(N, [m.Fault(8, 5, "dead")])), 24,
        dict(bootstrap_rounds=2, max_quarantine_steps=16,
             quarantine_threshold=1e9)),
}


@pytest.mark.parametrize("name", sorted(_CYCLES))
def test_elastic_cycles_equal_jax(name, tmp_path):
    plan, steps, elastic = _CYCLES[name]
    jres = _jrun(plan, steps, elastic, tmp_path)
    tres = _trun(plan, steps, elastic, tmp_path)
    assert _kinds(tres) == _kinds(jres)
    for je, te in zip(jres.events, tres.events):
        if "disagreement" in je.detail:
            assert te.detail["disagreement"] == pytest.approx(
                je.detail["disagreement"], rel=1e-6, abs=1e-9)
    assert tres.membership == jres.membership
    np.testing.assert_array_equal(tres.dead_mask, jres.dead_mask)
    np.testing.assert_array_equal(tres.total_skips, jres.total_skips)
    want = np.asarray(jres.params["w"])
    got = tres.params["w"].numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert R.update_health(tres.params).all()
    if name == "promotion_rolled_back":
        fails = [e for e in tres.events if e.kind == "rank_join_failed"]
        assert [e.detail["reason"] for e in fails] == [
            "promotion_rolled_back"]
    if name == "preempt_rejoin":
        assert tres.membership == ["live"] * N


def _p22_plan(m):
    """chip_smoke.py phase 22's faults over 4 ranks: a NaN burst on rank 1
    at steps 5-6, rank 2 preempted for steps 12-23."""
    return m.FaultPlan.nan_burst(4, rank=1, step=5, duration=2).merged(
        m.FaultPlan.preempt(4, rank=2, step=12, duration=12))


def _p22_runs(threshold, tmp):
    """JAX's and the port's run_resilient over ExponentialTwoGraph(4) (atc,
    guarded, SGD with momentum, per-rank data) through phase 22's plan
    and quarantine policy, 48 steps, a checkpoint every 8."""
    n = 4
    rng = np.random.RandomState(7)
    x, y = rng.randn(48, n, 4, 6), rng.randn(48, n, 4, 2)
    elastic = dict(bootstrap_rounds=4, max_quarantine_steps=16,
                   quarantine_threshold=threshold)
    mesh = Mesh(np.array(jax.devices()[:n]), ("bf",))
    opt = optax.sgd(0.05, momentum=0.9)
    jsched = [JT.uniform_topology_spec(JT.ExponentialTwoGraph(n))]
    if "exp2_4" not in _JSTEP:
        _JSTEP["exp2_4"] = JF.build_train_step(
            lambda p, b: jnp.mean((b[0] @ p["w"] - b[1]) ** 2), opt, mesh,
            comm_mode="atc", topology=jsched[0], guard=JF.GuardConfig())
    ck = JCheckpointer(str(tmp / "j"))
    jres = JR.run_resilient(
        _JSTEP["exp2_4"], JF.rank_major({"w": jnp.zeros((6, 2))}, mesh),
        JF.rank_major(opt.init({"w": jnp.zeros((6, 2))}), mesh),
        lambda s: (x[s], y[s]), steps=48, checkpointer=ck, mesh=mesh,
        schedule=jsched, fault_plan=_p22_plan(JR), checkpoint_every=8,
        sleep=lambda s: None, elastic=JE.ElasticConfig(**elastic))
    ck.close()
    params = {"w": torch.zeros(n, 6, 2, dtype=torch.float64)}
    topt = torch.optim.SGD(params.values(), lr=0.05, momentum=0.9)
    tsched = [TT.uniform_topology_spec(TT.ExponentialTwoGraph(n))]
    step = bt.build_train_step(
        lambda p, b: ((b[0] @ p["w"] - b[1]) ** 2).mean(), topt,
        bt.StackedBackend(n, device="cpu"), comm_mode="atc",
        topology=tsched[0], guard=bt.GuardConfig())
    tres = R.run_resilient(
        step, params, topt,
        lambda s: (torch.from_numpy(x[s]), torch.from_numpy(y[s])),
        steps=48, checkpointer=Checkpointer(str(tmp / "t")),
        schedule=tsched, fault_plan=_p22_plan(R), checkpoint_every=8,
        sleep=lambda s: None, elastic=E.ElasticConfig(**elastic))
    return jres, tres


@pytest.mark.parametrize("threshold", [None, 2.0])
def test_phase22_quarantine_equals_jax(threshold, tmp_path):
    """Over ExponentialTwoGraph(4) with per-rank data a joiner that mixes
    like a live rank but is read by none sits outside the live ranks'
    cloud at its checks: at the default quarantine threshold (1.0)
    neither package promotes it (its quarantine expires at the same
    reading in both), at phase 22's 2.0 both promote it at the same step
    and reading."""
    jres, tres = _p22_runs(threshold, tmp_path)
    assert _kinds(tres) == _kinds(jres)
    for je, te in zip(jres.events, tres.events):
        if "disagreement" in je.detail:
            assert te.detail["disagreement"] == pytest.approx(
                je.detail["disagreement"], rel=1e-6, abs=1e-9)
    kinds = [e.kind for e in tres.events]
    if threshold is None:
        assert "rank_promoted" not in kinds
        fails = [e for e in tres.events if e.kind == "rank_join_failed"]
        assert [e.detail["reason"] for e in fails] == ["quarantine_expired"]
        assert 1.0 < fails[0].detail["disagreement"] <= 2.0
    else:
        assert kinds.count("rank_promoted") == 1
        assert tres.membership == jres.membership == ["live"] * 4
    want = np.asarray(jres.params["w"])
    got = tres.params["w"].numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_elastic_validation_and_adam_rejoin(tmp_path):
    """The runner's elastic refusals, and the cycle under Adam: the
    joiner's moments are zeroed in place at admission (its per-rank count
    is kept, as optax keeps its int count) and it is promoted."""
    backend = bt.StackedBackend(N, device="cpu")
    params = {"w": torch.zeros(N, 6, 2, dtype=torch.float64)}
    opt = torch.optim.SGD(params.values(), lr=0.05)
    sched = TT.one_peer_dynamic_schedule(N)
    step = bt.build_train_step(
        lambda p, b: ((b[0] @ p["w"] - b[1]) ** 2).mean(), opt, backend,
        comm_mode="atc", schedule=sched, guard=bt.GuardConfig())
    with pytest.raises(ValueError, match="max_quarantine_steps"):
        R.run_resilient(step, params, opt, None, steps=1, checkpointer=None,
                        schedule=sched,
                        elastic=E.ElasticConfig(bootstrap_rounds=8,
                                                max_quarantine_steps=4))
    res = _trun(_CYCLES["preempt_rejoin"][0], 30,
                _CYCLES["preempt_rejoin"][2], tmp_path, adam=True)
    kinds = [e.kind for e in res.events]
    assert kinds.count("rank_promoted") == 1 and res.membership == \
        ["live"] * N
    assert R.update_health(res.params).all()

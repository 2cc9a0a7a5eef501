"""The port's resilience stack (bluefog_tpu_torch/resilience/) against the
JAX package's on the CPU.

* The host-only copies (``FaultPlan``, ``FailureDetector``, the healing
  tables, ``consensus_simulation``) take the same random plans, skip
  streams, specs and masks on both sides and must agree byte for byte.
* ``run_resilient`` over ``StackedBackend(8)`` drives JAX's
  ``tests/test_resilience.py`` model (a 6 x 2 float64 linear map, SGD 0.05
  with momentum 0.9, atc over the one-peer schedule) through the same
  fault plans as JAX's ``run_resilient`` on its 8-device mesh: the event
  lists must be equal, and the params within 1e-6 of each leaf's largest
  entry.  The three runner tests of ``tests/test_fleet.py`` (the
  straggler wiring, external suspicion, a NaN window never attributed to
  a straggler) are held to JAX's outcomes the same way.
* The hierarchical heal (a machine with a dead rank is excised whole) and
  the runner's refusals.

Each JAX step is built once and shared, as ``tests/test_resilience.py``
does.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import resilience as JR
from bluefog_tpu import topology as JT
from bluefog_tpu.checkpoint import Checkpointer as JCheckpointer
from bluefog_tpu.observe import fleet as JFL
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.topology.spec import Topology as JTopology

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import resilience as R
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.checkpoint import Checkpointer
from bluefog_tpu_torch.context import BluefogError
from bluefog_tpu_torch.observe import fleet as FL
from bluefog_tpu_torch.topology.spec import Topology as TTopology

pytestmark = pytest.mark.resilience

N = 8
_DATA = None


def _data():
    global _DATA
    if _DATA is None:
        rng = np.random.RandomState(7)
        _DATA = (rng.randn(32, N, 4, 6), rng.randn(32, N, 4, 2))
    return _DATA


def _jbatch(step):
    x, y = _data()
    return (x[step % 32], y[step % 32])


def _tbatch(step):
    x, y = _data()
    return (torch.from_numpy(x[step % 32]), torch.from_numpy(y[step % 32]))


def _jloss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] - y) ** 2)


def _tloss(params, batch):
    x, y = batch
    return ((x @ params["w"] - y) ** 2).mean()


_JOPT = optax.sgd(0.05, momentum=0.9)
_STEPS = {}


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("bf",))


def _jstep(guard=None):
    """JAX's guarded atc one-peer step of tests/test_resilience.py, built
    once per guard config."""
    key = ("j", guard)
    if key not in _STEPS:
        _STEPS[key] = JF.build_train_step(
            _jloss, _JOPT, _mesh(), comm_mode="atc",
            schedule=JT.one_peer_dynamic_schedule(N),
            guard=guard or JF.GuardConfig())
    return _STEPS[key]


def _jstate():
    mesh = _mesh()
    return (JF.rank_major({"w": jnp.zeros((6, 2))}, mesh),
            JF.rank_major(_JOPT.init({"w": jnp.zeros((6, 2))}), mesh))


def _tstep(guard=None):
    """The port's step: (step, params, optimizer), fresh state."""
    backend = bt.StackedBackend(N, device="cpu")
    params = {"w": torch.zeros(N, 6, 2, dtype=torch.float64)}
    opt = torch.optim.SGD(params.values(), lr=0.05, momentum=0.9)
    step = bt.build_train_step(
        _tloss, opt, backend, comm_mode="atc",
        schedule=TT.one_peer_dynamic_schedule(N),
        guard=guard or bt.GuardConfig())
    return step, params, opt


def _events(res):
    return [(e.kind, e.step, e.detail) for e in res.events]


def _assert_params_close(jparams, tparams):
    for k, want in jparams.items():
        want = np.asarray(want)
        got = tparams[k].detach().cpu().numpy()
        bound = 1e-6 * np.abs(want).max() + 1e-12
        assert np.abs(got - want).max() <= bound, k


# ------------------------------------------------------------------ #
# host-only copies: byte-equal on random inputs
# ------------------------------------------------------------------ #
def _random_faults(mod, rng, n, k=6):
    kinds = ["nan", "inf", "dead", "stall", "preempt", "congest"]
    faults = []
    for _ in range(k):
        kind = kinds[rng.randint(len(kinds))]
        kw = dict(duration=int(rng.randint(1, 6)))
        if kind == "stall":
            kw["stall_seconds"] = float(rng.rand())
        if kind == "congest":
            kw.update(dst=int(rng.randint(n)), factor=1.0 + rng.rand() * 3)
        faults.append(mod.Fault(int(rng.randint(0, 12)), int(rng.randint(n)),
                                kind, **kw))
    return faults


@pytest.mark.parametrize("seed", range(4))
def test_fault_plan_queries_equal_jax(seed):
    rng = np.random.RandomState(seed)
    faults = _random_faults(JR.faults, rng, N)
    jp = JR.FaultPlan(N, faults)
    tp = R.FaultPlan(N, [R.Fault(**vars(f)) for f in faults])
    other = R.FaultPlan.preempt(N, 3, 4, 5)
    jp2 = jp.merged(JR.FaultPlan.preempt(N, 3, 4, 5))
    tp2 = tp.merged(other)
    assert tp2.last_onset() == jp2.last_onset()
    for s in range(20):
        assert [vars(f) for f in tp2.active(s)] == \
            [vars(f) for f in jp2.active(s)]
        np.testing.assert_array_equal(tp2.corrupt_codes(s),
                                      jp2.corrupt_codes(s))
        assert tp2.dead_ranks(s) == jp2.dead_ranks(s)
        assert tp2.preempted_ranks(s) == jp2.preempted_ranks(s)
        assert tp2.rejoinable_ranks(s) == jp2.rejoinable_ranks(s)
        assert tp2.stall_seconds(s) == jp2.stall_seconds(s)
        assert tp2.stall_seconds_by_rank(s).tobytes() == \
            jp2.stall_seconds_by_rank(s).tobytes()
        assert tp2.congested_links(s) == jp2.congested_links(s)
        # corrupt_batch: numpy rows as JAX's, torch rows alike
        x = rng.randn(N, 3)
        jx = np.asarray(jp2.corrupt_batch((x,), s)[0])
        np.testing.assert_array_equal(tp2.corrupt_batch((x,), s)[0], jx)
        got = tp2.corrupt_batch((torch.from_numpy(x),), s)[0]
        np.testing.assert_array_equal(got.numpy(), jx)
    with pytest.raises(ValueError, match="kind"):
        R.Fault(0, 0, "flaky")
    with pytest.raises(ValueError, match="outside world"):
        R.FaultPlan(4, [R.Fault(0, 7, "nan")])


def test_corrupt_batch_rows_devices_and_identity():
    plan = R.FaultPlan.nan_burst(N, rank=3, step=2).merged(
        R.FaultPlan(N, [R.Fault(2, 5, "inf")]))
    x = torch.ones(N, 4, 6, dtype=torch.bfloat16)
    y = torch.arange(N)  # int leaves pass through untouched
    bx, by = plan.corrupt_batch((x, y), 2)
    assert torch.isnan(bx[3]).all() and torch.isinf(bx[5]).all()
    assert bx.dtype == torch.bfloat16 and by is y
    assert torch.isfinite(x).all()  # the input is not mutated
    out = plan.corrupt_batch((x, y), 0)  # healthy: identity, no copy
    assert out[0] is x and out[1] is y
    # a process's rows: ranks 2..5 of the world
    part = plan.corrupt_batch((torch.ones(4, 2),), 2, ranks=range(2, 6))[0]
    assert torch.isnan(part[1]).all() and torch.isinf(part[3]).all()
    assert torch.isfinite(part[[0, 2]]).all()
    with pytest.raises(ValueError, match="rank-major"):
        plan.corrupt_batch((torch.ones(3, 2),), 2)


@pytest.mark.parametrize("seed", range(3))
def test_failure_detector_equals_jax(seed):
    rng = np.random.RandomState(seed)
    jd, td = JR.FailureDetector(N), R.FailureDetector(N)
    for t in range(40):
        sk = rng.rand(N) < 0.3
        sk[seed] = t % 7 < 5  # one rank with long streaks
        jd.observe(sk)
        td.observe(sk)
        for k in (1, 3):
            assert td.suspects(k) == jd.suspects(k)
            assert td.streak_suspects(k) == jd.streak_suspects(k)
        assert td.live_bad(sk) == jd.live_bad(sk)
        if t == 10:
            jd.declare_dead([seed])
            td.declare_dead([seed])
        if t == 20:
            jd.suspect([4], source="straggler")
            td.suspect([4], source="straggler")
        if t == 25:
            jd.readmit([seed])
            td.readmit([seed])
            jd.clear_suspicion(source="straggler")
            td.clear_suspicion(source="straggler")
        if t == 30:
            jd.reset_streaks()
            td.reset_streaks()
        np.testing.assert_array_equal(td.consecutive_bad(),
                                      jd.consecutive_bad())
        np.testing.assert_array_equal(td.total_skips(), jd.total_skips())
        np.testing.assert_array_equal(td.dead_mask(), jd.dead_mask())
    assert R.FailureDetector.heartbeat_dead_processes(0.01) == []
    assert R.FailureDetector.heartbeat_dead_ranks(0.01) == []


def test_update_health_tensors_and_optimizer():
    tree = {"a": np.ones((4, 3)), "b": np.ones((4, 2))}
    tree["a"][2, 1] = np.nan
    tree["b"][1, 0] = np.inf
    want = JR.update_health(tree)
    np.testing.assert_array_equal(R.update_health(tree), want)
    ttree = {k: torch.from_numpy(v).to(torch.bfloat16)
             for k, v in tree.items()}
    np.testing.assert_array_equal(R.update_health(ttree), want)
    # an optimizer's state tensors are leaves too
    p = torch.zeros(4, 3, requires_grad=True)
    opt = torch.optim.SGD([p], lr=0.1, momentum=0.9)
    opt.state[p]["momentum_buffer"] = torch.zeros(4, 3)
    opt.state[p]["momentum_buffer"][0, 0] = np.nan
    np.testing.assert_array_equal(R.update_health((p, opt)),
                                  [False, True, True, True])


def _specs(mod):
    W = np.zeros((N, N))
    for r in range(N):
        W[(r - 1) % N, r] = 0.3
        W[(r + 1) % N, r] = 0.1
        W[r, r] = 0.6
    topo = JTopology if mod is JT else TTopology
    return ([mod.uniform_topology_spec(mod.ExponentialTwoGraph(N)),
             topo.from_weight_matrix(W)]
            + list(mod.one_peer_dynamic_schedule(N)))


@pytest.mark.parametrize("seed", range(3))
def test_healing_equals_jax(seed):
    rng = np.random.RandomState(seed)
    jspecs, tspecs = _specs(JT), _specs(TT)
    for _ in range(4):
        dead = rng.rand(N) < 0.3
        for js, ts in zip(jspecs, tspecs):
            jcw, jsw = JR.heal_weights(js, dead)
            tcw, tsw = R.heal_weights(ts, dead)
            assert tcw.tobytes() == jcw.tobytes()
            assert tsw.tobytes() == jsw.tobytes()
            assert R.mixing_matrix(ts).tobytes() == \
                JR.mixing_matrix(js).tobytes()
            assert R.mixing_matrix(R.heal_spec(ts, dead)).tobytes() == \
                JR.mixing_matrix(JR.heal_spec(js, dead)).tobytes()
            assert R.row_sums(R.heal_spec(ts, dead)).tobytes() == \
                JR.row_sums(JR.heal_spec(js, dead)).tobytes()
            assert R.is_row_stochastic(R.heal_spec(ts, dead))
        sched_j = jspecs[2:]
        sched_t = tspecs[2:]
        for (jcw, jsw), (tcw, tsw) in zip(
                JR.healed_comm_weights(sched_j, dead),
                R.healed_comm_weights(sched_t, dead)):
            assert tcw.dtype == tsw.dtype == torch.float64
            assert tcw.numpy().tobytes() == np.asarray(jcw).tobytes()
            assert tsw.numpy().tobytes() == np.asarray(jsw).tobytes()
        # the healed data has the unhealed step's shapes
        for (cw0, sw0), (cw1, sw1) in zip(bt.optim.comm_weight_inputs(
                sched_t), R.healed_comm_weights(sched_t, dead)):
            assert cw0.shape == cw1.shape and sw0.shape == sw1.shape
        if not dead.all():
            jt = JR.consensus_simulation(sched_j, 30, dim=4, seed=seed,
                                         dead_mask=dead)
            tt = R.consensus_simulation(sched_t, 30, dim=4, seed=seed,
                                        dead_mask=dead)
            assert tt.tobytes() == jt.tobytes()
    from bluefog_tpu.resilience import healing as JH
    from bluefog_tpu_torch.resilience import healing as TH

    dead = np.zeros(N, bool)
    dead[5] = True
    np.testing.assert_array_equal(TH.machine_dead_mask(dead, 2),
                                  JH.machine_dead_mask(dead, 2))
    m_j = JT.uniform_topology_spec(JT.ExponentialTwoGraph(4))
    m_t = TT.uniform_topology_spec(TT.ExponentialTwoGraph(4))
    for (jcw, jsw), (tcw, tsw) in zip(
            JH.healed_hierarchical_comm_weights([m_j], dead, 2),
            TH.healed_hierarchical_comm_weights([m_t], dead, 2)):
        assert tcw.numpy().tobytes() == np.asarray(jcw).tobytes()
        assert tsw.numpy().tobytes() == np.asarray(jsw).tobytes()
    with pytest.raises(ValueError, match="dead mask"):
        R.heal_weights(tspecs[0], np.zeros(3, bool))


# ------------------------------------------------------------------ #
# run_resilient against JAX's, event for event
# ------------------------------------------------------------------ #
_PLANS = {
    # a death at 6 trips K=3 at 8 and rolls back to step 4's checkpoint
    "death": (lambda m: m.FaultPlan.rank_death(N, rank=2, step=6), 14, 4,
              dict(max_consecutive_bad=3, backoff_base=0.125)),
    # transient NaN and Inf bursts: skips, no rollback
    "burst": (lambda m: m.FaultPlan(N, [m.Fault(2, 1, "nan", duration=2),
                                        m.Fault(4, 6, "inf")]), 10, 5,
              dict(max_consecutive_bad=3, backoff_base=0.0)),
    # overlapping transients from different ranks: unattributable
    "overlap": (lambda m: m.FaultPlan(N, [m.Fault(5, 1, "nan", duration=2),
                                          m.Fault(7, 3, "nan",
                                                  duration=2)]), 14, 4,
                dict(max_consecutive_bad=3, backoff_base=0.0)),
}


def _run_both(name, tmp_path):
    make, steps, every, guard_kw = _PLANS[name]
    jslept, tslept = [], []
    jck = JCheckpointer(str(tmp_path / "jck"))
    jp, jo = _jstate()
    jres = JR.run_resilient(
        _jstep(), jp, jo, _jbatch, steps=steps, checkpointer=jck,
        mesh=_mesh(), schedule=JT.one_peer_dynamic_schedule(N),
        guard=JF.GuardConfig(**guard_kw), fault_plan=make(JR),
        checkpoint_every=every, sleep=jslept.append)
    jck.close()
    step, params, opt = _tstep()
    tck = Checkpointer(str(tmp_path / "tck"))
    tres = R.run_resilient(
        step, params, opt, _tbatch, steps=steps, checkpointer=tck,
        schedule=TT.one_peer_dynamic_schedule(N),
        guard=bt.GuardConfig(**guard_kw), fault_plan=make(R),
        checkpoint_every=every, sleep=tslept.append)
    tck.close()
    return jres, tres, jslept, tslept, tck


@pytest.mark.parametrize("name", sorted(_PLANS))
def test_run_resilient_events_and_params_equal_jax(name, tmp_path):
    jres, tres, jslept, tslept, tck = _run_both(name, tmp_path)
    assert _events(tres) == _events(jres)
    assert tslept == jslept
    assert tres.step == jres.step and tres.n_rollbacks == jres.n_rollbacks
    np.testing.assert_array_equal(tres.dead_mask, jres.dead_mask)
    np.testing.assert_array_equal(tres.total_skips, jres.total_skips)
    _assert_params_close(jres.params, tres.params)
    # the state object is the live one, updated in place
    assert tres.params["w"] is tres.opt_state.param_groups[0]["params"][0]
    np.testing.assert_allclose(tres.last_loss, np.asarray(jres.last_loss),
                               rtol=1e-6, atol=1e-12)
    if name == "death":
        # the checkpoint the rollback restored is the hand-replayed step 4
        step, params, opt = _tstep()
        w = step.default_comm_weights
        for s in range(4):
            step(params, opt, _tbatch(s), s, w)
        saved = tck.restore(4)
        torch.testing.assert_close(saved["params"]["w"], params["w"],
                                   rtol=0, atol=0)
        assert saved["step"] == 4
        assert R.update_health(tres.params).all()


def test_run_resilient_gives_up_and_all_dead_raise(tmp_path):
    step, params, opt = _tstep()
    plan = R.FaultPlan(N, [R.Fault(2, 1, "dead"), R.Fault(8, 4, "dead")])
    with pytest.raises(BluefogError, match="rollbacks"):
        R.run_resilient(
            step, params, opt, _tbatch, steps=30,
            checkpointer=Checkpointer(str(tmp_path / "a")),
            schedule=TT.one_peer_dynamic_schedule(N),
            guard=bt.GuardConfig(max_consecutive_bad=2, backoff_base=0.0,
                                 max_rollbacks=1),
            fault_plan=plan, checkpoint_every=4, sleep=lambda s: None)
    step, params, opt = _tstep()
    plan = R.FaultPlan(N, [R.Fault(0, r, "dead") for r in range(N)])
    with pytest.raises(BluefogError, match="every rank"):
        R.run_resilient(
            step, params, opt, _tbatch, steps=10,
            checkpointer=Checkpointer(str(tmp_path / "b")),
            schedule=TT.one_peer_dynamic_schedule(N),
            guard=bt.GuardConfig(max_consecutive_bad=2, backoff_base=0.0),
            fault_plan=plan, sleep=lambda s: None)


def test_guard_config_rides_the_step(tmp_path):
    cfg = bt.GuardConfig(max_consecutive_bad=2, backoff_base=0.0)
    step, params, opt = _tstep(cfg)
    assert step.guard_config is cfg
    res = R.run_resilient(
        step, params, opt, _tbatch, steps=10,
        checkpointer=Checkpointer(str(tmp_path / "ck")),
        schedule=TT.one_peer_dynamic_schedule(N),
        fault_plan=R.FaultPlan.rank_death(N, rank=6, step=4),
        checkpoint_every=2, sleep=lambda s: None)
    rb = [e for e in res.events if e.kind == "rollback"]
    assert len(rb) == 1 and rb[0].step == 6
    assert rb[0].detail["restored_step"] == 4
    assert res.dead_mask[6] and res.step == 10


def test_runner_refusals(tmp_path):
    backend = bt.StackedBackend(N, device="cpu")
    params = {"w": torch.zeros(N, 6, 2, dtype=torch.float64)}
    opt = torch.optim.SGD(params.values(), lr=0.05)
    unguarded = bt.build_train_step(_tloss, opt, backend, comm_mode="none")
    with pytest.raises(ValueError, match="GUARDED"):
        R.run_resilient(unguarded, params, opt, _tbatch, steps=1,
                        checkpointer=None)

    def aux_loss(p, aux, batch):
        return _tloss(p, batch), aux

    aux_step = bt.build_train_step(aux_loss, opt, backend, comm_mode="none",
                                   has_aux=True, guard=bt.GuardConfig())
    with pytest.raises(ValueError, match="no-aux"):
        R.run_resilient(aux_step, params, opt, _tbatch, steps=1,
                        checkpointer=None)
    step, params, opt = _tstep()
    # the control plane is a weight re-plan over the step's schedule
    with pytest.raises(ValueError, match="needs schedule="):
        R.run_resilient(step, params, opt, _tbatch, steps=1,
                        checkpointer=None, control=object())
    with pytest.raises(ValueError, match="schedule"):
        R.run_resilient(step, params, opt, _tbatch, steps=1,
                        checkpointer=None, elastic=R.ElasticConfig())
    hier = bt.build_train_step(
        _tloss, opt, backend, comm_mode="atc",
        topology=TT.uniform_topology_spec(TT.ExponentialTwoGraph(4)),
        hierarchical_local_size=2, guard=bt.GuardConfig())
    with pytest.raises(ValueError, match="hierarchical"):
        R.run_resilient(
            hier, params, opt, _tbatch, steps=1, checkpointer=None,
            schedule=[TT.uniform_topology_spec(TT.ExponentialTwoGraph(4))],
            elastic=R.ElasticConfig())


def test_hierarchical_heal_excises_the_machine(tmp_path):
    """A rank death under the hierarchical exchange (4 machines of 2
    ranks) excises its whole machine: the heal collapses the rank mask
    to machines, as JAX's runner does; events equal JAX's."""
    guard = dict(max_consecutive_bad=2, backoff_base=0.0)
    plan = dict(rank=3, step=3)
    jsched = [JT.uniform_topology_spec(JT.ExponentialTwoGraph(4))]
    jstep = JF.build_train_step(_jloss, _JOPT, _mesh(), comm_mode="atc",
                                topology=jsched[0],
                                hierarchical_local_size=2,
                                guard=JF.GuardConfig(**guard))
    jp, jo = _jstate()
    jck = JCheckpointer(str(tmp_path / "j"))
    jres = JR.run_resilient(jstep, jp, jo, _jbatch, steps=8,
                            checkpointer=jck, mesh=_mesh(), schedule=jsched,
                            fault_plan=JR.FaultPlan.rank_death(N, **plan),
                            checkpoint_every=2, sleep=lambda s: None)
    jck.close()
    backend = bt.StackedBackend(N, device="cpu")
    params = {"w": torch.zeros(N, 6, 2, dtype=torch.float64)}
    opt = torch.optim.SGD(params.values(), lr=0.05, momentum=0.9)
    tsched = [TT.uniform_topology_spec(TT.ExponentialTwoGraph(4))]
    step = bt.build_train_step(_tloss, opt, backend, comm_mode="atc",
                               topology=tsched[0],
                               hierarchical_local_size=2,
                               guard=bt.GuardConfig(**guard))
    assert step.hierarchical_local_size == 2
    heals = []
    tres = R.run_resilient(
        step, params, opt, _tbatch, steps=8,
        checkpointer=Checkpointer(str(tmp_path / "t")), schedule=tsched,
        fault_plan=R.FaultPlan.rank_death(N, **plan), checkpoint_every=2,
        sleep=lambda s: None,
        on_event=lambda e: heals.append(e) if e.kind == "rollback" else None)
    assert _events(tres) == _events(jres) and heals
    _assert_params_close(jres.params, tres.params)
    # machine 1 (ranks 2, 3) is frozen out of the machine mixing
    cw, sw = R.healing.healed_hierarchical_comm_weights(
        tsched, tres.dead_mask, 2)[0]
    assert sw[1] == 1.0 and (cw[:, 1] == 0).all()


# ------------------------------------------------------------------ #
# the runner tests of tests/test_fleet.py, against JAX's outcomes
# ------------------------------------------------------------------ #
def _fleet_runs(tmp_path, plan_of, stalls, **kw):
    """JAX's and the port's run of test_fleet.py's cta toy (w = eye(4),
    sgd 0.05, batch of ones) under a straggler; (jres, tres, jdet,
    tdet)."""
    jsched = JT.one_peer_dynamic_schedule(N)
    mesh = _mesh()

    def jloss(params, batch):
        return jnp.mean((batch @ params["w"]) ** 2)

    key = ("fleet", kw.get("max_consecutive_bad"))
    if key not in _STEPS:
        _STEPS[key] = JF.build_train_step(
            jloss, optax.sgd(0.05), mesh, comm_mode="cta", schedule=jsched,
            donate=False, guard=JF.GuardConfig(**kw))
    jstep = _STEPS[key]
    base = {"w": jnp.eye(4)}
    jp = JF.rank_major(base, mesh)
    jo = JF.rank_major(optax.sgd(0.05).init(base), mesh)

    def jbatch(i):
        return jax.device_put(np.ones((N, 2, 4), np.float32),
                              NamedSharding(mesh, P("bf")))

    def times(step_i, wall):
        t = np.full(N, 0.01)
        t[6] += stalls(step_i)
        return t

    jdet = JR.FailureDetector(N)
    jck = JCheckpointer(str(tmp_path / "j"))
    jres = JR.run_resilient(
        jstep, jp, jo, jbatch, steps=12 if plan_of is None else 8,
        checkpointer=jck, mesh=mesh, schedule=jsched, detector=jdet,
        fault_plan=plan_of(JR) if plan_of else None, checkpoint_every=0,
        sleep=lambda s: None,
        straggler=JFL.StragglerDetector(N, z_threshold=4.0, patience=2),
        step_times_fn=times)
    jck.close()

    backend = bt.StackedBackend(N, device="cpu")
    params = {"w": torch.eye(4, dtype=torch.float64).expand(N, 4, 4)
              .clone()}
    opt = torch.optim.SGD(params.values(), lr=0.05)
    tsched = TT.one_peer_dynamic_schedule(N)
    tstep = bt.build_train_step(
        lambda p, b: ((b @ p["w"]) ** 2).mean(), opt, backend,
        comm_mode="cta", schedule=tsched, guard=bt.GuardConfig(**kw))
    tdet = R.FailureDetector(N)
    tres = R.run_resilient(
        tstep, params, opt,
        lambda i: torch.ones(N, 2, 4, dtype=torch.float64),
        steps=12 if plan_of is None else 8,
        checkpointer=Checkpointer(str(tmp_path / "t")), schedule=tsched,
        detector=tdet, fault_plan=plan_of(R) if plan_of else None,
        checkpoint_every=0, sleep=lambda s: None,
        straggler=FL.StragglerDetector(N, z_threshold=4.0, patience=2),
        step_times_fn=times)
    return jres, tres, jdet, tdet


def test_run_resilient_wires_straggler_to_suspects(tmp_path):
    """tests/test_fleet.py:284: the slow rank is named (one straggler
    event at step 3 for rank 6), suspicion is withdrawn on recovery, and
    nobody dies — as in JAX's run."""
    jres, tres, jdet, tdet = _fleet_runs(
        tmp_path, None, lambda s: 0.3 if 2 <= s < 8 else 0.0)
    assert _events(tres) == _events(jres)
    strag = [e for e in tres.events if e.kind == "straggler"]
    assert len(strag) == 1 and strag[0].detail["ranks"] == [6]
    assert strag[0].step == 3
    assert tdet.external_suspects() == jdet.external_suspects() == []
    assert not tres.dead_mask.any() and tres.n_rollbacks == 0
    _assert_params_close(jres.params, tres.params)


def test_failure_detector_external_suspects():
    """tests/test_fleet.py:335, on both packages' detectors."""
    for det in (R.FailureDetector(4), JR.FailureDetector(4)):
        det.suspect([2])
        assert det.suspects(3) == [2]
        assert det.streak_suspects(3) == []
        assert det.external_suspects() == [2]
        det.declare_dead([2])
        assert det.suspects(3) == []
        det.suspect([1, 3])
        det.clear_suspicion([1])
        assert det.external_suspects() == [3]
        det.clear_suspicion()
        assert det.suspects(3) == []
        with pytest.raises(ValueError):
            det.suspect([9])
        det.suspect([1], source="operator")
        det.suspect([1], source="straggler")
        det.clear_suspicion([1], source="straggler")
        assert det.external_suspects() == [1]
        det.clear_suspicion([1], source="operator")
        assert det.external_suspects() == []


def test_straggler_suspicion_never_attributes_a_nan_window(tmp_path):
    """tests/test_fleet.py:362: rotating transients on ranks 0/1/2 while
    rank 6 is flagged slow give bad_window_unattributed, no death — the
    straggler stays named, not shot; events equal JAX's."""
    jres, tres, jdet, tdet = _fleet_runs(
        tmp_path, lambda m: m.FaultPlan(N, [m.Fault(2, 0, "nan"),
                                            m.Fault(3, 1, "nan"),
                                            m.Fault(4, 2, "nan")]),
        lambda s: 0.3, max_consecutive_bad=3)
    assert _events(tres) == _events(jres)
    kinds = [e.kind for e in tres.events]
    assert "bad_window_unattributed" in kinds and "rank_dead" not in kinds
    assert not tres.dead_mask.any() and tres.n_rollbacks == 0
    assert tdet.external_suspects() == jdet.external_suspects() == [6]

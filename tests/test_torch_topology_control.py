"""The port's topology control plane (bluefog_tpu_torch/topology/control.py)
against the JAX package's on the CPU.

Every case of ``tests/test_topology_control.py`` runs twice, once over
each package's plane, on the same pod (``PodSpec(4, 2, ici_cost=1.0,
dcn_cost=4.0)``), the same carrier (4 rounds declaring shifts 1, 2, 4,
6, 7) and the same telemetry fed to each plane's own registry.  Both
planes are host numpy, so the ``on_step`` event lists, the active
schedules and the scores must be EQUAL, float for float.  The one
exception is the probation health (``health``/``preswap_health``): the
port reduces the params on their device in float64 with torch, the JAX
package with numpy, so the two may round apart; they are held within
1e-12 relative.

End to end, the port's ``run_resilient(control=)`` over
``StackedBackend(8)`` goes through the shrink-swap cycle against JAX's
on its 8-device mesh: equal event kinds, steps and topology details,
params within 1e-6 of each leaf's largest entry, one step object at
every call and carrier-shaped float64 weights at every boundary.  JAX's
step is built once per process.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from bluefog_tpu import resilience as JR
from bluefog_tpu import topology as JT
from bluefog_tpu.checkpoint import Checkpointer as JCheckpointer
from bluefog_tpu.observe import MetricsRegistry as JRegistry
from bluefog_tpu.observe import fleet as JFL
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.resilience import healing as JH
from bluefog_tpu.topology import control as JC

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import resilience as R
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.checkpoint import Checkpointer
from bluefog_tpu_torch.observe import MetricsRegistry
from bluefog_tpu_torch.observe import fleet as FL
from bluefog_tpu_torch.resilience import healing as TH
from bluefog_tpu_torch.topology import control as TC

pytestmark = pytest.mark.topology

N = 8
MACHINES, LOCAL = 4, 2
SHIFTS = (1, 2, 4, 6, 7)
HEALTH_RTOL = 1e-12
_HEALTH_KEYS = ("health", "preswap_health")

JAX = types.SimpleNamespace(
    T=JT, C=JC, H=JH, registry=JRegistry, record=JFL.record_edge_timing,
    straggler=JFL.StragglerDetector)
PORT = types.SimpleNamespace(
    T=TT, C=TC, H=TH, registry=MetricsRegistry,
    record=FL.record_edge_timing, straggler=FL.StragglerDetector)
SIDES = (JAX, PORT)


def _pod(ns):
    return ns.T.PodSpec(MACHINES, LOCAL, ici_cost=1.0, dcn_cost=4.0)


def _carrier(ns, rounds=4):
    ew = {}
    for s in SHIFTS:
        for i in range(N):
            ew[(i, (i + s) % N)] = 1.0 / (len(SHIFTS) + 1)
    base = ns.T.DynamicTopology.from_edges(
        N, ew, [1.0 / (len(SHIFTS) + 1)] * N)
    return [base] * rounds


def _shift_round(ns, shift, weight=0.5):
    ew = {(i, (i + shift) % N): weight for i in range(N)}
    return ns.T.DynamicTopology.from_edges(N, ew, [1.0 - weight] * N)


def _plane(ns, cls=None, rounds=4, **kw):
    kw.setdefault("window", 4)
    kw.setdefault("patience", 2)
    kw.setdefault("degrade_ratio", 1.5)
    kw.setdefault("margin", 0.05)
    kw.setdefault("cooldown", 4)
    kw.setdefault("probation", 3)
    kw.setdefault("synchronous", True)
    cls = cls or ns.T.TopologyControlPlane
    return cls(_pod(ns), _carrier(ns, rounds), **kw)


def _live():
    return np.zeros(N, bool)


def _sched(specs):
    """A schedule as plain tuples, comparable across the packages."""
    return [(s.size, tuple(s.edges), tuple(float(v) for v in
                                           s.edge_weight_values),
             tuple(float(v) for v in s.self_weight_values))
            for s in specs]


def _same_events(got, want):
    """``(kind, detail)`` lists equal, the probation health to 1e-12."""
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if key in _HEALTH_KEYS:
                assert g[key] == pytest.approx(w[key], rel=HEALTH_RTOL)
            else:
                assert g[key] == w[key], key


def _same_plane(tp, jp):
    assert tp.active_name() == jp.active_name()
    assert _sched(tp.active_schedule()) == _sched(jp.active_schedule())
    assert tp.state == jp.state
    assert (tp.triggers, tp.swaps, tp.rollbacks) == \
        (jp.triggers, jp.swaps, jp.rollbacks)
    assert tp.last_scores == jp.last_scores


def _bill(ns, plane, reg, slow_edge=None, factor=1.0, scale=1.0):
    for spec in plane.active_schedule():
        for e, v in zip(spec.edges, spec.edge_weight_values):
            if v != 0.0:
                slow = 10.0 if e == slow_edge else 1.0
                ns.record(None, scale * slow * plane.pod.round_cost([e]),
                          registry=reg, pairs=[e])


# ------------------------------------------------------------------ #
# (a) projection
# ------------------------------------------------------------------ #
def test_project_reexpresses_on_carrier_edges():
    out = []
    for ns in SIDES:
        plane = _plane(ns)
        cand = [_shift_round(ns, 1), _shift_round(ns, 2)]
        proj = plane.project(cand)
        assert len(proj) == len(plane.carrier)
        for t, spec in enumerate(proj):
            assert spec.edges == plane.carrier[t].edges
            want = cand[t % len(cand)]
            wmap = dict(zip(want.edges, want.edge_weight_values))
            for e, v in zip(spec.edges, spec.edge_weight_values):
                assert v == wmap.get(e, 0.0)
        out.append(_sched(proj))
    assert out[1] == out[0]


def test_project_rejects_undeclared_edges():
    for ns in SIDES:
        plane = _plane(ns)
        bad = ns.T.DynamicTopology.from_edges(
            N, {(i, (i + 3) % N): 0.5 for i in range(N)}, [0.5] * N)
        with pytest.raises(ValueError, match="never\\s+declared"):
            plane.project([bad])
        with pytest.raises(ValueError, match="empty"):
            plane.project([])
        with pytest.raises(ValueError, match="ranks"):
            plane.project([ns.T.DynamicTopology.from_edges(
                4, {(0, 1): 0.5}, [0.5] * 4)])


def test_project_zero_weight_on_undeclared_edge_is_fine():
    out = []
    for ns in SIDES:
        plane = _plane(ns)
        ew = {(i, (i + 1) % N): 0.5 for i in range(N)}
        ew[(0, 3)] = 0.0
        cand = ns.T.DynamicTopology.from_edges(N, ew, [0.5] * N)
        proj = plane.project([cand])
        assert proj[0].edges == plane.carrier[0].edges
        out.append(_sched(proj))
    assert out[1] == out[0]


# ------------------------------------------------------------------ #
# (b) scoring under the dead mask
# ------------------------------------------------------------------ #
def test_score_active_healed_under_dead_mask():
    out = []
    for ns in SIDES:
        plane = _plane(ns)
        sched = plane.project([_shift_round(ns, 1)])
        full = plane.score_active(sched, _live())
        dead = _live()
        dead[[6, 7]] = True
        healed = plane.score_active(sched, dead)
        for sc in (full, healed):
            assert set(sc) == {"mean_round_cost", "max_round_cost",
                               "sigma", "rounds_to_consensus",
                               "cost_to_consensus"}
            assert sc["cost_to_consensus"] > 0
        assert healed["sigma"] != pytest.approx(full["sigma"])
        with pytest.raises(ValueError, match="no live"):
            plane.score_active(sched, np.ones(N, bool))
        out.append((full, healed))
    assert out[1] == out[0]


def test_score_active_calibrated_pod_reprices():
    out = []
    for ns in SIDES:
        plane = _plane(ns)
        sched = plane.project([_shift_round(ns, 2)])
        base = plane.score_active(sched, _live())
        hot = plane.pod.calibrated({(0, 2): 100.0}, contention=3.0)
        repriced = plane.score_active(sched, _live(), hot)
        assert repriced["cost_to_consensus"] > base["cost_to_consensus"]
        assert repriced["sigma"] == pytest.approx(base["sigma"])
        out.append((base, repriced))
    assert out[1] == out[0]


# ------------------------------------------------------------------ #
# (c) detection: debounce, relativity, membership
# ------------------------------------------------------------------ #
def test_uniform_load_never_triggers():
    planes = []
    for ns in SIDES:
        reg = ns.registry()
        plane = _plane(ns, registry=reg)
        for step in range(1, 25):
            _bill(ns, plane, reg, scale=2.0)
            assert plane.on_step(step, dead_mask=_live()) == []
        assert plane.triggers == 0 and plane.state == "steady"
        planes.append(plane)
    _same_plane(planes[1], planes[0])


def test_hot_edge_debounced_then_triggers():
    runs = []
    for ns in SIDES:
        reg = ns.registry()
        plane = _plane(ns, registry=reg)
        events, triggered_at = [], None
        for step in range(1, 13):
            _bill(ns, plane, reg, slow_edge=(0, 2))
            ev = plane.on_step(step, dead_mask=_live())
            events.append(ev)
            if "topology_trigger" in [k for k, _ in ev]:
                triggered_at = step
                break
        assert triggered_at == 8
        assert plane.triggers == 1
        # the synthesis ran inline; the next boundary delivers the swap
        events.append(plane.on_step(9, dead_mask=_live()))
        runs.append((plane, events))
    (jp, jev), (tp, tev) = runs
    assert len(tev) == len(jev)
    for g, w in zip(tev, jev):
        _same_events(g, w)
    _same_plane(tp, jp)


def test_membership_transition_triggers_immediately():
    runs = []
    for ns in SIDES:
        plane = _plane(ns, window=0)
        assert plane.on_step(1, dead_mask=_live()) == []
        dead = _live()
        dead[5] = True
        events = plane.on_step(2, dead_mask=dead)
        assert "topology_trigger" in [k for k, _ in events]
        assert dict(events)["topology_trigger"]["reason"] == "membership"
        events += plane.on_step(3, dead_mask=dead)
        runs.append((plane, events))
    _same_events(runs[1][1], runs[0][1])
    _same_plane(runs[1][0], runs[0][0])


def test_margin_gate_rejects_noise_wins():
    runs = []
    for ns in SIDES:
        plane = _plane(ns, window=0, margin=0.999)
        dead = _live()
        dead[7] = True
        first = plane.on_step(1, dead_mask=dead)
        assert [k for k, _ in first] == ["topology_trigger"]
        second = plane.on_step(2, dead_mask=dead)
        kinds = [k for k, _ in second]
        assert "topology_reject" in kinds and "topology_swap" not in kinds
        assert plane.swaps == 0 and plane.state == "steady"
        assert plane.last_scores["incumbent"] > 0
        runs.append((plane, first + second))
    _same_events(runs[1][1], runs[0][1])
    _same_plane(runs[1][0], runs[0][0])


def test_margin_gate_accepts_clear_win():
    runs = []
    for ns in SIDES:
        plane = _plane(ns, window=0, margin=0.05)
        dead = _live()
        dead[[6, 7]] = True
        first = plane.on_step(1, dead_mask=dead)
        events = plane.on_step(2, dead_mask=dead)
        assert "topology_swap" in [k for k, _ in events]
        swap = dict(events)["topology_swap"]
        assert swap["cost_to_consensus"] < swap["incumbent"]
        assert plane.active_name() == swap["schedule"] != "carrier"
        assert plane.state == "probation"
        runs.append((plane, first + events))
    _same_events(runs[1][1], runs[0][1])
    _same_plane(runs[1][0], runs[0][0])


def test_cooldown_suppresses_retrigger():
    runs = []
    for ns in SIDES:
        plane = _plane(ns, window=0, margin=0.999, cooldown=50)
        dead = _live()
        dead[7] = True
        events = plane.on_step(1, dead_mask=dead)
        events += plane.on_step(2, dead_mask=dead)
        assert plane.triggers == 1
        dead2 = dead.copy()
        dead2[6] = True
        for step in range(3, 20):
            events += plane.on_step(step, dead_mask=dead2)
        assert plane.triggers == 1
        runs.append((plane, events))
    _same_events(runs[1][1], runs[0][1])
    _same_plane(runs[1][0], runs[0][0])


# ------------------------------------------------------------------ #
# swap mechanics: carrier shapes, dead-mask composition, boundary fn
# ------------------------------------------------------------------ #
def test_swap_comm_weights_keeps_shapes_and_composes_mask():
    tables = []
    for ns in SIDES:
        plane = _plane(ns)
        before = ns.C.swap_comm_weights(plane, _live())
        dead = _live()
        dead[3] = True
        plane.force_candidate([_shift_round(ns, 1), _shift_round(ns, 2)],
                              name="swapped")
        plane.on_step(1, dead_mask=dead)
        assert plane.active_name() == "swapped"
        after = ns.C.swap_comm_weights(plane, dead)
        assert len(after) == len(before) == len(plane.carrier)
        for (cw0, sw0), (cw1, sw1) in zip(before, after):
            assert np.asarray(cw0).shape == np.asarray(cw1).shape
            assert np.asarray(sw0).shape == np.asarray(sw1).shape
        want = ns.H.healed_comm_weights(plane.active_schedule(), dead)
        for (wcw, wsw), (cw1, sw1) in zip(want, after):
            np.testing.assert_array_equal(np.asarray(wcw), np.asarray(cw1))
            np.testing.assert_array_equal(np.asarray(wsw), np.asarray(sw1))
        tables.append(after)
    # the port's tables are float64 tensors, byte-equal to JAX's arrays
    for (jcw, jsw), (tcw, tsw) in zip(*tables):
        assert tcw.dtype == tsw.dtype == torch.float64
        assert tcw.numpy().tobytes() == np.asarray(jcw).tobytes()
        assert tsw.numpy().tobytes() == np.asarray(jsw).tobytes()


def test_force_candidate_still_enforces_projection():
    for ns in SIDES:
        plane = _plane(ns)
        bad = ns.T.DynamicTopology.from_edges(
            N, {(i, (i + 3) % N): 0.5 for i in range(N)}, [0.5] * N)
        with pytest.raises(ValueError, match="never\\s+declared"):
            plane.force_candidate([bad])


# ------------------------------------------------------------------ #
# (e) probation rollback, and the health signal itself
# ------------------------------------------------------------------ #
def _params_with_spread(spread):
    w = np.zeros((N, 3))
    w[:, 0] = np.linspace(0.0, spread, N)
    return {"w": w}


def test_probation_rolls_back_on_worse_health():
    runs = []
    for ns in SIDES:
        plane = _plane(ns, rollback_tolerance=1.2)
        plane.force_candidate([_shift_round(ns, 1)], name="bad")
        first = plane.on_step(1, dead_mask=_live(),
                              params=_params_with_spread(1.0))
        assert [k for k, _ in first] == ["topology_swap"]
        assert plane.active_name() == "bad"
        events = plane.on_step(2, dead_mask=_live(),
                               params=_params_with_spread(10.0))
        assert [k for k, _ in events] == ["topology_rollback"]
        assert plane.active_name() == "carrier"
        assert plane.rollbacks == 1 and plane.state == "steady"
        detail = dict(events)["topology_rollback"]
        assert detail["restored"] == "carrier"
        assert detail["health"] > detail["preswap_health"]
        runs.append((plane, first + events))
    _same_events(runs[1][1], runs[0][1])
    _same_plane(runs[1][0], runs[0][0])


def test_probation_commits_on_clean_health():
    runs = []
    for ns in SIDES:
        plane = _plane(ns, probation=3, rollback_tolerance=1.2)
        plane.force_candidate([_shift_round(ns, 1)], name="good")
        events = plane.on_step(1, dead_mask=_live(),
                               params=_params_with_spread(1.0))
        for step in (2, 3):
            assert plane.on_step(step, dead_mask=_live(),
                                 params=_params_with_spread(0.5)) == []
        last = plane.on_step(4, dead_mask=_live(),
                             params=_params_with_spread(0.2))
        assert [k for k, _ in last] == ["topology_commit"]
        assert plane.active_name() == "good"
        assert plane.rollbacks == 0 and plane.state == "steady"
        runs.append((plane, events + last))
    _same_events(runs[1][1], runs[0][1])
    _same_plane(runs[1][0], runs[0][0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consensus_distance_equals_the_host_float64(seed):
    """The port's on-device float64 reduction against JAX's host one, on
    float32 and float64 tensor leaves, a leaf without a rank axis
    (skipped) and random live masks; and under a dead mask the dead
    rows do not count."""
    rng = np.random.RandomState(seed)
    live = rng.rand(N) < 0.7
    live[0] = True
    tree = {"a": rng.randn(N, 5, 3).astype(np.float32),
            "b": rng.randn(N, 7) * 1e3,
            "scalar_bias": rng.randn(3)}
    want = JC._consensus_distance(tree, live)
    got = TC._consensus_distance(
        {k: torch.from_numpy(v) for k, v in tree.items()}, live)
    assert got == pytest.approx(want, rel=HEALTH_RTOL)
    dead_rows = dict(tree, b=tree["b"].copy())
    dead_rows["b"][~live] = 1e9
    assert TC._consensus_distance(
        {k: torch.from_numpy(v) for k, v in dead_rows.items()},
        live) == pytest.approx(want, rel=HEALTH_RTOL)


# ------------------------------------------------------------------ #
# background-thread synthesis path
# ------------------------------------------------------------------ #
def test_background_synthesis_delivers_swap():
    runs = []
    for ns in SIDES:
        plane = _plane(ns, window=0, synchronous=False)
        dead = _live()
        dead[[6, 7]] = True
        events = plane.on_step(1, dead_mask=dead)
        assert [k for k, _ in events] == ["topology_trigger"]
        plane.join(timeout=30.0)
        assert plane.state == "candidate_ready"
        second = plane.on_step(2, dead_mask=dead)
        assert "topology_swap" in [k for k, _ in second]
        assert plane.swaps == 1
        runs.append((plane, events + second))
    _same_events(runs[1][1], runs[0][1])
    _same_plane(runs[1][0], runs[0][0])


# ------------------------------------------------------------------ #
# straggler z-scores degrade the window and reprice the pod
# ------------------------------------------------------------------ #
def test_straggler_z_hot_degrades_and_triggers():
    runs = []
    for ns in SIDES:
        det = ns.straggler(N, z_threshold=3.0, patience=2)
        plane = _plane(ns, straggler=det, z_threshold=3.0, patience=1)
        rng = np.random.RandomState(0)
        events = []
        for step in range(1, 9):
            t = 1.0 + 0.01 * rng.randn(N)
            t[5] += 5.0
            det.observe(t)
            ev = plane.on_step(step, dead_mask=_live())
            events.append((step, ev))
            if any(k == "topology_trigger" for k, _ in ev):
                assert dict(ev)["topology_trigger"]["reason"] == "degraded"
                break
        else:
            pytest.fail("straggler z never degraded a window")
        assert det.z_scores().get(5, 0.0) >= 3.0
        events.append((step + 1, plane.on_step(step + 1,
                                               dead_mask=_live())))
        runs.append((plane, events))
    (jp, jev), (tp, tev) = runs
    assert [s for s, _ in tev] == [s for s, _ in jev]
    for (_, g), (_, w) in zip(tev, jev):
        _same_events(g, w)
    _same_plane(tp, jp)


# ------------------------------------------------------------------ #
# constructor validation + config defaults
# ------------------------------------------------------------------ #
def test_constructor_validation_and_env_defaults(monkeypatch):
    for ns in SIDES:
        with pytest.raises(ValueError, match="non-empty carrier"):
            ns.T.TopologyControlPlane(_pod(ns), [])
        with pytest.raises(ValueError, match="does not match"):
            ns.T.TopologyControlPlane(ns.T.PodSpec(2, 2), _carrier(ns))
    defaults = [(p.window, p.patience, p.degrade_ratio, p.margin,
                 p.cooldown, p.probation)
                for p in (ns.T.TopologyControlPlane(_pod(ns), _carrier(ns))
                          for ns in SIDES)]
    assert defaults[1] == defaults[0] == (8, 2, 1.3, 0.05, 16, 8)
    env = {"WINDOW": "17", "PATIENCE": "5", "MARGIN": "0.25",
           "DEGRADE": "2.5", "COOLDOWN": "-3", "PROBATION": "junk"}
    for k, v in env.items():
        monkeypatch.setenv(f"BLUEFOG_TOPOLOGY_REPLAN_{k}", v)
    got = []
    for ns in SIDES:
        plane = ns.T.TopologyControlPlane(_pod(ns), _carrier(ns))
        assert plane.window == 17
        assert plane.patience == 5
        assert plane.margin == 0.25
        got.append((plane.window, plane.patience, plane.degrade_ratio,
                    plane.margin, plane.cooldown, plane.probation))
        plane = ns.T.TopologyControlPlane(_pod(ns), _carrier(ns), window=3)
        assert plane.window == 3
    assert got[1] == got[0] == (17, 5, 2.5, 0.25, 0, 8)


# ------------------------------------------------------------------ #
# (d) end-to-end: run_resilient(control=...) through one step object
# ------------------------------------------------------------------ #
_OPT = optax.sgd(0.05, momentum=0.9)
_E2E = {}


def _data():
    if "data" not in _E2E:
        rng = np.random.RandomState(11)
        _E2E["data"] = (rng.randn(16, N, 4, 6), rng.randn(16, N, 4, 2))
    return _E2E["data"]


def _jstep():
    """JAX's guarded atc step over the carrier, built once per process."""
    if "jstep" not in _E2E:
        def loss_fn(params, batch):
            x, y = batch
            return jnp.mean((x @ params["w"] - y) ** 2)

        _E2E["mesh"] = Mesh(np.array(jax.devices()[:N]), ("bf",))
        _E2E["jstep"] = JF.build_train_step(
            loss_fn, _OPT, _E2E["mesh"], comm_mode="atc",
            schedule=_carrier(JAX), guard=JF.GuardConfig())
    return _E2E["jstep"], _E2E["mesh"]


def _tstep():
    """The port's step over the carrier: (step, params, optimizer)."""
    def loss_fn(params, batch):
        x, y = batch
        return ((x @ params["w"] - y) ** 2).mean()

    backend = bt.StackedBackend(N, device="cpu")
    params = {"w": torch.zeros(N, 6, 2, dtype=torch.float64)}
    opt = torch.optim.SGD(params.values(), lr=0.05, momentum=0.9)
    step = bt.build_train_step(loss_fn, opt, backend, comm_mode="atc",
                               schedule=_carrier(PORT),
                               guard=bt.GuardConfig())
    return step, params, opt


def _jbatch(step):
    x, y = _data()
    return (x[step % 16], y[step % 16])


def _tbatch(step):
    x, y = _data()
    return (torch.from_numpy(x[step % 16]), torch.from_numpy(y[step % 16]))


def test_control_requires_matching_carrier(tmp_path):
    step, params, opt = _tstep()
    plane = _plane(PORT)
    with pytest.raises(ValueError, match="schedule"):
        R.run_resilient(step, params, opt, _tbatch, steps=1,
                        checkpointer=None, control=plane)
    with pytest.raises(ValueError, match="carrier has 4 rounds"):
        R.run_resilient(step, params, opt, _tbatch, steps=1,
                        checkpointer=None, schedule=_carrier(PORT, 2),
                        control=plane)
    # a process holding half the ranks: the health needs every row
    half = types.SimpleNamespace(size=N, n_local=N // 2, first_rank=0,
                                 gather_ranks=lambda t: t)
    with pytest.raises(ValueError, match="every rank's rows"):
        R.run_resilient(step, params, opt, _tbatch, steps=1,
                        checkpointer=None, backend=half,
                        schedule=_carrier(PORT), control=plane)


def test_shrink_swap_cycle_one_step_object_e2e(tmp_path):
    """Two ranks die -> membership trigger -> inline synthesis -> swap
    -> probation -> commit, on both packages: the same events at the
    same steps, the params alike, and on the port one step object called
    with carrier-shaped float64 weights at every boundary, equal after
    the swap to ``swap_comm_weights`` under the dead mask."""
    jstep, mesh = _jstep()
    guard = dict(max_consecutive_bad=3, backoff_base=0.0)
    plane_kw = dict(window=0, margin=0.05, cooldown=4, probation=3,
                    rollback_tolerance=4.0, synchronous=True)

    def plan(m):
        return m.FaultPlan(N, [m.Fault(4, 6, "dead"), m.Fault(4, 7, "dead")])

    jplane = JT.TopologyControlPlane(_pod(JAX), _carrier(JAX), **plane_kw)
    jp = JF.rank_major({"w": jnp.zeros((6, 2))}, mesh)
    jo = JF.rank_major(_OPT.init({"w": jnp.zeros((6, 2))}), mesh)
    jck = JCheckpointer(str(tmp_path / "jck"))
    jres = JR.run_resilient(
        jstep, jp, jo, _jbatch, steps=20, checkpointer=jck, mesh=mesh,
        schedule=_carrier(JAX), guard=JF.GuardConfig(**guard),
        fault_plan=plan(JR), checkpoint_every=0, sleep=lambda s: None,
        control=jplane)
    jck.close()

    step, params, opt = _tstep()
    calls = []

    def recorded(p, o, batch, i, weights):
        calls.append(weights)
        return step(p, o, batch, i, weights)

    recorded.default_comm_weights = step.default_comm_weights
    recorded.backend = step.backend
    recorded.guard_config = step.guard_config
    tplane = TT.TopologyControlPlane(_pod(PORT), _carrier(PORT), **plane_kw)
    tck = Checkpointer(str(tmp_path / "tck"))
    tres = R.run_resilient(
        recorded, params, opt, _tbatch, steps=20, checkpointer=tck,
        schedule=_carrier(PORT), guard=bt.GuardConfig(**guard),
        fault_plan=plan(R), checkpoint_every=0, sleep=lambda s: None,
        control=tplane)
    tck.close()

    jev = [(e.kind, e.step) for e in jres.events]
    assert [(e.kind, e.step) for e in tres.events] == jev
    kinds = [k for k, _ in jev]
    for kind in ("topology_trigger", "topology_swap", "topology_commit"):
        assert kind in kinds
    assert "topology_rollback" not in kinds
    _same_events([(e.kind, e.detail) for e in tres.events
                  if e.kind.startswith("topology_")],
                 [(e.kind, e.detail) for e in jres.events
                  if e.kind.startswith("topology_")])
    _same_plane(tplane, jplane)
    assert tplane.swaps == 1 and tplane.rollbacks == 0
    assert tplane.active_name() not in ("carrier", "initial")
    assert tres.step == jres.step == 20
    np.testing.assert_array_equal(tres.dead_mask, jres.dead_mask)
    want = np.asarray(jres.params["w"])
    got = tres.params["w"].numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max() + 1e-12
    assert R.update_health(tres.params)[~tres.dead_mask].all()

    # every step call, replays included, went to the one step object,
    # with carrier-shaped float64 weights
    replayed = sum(e.step - e.detail["restored_step"] for e in tres.events
                   if e.kind == "rollback")
    assert len(calls) == tres.step + replayed
    ref = step.default_comm_weights
    for w in calls:
        assert len(w) == len(ref)
        for (cw, sw), (rcw, rsw) in zip(w, ref):
            assert cw.shape == rcw.shape and sw.shape == rsw.shape
            assert cw.dtype == sw.dtype == torch.float64
            assert cw.device == rcw.device and sw.device == rsw.device
    # the swap lands after the rollback's replay: the last call runs the
    # committed plan healed under the final dead mask
    want_w = TC.swap_comm_weights(tplane, tres.dead_mask)
    for (cw, sw), (wcw, wsw) in zip(calls[-1], want_w):
        assert torch.equal(cw, wcw) and torch.equal(sw, wsw)
    assert not all(torch.equal(a, b) for (a, _), (b, _)
                   in zip(calls[0], want_w))


# ------------------------------------------------------------------ #
# (f) the mix-ratio ladder
# ------------------------------------------------------------------ #
def _forced(ns):
    class _ForcedPlane(ns.T.TopologyControlPlane):
        degraded = True

        def _window_degraded(self, secs, z):
            return self.degraded, 9.9

    return _ForcedPlane


def _ladder_plane(ns, **kw):
    kw.setdefault("window", 1)
    kw.setdefault("patience", 2)
    kw.setdefault("cooldown", 0)
    kw.setdefault("probation", 2)
    kw.setdefault("synchronous", True)
    kw.setdefault("use_compiler", False)
    kw.setdefault("mix_ratios", (0.25, 0.1, 0.05))
    return _plane(ns, cls=_forced(ns), rounds=1, **kw)


def _ladder_params():
    return {"x": np.zeros((N, 3))}


def test_mix_ladder_steps_down_commits_and_recovers():
    runs = []
    for ns in SIDES:
        health = {"v": 1.0}
        plane = _ladder_plane(ns, mix_recover_windows=2,
                              health_fn=lambda p, live: health["v"])
        assert ns.C.swap_mix_ratio(plane) == 0.25
        events, raw = [], []
        for step in range(1, 30):
            ev = plane.on_step(step, params=_ladder_params())
            raw += ev
            for kind, data in ev:
                events.append((kind, data.get("ratio"), data.get("reason")))
            if (ns.C.swap_mix_ratio(plane) == 0.1
                    and ("mix_ratio_commit", 0.1, None) in events):
                plane.degraded = False
            if ns.C.swap_mix_ratio(plane) == 0.25 and not plane.degraded:
                break
        kinds = [e[0] for e in events]
        assert ("mix_ratio_swap", 0.1, "degraded") in events
        assert ("mix_ratio_commit", 0.1, None) in events
        assert ("mix_ratio_swap", 0.25, "recover") in events
        assert ns.C.swap_mix_ratio(plane) == 0.25
        assert kinds.count("mix_ratio_rollback") == 0
        assert plane.mix_swaps >= 2 and plane.mix_rollbacks == 0
        runs.append((plane, raw))
    _same_events(runs[1][1], runs[0][1])
    assert runs[1][0].mix_swaps == runs[0][0].mix_swaps


def test_mix_ladder_rolls_back_on_worse_health():
    runs = []
    for ns in SIDES:
        health = {"v": 1.0}
        plane = _ladder_plane(ns, patience=1, probation=5,
                              mix_ratios=(0.25, 0.1),
                              health_fn=lambda p, live: health["v"])
        evs = plane.on_step(1, params=_ladder_params())
        assert [k for k, _ in evs] == ["mix_ratio_swap"]
        assert ns.C.swap_mix_ratio(plane) == 0.1
        health["v"] = 10.0
        evs2 = plane.on_step(2, params=_ladder_params())
        assert [k for k, _ in evs2] == ["mix_ratio_rollback"]
        assert ns.C.swap_mix_ratio(plane) == 0.25
        assert plane.mix_rollbacks == 1
        runs.append(evs + evs2)
    _same_events(runs[1], runs[0])


def test_mix_ladder_exhausted_falls_through_to_topology():
    runs = []
    for ns in SIDES:
        plane = _ladder_plane(ns, patience=1, probation=1,
                              mix_ratios=(0.25, 0.1),
                              health_fn=lambda p, live: 0.0)
        seen, raw = [], []
        for step in range(1, 12):
            ev = plane.on_step(step, params=_ladder_params())
            raw += ev
            seen += [k for k, _ in ev]
            if "topology_trigger" in seen:
                break
        assert "topology_trigger" in seen
        assert ns.C.swap_mix_ratio(plane) == 0.1
        runs.append(raw)
    _same_events(runs[1], runs[0])


def test_mix_ladder_validation():
    for ns in SIDES:
        for bad in [(0.25,), (0.25, 0.3), (0.25, 0.0), (0.25, 0.25)]:
            with pytest.raises(ValueError):
                _ladder_plane(ns, mix_ratios=bad)
        with pytest.raises(ValueError):
            _plane(ns).mix_ratio()

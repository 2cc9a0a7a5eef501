"""The port's simulated training fleet (bluefog_tpu_torch/sim/training.py,
wire.py) against the JAX package's simulator and against the port's own
real ``run_resilient`` loop, on the CPU.

* **Port sim vs JAX sim.**  The r16 congestion scenario (8 ranks, 4
  machines x 2 chips; a DCN-heavy incumbent over a carrier that declares
  shifts 1, 2, 4, 6, 7; links (0, 2) and (1, 3) 4x slow from step 8),
  the membership churn round trip, the persistent straggler and the
  n=1024 control-plane smoke each run over both packages: equal
  summaries, events, decisions and costs, and byte-equal event-log and
  flight-recorder chain digests.
* **Port sim vs port real loop** (``tests/test_sim.py:407`` and ``:485``
  with the port on both sides): the simulated fleet and the port's real
  ``run_resilient`` at n=8 over ``StackedBackend(8)`` make the same
  decisions at the same steps with the same candidate and costs, bill
  the same wire, and record byte-identical decision chains for a forced
  probation rollback.

The scenario's builders are copied from ``benchmarks/
chaos_adaptive_topology.py`` (``make_pod``, ``rich_carrier``,
``ici_round``, ``dcn_round``, ``WIRE_UNIT``, ``ROUNDS``) and built over
either package's topology module.
"""

import tempfile
import types

import numpy as np
import pytest
import torch

from bluefog_tpu import elastic as JE
from bluefog_tpu import resilience as JR
from bluefog_tpu import sim as JS
from bluefog_tpu import topology as JT
from bluefog_tpu.observe import MetricsRegistry as JRegistry
from bluefog_tpu.observe import blackbox as JBB
from bluefog_tpu.observe import fleet as JFL

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import elastic as TE
from bluefog_tpu_torch import resilience as R
from bluefog_tpu_torch import sim as TS
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.checkpoint import Checkpointer
from bluefog_tpu_torch.observe import MetricsRegistry
from bluefog_tpu_torch.observe import blackbox as TBB
from bluefog_tpu_torch.observe import fleet as FL

pytestmark = pytest.mark.sim

JAX = types.SimpleNamespace(S=JS, T=JT, R=JR, E=JE, BB=JBB, FL=JFL,
                            registry=JRegistry)
PORT = types.SimpleNamespace(S=TS, T=TT, R=R, E=TE, BB=TBB, FL=FL,
                             registry=MetricsRegistry)

# ------------------------------------------------------------------ #
# the r16 scenario (benchmarks/chaos_adaptive_topology.py's builders)
# ------------------------------------------------------------------ #
N = 8
MACHINES, LOCAL = 4, 2
SHIFTS = (1, 2, 4, 6, 7)   # declared by every carrier round
ROUNDS = 4                 # carrier period
WIRE_UNIT = 1e-3           # virtual seconds per unit of pod cost


def make_pod(ns):
    return ns.T.PodSpec(MACHINES, LOCAL, ici_cost=1.0, dcn_cost=4.0)


def rich_carrier(ns):
    w = 1.0 / (len(SHIFTS) + 1)
    ew = {(i, (i + s) % N): w for s in SHIFTS for i in range(N)}
    r = ns.T.DynamicTopology.from_edges(N, ew, [w] * N)
    return [r] * ROUNDS


def ici_round(ns):
    ew = {}
    for m in range(MACHINES):
        a, b = LOCAL * m, LOCAL * m + 1
        ew[(a, b)] = 0.5
        ew[(b, a)] = 0.5
    return ns.T.DynamicTopology.from_edges(N, ew, [0.5] * N)


def dcn_round(ns, direction):
    order = list(range(MACHINES))
    if direction < 0:
        order = list(reversed(order))
    mpairs = [(order[i], order[(i + 1) % MACHINES])
              for i in range(MACHINES)]
    ew = {p: 0.5 for p in ns.T.expand_machine_pairs(mpairs, LOCAL)}
    return ns.T.DynamicTopology.from_edges(N, ew, [0.5] * N)


def _static(ns):
    return [dcn_round(ns, +1), ici_round(ns), dcn_round(ns, +1),
            dcn_round(ns, -1)]


def _congestion(ns, steps, at=8):
    plan = ns.R.FaultPlan.congest_link(N, 0, 2, 4.0, start=at,
                                       duration=steps)
    return plan.merged(ns.R.FaultPlan.congest_link(
        N, 1, 3, 4.0, start=at, duration=steps))


def _control_and_wire(ns, plan, registry):
    """The r16 scenario's plane and wire, one construction per run (the
    plane is stateful)."""
    pod = make_pod(ns)
    control = ns.T.TopologyControlPlane(
        pod, rich_carrier(ns), registry=registry, window=8, patience=2,
        degrade_ratio=1.3, margin=0.05, cooldown=8, probation=6,
        rollback_tolerance=2.0, contention=3.0, synchronous=True,
        initial=_static(ns))
    wire = ns.S.LinkWire(
        pod, registry,
        schedule_fn=lambda s: control.active_schedule()[s % ROUNDS],
        dead_fn=lambda: np.zeros(N, bool),
        congestion_fn=plan.congested_links, wire_unit=WIRE_UNIT,
        period=ROUNDS)
    return control, wire


def _sim_congested(ns, steps, blackbox=None):
    reg = ns.registry()
    plan = _congestion(ns, steps)
    control, wire = _control_and_wire(ns, plan, reg)
    if blackbox is not None:
        control._blackbox = blackbox
    fleet = ns.S.SimTrainingFleet(
        control=control, wire=wire, fault_plan=plan,
        cost=ns.S.CostModel(train_step_s=1e-3, wire_unit_s=WIRE_UNIT))
    fleet.run(steps)
    return fleet


def _topology(events):
    return [(k, s, d) for k, s, d in events if k.startswith("topology_")]


def test_sim_congestion_cycle_equals_jax():
    """40 congested steps over each package: trigger (reason degraded)
    -> swap -> commit at the same steps with the same candidate and
    costs, the same wire charges, equal summaries and byte-equal event
    logs and flight-recorder chains; the adapted schedule is cheaper."""
    bbs = {id(ns): ns.BB.BlackBox(capacity=256) for ns in (JAX, PORT)}
    jf = _sim_congested(JAX, 40, bbs[id(JAX)])
    tf = _sim_congested(PORT, 40, bbs[id(PORT)])
    assert tf.summary() == jf.summary()
    assert tf.log.lines == jf.log.lines
    assert tf.events == jf.events
    assert tf.step_times == jf.step_times
    assert tf.wire.charges == jf.wire.charges
    assert tf.control.last_scores == jf.control.last_scores
    topo = _topology(tf.events)
    kinds = [(k, s) for k, s, _ in topo]
    # windows close every 8 steps; patience 2 -> trigger at 24
    assert kinds == [("topology_trigger", 24), ("topology_swap", 25),
                     ("topology_commit", 31)]
    assert topo[0][2]["reason"] == "degraded"
    assert topo[1][2]["schedule"] == "synth:hier:torus_exp2_rev"
    swap = topo[1][2]
    assert swap["cost_to_consensus"] < swap["incumbent"]
    assert tf.p50_step_s(32, 40) < tf.p50_step_s(8, 16)
    assert tf.detect_to_swap(8) == jf.detect_to_swap(8)
    tb, jb = bbs[id(PORT)], bbs[id(JAX)]
    assert [e.canonical_line() for e in tb.events()] == \
        [e.canonical_line() for e in jb.events()]
    assert tb.chain_digest() == jb.chain_digest()
    # and deterministic: a second port run gives the same digest
    assert _sim_congested(PORT, 40).summary()["event_digest"] == \
        tf.summary()["event_digest"]


# ------------------------------------------------------------------ #
# the port's sim against the port's real run_resilient at n=8
# ------------------------------------------------------------------ #
def _training_setup(seed):
    """The chaos bench's linear-regression fleet on the port: rank-major
    data, ``mean((x @ w - y)^2)``, SGD(0.05, momentum 0.9)."""
    dim, width = 16, 4
    rng = np.random.RandomState(seed)
    w_true = rng.randn(dim, width)
    w_rank = w_true[None] + 0.0 * rng.randn(N, dim, width)
    xs = rng.randn(64, N, 8, dim)
    ys = np.einsum("bnsd,ndw->bnsw", xs, w_rank) \
        + 0.01 * rng.randn(64, N, 8, width)
    return dim, width, torch.from_numpy(xs), torch.from_numpy(ys)


def _real_run(control, steps, batch_fn=None, detector=None, fault_plan=None):
    dim, width, xs, ys = _training_setup(0)

    def loss_fn(params, batch):
        x, y = batch
        return ((x @ params["w"] - y) ** 2).mean()

    backend = bt.StackedBackend(N, device="cpu")
    params = {"w": torch.zeros(N, dim, width, dtype=torch.float64)}
    opt = torch.optim.SGD(params.values(), lr=0.05, momentum=0.9)
    step = bt.build_train_step(loss_fn, opt, backend, comm_mode="atc",
                               schedule=control.carrier,
                               guard=bt.GuardConfig())
    batch_fn = batch_fn or (lambda s, x, y: (x[s % 64], y[s % 64]))
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        res = R.run_resilient(
            step, params, opt, lambda s: batch_fn(s, xs, ys),
            steps=steps, checkpointer=ck,
            schedule=control.carrier, fault_plan=fault_plan,
            detector=detector or R.FailureDetector(N), checkpoint_every=0,
            sleep=lambda s: None, control=control)
        ck.close()
    return res


def test_sim_vs_real_training_control_decisions_agree():
    """The port's simulated fleet reproduces the port's REAL
    ``run_resilient`` closed loop on the same telemetry: same trigger
    step, swap step, candidate and scored costs, the same per-step wire
    charges."""
    steps = 28
    reg = MetricsRegistry()
    plan = _congestion(PORT, steps)
    control, wire = _control_and_wire(PORT, plan, reg)
    det = R.FailureDetector(N)
    wire.dead_fn = det.dead_mask

    def batch_fn(step, xs, ys):
        wire.bill(step)
        return (xs[step % 64], ys[step % 64])

    res = _real_run(control, steps, batch_fn=batch_fn, detector=det,
                    fault_plan=plan)
    real = [(e.kind, e.step, e.detail) for e in res.events
            if e.kind.startswith("topology_")]

    reg2 = MetricsRegistry()
    plan2 = _congestion(PORT, steps)
    control2, wire2 = _control_and_wire(PORT, plan2, reg2)
    fleet = TS.SimTrainingFleet(
        control=control2, wire=wire2, fault_plan=plan2,
        cost=TS.CostModel(train_step_s=1e-3, wire_unit_s=WIRE_UNIT))
    fleet.run(steps)
    sim = _topology(fleet.events)

    assert [(k, s) for k, s, _ in sim] == [(k, s) for k, s, _ in real]
    assert any(k == "topology_swap" for k, _, _ in sim)
    sim_swap = next(d for k, _, d in sim if k == "topology_swap")
    real_swap = next(d for k, _, d in real if k == "topology_swap")
    assert sim_swap == real_swap      # candidate, cost and incumbent
    assert control2.active_name() == control.active_name()
    assert wire2.charges == wire.charges
    assert R.update_health(res.params).all()


def _forced_plane(ns, bb):
    # scripted probation health: baseline 1.0 at swap time, 10x on the
    # first probation check — beyond rollback_tolerance
    h = iter([1.0] + [10.0] * 32)
    plane = ns.T.TopologyControlPlane(
        make_pod(ns), rich_carrier(ns), window=0, probation=3,
        rollback_tolerance=1.2, synchronous=True,
        health_fn=lambda params, alive: next(h), blackbox=bb)
    plane.force_candidate(list(rich_carrier(ns)), "frozen")
    return plane


def _sim_forced(ns, steps):
    bb = ns.BB.BlackBox(capacity=256)
    fleet = ns.S.SimTrainingFleet(
        control=_forced_plane(ns, bb),
        cost=ns.S.CostModel(train_step_s=1e-3, wire_unit_s=WIRE_UNIT),
        params_fn=lambda step: {})
    fleet.run(steps)
    return bb, fleet


def test_decision_chain_real_vs_sim_byte_identical():
    """A forced probation-rollback cycle records the same causal chain
    (trigger -> synthesize -> candidate_ready -> swap -> rollback, linked
    parents, monotone steps) in the port's REAL 8-rank loop, in the
    port's sim and in the JAX package's sim, and the three chain digests
    are byte-identical (the probation health is detail only)."""
    steps = 6
    bb_real = TBB.BlackBox(capacity=256)
    _real_run(_forced_plane(PORT, bb_real), steps)
    bb_sim, tfleet = _sim_forced(PORT, steps)
    bb_jax, jfleet = _sim_forced(JAX, steps)
    for bb in (bb_real, bb_sim):
        evs = bb.events()
        assert [e.kind for e in evs] == [
            "trigger", "synthesize", "candidate_ready", "swap", "rollback"]
        trig, synth, ready, swap, rollback = evs
        assert trig.parent_id is None
        assert synth.parent_id == trig.event_id
        assert ready.parent_id == synth.event_id
        assert swap.parent_id == ready.event_id
        assert rollback.parent_id == swap.event_id
        assert [e.step for e in evs] == sorted(e.step for e in evs)
        assert rollback.step > swap.step
        assert {e.outcome for e in evs} == {"rolled_back"}
        assert "rollback" in bb.explain(trig)
    assert bb_real.chain_digest() == bb_sim.chain_digest()
    assert bb_sim.chain_digest() == bb_jax.chain_digest()
    assert tfleet.summary() == jfleet.summary()


# ------------------------------------------------------------------ #
# membership churn and the straggler, port vs JAX
# ------------------------------------------------------------------ #
def _churn_fleet(ns):
    reg = ns.registry()
    pod = make_pod(ns)
    control = ns.T.TopologyControlPlane(
        pod, rich_carrier(ns), registry=reg, window=8, patience=2,
        degrade_ratio=1.3, margin=0.05, cooldown=8, probation=6,
        synchronous=True, initial=_static(ns))
    membership = ns.E.MembershipController(control.active_schedule(),
                                           bootstrap_rounds=4)
    plan = ns.R.FaultPlan.preempt(N, 5, 6, 8)
    churn = ns.S.ChurnSchedule.from_fault_plan(plan, 40, admit_after=0,
                                               promote_after=6)
    fleets = []
    wire = ns.S.LinkWire(
        pod, reg,
        schedule_fn=lambda s: control.active_schedule()[s % ROUNDS],
        dead_fn=lambda: fleets[-1].dead_mask(),
        wire_unit=WIRE_UNIT, period=ROUNDS)
    fleet = ns.S.SimTrainingFleet(
        control=control, wire=wire, membership=membership, churn=churn,
        cost=ns.S.CostModel(train_step_s=1e-3))
    fleets.append(fleet)
    return fleet


def test_membership_churn_roundtrip_n8():
    """die -> admit -> promote through the port's MembershipController:
    the dead mask round-trips, every transition re-renders weights, and
    the run equals JAX's event for event and digest for digest."""
    fleet = _churn_fleet(PORT)
    fleet.run(6)
    assert fleet.dead_mask().sum() == 0
    fleet.run(1)
    assert fleet.dead_mask()[5] and fleet.dead_mask().sum() == 1
    renders_at_death = fleet.weight_renders
    assert renders_at_death >= 1
    fleet.run(33 - 7)
    assert fleet.dead_mask().sum() == 0
    kinds = {k for k, _, _ in fleet.events}
    assert {"membership_die", "membership_admit",
            "membership_promote"} <= kinds
    assert fleet.weight_renders > renders_at_death
    s1 = fleet.summary()
    assert _churn_fleet(PORT).run(33)["event_digest"] == s1["event_digest"]
    jfleet = _churn_fleet(JAX)
    assert jfleet.run(33) == s1
    assert jfleet.log.lines == fleet.log.lines
    assert fleet.membership.states() == jfleet.membership.states()


def _straggler_fleet(ns):
    reg = ns.registry()
    control = ns.T.TopologyControlPlane(
        make_pod(ns), rich_carrier(ns), registry=reg, window=8, patience=3,
        degrade_ratio=1.5, cooldown=8, synchronous=True,
        initial=[ici_round(ns)] * ROUNDS)
    plan = ns.R.FaultPlan.persistent_straggler(N, 5, 4, 0.25)
    fleet = ns.S.SimTrainingFleet(
        control=control, fault_plan=plan,
        straggler=ns.FL.StragglerDetector(N, registry=reg),
        cost=ns.S.CostModel(train_step_s=1e-3))
    fleet.run(16)
    return fleet


def test_training_straggler_detected_by_real_detector():
    fleet = _straggler_fleet(PORT)
    flagged = [d["rank"] for k, _, d in fleet.events if k == "straggler"]
    assert flagged == [5]
    assert dict(fleet.step_times)[10] >= 0.25
    jfleet = _straggler_fleet(JAX)
    assert fleet.events == jfleet.events
    assert fleet.summary() == jfleet.summary()


# ------------------------------------------------------------------ #
# scale smoke: n=1024 through the control plane, port vs JAX
# ------------------------------------------------------------------ #
def _menu_candidates(ns, shifts):
    def gen(pod, dead):
        n = pod.size
        out = []
        for name, ss in shifts:
            rounds = []
            for s in ss:
                ew = {(i, (i + s) % n): 0.5 for i in range(n)}
                rounds.append(ns.T.DynamicTopology.from_edges(
                    n, ew, [0.5] * n))
            out.append((name, rounds))
        return out

    return gen


def _n1024(ns):
    n, machines, local = 1024, 128, 8
    shifts = (1, 8, 64, 512)
    w = 1.0 / (len(shifts) + 1)
    ew = {(i, (i + s) % n): w for s in shifts for i in range(n)}
    carrier = [ns.T.DynamicTopology.from_edges(n, ew, [w] * n)] * 2

    def shift_round(s):
        return ns.T.DynamicTopology.from_edges(
            n, {(i, (i + s) % n): 0.5 for i in range(n)}, [0.5] * n)

    pod = ns.T.PodSpec(machines, local, ici_cost=1.0, dcn_cost=4.0)
    reg = ns.registry()
    control = ns.T.TopologyControlPlane(
        pod, carrier, registry=reg, window=4, patience=1,
        degrade_ratio=1.2, margin=0.01, cooldown=6, probation=4,
        contention=3.0, synchronous=True,
        initial=[shift_round(8), shift_round(512)],
        candidates_fn=_menu_candidates(
            ns, [("ring", (1, 1)), ("exp2", (1, 64))]))
    plan = ns.R.FaultPlan.congest_link(n, 8, 16, 6.0, start=4, duration=32)
    wire = ns.S.LinkWire(
        pod, reg, schedule_fn=lambda s: control.active_schedule()[s % 2],
        dead_fn=lambda: np.zeros(n, bool),
        congestion_fn=plan.congested_links, wire_unit=1e-3, period=2)
    return ns.S.SimTrainingFleet(
        control=control, wire=wire, cost=ns.S.CostModel(train_step_s=1e-3),
        sim=ns.S.Simulation(log=ns.S.EventLog(keep_lines=False)))


def test_n1024_control_plane_smoke():
    """1024 ranks (128 machines x 8 chips): a congested DCN link drives
    the port's windowed detection -> menu synthesis -> hot swap in
    virtual time, and the run's digest equals JAX's.  The eigenvalue
    solves run on one BLAS thread, so the test's cost stays its own on a
    shared host."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(1):
        fleet = _n1024(PORT)
        s = fleet.run(20)
        j = _n1024(JAX).run(20)
    assert s["ranks"] == 1024
    kinds = s["event_counts"]
    assert kinds.get("topology_trigger", 0) >= 1
    assert kinds.get("topology_swap", 0) >= 1
    assert fleet.control.active_name() in ("ring", "exp2")
    assert s["virtual_seconds"] > 0
    assert s == j

"""The port's fleet telemetry (bluefog_tpu_torch/observe/fleet.py and the
train step's ``bf_edge_bytes_total`` account) against the JAX package's
on the same numpy inputs, mirroring tests/test_fleet.py: push-sum
matrices and gossip to 1e-13 (the port's ``dead_mask`` path against
JAX's ``heal_spec``-healed schedules), byte counts, straggler flags and
Prometheus text exactly.  The run_resilient / FailureDetector tests of
tests/test_fleet.py are ported in tests/test_torch_resilience.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import observe as jobserve
from bluefog_tpu.observe import fleet as JFL
from bluefog_tpu.observe.registry import MetricsRegistry as JRegistry
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.resilience.healing import heal_spec
from bluefog_tpu import topology as jtopo
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import observe
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.observe import fleet as FL
from bluefog_tpu_torch.observe.registry import MetricsRegistry

N = 8
TOL = 1e-13


def _sched(n):
    """The one-peer schedule of ``n`` ranks in both packages (equal
    digests: the same specs)."""
    ours, theirs = (ttopo.one_peer_dynamic_schedule(n),
                    jtopo.one_peer_dynamic_schedule(n))
    assert [s.digest() for s in ours] == [s.digest() for s in theirs]
    return ours, theirs


def _exp2(n):
    return (ttopo.uniform_topology_spec(ttopo.ExponentialTwoGraph(n)),
            jtopo.uniform_topology_spec(jtopo.ExponentialTwoGraph(n)))


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    scale = max(np.nanmax(np.abs(b)), 1.0)
    assert np.nanmax(np.abs(a - b)) <= tol * scale


def _counters(reg, name="bf_edge_bytes_total"):
    return {tuple(sorted(lbl.items())): m.value
            for n, kind, _h, lbl, m in reg.collect() if n == name}


# --------------------------------------------------------------------- #
# push-sum gossip core
# --------------------------------------------------------------------- #
def test_push_sum_matrix_column_stochastic():
    ours, theirs = _sched(N)
    pairs = [_exp2(N)] + list(zip(ours, theirs))
    for spec, jspec in pairs:
        A = FL.push_sum_matrix(spec)
        np.testing.assert_array_equal(A, JFL.push_sum_matrix(jspec))
        np.testing.assert_allclose(A.sum(axis=0), 1.0, atol=1e-15)
    dead = np.zeros(N, bool)
    dead[2] = True
    A = FL.push_sum_matrix(ours[0], dead)
    np.testing.assert_array_equal(A, JFL.push_sum_matrix(theirs[0], dead))
    np.testing.assert_allclose(A.sum(axis=0), 1.0, atol=1e-15)
    assert A[2, 2] == 1.0 and A[2].sum() == 1.0  # dead rank is inert


def test_push_sum_matrix_matches_push_sum_mix():
    """The host gossip matrix IS one round of the port's push-sum mix on
    stacked ranks (f64 payload), as the JAX matrix is one round of the
    device mix."""
    spec, jspec = _exp2(N)
    x = np.arange(N, dtype=np.float64) + 1.0
    w = np.ones(N)
    mixed, mps = bt.parallel.collectives.push_sum_mix(
        {"v": torch.from_numpy(x)}, torch.from_numpy(w), spec)
    A = FL.push_sum_matrix(spec)
    np.testing.assert_allclose(mixed["v"].numpy(), A @ x, rtol=1e-12)
    np.testing.assert_allclose(mps.numpy(), A @ w, rtol=1e-12)
    np.testing.assert_array_equal(A, JFL.push_sum_matrix(jspec))


def test_aggregator_matches_centralized_mean_32_ranks():
    n = 32
    ours, theirs = _sched(n)
    vals = np.random.default_rng(0).standard_normal((n, 3)) * 10
    res = FL.FleetAggregator(ours, registry=MetricsRegistry()).aggregate(
        vals, names=("a", "b", "c"))
    jres = JFL.FleetAggregator(theirs, registry=JRegistry()).aggregate(
        vals, names=("a", "b", "c"))
    true = vals.mean(axis=0)
    assert np.abs(res.per_rank - true).max() / np.abs(true).max() <= 1e-12
    assert res.names == jres.names == ("a", "b", "c")
    assert res.rounds == jres.rounds
    _close(res.per_rank, jres.per_rank)
    _close(res.mean, jres.mean)


def test_aggregator_dead_mask_matches_healed_schedule():
    """The port's dead-mask excision against JAX's gossip over the
    ``heal_spec``-healed schedule: the same matrices, rounds and live
    means (dead ranks' garbage never leaks in)."""
    n = 32
    ours, theirs = _sched(n)
    dead = np.zeros(n, bool)
    dead[[3, 17]] = True
    vals = np.random.default_rng(1).standard_normal((n, 2))
    vals[dead] = 1e6
    healed = [heal_spec(s, dead) for s in theirs]
    for s, h in zip(ours, healed):
        np.testing.assert_array_equal(FL.push_sum_matrix(s, dead),
                                      JFL.push_sum_matrix(h))
    res = FL.FleetAggregator(ours, registry=MetricsRegistry()).aggregate(
        vals, dead_mask=dead)
    jres = JFL.FleetAggregator(healed, registry=JRegistry()).aggregate(
        vals, dead_mask=dead)
    true_live = vals[~dead].mean(axis=0)
    assert np.nanmax(np.abs(res.per_rank - true_live)) <= \
        1e-12 * np.abs(true_live).max()
    assert np.isnan(res.per_rank[3]).all()
    assert res.rounds == jres.rounds
    _close(res.per_rank, jres.per_rank)


def test_aggregator_dead_mask_matches_healed_schedule_without_mask():
    """JAX infers the excision from a healed schedule passed WITHOUT a
    dead mask (isolated ranks fold into it); the port's explicit mask
    over the plain schedule lands on the same views."""
    n = 32
    ours, theirs = _sched(n)
    dead = np.zeros(n, bool)
    dead[[3, 17]] = True
    vals = np.random.default_rng(2).standard_normal((n, 2))
    vals[dead] = 1e6
    healed = [heal_spec(s, dead) for s in theirs]
    jres = JFL.FleetAggregator(healed, registry=JRegistry()).aggregate(vals)
    res = FL.FleetAggregator(ours, registry=MetricsRegistry()).aggregate(
        vals, dead_mask=dead)
    assert res.rounds == jres.rounds < 10_000
    _close(res.per_rank, jres.per_rank)
    _close(res.mean, jres.mean)
    # the port folds isolated ranks the same way when handed a healed
    # schedule of its own types without a mask
    own_healed = [ttopo.DynamicTopology(h.size, h.edges, h.edge_weight_values,
                                        h.self_weight_values)
                  for h in healed]
    res2 = FL.FleetAggregator(own_healed,
                              registry=MetricsRegistry()).aggregate(vals)
    _close(res2.per_rank, jres.per_rank)


def test_gossip_traffic_skips_zero_weight_and_dead_edges():
    """Billing is exact: the port's dead-mask gossip bills exactly what
    JAX bills over the healed schedule (whose zeroed edges carry
    nothing), and nothing touching the dead rank."""
    ours, theirs = _sched(N)
    dead = np.zeros(N, bool)
    dead[2] = True
    healed = [heal_spec(s, dead) for s in theirs]
    dropped = [e for s, h in zip(theirs, healed)
               for e in set(JFL.edge_list(s)) - set(JFL.gossip_edge_list(h))]
    assert dropped and all(2 in e for e in dropped)
    vals = np.random.default_rng(3).standard_normal(N)
    reg, jreg = MetricsRegistry(), JRegistry()
    FL.FleetAggregator(ours, registry=reg).aggregate(vals, dead_mask=dead)
    JFL.FleetAggregator(healed, registry=jreg).aggregate(vals,
                                                         dead_mask=dead)
    billed = _counters(reg)
    assert billed and billed == _counters(jreg)
    assert not any(2 in (int(dict(k)["src"]), int(dict(k)["dst"]))
                   for k in billed)


def test_aggregator_hierarchical_weighted_mean():
    n, local = 32, 4
    dead = np.zeros(n, bool)
    dead[[0, 1, 2, 5]] = True
    vals = np.random.default_rng(2).standard_normal((n, 2))
    ours, theirs = _sched(n)
    m_ours, m_theirs = _sched(n // local)
    reg, jreg = MetricsRegistry(), JRegistry()
    agg = FL.FleetAggregator(ours, registry=reg)
    res = agg.aggregate_hierarchical(vals, local, m_ours, dead_mask=dead)
    jres = JFL.FleetAggregator(theirs, registry=jreg).aggregate_hierarchical(
        vals, local, m_theirs, dead_mask=dead)
    true_live = vals[~dead].mean(axis=0)
    assert np.nanmax(np.abs(res.per_rank - true_live)) <= \
        1e-12 * max(np.abs(true_live).max(), 1e-12)
    assert res.rounds == jres.rounds
    _close(res.per_rank, jres.per_rank)
    billed = _counters(reg)
    assert billed == _counters(jreg)
    assert all(int(dict(k)["src"]) % local == 0 and dict(k)["link"] == "dcn"
               for k in billed)
    n_cached = len(agg._mats)
    agg.aggregate_hierarchical(vals, local, m_ours, dead_mask=dead)
    assert len(agg._mats) == n_cached


def test_aggregator_publish_and_prometheus_text_match():
    """publish lands the same bf_fleet_* gauges, and the port's exporter
    renders the registry to the same Prometheus text as JAX's."""
    ours, theirs = _sched(N)
    vals = np.tile(np.arange(N, dtype=float)[:, None], (1, 2))
    reg, jreg = MetricsRegistry(), JRegistry()
    FL.FleetAggregator(ours, registry=reg, rank=0).publish(
        ("step_time_p50", "skips_total"), vals)
    JFL.FleetAggregator(theirs, registry=jreg, rank=0).publish(
        ("step_time_p50", "skips_total"), vals)
    snap = reg.snapshot()
    expect = float(np.arange(N).mean())
    assert abs(snap["bf_fleet_step_time_p50"][0]["value"] - expect) < 1e-9
    assert snap["bf_fleet_gossip_rounds"][0]["value"] >= 1
    assert all(set(r["labels"]) == {"src", "dst"}
               for r in snap["bf_edge_bytes_total"])
    text = observe.prometheus_text(reg)
    assert text == jobserve.prometheus_text(jreg)
    assert "bf_fleet_step_time_p50" in text
    assert 'bf_edge_bytes_total{dst="' in text


def test_collect_local_reads_registry():
    out = []
    for R, mod in ((MetricsRegistry, FL), (JRegistry, JFL)):
        reg = R()
        reg.histogram("bf_step_wall_seconds", loop="train").observe(0.25)
        reg.counter("bf_resilience_skips_total", rank=1).inc(3)
        reg.counter("bf_resilience_skips_total", rank=2).inc(4)
        reg.gauge("bf_serving_queue_depth").set(5)
        out.append(mod.collect_local(reg))
    assert out[0] == out[1] == {"step_time_p50": 0.25, "skips_total": 7.0,
                                "queue_depth": 5.0}


# --------------------------------------------------------------------- #
# straggler detection
# --------------------------------------------------------------------- #
def test_straggler_detector_flags_within_patience_and_clears():
    dets = [FL.StragglerDetector(N, z_threshold=4.0, patience=3,
                                 registry=MetricsRegistry()),
            JFL.StragglerDetector(N, z_threshold=4.0, patience=3,
                                  registry=JRegistry())]
    base = np.full(N, 0.01)
    rng = np.random.default_rng(0)
    slow = base.copy()
    slow[5] += 0.2
    obs = ([base + rng.normal(0, 1e-4, N) for _ in range(5)]
           + [slow + rng.normal(0, 1e-4, N) for _ in range(3)]
           + [base + rng.normal(0, 1e-4, N)])
    for i, t in enumerate(obs):
        newly = [d.observe(t) for d in dets]
        assert newly[0] == newly[1]
        assert dets[0].flagged() == dets[1].flagged()
        assert dets[0].z_scores() == dets[1].z_scores()
        if i == 7:
            assert newly[0] == [5] and dets[0].z_scores()[5] > 4.0
        elif i < 7:
            assert newly[0] == []
    assert dets[0].flagged() == [] and dets[0].z_scores()[5] < 4.0
    assert _counters(dets[0]._registry, "bf_fleet_straggler") == \
        _counters(dets[1]._registry, "bf_fleet_straggler")


def test_straggler_detector_robust_to_its_own_outlier(monkeypatch):
    times = np.full(N, 0.02)
    times[3] = 0.5
    assert FL.StragglerDetector(N, z_threshold=4.0, patience=1).observe(
        times) == [3]
    # the threshold knob: same env name and default as the JAX package
    monkeypatch.setenv("BLUEFOG_STRAGGLER_Z", "6.5")
    assert FL.StragglerDetector(N).z_threshold == \
        JFL.StragglerDetector(N).z_threshold == 6.5
    monkeypatch.delenv("BLUEFOG_STRAGGLER_Z")
    assert FL.StragglerDetector(N).z_threshold == 4.0


# --------------------------------------------------------------------- #
# the train step's edge account
# --------------------------------------------------------------------- #
def _jax_toy(mesh, **kwargs):
    base = {"b": jnp.zeros((4,), jnp.float32), "w": jnp.eye(4,
                                                           dtype=jnp.float32)}

    def loss_fn(params, batch):
        return jnp.mean((batch @ params["w"] + params["b"]) ** 2)

    opt = optax.sgd(0.05, momentum=0.9)
    step = JF.build_train_step(loss_fn, opt, mesh, donate=False, **kwargs)
    batch = jax.device_put(
        np.random.RandomState(0).randn(N, 2, 4).astype(np.float32),
        NamedSharding(mesh, P("bf")))
    return (step, JF.rank_major(base, mesh),
            JF.rank_major(opt.init(base), mesh), batch)


def _torch_toy(**kwargs):
    backend = bt.StackedBackend(N, device="cpu")
    params = bt.rank_major({"b": torch.zeros(4), "w": torch.eye(4)},
                           backend)
    opt = torch.optim.SGD(params.values(), lr=0.05, momentum=0.9)

    def loss_fn(p, batch):
        return ((batch @ p["w"] + p["b"]) ** 2).mean()

    step = bt.build_train_step(loss_fn, opt, backend, **kwargs)
    batch = torch.from_numpy(
        np.random.RandomState(0).randn(N, 2, 4).astype(np.float32))
    opt_state = ((opt, bt.push_sum_weights(backend))
                 if kwargs.get("comm_mode") == "push_sum" else opt)
    return step, params, opt_state, batch


@pytest.mark.parametrize("mode", ["cta", "push_sum", "hier"])
def test_train_step_records_edge_traffic(mode):
    """Each on-cycle call bills the per-rank payload to every edge of the
    round's topology, exactly the bytes JAX bills; off-cycle calls and
    non-neighbor modes bill nothing."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))
    ours, theirs = _sched(N)
    if mode == "hier":
        m_ours, m_theirs = _sched(N // 2)
        kw = dict(comm_mode="atc", hierarchical_local_size=2)
        tkw, jkw = dict(kw, schedule=m_ours), dict(kw, schedule=m_theirs)
    else:
        tkw = dict(comm_mode=mode, schedule=ours,
                   num_steps_per_communication=2)
        jkw = dict(comm_mode=mode, schedule=theirs,
                   num_steps_per_communication=2)
    before = (_counters(observe.get_registry()),
              _counters(jobserve.get_registry()))
    step, params, opt_state, batch = _torch_toy(**tkw)
    jstep, jparams, jostate, jbatch = _jax_toy(mesh, **jkw)
    if mode == "push_sum":
        jostate = (jostate, JF.push_sum_weights(mesh))
    for i in range(3):
        params, opt_state, _ = step(params, opt_state, batch, i)
        jparams, jostate, _ = jstep(jparams, jostate, jbatch, jnp.int32(i))
    got = {k: v - before[0].get(k, 0.0)
           for k, v in _counters(observe.get_registry()).items()}
    want = {k: v - before[1].get(k, 0.0)
            for k, v in _counters(jobserve.get_registry()).items()}
    got = {k: v for k, v in got.items() if v}
    assert got and got == {k: v for k, v in want.items() if v}
    if mode != "hier":   # steps 0 and 2 are on-cycle: rounds 0 and 2
        payload = 4 * 4 + 4 * 16
        edges = set(FL.gossip_edge_list(ours[0]) + FL.gossip_edge_list(
            ours[2]))
        assert {(int(dict(k)["src"]), int(dict(k)["dst"])) for k in got} \
            == edges
        assert set(got.values()) <= {payload, 2 * payload}

    # a topology passed with a non-neighbor mode moves nothing, bills
    # nothing
    mid = _counters(observe.get_registry())
    step2, params2, opt2, batch2 = _torch_toy(comm_mode="gradient_allreduce",
                                              topology=ours[0])
    step2(params2, opt2, batch2, 0)
    assert _counters(observe.get_registry()) == mid


# --------------------------------------------------------------------- #
# windowed traffic deltas + the timing twin
# --------------------------------------------------------------------- #
def test_record_edge_timing_bills_seconds_family():
    snaps = []
    for R, mod in ((MetricsRegistry, FL), (JRegistry, JFL)):
        reg = R()
        mod.record_edge_timing(None, 0.25, registry=reg, pairs=[(0, 1)])
        mod.record_edge_timing(None, 0.75, registry=reg,
                               pairs=[(0, 1), (2, 3)])
        mod.record_edge_timing(None, 0.5, registry=reg, pairs=[(0, 2)],
                               link="dcn")
        snaps.append((mod.traffic_snapshot(reg,
                                           metric="bf_edge_seconds_total"),
                       mod.traffic_snapshot(reg, link="dcn",
                                            metric="bf_edge_seconds_total"),
                       mod.traffic_snapshot(reg)))
    assert snaps[0] == snaps[1]
    assert snaps[0][0][(0, 1)] == pytest.approx(1.0)
    assert snaps[0][1] == {(0, 2): 0.5} and snaps[0][2] == {}


def test_traffic_deltas_window_semantics():
    seen = []
    for R, mod in ((MetricsRegistry, FL), (JRegistry, JFL)):
        reg = R()
        mod.record_edge_timing(None, 10.0, registry=reg, pairs=[(0, 1)])
        deltas = mod.TrafficDeltas(reg, metric="bf_edge_seconds_total")
        out = [deltas.take()]
        mod.record_edge_timing(None, 2.0, registry=reg, pairs=[(0, 1)])
        mod.record_edge_timing(None, 3.0, registry=reg, pairs=[(4, 5)])
        out += [deltas.peek(), deltas.peek(), deltas.take(), deltas.take()]
        mod.record_edge_timing(None, 1.5, registry=reg, pairs=[(0, 1)])
        out.append(deltas.take())
        seen.append(out)
    assert seen[0] == seen[1]
    assert seen[0] == [{}, {(0, 1): 2.0, (4, 5): 3.0},
                       {(0, 1): 2.0, (4, 5): 3.0},
                       {(0, 1): 2.0, (4, 5): 3.0}, {}, {(0, 1): 1.5}]


def test_traffic_snapshot_since_subtracts_marker():
    for R, mod in ((MetricsRegistry, FL), (JRegistry, JFL)):
        reg = R()
        mod.record_edge_traffic(None, registry=reg, pairs=[(0, 1)],
                                payload_bytes=100)
        mark = mod.traffic_snapshot(reg)
        mod.record_edge_traffic(None, registry=reg, pairs=[(0, 1)],
                                payload_bytes=40)
        mod.record_edge_traffic(None, registry=reg, pairs=[(2, 3)],
                                payload_bytes=7)
        assert mod.traffic_snapshot(reg, since=mark) == {(0, 1): 40.0,
                                                         (2, 3): 7.0}
        assert (0, 1) not in mod.traffic_snapshot(
            reg, since=mod.traffic_snapshot(reg))

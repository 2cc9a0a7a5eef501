"""The port's hierarchical (machine-level) exchange and push-sum
(bluefog_tpu_torch/parallel/collectives.py, optim/functional.py) against
the JAX package on the CPU mesh, and the train-step configurations both
packages refuse.

``machine_groups`` / ``validate_machine_decomposition`` and
``hierarchical_neighbor_allreduce`` (the exact intra-machine mean, then
the machine-level weighted exchange between counterparts; plain, int8
and bf16 on the inter-machine leg, runtime machine-level weights) run on
8 ranks; the train steps (a two-layer tanh MLP, 3 steps, SGD with
momentum 0.9) on 4 ranks as 2 machines of 2.  Inputs come from numpy
seeds.  Tolerances: 1e-5 relative plus 1e-6 absolute (f32 sums in
another order); push-sum's weight sum to 1e-5; refusals by exception
type and message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import topology as JT
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.parallel import collectives as JC
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.optim import functional as TF
from bluefog_tpu_torch.parallel import collectives as TC

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("size,local", [(8, 2), (8, 4), (4, 1), (6, 4),
                                        (8, 0)])
def test_machine_groups_match_jax(size, local):
    try:
        want = JC.machine_groups(size, local)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            TC.machine_groups(size, local)
        return
    assert TC.machine_groups(size, local) == want


def test_validate_machine_decomposition_matches_jax():
    good = [JT.uniform_topology_spec(JT.ExponentialTwoGraph(4))]
    assert TC.validate_machine_decomposition(
        8, 2, [TT.uniform_topology_spec(TT.ExponentialTwoGraph(4))]) == \
        JC.validate_machine_decomposition(8, 2, good)
    with pytest.raises(ValueError) as je:
        JC.validate_machine_decomposition(
            8, 2, [JT.uniform_topology_spec(JT.ExponentialTwoGraph(8))])
    with pytest.raises(ValueError) as te:
        TC.validate_machine_decomposition(
            8, 2, [TT.uniform_topology_spec(TT.ExponentialTwoGraph(8))])
    assert str(te.value) == str(je.value)


def _machine_spec(mod, name, m):
    if name == "exp2":
        return mod.uniform_topology_spec(mod.ExponentialTwoGraph(m))
    if name == "one_peer":
        return mod.one_peer_dynamic_schedule(m)[1]
    W = np.zeros((m, m))     # a weighted ring, no weight repeated in a row
    for r in range(m):
        W[(r - 1) % m, r], W[(r + 1) % m, r], W[r, r] = 0.3, 0.1, 0.6
    return mod.Topology.from_weight_matrix(W)


HIER = {
    "exp2_plain": ("exp2", 2, None, False),
    "exp2_int8": ("exp2", 2, "int8", False),
    "exp2_bf16": ("exp2", 2, "bf16", False),
    "one_peer_int8": ("one_peer", 2, "int8", False),
    "ring_runtime_weights": ("ring", 2, None, True),
    "two_machines_of_4": ("exp2", 4, "int8", False),
}


@pytest.mark.parametrize("case", sorted(HIER))
def test_hierarchical_neighbor_allreduce_matches_jax(case):
    name, L, compress, runtime_w = HIER[case]
    n = 8
    m = n // L
    rng = np.random.RandomState(3)
    x = rng.randn(n, 5, 3).astype(np.float32)
    jspec, tspec = _machine_spec(JT, name, m), _machine_spec(TT, name, m)
    mesh = Mesh(np.array(jax.devices()[:n]), ("bf",))
    jw = (JC.class_recv_weights(jspec), JC.self_weight_vector(jspec)) \
        if runtime_w else (None, None)

    def body(x):
        return JC.hierarchical_neighbor_allreduce(
            x[0], jspec, L, "bf", compress=compress, class_weights=jw[0],
            self_weights=jw[1])[None]

    want = np.asarray(jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=P("bf"), out_specs=P("bf"),
        check_vma=False))(jnp.asarray(x)))
    tw = (TC.class_recv_weights(tspec), TC.self_weight_vector(tspec)) \
        if runtime_w else (None, None)
    got = TC.hierarchical_neighbor_allreduce(
        torch.from_numpy(x), tspec, L, compress=compress,
        class_weights=tw[0], self_weights=tw[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # every rank of a machine ends with the machine's result
    rows = got.numpy().reshape(m, L, -1)
    np.testing.assert_array_equal(rows, np.repeat(rows[:, :1], L, axis=1))


def test_hierarchical_local_size_one_is_flat_bitwise():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(8, 11).astype(np.float32))
    for spec in (TT.uniform_topology_spec(TT.ExponentialTwoGraph(8)),
                 TT.one_peer_dynamic_schedule(8)[2]):
        for compress in (None, "int8", "bf16"):
            assert torch.equal(
                TC.hierarchical_neighbor_allreduce(x, spec, 1,
                                                   compress=compress),
                TC.neighbor_allreduce(x, spec, compress=compress))


N = 4


def _mlp():
    rng = np.random.RandomState(0)
    base = {"b1": (rng.randn(5) * 0.1).astype(np.float32),
            "b2": (rng.randn(3) * 0.1).astype(np.float32),
            "w1": (rng.randn(6, 5) * 0.5).astype(np.float32),
            "w2": (rng.randn(5, 3) * 0.5).astype(np.float32)}
    rng = np.random.RandomState(1)
    return (base, rng.randn(3, N, 3, 6).astype(np.float32),
            rng.randn(3, N, 3, 3).astype(np.float32))


def _jloss(p, batch):
    x, y = batch
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] + p["b2"] - y) ** 2)


def _tloss(p, batch):
    x, y = batch
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return ((h @ p["w2"] + p["b2"] - y) ** 2).mean()


def _steps_jax(comm_mode, kw, guarded=False):
    base, x, y = _mlp()
    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))
    opt = optax.sgd(0.1, momentum=0.9)
    step = JF.build_train_step(_jloss, opt, mesh, comm_mode=comm_mode,
                               donate=False, **kw)
    params = JF.rank_major({k: jnp.asarray(v) for k, v in base.items()},
                           mesh)
    opt_state = JF.rank_major(opt.init(base), mesh)
    if comm_mode == "push_sum":
        opt_state = (opt_state, JF.push_sum_weights(mesh))
    sh = NamedSharding(mesh, P("bf"))
    outs = []
    for s in range(3):
        batch = (jax.device_put(jnp.asarray(x[s]), sh),
                 jax.device_put(jnp.asarray(y[s]), sh))
        args = (params, opt_state, batch, jnp.int32(s))
        if guarded:
            args += (step.default_comm_weights,)
        out = step(*args)
        params, opt_state = out[0], out[1]
        outs.append(out)
    return ({k: np.asarray(v) for k, v in params.items()}, opt_state, outs,
            step)


def _steps_port(comm_mode, kw, guarded=False):
    base, x, y = _mlp()
    backend = bt.StackedBackend(N, device="cpu")
    params = TF.rank_major({k: torch.from_numpy(v) for k, v in base.items()},
                           backend)
    opt = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)
    step = bt.build_train_step(_tloss, opt, backend, comm_mode=comm_mode,
                               **kw)
    opt_state = (opt, bt.push_sum_weights(backend)) \
        if comm_mode == "push_sum" else opt
    outs = []
    for s in range(3):
        args = (params, opt_state,
                (torch.from_numpy(x[s]), torch.from_numpy(y[s])), s)
        if guarded:
            args += (step.default_comm_weights,)
        out = step(*args)
        params, opt_state = out[0], out[1]
        outs.append(out)
    return ({k: v.numpy().copy() for k, v in params.items()}, opt_state,
            outs, step)


class _Pod:
    """A duck-typed pod spec: the step reads only these two fields."""

    def __init__(self, machines, chips_per_machine):
        self.machines = machines
        self.chips_per_machine = chips_per_machine


HIER_STEPS = {
    "atc": ("atc", dict(hierarchical=2), False),
    "cta_int8": ("cta", dict(hierarchical_local_size=2, compress="int8"),
                 False),
    "pod_guard_bucketed": ("atc", dict(hierarchical="pod", overlap="bucketed",
                                       overlap_buckets=2), True),
}


@pytest.mark.parametrize("case", sorted(HIER_STEPS))
def test_hierarchical_step_matches_jax(case):
    """3 steps over 4 ranks as 2 machines of 2 (machine-level
    ExponentialTwoGraph(2)): params and losses against JAX; the guarded
    build's default weights are the machine-level tables."""
    comm_mode, kw, guarded = HIER_STEPS[case]

    def make(mod, F):
        out = dict(kw, topology=mod.uniform_topology_spec(
            mod.ExponentialTwoGraph(2)))
        if out.get("hierarchical") == "pod":
            out["hierarchical"] = _Pod(2, 2)
        if guarded:
            out["guard"] = F.GuardConfig()
        return out

    jp, _, jo, js = _steps_jax(comm_mode, make(JT, JF), guarded)
    tp, _, to, ts = _steps_port(comm_mode, make(TT, bt), guarded)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a[2].numpy(), np.asarray(b[2]),
                                   rtol=RTOL, atol=ATOL)
    assert ts.hierarchical_local_size == js.hierarchical_local_size == 2
    if guarded:
        (cw, sw), = ts.default_comm_weights
        assert cw.shape == (1, 2) and sw.shape == (2,)
    if comm_mode == "atc":   # a machine's ranks agree after the combine
        for r in range(2):
            np.testing.assert_array_equal(tp["w1"][2 * r],
                                          tp["w1"][2 * r + 1])


def test_hier_local_size_env_equals_keyword(monkeypatch):
    """BLUEFOG_HIER_LOCAL_SIZE=2 builds the same step as
    hierarchical_local_size=2, bit for bit (and as JAX's)."""
    topo = dict(topology=TT.uniform_topology_spec(TT.ExponentialTwoGraph(2)))
    kw_p, _, _, _ = _steps_port("atc", dict(topo, hierarchical_local_size=2))
    monkeypatch.setenv("BLUEFOG_HIER_LOCAL_SIZE", "2")
    env_p, _, _, step = _steps_port("atc", topo)
    assert step.hierarchical_local_size == 2
    for k in kw_p:
        np.testing.assert_array_equal(env_p[k], kw_p[k])
    jp, _, _, _ = _steps_jax("atc", dict(topology=JT.uniform_topology_spec(
        JT.ExponentialTwoGraph(2))))
    for k in jp:
        np.testing.assert_allclose(env_p[k], jp[k], rtol=RTOL, atol=ATOL)


def _digraph(mod):
    """A directed graph whose columns are not uniform: 0->1, 1->2, 2->3,
    3->0, 0->2, with a declared zero-weight edge 3->1 that push-sum must
    not count."""
    edges = {(0, 1): 0.5, (1, 2): 0.5, (2, 3): 0.5, (3, 0): 0.5,
             (0, 2): 0.25, (3, 1): 0.0}
    return mod.DynamicTopology.from_edges(N, edges)


@pytest.mark.parametrize("graph", ["exp2", "digraph"])
def test_push_sum_mix_matches_jax(graph):
    rng = np.random.RandomState(5)
    x = rng.randn(N, 7).astype(np.float32)
    ps = (1.0 + 0.1 * rng.rand(N)).astype(np.float32)

    def spec(mod):
        return (mod.uniform_topology_spec(mod.ExponentialTwoGraph(N))
                if graph == "exp2" else _digraph(mod))

    deg_t, perms_t = TC.push_sum_structure(spec(TT))
    deg_j, perms_j = JC.push_sum_structure(spec(JT))
    np.testing.assert_array_equal(deg_t, deg_j)
    assert perms_t == perms_j
    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))

    def body(x, ps):
        m, mp = JC.push_sum_mix([x[0]], ps[0], spec(JT), "bf")
        return m[0][None], mp[None]

    jm, jps = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("bf"), P("bf")),
        out_specs=(P("bf"), P("bf")), check_vma=False))(
            jnp.asarray(x), jnp.asarray(ps))
    tm, tps = TC.push_sum_mix([torch.from_numpy(x)], torch.from_numpy(ps),
                              spec(TT))
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tps.numpy(), np.asarray(jps), rtol=RTOL,
                               atol=ATOL)


def test_push_sum_keeps_weight_sum_over_rounds():
    """Column-stochastic mixing keeps sum(ps) == n (to 1e-5) over 50
    rounds of the directed graph, while the weights themselves spread."""
    ps = torch.ones(N)
    x = [torch.from_numpy(np.random.RandomState(6).randn(N, 3)
                          .astype(np.float32))]
    spec = _digraph(TT)
    for _ in range(50):
        x, ps = TC.push_sum_mix(x, ps, spec)
        assert abs(float(ps.sum()) - N) <= 1e-5
    assert float(ps.max() - ps.min()) > 0.1


PUSH_SUM = {
    "plain": dict(topology="exp2"),
    "digraph_health": dict(topology="digraph", health=True),
    "bucketed": dict(topology="exp2", overlap="bucketed", overlap_buckets=2),
    "one_peer_every_2": dict(schedule="one_peer",
                             num_steps_per_communication=2),
}


@pytest.mark.parametrize("case", sorted(PUSH_SUM))
def test_push_sum_step_matches_jax(case):
    """comm_mode="push_sum", opt_state (optimizer, ps weights): 3 steps
    of params, losses, ps weights (and HealthVector) against JAX; the ps
    weights sum to 4."""
    spec_kw = PUSH_SUM[case]

    def make(mod, F):
        out = dict(spec_kw)
        if out.get("topology") == "exp2":
            out["topology"] = mod.uniform_topology_spec(
                mod.ExponentialTwoGraph(N))
        elif out.get("topology") == "digraph":
            out["topology"] = _digraph(mod)
        if "schedule" in out:
            out["schedule"] = mod.one_peer_dynamic_schedule(N)
        if out.pop("health", False):
            out["health"] = F.HealthConfig()
        return out

    jp, jo, jouts, _ = _steps_jax("push_sum", make(JT, JF))
    tp, to, touts, _ = _steps_port("push_sum", make(TT, bt))
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), rtol=RTOL,
                               atol=ATOL)
    assert abs(float(to[1].sum()) - N) <= 1e-5
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a[2].numpy(), np.asarray(b[2]),
                                   rtol=RTOL, atol=ATOL)
        if len(b) > 3:
            for f in ("loss", "grad_norm", "skipped", "consensus"):
                np.testing.assert_allclose(
                    getattr(a[3], f).numpy(), np.asarray(getattr(b[3], f)),
                    rtol=RTOL, atol=ATOL, err_msg=f)


def _refusal(mod, F, case):
    exp2 = mod.uniform_topology_spec(mod.ExponentialTwoGraph(N))
    return {
        "push_sum_guard": dict(comm_mode="push_sum", topology=exp2,
                               guard=F.GuardConfig()),
        "push_sum_hierarchical": dict(comm_mode="push_sum", topology=exp2,
                                      hierarchical_local_size=2),
        "bucketed_gradient_allreduce": dict(comm_mode="gradient_allreduce",
                                            overlap="bucketed"),
        "bucketed_none": dict(comm_mode="none", overlap="bucketed"),
        "zero_buckets": dict(comm_mode="atc", topology=exp2,
                             overlap="bucketed", overlap_buckets=0),
        "hierarchical_conflict": dict(comm_mode="atc", topology=exp2,
                                      hierarchical=2,
                                      hierarchical_local_size=1),
        "machine_spec_of_ranks": dict(comm_mode="cta", topology=exp2,
                                      hierarchical=2),
        "topk_gradient_allreduce": dict(comm_mode="gradient_allreduce",
                                        compress="topk"),
        "mix_values": dict(comm_mode="atc", topology=exp2,
                           compress=F.MixCompressConfig(values="int4")),
        "mix_ratio_zero": dict(comm_mode="atc", topology=exp2,
                               compress=F.MixCompressConfig(ratio=0.0)),
        "int8_sr_none": dict(comm_mode="none", compress="int8_sr"),
        "no_topology": dict(comm_mode="push_sum"),
        "unfused_topk": dict(comm_mode="atc", topology=exp2,
                             compress="topk", env="0"),
        "unfused_push_sum_bucketed": dict(comm_mode="push_sum",
                                          topology=exp2, overlap="bucketed",
                                          env="0"),
    }[case]


@pytest.mark.parametrize("case", [
    "push_sum_guard", "push_sum_hierarchical", "bucketed_gradient_allreduce",
    "bucketed_none", "zero_buckets", "hierarchical_conflict",
    "machine_spec_of_ranks", "topk_gradient_allreduce", "mix_values",
    "mix_ratio_zero", "int8_sr_none", "no_topology", "unfused_topk",
    "unfused_push_sum_bucketed"])
def test_refuses_what_jax_refuses(case, monkeypatch):
    """Each configuration the JAX builder refuses, the port refuses with
    the same exception type and message."""
    jkw, tkw = _refusal(JT, JF, case), _refusal(TT, bt, case)
    env = jkw.pop("env", None)
    tkw.pop("env", None)
    if env is not None:
        monkeypatch.setenv("BLUEFOG_FUSE_EPILOGUES", env)
    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))
    with pytest.raises(Exception) as je:
        JF.build_train_step(_jloss, optax.sgd(0.1), mesh, **jkw)
    backend = bt.StackedBackend(N, device="cpu")
    params = TF.rank_major({"w": torch.ones(3)}, backend)
    with pytest.raises(Exception) as te:
        bt.build_train_step(_tloss, torch.optim.SGD(params.values(), lr=0.1),
                            backend, **tkw)
    assert type(te.value) is type(je.value)
    assert str(te.value) == str(je.value)


def test_refuses_a_pod_that_does_not_cover_the_ranks():
    """A duck-typed pod of 3 machines x 2 chips on 4 ranks: refused by
    both packages (the JAX message names its mesh axis)."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))
    machine = TT.uniform_topology_spec(TT.ExponentialTwoGraph(2))
    with pytest.raises(ValueError, match="3 machines x 2 chips"):
        JF.build_train_step(_jloss, optax.sgd(0.1), mesh, comm_mode="atc",
                            topology=JT.uniform_topology_spec(
                                JT.ExponentialTwoGraph(2)),
                            hierarchical=_Pod(3, 2))
    backend = bt.StackedBackend(N, device="cpu")
    params = TF.rank_major({"w": torch.ones(3)}, backend)
    with pytest.raises(ValueError, match="3 machines x 2 chips does not "
                       "cover the 4-rank"):
        bt.build_train_step(_tloss, torch.optim.SGD(params.values(), lr=0.1),
                            backend, comm_mode="atc", topology=machine,
                            hierarchical=_Pod(3, 2))

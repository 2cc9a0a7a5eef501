"""The port's expert-sharded MoE (bluefog_tpu_torch/moe/ and
``build_train_step(moe=MoEConfig(...))``) against the JAX package's
(tests/test_moe_dispatch.py) on 8 ranks: ``StackedBackend(8)`` on the
CPU against JAX's 8 virtual CPU devices under ``shard_map``.

* The compiled dispatch over ``compile_all_to_all(PodSpec(4, 2))``: the
  plan equals JAX's; the dispatch is bit-equal to JAX's and to
  ``lax.all_to_all``, the transpose round trip is the identity, and the
  int8 wire equals JAX's bit for bit.
* Route tables, heals, capacity masks and ``default_capacity`` (with
  its knob) byte-equal to JAX's; the no-survivor heal raises; a heal
  records its decision in the flight recorder.
* ``moe_apply``'s keep mask equals JAX's, its output within 1e-6.
* The kill -> heal -> return cycle through the step within 1e-6 of
  JAX's (f32 products summed in another order), experts local, the
  router mixed; guard and health compose; top-k mixing covers only the
  shared leaves; the refusals are JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import config as jconfig
from bluefog_tpu import moe as jmoe
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.topology import compiler as jcomp
from bluefog_tpu.topology import torus as jtorus
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import config as tconfig
from bluefog_tpu_torch import moe as tmoe
from bluefog_tpu_torch.optim import functional as TF
from bluefog_tpu_torch.topology import compiler as tcomp
from bluefog_tpu_torch.topology import torus as ttorus

pytestmark = pytest.mark.moe

N = 8


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:N]), ("bf",))


@pytest.fixture(scope="module")
def plans():
    j = jmoe.dispatch_plan(jcomp.compile_all_to_all(
        jcomp.PodSpec(4, 2, dcn_cost=4.0)).schedule)
    t = tmoe.dispatch_plan(tcomp.compile_all_to_all(
        tcomp.PodSpec(4, 2, dcn_cost=4.0)).schedule)
    return j, t


@pytest.fixture(scope="module")
def backend():
    return bt.StackedBackend(N, device="cpu")


def _shards(seed=0, c=3, d=4):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, N, c, d)).astype(np.float32)


def _jax_run(mesh, fn, *xs):
    sm = jax.shard_map(lambda *v: fn(*[a[0] for a in v])[None], mesh=mesh,
                       in_specs=(P("bf"),) * len(xs), out_specs=P("bf"),
                       check_vma=False)
    return np.asarray(jax.jit(sm)(*xs))


def test_plan_equals_jax(plans):
    j, t = plans
    assert t.n == j.n and t.rounds == j.rounds
    assert t.transpose().rounds == j.transpose().rounds
    assert t.permutes_per_period == j.permutes_per_period
    with pytest.raises(ValueError):
        tmoe.dispatch_plan([])


def test_dispatch_bit_equal_to_jax_and_all_to_all(mesh, plans, backend):
    j, t = plans
    x = _shards()
    want = _jax_run(mesh, lambda v: jmoe.all_to_all_dispatch(v, j, "bf"),
                    x)
    naive = _jax_run(mesh, lambda v: jmoe.naive_all_to_all(v, "bf"), x)
    got = tmoe.all_to_all_dispatch(torch.from_numpy(x), t, backend)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), naive)
    np.testing.assert_array_equal(
        tmoe.naive_all_to_all(torch.from_numpy(x), backend).numpy(), naive)
    back = tmoe.all_to_all_dispatch(got, t.transpose(), backend)
    np.testing.assert_array_equal(back.numpy(), x)


def test_int8_wire_equals_jax(mesh, plans, backend):
    j, t = plans
    x = _shards(seed=5)
    want = _jax_run(mesh, lambda v: jmoe.all_to_all_dispatch(
        v, j, "bf", wire_dtype="int8"), x)
    a = tmoe.all_to_all_dispatch(torch.from_numpy(x), t, backend,
                                 wire_dtype="int8")
    b = tmoe.all_to_all_dispatch(torch.from_numpy(x), t, backend,
                                 wire_dtype="int8")
    np.testing.assert_array_equal(a.numpy(), want)
    assert torch.equal(a, b)
    ref = np.swapaxes(x, 0, 1)
    assert np.abs(a.numpy() - ref).max() / np.abs(ref).max() < 0.02
    with pytest.raises(ValueError, match="wire_dtype"):
        tmoe.all_to_all_dispatch(torch.from_numpy(x), t, backend,
                                 wire_dtype="fp8")


def test_route_tables_heal_and_capacity_equal_jax(monkeypatch):
    for e in (1, 4, 8):
        np.testing.assert_array_equal(tmoe.default_route_table(N, e),
                                      jmoe.default_route_table(N, e))
    for bad in (0, N + 1):
        with pytest.raises(ValueError):
            tmoe.default_route_table(N, bad)
    route = tmoe.default_route_table(N, 4)
    for dead_ranks in ([5], [2, 7], [0, 3]):
        dead = np.zeros(N, bool)
        dead[dead_ranks] = True
        got = tmoe.heal_route_table(route, dead, 4)
        want = jmoe.heal_route_table(route, dead, 4)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert tmoe.capacity_mask_of(dead).tobytes() == \
            jmoe.capacity_mask_of(dead).tobytes()
    dead = np.zeros(N, bool)
    dead[[1, 5]] = True
    with pytest.raises(ValueError, match="expert 1 has no surviving"):
        tmoe.heal_route_table(route, dead, 4)
    assert [tmoe.expert_owner(r, 4) for r in range(N)] == \
        [jmoe.expert_owner(r, 4) for r in range(N)]
    for toks in (1, 8, 2048):
        assert tmoe.default_capacity(toks, N) == \
            jmoe.default_capacity(toks, N)
    for value in ("2.0", "-1", "nope"):
        monkeypatch.setenv("BLUEFOG_MOE_CAPACITY_FACTOR", value)
        assert tconfig.moe_capacity_factor() == \
            jconfig.moe_capacity_factor()
        assert tmoe.default_capacity(8, N) == jmoe.default_capacity(8, N)
    with pytest.raises(ValueError):
        tmoe.default_capacity(8, N, factor=0.0)


def test_heal_records_its_decision(monkeypatch):
    from bluefog_tpu_torch.observe import blackbox

    box = blackbox.BlackBox()
    monkeypatch.setattr(blackbox, "get_blackbox", lambda: box)
    monkeypatch.setenv("BLUEFOG_BLACKBOX", "1")
    dead = np.zeros(N, bool)
    dead[5] = True
    tmoe.heal_route_table(tmoe.default_route_table(N, 4), dead, 4)
    (ev,) = box.events()
    assert (ev.plane, ev.kind) == ("moe", "replan")
    assert ev.telemetry["dead"] == [5]


def _jax_params(d=4, h=4, e=4):
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    per_rank = [jmoe.init_moe_params(k, d, h, e) for k in keys]
    params = jax.tree.map(lambda *xs: np.asarray(jnp.stack(xs)), *per_rank)
    # shared leaves start at consensus, experts rank-diverse
    params["router"]["w"] = np.broadcast_to(
        params["router"]["w"][:1], (N, d, e)).copy()
    return params


def _port_params(jp):
    return {"expert.wi": torch.from_numpy(jp["expert"]["wi"].copy()),
            "expert.wo": torch.from_numpy(jp["expert"]["wo"].copy()),
            "router.w": torch.from_numpy(jp["router"]["w"].copy())}


def _batch_np(route, cmask, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.normal(size=(N, 6, 4)).astype(np.float32)
    return (tokens, np.asarray(route, np.int32),
            np.broadcast_to(cmask[None], (N, N)).copy())


def test_moe_apply_equals_jax(mesh, plans, backend):
    j, t = plans
    jp = _jax_params()
    route = tmoe.default_route_table(N, 4)
    dead = np.zeros(N, bool)
    dead[2] = True
    tokens, rt, cm = _batch_np(tmoe.heal_route_table(route, dead, 4),
                               tmoe.capacity_mask_of(dead), seed=11)
    for wire in (None, "int8"):
        def run(p, tok, r, c):
            out, keep = jmoe.moe_apply(p, tok, r, c, plan=j,
                                       axis_name="bf", capacity=2,
                                       wire_dtype=wire)
            return out, keep
        sm = jax.shard_map(
            lambda p, a, b, c: jax.tree.map(
                lambda v: v[None], run(jax.tree.map(lambda l: l[0], p),
                                       a[0], b[0], c[0])),
            mesh=mesh, in_specs=(P("bf"),) * 4, out_specs=P("bf"),
            check_vma=False)
        j_out, j_keep = jax.jit(sm)(jp, tokens, rt, cm)
        out, keep = tmoe.moe_apply(
            _port_params(jp), torch.from_numpy(tokens),
            torch.from_numpy(rt), torch.from_numpy(cm), plan=t,
            backend=backend, capacity=2, wire_dtype=wire)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
        assert not keep.all()   # capacity 2 of 6 tokens: overflow drops
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                   rtol=0, atol=1e-6)


# ------------------------------------------------------------------ #
# the expert-sharded train step: kill -> heal -> return
# ------------------------------------------------------------------ #
LR = 1e-2


def _sched(mod):
    return mod.torus_one_peer_schedule((4, 2), "exp2")


def _cycle_batches(route):
    dead = np.zeros(N, bool)
    dead[5] = True
    live = tmoe.capacity_mask_of(np.zeros(N))
    return [_batch_np(route, live, 0),
            _batch_np(tmoe.heal_route_table(route, dead, 4),
                      tmoe.capacity_mask_of(dead), 1),
            _batch_np(route, live, 2)]


def _run_jax_cycle(mesh, plan, comm_mode, **kw):
    opt = optax.sgd(LR)
    step = JF.build_train_step(
        jmoe.make_moe_loss(plan, "bf", 3), opt, mesh, comm_mode=comm_mode,
        schedule=_sched(jtorus), moe=JF.MoEConfig(n_experts=4, capacity=3),
        **kw)
    sh = NamedSharding(mesh, P("bf"))
    put = lambda t: jax.tree.map(  # noqa: E731
        lambda x: jax.device_put(jnp.asarray(x), sh), t)
    jp = _jax_params()
    p = put(jp)
    o = put(jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[opt.init(jax.tree.map(lambda l: l[r], jp))
                           for r in range(N)]))
    extra = (step.default_comm_weights,) if "guard" in kw else ()
    losses = []
    for s, b in enumerate(_cycle_batches(tmoe.default_route_table(N, 4))):
        out = step(p, o, put(b), jnp.int32(s), *extra)
        p, o, loss = out[:3]
        losses.append(np.asarray(loss))
    return jax.tree.map(np.asarray, p), np.stack(losses), out


def _run_port_cycle(backend, plan, comm_mode, **kw):
    params = _port_params(_jax_params())
    opt = torch.optim.SGD(params.values(), lr=LR)
    step = bt.build_train_step(
        tmoe.make_moe_loss(plan, backend, 3), opt, backend,
        comm_mode=comm_mode, schedule=_sched(ttorus),
        moe=bt.MoEConfig(n_experts=4, capacity=3), **kw)
    extra = (step.default_comm_weights,) if "guard" in kw else ()
    losses = []
    for s, b in enumerate(_cycle_batches(tmoe.default_route_table(N, 4))):
        out = step(params, opt, tuple(torch.from_numpy(v) for v in b), s,
                   *extra)
        losses.append(out[2].numpy().copy())
    return step, params, np.stack(losses), out


@pytest.mark.parametrize("comm_mode", ["cta", "atc"])
def test_kill_heal_cycle_equals_jax(mesh, plans, backend, comm_mode):
    j, t = plans
    jp, j_loss, _ = _run_jax_cycle(mesh, j, comm_mode)
    step, tp, t_loss, _ = _run_port_cycle(backend, t, comm_mode)
    assert step.moe_config.n_experts == 4
    np.testing.assert_allclose(t_loss, j_loss, rtol=0, atol=1e-6)
    for k, want in _port_params(jp).items():
        np.testing.assert_allclose(tp[k].numpy(), want.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    wi = tp["expert.wi"].numpy()
    assert not np.allclose(wi[0], wi[1])       # experts stayed local
    rw = tp["router.w"].numpy()
    assert np.abs(rw - rw.mean(0)).max() < np.abs(wi - wi.mean(0)).max()


def test_moe_composes_with_guard_and_health(mesh, plans, backend):
    j, t = plans
    kw = dict(guard=bt.GuardConfig(), health=bt.HealthConfig())
    jp, j_loss, j_out = _run_jax_cycle(
        mesh, j, "atc", guard=JF.GuardConfig(), health=JF.HealthConfig())
    _, tp, t_loss, t_out = _run_port_cycle(backend, t, "atc", **kw)
    hv = t_out[-1]
    assert isinstance(hv, TF.HealthVector)
    np.testing.assert_array_equal(t_out[3].numpy(),
                                  np.asarray(j_out[3]))   # skipped
    for f in ("loss", "grad_norm", "update_norm", "consensus"):
        np.testing.assert_allclose(getattr(hv, f).numpy(),
                                   np.asarray(getattr(j_out[-1], f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    for k, want in _port_params(jp).items():
        np.testing.assert_allclose(tp[k].numpy(), want.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_topk_mix_covers_only_shared_leaves(backend, plans):
    _, t = plans
    params = _port_params(_jax_params())
    opt = torch.optim.SGD(params.values(), lr=LR)
    step = bt.build_train_step(
        tmoe.make_moe_loss(t, backend, 3), opt, backend, comm_mode="cta",
        schedule=_sched(ttorus), compress=bt.MixCompressConfig(ratio=0.5),
        moe=bt.MoEConfig(n_experts=4, capacity=3))
    layout = step.mix_wire_layout(params)
    assert len(layout) == 1 and layout[0]["numel"] == 4 * 4  # the router
    ms = step.init_mix_state(params)
    assert [e.shape for e in ms.err] == [(N, 16)]
    state = (opt, ms)
    for s, b in enumerate(_cycle_batches(tmoe.default_route_table(N, 4))):
        params, state, loss = step(
            params, state, tuple(torch.from_numpy(v) for v in b), s)
        assert torch.isfinite(loss).all()
    wi = params["expert.wi"]
    assert not torch.allclose(wi[0], wi[1])


def test_edge_account_bills_only_shared_leaves(backend, plans):
    from bluefog_tpu_torch import observe

    _, t = plans
    params = _port_params(_jax_params())
    opt = torch.optim.SGD(params.values(), lr=LR)
    step = bt.build_train_step(
        tmoe.make_moe_loss(t, backend, 3), opt, backend, comm_mode="atc",
        schedule=_sched(ttorus), moe=bt.MoEConfig(n_experts=4, capacity=3))
    reg = observe.get_registry()

    def billed():
        return sum(r["value"]
                   for r in reg.snapshot().get("bf_edge_bytes_total", []))

    before = billed()
    b = _cycle_batches(tmoe.default_route_table(N, 4))[0]
    step(params, opt, tuple(torch.from_numpy(v) for v in b), 0)
    edges = len(_sched(ttorus)[0].edges)
    assert billed() - before == edges * 4 * 4 * 4   # router f32 bytes


def test_refusals_equal_jax(monkeypatch, backend, plans):
    _, t = plans
    with pytest.raises(ValueError):
        bt.MoEConfig(n_experts=0, capacity=1)
    with pytest.raises(ValueError):
        bt.MoEConfig(n_experts=4, capacity=0)
    with pytest.raises(ValueError):
        bt.MoEConfig(n_experts=4, capacity=3, expert_path_tokens=())
    params = _port_params(_jax_params())
    opt = torch.optim.SGD(params.values(), lr=LR)
    loss_fn = tmoe.make_moe_loss(t, backend, 3)
    moe = bt.MoEConfig(n_experts=4, capacity=3)
    for mode in ("gradient_allreduce", "push_sum"):
        with pytest.raises(ValueError, match="moe"):
            bt.build_train_step(loss_fn, opt, backend, comm_mode=mode,
                                schedule=_sched(ttorus), moe=moe)
    monkeypatch.setenv("BLUEFOG_FUSE_EPILOGUES", "0")
    with pytest.raises(ValueError, match="fused epilogue"):
        bt.build_train_step(loss_fn, opt, backend, comm_mode="cta",
                            schedule=_sched(ttorus), moe=moe)
    monkeypatch.delenv("BLUEFOG_FUSE_EPILOGUES")
    experts = {k: v for k, v in params.items() if k.startswith("expert")}
    opt2 = torch.optim.SGD(experts.values(), lr=LR)

    def only_experts(p, batch):
        return loss_fn(dict(p, **{"router.w": torch.zeros(N, 4, 4)}), batch)

    step = bt.build_train_step(only_experts, opt2, backend,
                               comm_mode="cta", schedule=_sched(ttorus),
                               moe=moe)
    b = _cycle_batches(tmoe.default_route_table(N, 4))[0]
    with pytest.raises(ValueError, match="EVERY param leaf"):
        step(experts, opt2, tuple(torch.from_numpy(v) for v in b), 0)


def test_init_moe_params_shapes_and_device():
    g = torch.Generator().manual_seed(0)
    one = tmoe.init_moe_params(g, 8, 16, 4, device="cpu")
    assert {k: tuple(v.shape) for k, v in one.items()} == {
        "expert.wi": (8, 16), "expert.wo": (16, 8), "router.w": (8, 4)}
    stacked = tmoe.init_moe_params(g, 8, 16, 4, n_ranks=3, device="cpu")
    assert stacked["expert.wi"].shape == (3, 8, 16)
    assert not torch.equal(stacked["expert.wi"][0], stacked["expert.wi"][1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmoe.init_moe_params(g, 8, 16, 4)

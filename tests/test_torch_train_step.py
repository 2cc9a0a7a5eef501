"""The port's ``build_train_step`` (bluefog_tpu_torch/optim/functional.py,
stacked backend) against the JAX package's on a 4-device CPU mesh: a one-block f32
Bottleneck ResNet (``pallas_conv1x1=True``: the block's expansion and
projection run K1's plain version on the CPU) with train-mode batch norm, SGD(0.1, momentum 0.9) on both sides
(``optax.sgd`` / ``torch.optim.SGD(dampening=0)``), the same initial
parameters (``resnet_params_from_flax``) and per-rank batches, 3 steps.
Params, batch statistics, momentum and per-rank losses are compared after
the 3 steps, for comm modes none / atc / cta / gradient_allreduce, a
one-peer ``schedule=``, ``num_steps_per_communication=2`` and the bf16
and int8 wires.

Tolerance: 5e-4 of each leaf's largest entry plus 5e-7 (losses 1e-5):
the f32 convolutions and reductions sum in another order on the two
sides (~1e-6 on the losses and params), three SGD steps with momentum
carry that forward, and gradients through train-mode batch norm cancel
(each BN removes its channel means), so the small gradient leaves
carry f32 noise of ~1e-7 absolute and ~1.2e-4 of the leaf (measured on
the momentum of the first convolution)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import topology as JT
from bluefog_tpu.models import resnet as JR
from bluefog_tpu.optim import functional as JF
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.interop import resnet_params_from_flax
from bluefog_tpu_torch.models import resnet as TR
from bluefog_tpu_torch.optim import functional as TF

N, B, HW, STEPS = 4, 2, 16, 3


def _setup():
    jm = JR.ResNet(stage_sizes=(1,), block_cls=JR.BottleneckBlock,
                   num_classes=10, num_filters=4, dtype=jnp.float32,
                   pallas_conv1x1=True)
    tm = bt.ResNet(stage_sizes=(1,), block_cls=TR.BottleneckBlock,
                   num_classes=10, num_filters=4, dtype=torch.float32,
                   pallas_conv1x1=True, device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(N, B, HW, HW, 3).astype(np.float32)
    y = rng.randint(0, 10, (N, B)).astype(np.int32)
    v = jax.tree.map(np.asarray,
                     jm.init(jax.random.PRNGKey(0), jnp.asarray(x[0])))
    return jm, tm, x, y, v


def _specs(kw, mod):
    out = dict(kw)
    if out.get("topology") == "exp2":
        out["topology"] = mod.uniform_topology_spec(
            mod.ExponentialTwoGraph(N))
    if out.get("schedule") == "one_peer":
        out["schedule"] = mod.one_peer_dynamic_schedule(N)
    return out


def _run_jax(jm, x, y, v, comm_mode, kw):
    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))

    def loss_fn(params, aux, batch):
        images, labels = batch
        logits, upd = jm.apply({"params": params, "batch_stats": aux},
                               images, train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return jnp.mean(ce), upd["batch_stats"]

    opt = optax.sgd(0.1, momentum=0.9)
    step = JF.build_train_step(loss_fn, opt, mesh, comm_mode=comm_mode,
                               has_aux=True, **_specs(kw, JT))
    params = JF.rank_major(v["params"], mesh)
    aux = JF.rank_major(v["batch_stats"], mesh)
    opt_state = JF.rank_major(opt.init(v["params"]), mesh)
    sh = NamedSharding(mesh, P("bf"))
    batch = (jax.device_put(jnp.asarray(x), sh),
             jax.device_put(jnp.asarray(y), sh))
    losses = []
    for s in range(STEPS):
        params, aux, opt_state, loss = step(params, aux, opt_state, batch,
                                            jnp.int32(s))
        losses.append(np.asarray(loss))
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, aux),
            jax.tree.map(np.asarray, opt_state[0].trace), np.stack(losses))


def _run_port(tm, x, y, v, comm_mode, kw):
    backend = bt.StackedBackend(N, device="cpu")
    p0, a0 = resnet_params_from_flax(v, tm, device="cpu")
    params, aux = TF.rank_major(p0, backend), TF.rank_major(a0, backend)
    opt = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)

    def loss_fn(p, a, batch):
        images, labels = batch
        logits, new = tm.apply(p, a, images, train=True)
        return F.cross_entropy(logits, labels), new

    step = bt.build_train_step(loss_fn, opt, backend, comm_mode=comm_mode,
                               has_aux=True, **_specs(kw, TT))
    batch = (torch.from_numpy(x), torch.from_numpy(y).long())
    losses = []
    for s in range(STEPS):
        params, aux, opt, loss = step(params, aux, opt, batch, s)
        assert loss.shape == (N,) and loss.dtype == torch.float32
        losses.append(loss.numpy().copy())
    mom = {k: opt.state[p]["momentum_buffer"] for k, p in params.items()}
    return params, aux, mom, np.stack(losses)


def _close(got, want, what):
    for k in want:
        w = want[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=5e-4 * scale + 5e-7,
                                   err_msg=f"{what} {k}")


CONFIGS = {
    "none": ("none", {}),
    "atc": ("atc", {"topology": "exp2"}),
    "cta": ("cta", {"topology": "exp2"}),
    "gradient_allreduce": ("gradient_allreduce", {}),
    "atc_one_peer_schedule": ("atc", {"schedule": "one_peer"}),
    "cta_one_peer_schedule": ("cta", {"schedule": "one_peer"}),
    "cta_every_2": ("cta", {"topology": "exp2",
                            "num_steps_per_communication": 2}),
    "atc_every_2": ("atc", {"schedule": "one_peer",
                            "num_steps_per_communication": 2}),
    "atc_bf16_wire": ("atc", {"topology": "exp2", "compress": "bf16"}),
    "atc_int8_wire": ("atc", {"topology": "exp2", "compress": "int8"}),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_three_steps_match_jax(config):
    comm_mode, kw = CONFIGS[config]
    jm, tm, x, y, v = _setup()
    jp, ja, jmom, jl = _run_jax(jm, x, y, v, comm_mode, kw)
    tp, ta, tmom, tl = _run_port(tm, x, y, v, comm_mode, kw)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    for r in range(N):
        pick = lambda t: jax.tree.map(lambda a: a[r], t)  # noqa: E731
        wp, wa = resnet_params_from_flax(
            {"params": pick(jp), "batch_stats": pick(ja)}, tm, device="cpu")
        wm, _ = resnet_params_from_flax(
            {"params": pick(jmom), "batch_stats": pick(ja)}, tm,
            device="cpu")
        _close({k: t[r] for k, t in tp.items()}, wp, f"rank {r} param")
        _close({k: t[r] for k, t in ta.items()}, wa, f"rank {r} stat")
        _close({k: t[r] for k, t in tmom.items()}, wm, f"rank {r} momentum")
    spread = float(TF.consensus_distance(tp))
    if comm_mode == "gradient_allreduce":   # every rank took one update
        assert spread == 0.0
    else:                                   # the ranks saw different data
        assert spread > 0.0


def test_consensus_distance_matches_jax():
    rng = np.random.RandomState(5)
    tree = {"a": rng.randn(N, 3, 4).astype(np.float32),
            "b": rng.randn(N, 7).astype(np.float32)}
    want = float(JF.consensus_distance({k: jnp.asarray(v)
                                        for k, v in tree.items()}))
    got = TF.consensus_distance({k: torch.from_numpy(v)
                                 for k, v in tree.items()})
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)


def _tiny_step(**kw):
    backend = bt.StackedBackend(N, device="cpu")
    params = TF.rank_major({"w": torch.ones(3)}, backend)
    opt = kw.pop("opt", None) or torch.optim.SGD(params.values(), lr=0.1)

    def loss_fn(p, batch):
        return ((p["w"] - batch) ** 2).sum()

    return params, opt, bt.build_train_step(loss_fn, opt, backend, **kw)


def test_no_aux_step_and_adam():
    params, opt, step = _tiny_step(comm_mode="atc", topology=TT.
                                   uniform_topology_spec(
                                       TT.ExponentialTwoGraph(N)))
    batch = torch.arange(N, dtype=torch.float32)[:, None].expand(N, 3)
    params, opt, loss = step(params, opt, batch, 0)
    assert loss.shape == (N,)
    backend = bt.StackedBackend(N, device="cpu")
    p2 = TF.rank_major({"w": torch.ones(3)}, backend)
    adam = torch.optim.Adam(p2.values(), lr=0.1)
    step2 = bt.build_train_step(lambda p, b: ((p["w"] - b) ** 2).sum(),
                                adam, backend, comm_mode="none")
    step2(p2, adam, batch, 0)
    assert not torch.equal(p2["w"][0], p2["w"][3])
    with pytest.raises(ValueError, match="opt_state"):
        step(params, torch.optim.SGD(params.values(), lr=0.1), batch, 1)


@pytest.mark.parametrize("kw,item", [
    (dict(moe=bt.MoEConfig(4, 2), sp_axis=bt.SeqAxis("sp", 2)),
     "item 10"),
    (dict(opt_state_specs={}), "item 10"),
    (dict(pp_axis="pp"), "item 10"),
    (dict(param_specs={}), "item 10"),
])
def test_unported_features_raise(kw, item):
    kw.setdefault("comm_mode", "atc")
    kw.setdefault("topology", TT.uniform_topology_spec(
        TT.ExponentialTwoGraph(N)))
    with pytest.raises(NotImplementedError, match=item):
        _tiny_step(**kw)


def _knob_run(env_monkeypatch, env, value, **kw):
    """Params after 2 steps of the tiny problem, and the step, with
    ``env=value`` set (or not) and the builder keywords ``kw``."""
    if env is not None:
        env_monkeypatch.setenv(env, value)
    params, opt, step = _tiny_step(**kw)
    if env is not None:
        env_monkeypatch.delenv(env)
    state = (opt, step.init_mix_state(params)) if step.mix_config else opt
    batch = torch.arange(N * 3, dtype=torch.float32).reshape(N, 3)
    for s in range(2):
        params, state, _ = step(params, state, batch, s)
    return params, step


@pytest.mark.parametrize("env,value", [
    ("BLUEFOG_FUSE_EPILOGUES", "0"), ("BLUEFOG_HIER_LOCAL_SIZE", "2"),
    ("BLUEFOG_MIX_COMPRESS", "topk")])
def test_unported_env_knobs_raise(monkeypatch, env, value):
    """The three knobs the port once refused now take effect, each equal
    to the builder keyword it stands for: BLUEFOG_HIER_LOCAL_SIZE=2 is
    hierarchical_local_size=2 (over a machine-level topology),
    BLUEFOG_MIX_COMPRESS=topk is compress="topk", and
    BLUEFOG_FUSE_EPILOGUES=0 (no keyword) selects the pre-fusion order,
    which gives the plain step's params and refuses top-k mixing as
    the JAX package does."""
    if env == "BLUEFOG_HIER_LOCAL_SIZE":
        topo = TT.uniform_topology_spec(TT.ExponentialTwoGraph(N // 2))
        got, step = _knob_run(monkeypatch, env, value, comm_mode="atc",
                              topology=topo)
        want, _ = _knob_run(monkeypatch, None, None, comm_mode="atc",
                            topology=topo, hierarchical_local_size=2)
        assert step.hierarchical_local_size == 2
    else:
        topo = TT.uniform_topology_spec(TT.ExponentialTwoGraph(N))
        got, step = _knob_run(monkeypatch, env, value, comm_mode="atc",
                              topology=topo)
        want, ref = _knob_run(
            monkeypatch, None, None, comm_mode="atc", topology=topo,
            **({"compress": "topk"} if value == "topk" else {}))
        assert step.mix_config == ref.mix_config
        if env == "BLUEFOG_FUSE_EPILOGUES":
            monkeypatch.setenv(env, value)
            with pytest.raises(ValueError, match="BLUEFOG_FUSE_EPILOGUES"):
                _tiny_step(comm_mode="atc", topology=topo, compress="topk")
    assert torch.equal(got["w"], want["w"])


def test_refuses_rank_mixing_optimizers_and_bad_config():
    backend = bt.StackedBackend(N, device="cpu")
    params = TF.rank_major({"w": torch.ones(3)}, backend)
    for opt in (torch.optim.Adagrad(params.values()),
                torch.optim.LBFGS(params.values())):
        with pytest.raises(TypeError, match="element-wise"):
            bt.build_train_step(lambda p, b: p["w"].sum(), opt, backend,
                                comm_mode="none")
    opt = torch.optim.SGD(params.values(), lr=0.1)
    with pytest.raises(ValueError, match="exactly one"):
        bt.build_train_step(lambda p, b: p["w"].sum(), opt, backend,
                            comm_mode="atc")
    with pytest.raises(ValueError, match="unknown comm_mode"):
        bt.build_train_step(lambda p, b: p["w"].sum(), opt, backend,
                            comm_mode="gossip")
    with pytest.raises(ValueError, match="compress"):
        bt.build_train_step(lambda p, b: p["w"].sum(), opt, backend,
                            comm_mode="none", compress="int8")
    with pytest.raises(ValueError, match="ranks"):
        bt.build_train_step(lambda p, b: p["w"].sum(), opt, backend,
                            comm_mode="atc", topology=TT.uniform_topology_spec(
                                TT.ExponentialTwoGraph(8)))

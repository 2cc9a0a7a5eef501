"""Per-device wire buckets under tensor parallelism: the int8 wire and
error-feedback top-k mixing of the port's dp 4 x tp 2 train step against
JAX's ``build_train_step(param_specs=...)`` on the 4 x 2 ("bf", "tp")
CPU mesh, the tiny f32 Llama on the same weights and numpy-seeded
tokens:

* ``compress="int8"``, ``"int8"`` with ``overlap="bucketed"`` + guard +
  health, ``MixCompressConfig(0.5, "int8")`` and ``MixCompressConfig(0.5,
  "none")``, cta over ``ExponentialTwoGraph(4)``, 3 steps: each step of
  the port starts from JAX's state before it (params, and every
  ``MixState`` buffer) and lands on JAX's state after it — losses,
  params and every ``MixState`` buffer within ``test_torch_mix_compress
  .py``'s tolerances (1e-5 relative plus 1e-6 absolute), the skip flags
  exactly; ``mix_wire_layout``, ``mix_state_specs`` and
  ``epilogue_stages`` equal to JAX's;
* the int8_sr wire under tp: one step within one int8 grid step of the
  round-to-nearest wire's, the same bits for the same step, and one
  stream per (step, bucket, rank, device);
* a specs tree that does not match the params raises JAX's ValueError.

Why each step starts from JAX's state: the wire's decisions (an int8
code at a rounding boundary, a top-k place between near-equal
magnitudes) are discontinuous, and the two packages' gradients differ in
the last f32 ulps; a code that flips at step 0 then moves every later
step's selection, so three free-running steps are not comparable
element by element.  Under cta the exchange reads the step's starting
params, which are then the same bits on both sides: each step holds the
wire exactly, and the update to f32 noise.  JAX's step too starts each
step from the numpy state, its params placed by their specs: where a
bucket mixes a replicated leaf with sharded ones, each device's copy of
the replicated leaf gets its own scale and the copies part, and JAX's
outputs (``out_specs=P("bf")``) read the first device's; the port holds
that one copy, so both start each step from it.

The port's params dict is in JAX's flatten order (``layer_10`` would
sort before ``layer_2``), so both plan the same buckets on each device's
leaves."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import models as jm
from bluefog_tpu.models.llama import llama_param_specs as j_specs
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.topology import ExponentialTwoGraph, uniform_topology_spec
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models.llama import llama_loss_fn, llama_param_specs
from bluefog_tpu_torch.optim import functional as TF
from bluefog_tpu_torch.parallel import collectives as TC

N_BF, N_TP, B, T, STEPS, LR = 4, 2, 2, 16, 3, 0.3
RTOL, ATOL = 1e-5, 1e-6
TP = bt.MeshAxis("tp", N_TP)

MODES = {
    "int8": dict(compress="int8"),
    "int8_bucketed_guard_health": dict(compress="int8", overlap="bucketed",
                                       overlap_buckets=3, guard=True,
                                       health=True),
    "mix_int8": dict(mix="int8"),
    "mix_none": dict(mix="none"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module: its many tiny torch ops
    otherwise wait on torch's spinning thread pool whenever the host is
    shared (by the test run's other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh():
    return Mesh(np.array(jax.devices()[:8]).reshape(N_BF, N_TP),
                ("bf", "tp"))


def _port_name(path) -> str:
    keys = [str(getattr(k, "key", k)) for k in path]
    name = ".".join(keys[1:] if keys[0] == "params" else keys)
    for i in range(64):
        name = name.replace(f"layer_{i}.", f"layers.{i}.")
    return name


@pytest.fixture(scope="module")
def ref():
    """The tiny f32 Llama's init, the batch, and the port's names in
    JAX's flatten order."""
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jax.jit(jm.Llama(cfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((B, T), jnp.int32)))
    order = [_port_name(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(variables)[0]]
    raw = np.random.RandomState(0).randint(0, 256, (N_BF, B, T + 1))
    return dict(variables=variables, order=order,
                inp=raw[..., :-1].astype(np.int32),
                tgt=raw[..., 1:].astype(np.int32))


def _kw(F, mode):
    """``build_train_step`` keywords of ``mode`` for the JAX package's
    functional module or the port (``F``)."""
    kw = dict(MODES[mode])
    if "mix" in kw:
        kw["compress"] = F.MixCompressConfig(0.5, kw.pop("mix"))
    if kw.pop("guard", False):
        kw["guard"] = F.GuardConfig()
    if kw.pop("health", False):
        kw["health"] = F.HealthConfig()
    return kw


def _put(mesh, step, specs, state, opt_state):
    """JAX's step inputs from a numpy state: the params placed by their
    specs (a leaf replicated over a model axis the same on each of its
    devices), the MixState by ``step.mix_state_specs``."""
    jp, jmix = state

    def put(a, sp):
        return jax.device_put(a, NamedSharding(mesh, sp))

    params = jax.tree.map(put, jp, specs)
    if jmix is None:
        return params, opt_state
    sp = step.mix_state_specs
    mix = JF.MixState(
        ratio=put(jmix.ratio, sp.ratio),
        err=tuple(put(e, sp.err) for e in jmix.err),
        ref=tuple(put(e, sp.ref) for e in jmix.ref),
        mirror=tuple(put(e, sp.mirror) for e in jmix.mirror))
    return params, (opt_state[0], mix)


_JAX = {}


def _jax_run(ref, mode):
    """JAX's dp 4 x tp 2 cta step of ``mode``, 3 steps (built once a
    mode): its states before and after each step (numpy), losses, skip
    flags, wire layout, MixState specs and stages."""
    if mode in _JAX:
        return _JAX[mode]
    v = ref["variables"]
    mesh = _mesh()
    m2 = jm.Llama(jm.LlamaConfig.tiny(dtype=jnp.float32, tp_axis="tp",
                                      tp_size=N_TP))

    def loss_fn(params, batch):
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            m2.apply(params, batch[0]), batch[1]))

    opt = optax.sgd(LR)
    specs = j_specs(v)
    ospecs = JF.optax_state_specs(opt, v, specs)
    step = JF.build_train_step(
        loss_fn, opt, mesh, comm_mode="cta",
        topology=uniform_topology_spec(ExponentialTwoGraph(N_BF)),
        param_specs=specs, opt_state_specs=ospecs, donate=False,
        **_kw(JF, mode))
    params = JF.rank_major(v, mesh, specs=specs)
    opt_state = JF.rank_major(opt.init(v), mesh, specs=ospecs)
    if step.mix_config is not None:
        opt_state = (opt_state, step.init_mix_state(params))
    sh = NamedSharding(mesh, P("bf"))
    batch = (jax.device_put(ref["inp"], sh), jax.device_put(ref["tgt"], sh))
    guarded = "guard" in MODES[mode]

    def snap(p, o):
        mix = (jax.tree.map(np.asarray, o[1])
               if step.mix_config is not None else None)
        return jax.tree.map(np.asarray, p), mix

    states, losses, skips = [snap(params, opt_state)], [], []
    layout = (step.mix_wire_layout(params)
              if step.mix_config is not None else None)
    for s in range(STEPS):
        params, opt_state = _put(mesh, step, specs, states[s], opt_state)
        args = (params, opt_state, batch, jnp.int32(s))
        if guarded:
            args = args + (step.default_comm_weights,)
        out = step(*args)
        params, opt_state, loss = out[:3]
        if guarded:
            skips.append(np.asarray(out[3]))
        losses.append(np.asarray(loss))
        states.append(snap(params, opt_state))
    specs_out = (tuple(tuple(sp) for sp in step.mix_state_specs)
                 if step.mix_config is not None else None)
    _JAX[mode] = dict(states=states, losses=losses, skips=skips,
                      layout=layout, mix_specs=specs_out,
                      stages=step.epilogue_stages)
    return _JAX[mode]


def _port_step(ref, mode, **over):
    """The port's dp 4 x tp 2 step of ``mode`` (stacked, cta over
    ExponentialTwoGraph(4)), its params dict in JAX's flatten order:
    (cfg, step, params, opt_state, batch)."""
    kw = _kw(bt, mode)
    kw.update(over)
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, tp_axis="tp",
                              tp_size=N_TP)
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(ref["variables"], cfg,
                                                 device="cpu"))
    state = model.state(release=True)
    assert sorted(state) == sorted(ref["order"])
    state = {k: state[k] for k in ref["order"]}
    backend = bt.StackedBackend(N_BF, device="cpu")
    specs = llama_param_specs(state)
    params = bt.rank_major(state, backend, specs=specs)
    opt = torch.optim.SGD(params.values(), lr=LR)
    step = bt.build_train_step(
        llama_loss_fn(model), opt, backend, comm_mode="cta",
        topology=TT.uniform_topology_spec(TT.ExponentialTwoGraph(N_BF)),
        mesh_axes=(TP,), param_specs=specs,
        opt_state_specs=TF.optax_state_specs(opt, state, specs), **kw)
    opt_state = ((opt, step.init_mix_state(params))
                 if step.mix_config is not None else opt)
    batch = (torch.from_numpy(ref["inp"]), torch.from_numpy(ref["tgt"]))
    return cfg, step, params, opt_state, batch


def _load(cfg, params, opt_state, jstate):
    """Set the port's state to JAX's (numpy) state."""
    jp, jmix = jstate
    for r in range(N_BF):
        want = llama_params_from_flax(jax.tree.map(lambda x: x[r], jp), cfg,
                                      device="cpu")
        for k, w in want.items():
            params[k][r].copy_(w)
    if jmix is not None:
        ms = opt_state[1]
        ms.ratio.copy_(torch.from_numpy(np.array(jmix.ratio)))
        for field in ("err", "ref", "mirror"):
            for a, b in zip(getattr(ms, field), getattr(jmix, field)):
                a.copy_(torch.from_numpy(np.array(b)))


def _hold(cfg, params, opt_state, jstate, what):
    """The port's state against JAX's (numpy) state."""
    jp, jmix = jstate
    for r in range(N_BF):
        want = llama_params_from_flax(jax.tree.map(lambda x: x[r], jp), cfg,
                                      device="cpu")
        for k, w in want.items():
            np.testing.assert_allclose(params[k][r].numpy(), w.numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: rank {r} {k}")
    if jmix is not None:
        ms = opt_state[1]
        np.testing.assert_array_equal(ms.ratio.numpy(), jmix.ratio)
        for field in ("err", "ref", "mirror"):
            got, want = getattr(ms, field), getattr(jmix, field)
            assert len(got) == len(want)
            for i, (a, b) in enumerate(zip(got, want)):
                assert tuple(a.shape) == b.shape, (field, i)
                np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                           atol=ATOL,
                                           err_msg=f"{what}: {field}[{i}]")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tp_wire_step_matches_jax(ref, mode):
    """Each of 3 steps of the port's dp 4 x tp 2 step from JAX's state
    lands on JAX's next state: losses, params, every MixState buffer
    (one row per device, shard-major) and the skip flags; the wire
    layout (bucket, per-device numel, k, wire bytes), the MixState
    specs and the epilogue stages are JAX's."""
    j = _jax_run(ref, mode)
    cfg, step, params, opt_state, batch = _port_step(ref, mode)
    guarded = "guard" in MODES[mode]
    for s in range(STEPS):
        _load(cfg, params, opt_state, j["states"][s])
        args = (params, opt_state, batch, s)
        if guarded:
            args = args + (step.default_comm_weights,)
        out = step(*args)
        params, opt_state, loss = out[:3]
        np.testing.assert_allclose(loss.numpy(), j["losses"][s], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {s} losses")
        if guarded:
            np.testing.assert_array_equal(out[3].numpy(), j["skips"][s])
            hv = out[4]
            np.testing.assert_allclose(hv.loss.numpy(), j["losses"][s],
                                       rtol=RTOL, atol=ATOL)
            assert not hv.skipped.any()
        _hold(cfg, params, opt_state, j["states"][s + 1], f"step {s}")
    assert step.epilogue_stages == j["stages"]
    if j["layout"] is not None:
        assert step.mix_wire_layout(params) == j["layout"]
        assert tuple(step.mix_state_specs) == j["mix_specs"]
        # one row per device: the packed axis holds both tp shards
        assert opt_state[1].err[0].shape == (
            N_BF, N_TP * j["layout"][0]["numel"])


def test_int8_sr_under_tp_within_a_grid_step_and_deterministic(ref):
    """compress="int8_sr" under tp: one cta step from the same start lands
    within one int8 grid step of the round-to-nearest wire's (per leaf,
    the largest scale of any device's slice), repeats bit for bit for the
    same step, and draws otherwise at another step; each (rank, device)
    row of a per-device bucket rounds from its own stream."""
    outs = {}
    for what, compress, s in (("sr", "int8_sr", 0), ("sr2", "int8_sr", 0),
                              ("sr_next", "int8_sr", 1),
                              ("rn", "int8", 0)):
        _, step, params, opt, batch = _port_step(ref, "int8",
                                                 compress=compress)
        start = {k: v.clone() for k, v in params.items()}
        step(params, opt, batch, s)
        outs[what] = params
    for k, x0 in start.items():
        grid = float(x0.abs().max()) / 127
        assert torch.equal(outs["sr"][k], outs["sr2"][k]), k
        d = (outs["sr"][k] - outs["rn"][k]).abs().max().item()
        assert d <= grid * (1 + 1e-5), (k, d, grid)
    assert any(not torch.equal(outs["sr"][k], outs["sr_next"][k])
               for k in start)
    # the streams: row (r, d) of a per-device bucket draws from
    # (0x51EED, step, bucket, rank, device)
    x = torch.from_numpy(np.random.RandomState(3).randn(
        N_BF, N_TP, 40).astype(np.float32))
    gen = TC.wire_generator("cpu", 5, 2)
    q, scale = TC._wire_quantize_int8(x, gen, per_device=True)
    assert scale.shape == (N_BF, N_TP)
    for r in range(N_BF):
        for d in range(N_TP):
            s = x[r, d].abs().max() / 127.0
            assert scale[r, d] == s
            u = torch.rand(40, generator=gen.generator(r, d))
            want = torch.clamp(torch.floor(x[r, d] / s + u), -127, 127)
            assert torch.equal(q[r, d], want.to(torch.int8)), (r, d)
    assert not torch.equal(
        torch.rand(40, generator=gen.generator(0, 0)),
        torch.rand(40, generator=gen.generator(0, 1)))


def test_specs_that_do_not_match_the_params_raise(ref):
    """A specs tree naming a leaf the params do not hold: the per-device
    plan raises JAX's ValueError (``_local_shapes``' condition)."""
    _, step, params, opt_state, batch = _port_step(ref, "mix_int8")
    less = dict(params)
    less.pop("norm.scale")
    with pytest.raises(ValueError, match="tree matching params exactly"):
        step.init_mix_state(less)

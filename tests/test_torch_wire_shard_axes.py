"""Per-device wire buckets over the other model axes, against JAX's
``build_train_step(param_specs=...)`` on the 8-device CPU mesh, on the
same weights and numpy-seeded tokens (``test_torch_wire_shard.py``'s
contract: each step of the port from JAX's state lands on JAX's next
state, for 3 steps; losses, params and every ``MixState`` buffer within
1e-5 relative plus 1e-6 absolute; ``mix_wire_layout`` and
``epilogue_stages`` equal to JAX's):

* pp 2 on the 4 x 2 ("bf", "pp") mesh, the scanned tiny Llama at 4
  layers: GPipe under ``MixCompressConfig(0.5, "int8")`` and the
  circular layout (2 loops) under the bucketed int8 wire.  A device holds
  its stage's slice of each weight's layer stack, so each weight name of
  a stage is one leaf of the plan (the port's per-layer leaves stacked
  in storage order), placed where JAX's scanned leaf stands;
* ep 2 on the 4 x 2 ("bf", "ep") mesh, the tiny MoE Llama (4 experts)
  under ``MixCompressConfig(0.5, "int8")``: the expert tensors split by
  the expert dim, the router and the dense trunk replicated;
* the hierarchical exchange (2 machines of 2 ranks) at tp 2 under
  ``MixCompressConfig(0.5, "int8")``: each device's machine mean, then
  the machine-level wire;
* tp 2, ep 2 and dp alone with ``scan_layers=True`` and no pp axis,
  each under the bucketed int8 wire and under bucketed
  ``MixCompressConfig(0.5, "int8")`` (3 buckets asked for, 3-5 made):
  JAX holds each weight name's layers as one scanned leaf ``[L, ...]``,
  so the port plans, scales and selects a weight name's layers as one
  leaf there too (``llama_param_specs(scan_layers=True)``).

Why each step starts from JAX's state, and JAX's too: see
``test_torch_wire_shard.py`` (the wire's decisions are discontinuous in
the last f32 ulps of the gradients, and a replicated leaf's copies part
across a rank's devices where a bucket mixes it with sharded leaves:
under pp the head's copy on stage 1, which the loss reads, is not the
copy JAX's outputs keep)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import models as jm
from bluefog_tpu.models.llama import (llama_circular_layout as j_circular,
                                      llama_param_specs as j_specs,
                                      llama_pp_loss_fn as j_pp_loss)
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.topology import ExponentialTwoGraph, uniform_topology_spec
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models.llama import (llama_loss_fn,
                                            llama_param_specs,
                                            llama_pp_loss_fn)
from bluefog_tpu_torch.optim import functional as TF

N_BF, STEPS, LR, L = 4, 3, 0.3, 4
RTOL, ATOL = 1e-5, 1e-6

# case: (model axis, its size, step keywords, n_loops, batch rows)
CASES = {
    "pp_gpipe": ("pp", 2, dict(mix="int8"), 1, 4),
    "pp_circular": ("pp", 2, dict(compress="int8", overlap="bucketed",
                                  overlap_buckets=3), 2, 4),
    "ep": ("ep", 2, dict(mix="int8"), None, 2),
    "hier_tp": ("tp", 2, dict(mix="int8", hier=2), None, 2),
    "tp_scan_int8": ("tp", 2, dict(compress="int8", overlap="bucketed",
                                   overlap_buckets=3), None, 2),
    "tp_scan_mix": ("tp", 2, dict(mix="int8", overlap="bucketed",
                                  overlap_buckets=3), None, 2),
    "ep_scan_int8": ("ep", 2, dict(compress="int8", overlap="bucketed",
                                   overlap_buckets=3), None, 2),
    "ep_scan_mix": ("ep", 2, dict(mix="int8", overlap="bucketed",
                                  overlap_buckets=3), None, 2),
    "dp_scan_int8": (None, 1, dict(compress="int8", overlap="bucketed",
                                   overlap_buckets=3), None, 2),
    "dp_scan_mix": (None, 1, dict(mix="int8", overlap="bucketed",
                                  overlap_buckets=3), None, 2),
}
T = 16
# data-parallel ranks where a case takes fewer than N_BF: on 8 CPU
# devices XLA's in-process collectives can deadlock on JAX's scanned tp
# int8 step (the early exchange's permutes over every device and the
# scanned forward's tp all-reduces wait for each other's threads on a
# loaded host), and do not over dp 2 x tp 2
DP = {"tp_scan_int8": 2}


def _dp(case):
    return DP.get(case, N_BF)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module: its many tiny torch ops
    otherwise wait on torch's spinning thread pool whenever the host is
    shared (by the test run's other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _over(case):
    """The LlamaConfig fields of ``case`` beyond tiny f32."""
    axis = CASES[case][0]
    if axis == "pp":
        return dict(n_layers=L, scan_layers=True)
    scan = dict(n_layers=L, scan_layers=True) if "_scan" in case else {}
    if axis == "ep":
        return dict(n_experts=4, moe_top_k=2, capacity_factor=2.0, **scan)
    return scan


def _model_over(case):
    """The sharded model's extra fields (the pp model is the plain one:
    the loss function runs the pipeline)."""
    axis, size = CASES[case][:2]
    if axis == "tp":
        return dict(tp_axis="tp", tp_size=size)
    if axis == "ep":
        return dict(ep_axis="ep", ep_size=size)
    return {}


def _kw(F, case):
    kw = dict(CASES[case][2])
    if "mix" in kw:
        kw["compress"] = F.MixCompressConfig(0.5, kw.pop("mix"))
    hier = kw.pop("hier", None)
    n_topo = _dp(case) // hier if hier else _dp(case)
    kw["topology"] = F.uniform_topology_spec(F.ExponentialTwoGraph(n_topo)) \
        if F is bt else uniform_topology_spec(ExponentialTwoGraph(n_topo))
    if hier:
        kw["hierarchical_local_size"] = hier
    return kw


def _port_names(variables, n_layers):
    """The port's state-dict names in JAX's flatten order: a scanned
    row ``layers/block/...`` stands for every layer's leaf, in storage
    order."""
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(
            variables["params"])[0]:
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[:2] == ["layers", "block"]:
            out += [f"layers.{i}." + ".".join(keys[2:])
                    for i in range(n_layers)]
            continue
        name = ".".join(keys)
        for i in range(64):
            name = name.replace(f"layer_{i}.", f"layers.{i}.")
        out.append(name)
    return out


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


_REF = {}


def _jax_run(case):
    """JAX's cta step of ``case`` on the dp 4 x axis mesh, 3 steps:
    variables (in the circular layout where it applies), batch, states
    before and after each step, losses, wire layout and stages."""
    if case in _REF:
        return _REF[case]
    axis, size, _, n_loops, rows = CASES[case]
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32, **_over(case))
    variables = jax.tree.map(np.asarray, jax.jit(jm.Llama(cfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((rows, T), jnp.int32)))
    variables = {"params": variables["params"]}
    if n_loops and n_loops > 1:
        variables = jax.tree.map(np.asarray,
                                 j_circular(variables, size, n_loops))
    n = _dp(case)
    mesh = (Mesh(np.array(jax.devices()[:n]), ("bf",)) if axis is None
            else Mesh(np.array(jax.devices()[:n * size]).reshape(n, size),
                      ("bf", axis)))
    opt = optax.sgd(LR)
    kw = _kw(JF, case)
    if axis == "pp":
        loss_fn = j_pp_loss(cfg, pp_axis="pp", n_stages=size,
                            n_micro=2 * n_loops, n_loops=n_loops)
        specs = j_specs(variables, tp_axis=None, ep_axis=None,
                        pp_axis="pp")
        kw["pp_axis"] = "pp"
    else:
        model = jm.Llama(jm.LlamaConfig.tiny(
            dtype=jnp.float32, **_over(case), **_model_over(case)))

        def loss_fn(params, batch):
            return jnp.mean(
                optax.softmax_cross_entropy_with_integer_labels(
                    model.apply(params, batch[0]), batch[1]))

        specs = (j_specs(variables, tp_axis=None, ep_axis="ep")
                 if axis == "ep" else j_specs(variables, tp_axis=axis))
    ospecs = JF.optax_state_specs(opt, variables, specs)
    step = JF.build_train_step(
        loss_fn, opt, mesh, comm_mode="cta", batch_specs=P("bf"),
        param_specs=specs, opt_state_specs=ospecs, donate=False, **kw)
    params = JF.rank_major(variables, mesh, specs=specs)
    opt_state = JF.rank_major(opt.init(variables), mesh, specs=ospecs)
    mix = step.mix_config is not None
    if mix:
        opt_state = (opt_state, step.init_mix_state(params))
    raw = np.random.RandomState(0).randint(0, 256, (n, rows, T + 1))
    inp, tgt = raw[..., :-1].astype(np.int32), raw[..., 1:].astype(np.int32)
    sh = NamedSharding(mesh, P("bf"))
    batch = (jax.device_put(inp, sh), jax.device_put(tgt, sh))

    def snap(p, o):
        return (jax.tree.map(np.asarray, p),
                jax.tree.map(np.asarray, o[1]) if mix else None)

    states, losses = [snap(params, opt_state)], []
    layout = step.mix_wire_layout(params) if mix else None
    for s in range(STEPS):
        params, opt_state = _put(mesh, step, specs, states[s], opt_state)
        params, opt_state, loss = step(params, opt_state, batch,
                                       jnp.int32(s))
        losses.append(np.asarray(loss))
        states.append(snap(params, opt_state))
    _REF[case] = dict(variables=variables, inp=inp, tgt=tgt, states=states,
                      losses=losses, layout=layout,
                      stages=step.epilogue_stages)
    return _REF[case]


def _port(case, ref):
    """The port's step of ``case`` (4 stacked ranks), its params dict in
    JAX's flatten order: (cfg, step, params, opt_state, batch)."""
    axis, size, _, n_loops, _ = CASES[case]
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, **_over(case),
                              **_model_over(case))
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(ref["variables"], cfg,
                                                 device="cpu"))
    state = model.state(release=True)
    order = _port_names(ref["variables"], cfg.n_layers)
    assert sorted(order) == sorted(state)
    state = {k: state[k] for k in order}
    backend = bt.StackedBackend(_dp(case), device="cpu")
    kw = _kw(bt, case)
    ax = bt.MeshAxis(axis, size) if axis is not None else None
    if axis == "pp":
        specs = llama_param_specs(state, tp_axis=None, ep_axis=None,
                                  pp_axis="pp")
        loss_fn = llama_pp_loss_fn(cfg, pp_axis="pp", n_stages=size,
                                   n_micro=2 * n_loops, n_loops=n_loops)
        kw["pp_axis"] = ax
    else:
        specs = (llama_param_specs(state, tp_axis=None, ep_axis="ep",
                                   scan_layers=cfg.scan_layers)
                 if axis == "ep" else
                 llama_param_specs(state, tp_axis=axis,
                                   scan_layers=cfg.scan_layers))
        loss_fn = llama_loss_fn(model)
        if axis is not None:
            kw["mesh_axes"] = (ax,)
    params = bt.rank_major(state, backend, specs=specs)
    opt = torch.optim.SGD(params.values(), lr=LR)
    step = bt.build_train_step(
        loss_fn, opt, backend, comm_mode="cta", param_specs=specs,
        opt_state_specs=TF.optax_state_specs(opt, state, specs), **kw)
    opt_state = ((opt, step.init_mix_state(params))
                 if step.mix_config is not None else opt)
    batch = (torch.from_numpy(ref["inp"]), torch.from_numpy(ref["tgt"]))
    return cfg, step, params, opt_state, batch


def _rank(cfg, tree, r):
    return llama_params_from_flax(
        {"params": jax.tree.map(lambda x: x[r], tree["params"])}, cfg,
        device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_axis_wire_step_matches_jax(case):
    """Each of 3 cta steps of the port from JAX's state lands on JAX's
    next state: losses, params (stage-owned layers, expert slices and
    replicated leaves) and every MixState buffer (one row per device);
    the wire layout and the epilogue stages are JAX's."""
    ref = _jax_run(case)
    cfg, step, params, opt_state, batch = _port(case, ref)
    mix = step.mix_config is not None
    for s in range(STEPS):
        jp, jmix = ref["states"][s]
        for r in range(_dp(case)):
            for k, w in _rank(cfg, jp, r).items():
                params[k][r].copy_(w)
        if mix:
            ms = opt_state[1]
            ms.ratio.copy_(torch.from_numpy(np.array(jmix.ratio)))
            for field in ("err", "ref", "mirror"):
                for a, b in zip(getattr(ms, field), getattr(jmix, field)):
                    a.copy_(torch.from_numpy(np.array(b)))
        params, opt_state, loss = step(params, opt_state, batch, s)
        np.testing.assert_allclose(loss.numpy(), ref["losses"][s],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {s} losses")
        jp, jmix = ref["states"][s + 1]
        for r in range(_dp(case)):
            for k, w in _rank(cfg, jp, r).items():
                np.testing.assert_allclose(
                    params[k][r].numpy(), w.numpy(), rtol=RTOL, atol=ATOL,
                    err_msg=f"step {s}: rank {r} {k}")
        if mix:
            ms = opt_state[1]
            for field in ("err", "ref", "mirror"):
                got, want = getattr(ms, field), getattr(jmix, field)
                assert len(got) == len(want)
                for i, (a, b) in enumerate(zip(got, want)):
                    assert tuple(a.shape) == b.shape, (field, i)
                    np.testing.assert_allclose(
                        a.numpy(), b, rtol=RTOL, atol=ATOL,
                        err_msg=f"step {s}: {field}[{i}]")
    assert step.epilogue_stages == ref["stages"]
    if mix:
        assert step.mix_wire_layout(params) == ref["layout"]

"""Tensor parallelism of the port's Llama against the JAX package's
``tests/test_tp.py``, on the same weights (``llama_params_from_flax``)
and numpy-seeded tokens:

* the tp=2 forward and the gradients of the next-token loss, every leaf
  (the replicated embedding and norms included), against JAX's tp=2
  Llama under ``shard_map`` on the 4 x 2 ("bf", "tp") CPU mesh and
  against the port's tp=1 model;
* ``llama_param_specs`` leaf for leaf equal to JAX's (plain, vocab-
  parallel, expert-parallel, quantized, without the rank axis);
* a dp 4 x tp 2 cta step (``build_train_step(mesh_axes=, param_specs=,
  opt_state_specs=)``, SGD(0.3), ``RingGraph(4)``), its losses and
  params for 3 steps against JAX's (``tests/test_tp.py:110-150``, here
  compared by value); and every comm mode, the guard and the bucketed
  exchange of the port's tp=2 step against its tp=1 step;
* ``optax_state_specs`` over a torch optimizer's state, and the factored
  optimizer's refusal; tp inside a sequence-parallel ring (tp 2 x sp 2
  against the ring at tp 1).

The port holds every tp shard of a rank on one device, stacked
shard-major, and a replicated value once (``parallel/collectives.py``'s
``MeshAxis``).  Tolerances are JAX's (``tests/test_tp.py:58,106-108``):
logits ``rtol = atol = 2e-4``, gradients ``5e-5`` of each leaf's largest
entry; losses after the steps 1e-5, params 1e-4 of each leaf's largest
entry (``tests/test_torch_llama_train_step.py``'s)."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import models as jm
from bluefog_tpu.models.llama import llama_param_specs as j_specs
from bluefog_tpu.models.quant import quantize_llama_params as j_quant
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.topology import RingGraph, uniform_topology_spec
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models.llama import llama_loss_fn, llama_param_specs
from bluefog_tpu_torch.optim import functional as TF

N_BF, N_TP, B, T, STEPS, LR = 4, 2, 2, 16, 3, 0.3
TP = bt.MeshAxis("tp", N_TP)


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


def _port_model(variables, **over):
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, **over)
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, cfg,
                                                 device="cpu"))
    return cfg, model


def _port_name(path) -> str:
    keys = [str(getattr(k, "key", k)) for k in path]
    if keys and keys[0] == "params":
        keys = keys[1:]
    name = ".".join(keys)
    for i in range(64):
        name = name.replace(f"layer_{i}.", f"layers.{i}.")
    return name


def _jax_specs_by_name(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {_port_name(path): tuple(spec) for path, spec in flat}


@pytest.fixture(scope="module")
def ref():
    """The tiny f32 Llama's init, the tokens, and JAX's tp=2 logits,
    losses and gradients per rank (one shard_map program)."""
    cfg1 = jm.LlamaConfig.tiny(dtype=jnp.float32)
    cfg2 = jm.LlamaConfig.tiny(dtype=jnp.float32, tp_axis="tp",
                               tp_size=N_TP)
    m2 = jm.Llama(cfg2)
    variables = jax.tree.map(np.asarray, jax.jit(jm.Llama(cfg1).init)(
        jax.random.PRNGKey(1), jnp.zeros((B, T), jnp.int32)))
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 256, (N_BF, B, T)).astype(np.int32)
    targets = rng.randint(0, 256, (N_BF, B, T)).astype(np.int32)
    mesh = _mesh()
    specs = j_specs(variables)
    params = JF.rank_major(variables, mesh, specs=specs)

    def loss_fn(p, toks, tgt):
        logits = m2.apply(p, toks)
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, tgt)), logits

    def shard(p, toks, tgt):
        local = jax.tree.map(lambda l: l[0], p)
        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(
            local, toks[0], tgt[0])
        return (logits[None], loss[None],
                jax.tree.map(lambda l: l[None], g))

    sm = jax.shard_map(shard, mesh=mesh,
                       in_specs=(specs, P("bf"), P("bf")),
                       out_specs=(P("bf"), P("bf"), specs),
                       check_vma=False)
    sh = NamedSharding(mesh, P("bf"))
    logits, loss, grads = jax.jit(sm)(params,
                                      jax.device_put(tokens, sh),
                                      jax.device_put(targets, sh))
    return dict(variables=variables, tokens=tokens, targets=targets,
                logits=np.asarray(logits), loss=np.asarray(loss),
                grads=jax.tree.map(np.asarray, grads))


def _port_grads(model, params, tokens, targets, axis=None):
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    with bt.bind_axis(axis) if axis is not None else \
            contextlib.nullcontext():
        logits = model.apply(p, torch.from_numpy(tokens))
        loss = llama_loss_fn(model)(p, (torch.from_numpy(tokens),
                                        torch.from_numpy(targets)))
        g = torch.autograd.grad(loss, list(p.values()))
    return logits.detach(), loss.item(), dict(zip(p, g))


def _close_grads(got, want, what):
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-6)
        np.testing.assert_allclose((got[k] / scale).numpy(),
                                   (w / scale).numpy(), rtol=0, atol=5e-5,
                                   err_msg=f"{what} {k}")


def test_tp_forward_and_gradients_match_jax_and_tp1(ref):
    """THE correctness test: the tp=2 logits, loss and every gradient
    (the replicated embedding and norms included) equal JAX's tp=2
    shard_map and the port's tp=1 model on the same global params."""
    v = ref["variables"]
    cfg1, m1 = _port_model(v)
    cfg2, m2 = _port_model(v, tp_axis="tp", tp_size=N_TP)
    params = m1.state()
    for r in range(N_BF):
        toks, tgt = ref["tokens"][r], ref["targets"][r]
        logits2, loss2, g2 = _port_grads(m2, params, toks, tgt, TP)
        logits1, loss1, g1 = _port_grads(m1, params, toks, tgt)
        np.testing.assert_allclose(logits2.numpy(), ref["logits"][r],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(logits2.numpy(), logits1.numpy(),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(loss2, ref["loss"][r], rtol=1e-5)
        np.testing.assert_allclose(loss2, loss1, rtol=1e-5)
        want = llama_params_from_flax(
            jax.tree.map(lambda x: x[r], ref["grads"]), cfg1, device="cpu")
        assert sorted(want) == sorted(g2)
        _close_grads(g2, want, f"rank {r} against JAX's tp=2:")
        _close_grads(g2, g1, f"rank {r} against the port's tp=1:")


def test_tp_model_needs_its_bound_axis(ref):
    """A tp model called outside ``bind_axis`` raises, as ``lax.psum``
    outside ``shard_map``; an axis of another size is refused."""
    _, m2 = _port_model(ref["variables"], tp_axis="tp", tp_size=N_TP)
    toks = torch.from_numpy(ref["tokens"][0])
    with pytest.raises(NameError, match="unbound axis name"):
        m2(toks)
    with bt.bind_axis(bt.MeshAxis("tp", 4)):
        with pytest.raises(ValueError, match="tp_size=2"):
            m2(toks)


_SPEC_CASES = {
    "plain": (dict(), dict()),
    "vocab": (dict(), dict(vocab_axis="tp")),
    "no_rank": (dict(), dict(rank_axis=None)),
    "moe": (dict(n_experts=4), dict(tp_axis=None, ep_axis="ep")),
    "quant": (dict(), dict(rank_axis=None)),
}


@pytest.mark.parametrize("case", sorted(_SPEC_CASES))
def test_llama_param_specs_equal_jax(case):
    """``llama_param_specs`` gives JAX's PartitionSpecs leaf for leaf
    (a spec tuple per state-dict name): column kernels and their scales
    shard the output dim, row kernels the input dim, expert tensors the
    expert dim, the vocab matrices their vocab dim under vocab_axis, the
    rest replicated."""
    over, kw = _SPEC_CASES[case]
    jcfg = jm.LlamaConfig.tiny(dtype=jnp.float32, **over)
    shapes = jax.eval_shape(lambda: jm.Llama(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    if case == "quant":
        shapes = jax.eval_shape(j_quant, shapes)
    want = _jax_specs_by_name(j_specs(shapes["params"], **kw))
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32, **over)
    if case == "quant":
        tcfg = bt.models.decode_config(tcfg, 16, weight_quant="int8")
    state = dict(bt.Llama(tcfg, device="cpu").named_parameters())
    got = llama_param_specs(state, **kw)
    assert got == want
    if case == "plain":
        assert got["layers.0.attention.wq.kernel"] == ("bf", None, "tp")
        assert got["layers.0.attention.wo.kernel"] == ("bf", "tp")
        assert got["layers.0.attention_norm.scale"] == ("bf",)


def _tp_step(v, kw, **step_kw):
    """The port's dp 4 x tp 2 (or tp=1 with ``kw`` empty) step over
    ``v``'s params: (step, params, optimizer, batch)."""
    cfg, model = _port_model(v, **kw)
    backend = bt.StackedBackend(N_BF, device="cpu")
    state = model.state(release=True)
    specs = llama_param_specs(state) if kw else None
    params = bt.rank_major(state, backend)
    opt = torch.optim.SGD(params.values(), lr=LR)
    axes = dict(mesh_axes=(TP,), param_specs=specs,
                opt_state_specs=TF.optax_state_specs(opt, state, specs)
                ) if kw else {}
    step = bt.build_train_step(llama_loss_fn(model), opt, backend,
                               **axes, **step_kw)
    raw = np.random.RandomState(0).randint(0, 256, (N_BF, B, T + 1))
    batch = (torch.from_numpy(raw[..., :-1].astype(np.int32)),
             torch.from_numpy(raw[..., 1:].astype(np.int32)))
    return cfg, step, params, opt, batch


def test_tp_train_step_matches_jax(ref):
    """dp 4 x tp 2 decentralized training: cta over RingGraph(4) with
    tensor parallelism over "tp", param and optimizer-state specs; the
    losses and params of 3 steps equal JAX's step."""
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
        topology=uniform_topology_spec(RingGraph(N_BF)), param_specs=specs,
        opt_state_specs=ospecs, donate=False)
    params = JF.rank_major(v, mesh, specs=specs)
    opt_state = JF.rank_major(opt.init(v), mesh, specs=ospecs)
    raw = np.random.RandomState(0).randint(0, 256, (N_BF, B, T + 1))
    sh = NamedSharding(mesh, P("bf"))
    batch = (jax.device_put(raw[..., :-1].astype(np.int32), sh),
             jax.device_put(raw[..., 1:].astype(np.int32), sh))
    j_losses = []
    for s in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch,
                                       jnp.int32(s))
        j_losses.append(np.asarray(loss))
    j_params = jax.tree.map(np.asarray, params)

    cfg, t_step, t_params, t_opt, t_batch = _tp_step(
        v, dict(tp_axis="tp", tp_size=N_TP), comm_mode="cta",
        topology=TT.uniform_topology_spec(TT.RingGraph(N_BF)))
    t_losses = []
    for s in range(STEPS):
        t_params, t_opt, loss = t_step(t_params, t_opt, t_batch, s)
        t_losses.append(loss.numpy().copy())
    np.testing.assert_allclose(np.stack(t_losses), np.stack(j_losses),
                               rtol=0, atol=1e-5)
    assert t_losses[-1].mean() < t_losses[0].mean()
    for r in range(N_BF):
        want = llama_params_from_flax(jax.tree.map(lambda x: x[r],
                                                   j_params), cfg,
                                      device="cpu")
        for k, w in want.items():
            scale = max(float(w.abs().max()), 1e-12)
            np.testing.assert_allclose(
                t_params[k][r].numpy(), w.numpy(), rtol=0,
                atol=1e-4 * scale, err_msg=f"rank {r} {k}")


_MODES = {
    "none": dict(comm_mode="none"),
    "atc": dict(comm_mode="atc"),
    "cta": dict(comm_mode="cta"),
    "gradient_allreduce": dict(comm_mode="gradient_allreduce"),
    "push_sum": dict(comm_mode="push_sum"),
    "guard": dict(comm_mode="atc", guard=bt.GuardConfig()),
    "bucketed": dict(comm_mode="cta", overlap="bucketed",
                     overlap_buckets=3),
    "bf16_wire": dict(comm_mode="atc", compress="bf16"),
    "hierarchical": dict(comm_mode="atc", hierarchical_local_size=2),
}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_tp_step_every_mode_equals_tp1(ref, mode):
    """Every comm mode, the guard, the bucketed and the bf16 exchange:
    the tp=2 step's losses and params over 2 steps equal the tp=1
    step's on the same global params (the combine of a sharded leaf
    mixes what each device holds: the same arithmetic per element)."""
    kw = dict(_MODES[mode])
    n_topo = 2 if "hierarchical_local_size" in kw else N_BF
    if kw["comm_mode"] in ("atc", "cta", "push_sum"):
        kw["topology"] = TT.uniform_topology_spec(
            TT.ExponentialTwoGraph(n_topo))
    out = {}
    for name, over in (("tp1", {}), ("tp2", dict(tp_axis="tp",
                                                 tp_size=N_TP))):
        _, step, params, opt, batch = _tp_step(ref["variables"], over,
                                               **kw)
        state = (opt, bt.push_sum_weights(step.backend)) \
            if mode == "push_sum" else opt
        losses = []
        for s in range(2):
            args = (params, state, batch, s)
            if "guard" in kw:
                args = args + (step.default_comm_weights,)
            res = step(*args)
            params, state, loss = res[:3]
            if "guard" in kw:
                assert not res[3].any()
            losses.append(loss.numpy().copy())
        out[name] = (np.stack(losses), params)
    # the bf16 wire rounds every value to bf16: an f32 value that the
    # two layouts' summation orders leave a few ulps apart can round to
    # neighbouring bf16 codes, one bf16 ulp of the leaf (2**-8)
    tol = 2.0 ** -8 if kw.get("compress") == "bf16" else 1e-5
    np.testing.assert_allclose(out["tp2"][0], out["tp1"][0], rtol=0,
                               atol=1e-5)
    for k, w in out["tp1"][1].items():
        scale = max(float(w.abs().max()), 1e-12)
        np.testing.assert_allclose(out["tp2"][1][k].numpy(), w.numpy(),
                                   rtol=0, atol=tol * scale, err_msg=k)


def test_tp_step_refuses_per_device_wires(ref):
    """The int8 wires and top-k mixing, whose scale and selection are per
    bucket of ONE device's shards, build and step under model-parallel
    specs (per-device buckets; held to JAX by
    ``tests/test_torch_wire_shard.py``), their MixState one row per
    device; what is still refused is a param spec over an axis the step
    does not hold, and a sequence axis among the model axes."""
    topo = TT.uniform_topology_spec(TT.ExponentialTwoGraph(N_BF))
    for compress in ("int8", "int8_sr", "topk"):
        _, step, params, opt, batch = _tp_step(
            ref["variables"], dict(tp_axis="tp", tp_size=N_TP),
            comm_mode="atc", topology=topo, compress=compress)
        state = ((opt, step.init_mix_state(params)) if compress == "topk"
                 else opt)
        params, state, loss = step(params, state, batch, 0)
        assert torch.isfinite(loss).all(), compress
        if compress == "topk":
            numel = sum(r["numel"] for r in step.mix_wire_layout(params))
            assert sum(e.shape[1] for e in state[1].err) == N_TP * numel
    cfg, model = _port_model(ref["variables"])
    backend = bt.StackedBackend(N_BF, device="cpu")
    state = model.state(release=True)
    params = bt.rank_major(state, backend)
    opt = torch.optim.SGD(params.values(), lr=LR)
    step = bt.build_train_step(llama_loss_fn(model), opt, backend,
                               comm_mode="none",
                               param_specs=llama_param_specs(state))
    raw = torch.zeros(N_BF, B, T, dtype=torch.int32)
    with pytest.raises(ValueError, match="mesh_axes does not hold"):
        step(params, opt, (raw, raw), 0)
    with pytest.raises(TypeError, match="mesh_axes"):
        bt.build_train_step(llama_loss_fn(model), opt, backend,
                            comm_mode="none",
                            mesh_axes=(bt.SeqAxis("sp", 2),))


def test_optax_state_specs_structure():
    """Moments inherit the param specs, Adam's per-rank step count gets
    ("bf",), SGD's momentum its param's spec: JAX's mu/nu/count."""
    params = {"a": torch.zeros(3, 4), "b": torch.zeros(2)}
    specs = {"a": ("bf", None, "tp"), "b": ("bf",)}
    adam = torch.optim.Adam([torch.zeros(1)], lr=1e-3)
    out = TF.optax_state_specs(adam, params, specs)
    assert out == {k: {"step": ("bf",), "exp_avg": s, "exp_avg_sq": s}
                   for k, s in specs.items()}
    j = JF.optax_state_specs(optax.adam(1e-3),
                             {k: jnp.zeros(v.shape) for k, v in
                              params.items()},
                             {k: P(*s) for k, s in specs.items()})[0]
    assert {k: tuple(v) for k, v in j.mu.items()} == specs
    assert tuple(j.count) == ("bf",)
    sgd = torch.optim.SGD([torch.zeros(1)], lr=0.1, momentum=0.9)
    assert TF.optax_state_specs(sgd, params, specs) == {
        k: {"momentum_buffer": s} for k, s in specs.items()}
    assert TF.rank_spec_tree(params) == {"a": ("bf",), "b": ("bf",)}


def test_optax_state_specs_factored_optimizer():
    """A factored optimizer's shape-reduced moments fall back to ("bf",)
    under a rank-only spec; under a MODEL-parallel spec they raise, as
    JAX's ``optax_state_specs`` does."""
    params = {"w": torch.zeros(8, 16)}
    fac = torch.optim.Adafactor([torch.zeros(1)], lr=1e-3)
    out = TF.optax_state_specs(fac, params, {"w": ("bf",)})
    assert all(s == ("bf",) for s in out["w"].values())
    with pytest.raises(ValueError, match="factored"):
        TF.optax_state_specs(fac, params, {"w": ("bf", None, "tp")})


def test_rank_major_init_equals_rank_major():
    """``rank_major_init`` builds the stack on the backend's device from
    one rank's init, with the values ``rank_major`` gives."""
    backend = bt.StackedBackend(3, device="cpu")
    cfg = dataclasses.replace(bt.LlamaConfig.tiny(dtype=torch.float32),
                              n_layers=1)

    def init():
        return bt.Llama(cfg, device="cpu").state(release=True)

    specs = llama_param_specs(init())
    got = TF.rank_major_init(init, backend, specs=specs)
    want = bt.rank_major(init(), backend, specs=specs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="starts with"):
        bt.rank_major(init(), backend, specs={"norm.scale": ("tp",)})


def test_tp_composes_with_ring_attention(ref):
    """Tensor parallelism inside a sequence-parallel ring (both axes
    bound; each tp shard's heads ride the ring folded into its batch):
    the tp 2 x sp 2 logits and gradients equal the sp 2 ring's at tp 1."""
    sp = bt.SeqAxis("sp", 2)
    over = dict(attn_mode="ring", sp_axis="sp", attn_impl="flash")
    _, m1 = _port_model(ref["variables"], **over)
    _, m2 = _port_model(ref["variables"], tp_axis="tp", tp_size=N_TP,
                        **over)
    params = m1.state()
    toks = torch.from_numpy(ref["tokens"][0]).reshape(B, 2, T // 2)
    tgt = torch.from_numpy(ref["targets"][0]).reshape(B, 2, T // 2)
    toks, tgt = toks.transpose(0, 1), tgt.transpose(0, 1)   # [S, B, T/S]
    out = []
    for model, axes in ((m1, (sp,)), (m2, (sp, TP))):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        with contextlib.ExitStack() as stack:
            for ax in axes:
                stack.enter_context(bt.bind_axis(ax))
            logits = model.apply(p, toks)
            loss = llama_loss_fn(model)(p, (toks, tgt)).mean()
            g = torch.autograd.grad(loss, list(p.values()))
        out.append((logits.detach(), dict(zip(p, g))))
    np.testing.assert_allclose(out[1][0].numpy(), out[0][0].numpy(),
                               rtol=2e-4, atol=2e-4)
    _close_grads(out[1][1], out[0][1], "tp 2 x sp 2 against sp 2:")

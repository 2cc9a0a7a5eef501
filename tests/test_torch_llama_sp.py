"""Sequence-parallel Llama through the port against the JAX package, on
the same weights (``llama_params_from_flax``) and numpy tokens:

* the forward of a ring (sp 4, flash, ``scan_layers``) and a Ulysses
  (sp 2, xla) tiny f32 Llama,
  against JAX's sharded Llama under ``shard_map``
  (``tests/test_models.py:52-75,203-228``) and against the unsharded
  port; and the gradients of the shard-mean loss against JAX's
  ``pmean`` of its shards' gradients;
* a dp 4 x sp 2 atc step (``build_train_step(sp_axis=, batch_specs=)``)
  over ``ExponentialTwoGraph(4)``, 3 steps of Adam(1e-3), against JAX's
  ``build_train_step(sp_axis="sp", batch_specs=P("bf", None, "sp"))``
  (``tests/test_functional.py:115-160``, here compared by value): ring
  and Ulysses, with the guard and ``overlap="bucketed"`` once each; the
  step-0 losses also equal the unsharded model's
  (``tests/test_ulysses.py:97-137``);
* no refusal naming a ROADMAP item is left (item 13's two now answer);
  what slices 18 and 19 ported (the pipeline, the expert step over a
  sequence axis, the per-device wires under model-parallel specs) runs,
  or raises JAX's errors.

The JAX side runs ``attn_impl="xla"`` throughout, the same function as
its flash (its ring and Ulysses flash in interpret mode cost ~20 s a
build; ``tests/test_torch_ring_attention.py`` and
``tests/test_torch_ulysses.py`` hold the port's flash to JAX's flash);
the port's flash runs the kernels' plain versions on CPU tensors.
Tolerance: logits 2e-4 (the JAX
package's ``tests/test_models.py:75``), gradients 2e-4 of each leaf's
largest entry, params after 3 steps 1e-4 of each leaf's largest entry
and losses 1e-5 (``tests/test_torch_llama_train_step.py``'s)."""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import models as jm
from bluefog_tpu import topology as JT
from bluefog_tpu.optim import functional as JF
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models.llama import llama_loss_fn

N_DP, N_SP, B, T, STEPS, LR = 4, 2, 2, 32, 3, 1e-3
SP = {"ring": 4, "ulysses": 2}   # the tiny config's 2 kv heads cap Ulysses


_VARIABLES = {}


def _variables(scan=False):
    # one compiled init per layout, shared by the forward and the
    # train-step tests (each takes its own copy): op by op, the init
    # compiles each primitive apart
    if scan not in _VARIABLES:
        cfg = jm.LlamaConfig.tiny(dtype=jnp.float32, scan_layers=scan)
        _VARIABLES[scan] = jax.tree.map(np.asarray, jax.jit(
            jm.Llama(cfg).init)(jax.random.PRNGKey(3),
                                jnp.zeros((1, 8), jnp.int32)))
    return jax.tree.map(np.copy, _VARIABLES[scan])


def _tokens(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.int32)


def _port_model(mode, impl, variables, **over):
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, attn_mode=mode,
                              sp_axis="sp", attn_impl=impl, **over)
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, cfg,
                                                 device="cpu"))
    return model


def _close_leaves(got, want_tree, cfg, tol, what):
    want = llama_params_from_flax(want_tree, cfg, device="cpu")
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-12)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=tol * scale, err_msg=f"{what} {k}")


@pytest.mark.parametrize("mode,impl,scan", [
    ("ring", "flash", True), ("ulysses", "xla", False)])
def test_sp_llama_forward_and_grads_match_jax(mode, impl, scan):
    n = SP[mode]
    t_local = T // n
    variables = _variables(scan)
    raw = _tokens((B, T + 1), 1)
    inp, tgt = raw[:, :-1], raw[:, 1:]
    jcfg = jm.LlamaConfig.tiny(dtype=jnp.float32, attn_mode=mode,
                               sp_axis="sp", scan_layers=scan)
    jmodel = jm.Llama(jcfg)
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))

    def shard_loss(params, inp, tgt):
        off = jax.lax.axis_index("sp") * t_local
        logits = jmodel.apply(params, inp, pos_offset=off)
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, tgt)), logits

    def shard_fn(params, inp, tgt):
        (loss, logits), g = jax.value_and_grad(shard_loss, has_aux=True)(
            params, inp, tgt)
        return logits, jax.lax.pmean(loss, "sp"), jax.lax.pmean(g, "sp")

    want_logits, want_loss, want_grads = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(), P(None, "sp"), P(None, "sp")),
        out_specs=(P(None, "sp"), P(), P()), check_vma=False))(
            variables, inp, tgt)

    model = _port_model(mode, impl, variables, scan_layers=scan)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.state(release=True).items()}
    axis = bt.SeqAxis("sp", n)
    shard = lambda x: torch.from_numpy(x).reshape(  # noqa: E731
        B, n, t_local).movedim(1, 0)
    with bt.bind_axis(axis):
        logits = model.apply(params, shard(inp),
                             pos_offset=axis.index() * t_local)
        losses = llama_loss_fn(model)(params, (shard(inp), shard(tgt)))
        grads = torch.autograd.grad(losses.mean(), list(params.values()))
    assert logits.shape == (n, B, t_local, 256) and losses.shape == (n,)
    got = logits.detach().movedim(0, 1).reshape(B, T, 256).numpy()
    np.testing.assert_allclose(got, np.asarray(want_logits), rtol=2e-4,
                               atol=2e-4)
    plain = bt.Llama(bt.LlamaConfig.tiny(dtype=torch.float32), device="cpu",
                     param_dtype=torch.float32)
    plain.load_state_dict(llama_params_from_flax(variables, plain.cfg,
                                                 device="cpu"))
    np.testing.assert_allclose(
        got, plain(torch.from_numpy(inp)).detach().numpy(), rtol=2e-4,
        atol=2e-4)
    np.testing.assert_allclose(losses.mean().item(), float(want_loss),
                               rtol=0, atol=1e-5)
    _close_leaves(dict(zip(params, grads)),
                  jax.tree.map(np.asarray, want_grads), model.cfg, 2e-4,
                  "grad")


# (attn_mode, the port's attn_impl, builder keywords)
MODES = {
    "ring_flash_guard": ("ring", "flash", {"guard": True}),
    "ulysses_flash_bucketed": ("ulysses", "flash",
                               {"overlap": "bucketed",
                                "overlap_buckets": 3}),
}


def _run_jax(variables, mode, impl, kw, inp, tgt):
    n = N_SP
    t_local = T // n
    mesh = Mesh(np.array(jax.devices()[:N_DP * n]).reshape(N_DP, n),
                ("bf", "sp"))
    model = jm.Llama(jm.LlamaConfig.tiny(dtype=jnp.float32, attn_mode=mode,
                                         sp_axis="sp", attn_impl=impl))

    def loss_fn(params, batch):
        off = jax.lax.axis_index("sp") * t_local
        logits = model.apply(params, batch[0], pos_offset=off)
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, batch[1]))

    kw = dict(kw)
    guarded = kw.pop("guard", False)
    if guarded:
        kw["guard"] = JF.GuardConfig()
    opt = optax.adam(LR)
    step = JF.build_train_step(
        loss_fn, opt, mesh, comm_mode="atc",
        topology=JT.uniform_topology_spec(JT.ExponentialTwoGraph(N_DP)),
        sp_axis="sp", batch_specs=P("bf", None, "sp"), donate=False, **kw)
    params = JF.rank_major(variables, mesh)
    opt_state = JF.rank_major(opt.init(variables), mesh)
    sh = NamedSharding(mesh, P("bf", None, "sp"))
    batch = (jax.device_put(inp, sh), jax.device_put(tgt, sh))
    losses = []
    for s in range(STEPS):
        args = (params, opt_state, batch, jnp.int32(s))
        if guarded:
            args = args + (step.default_comm_weights,)
        out = step(*args)
        params, opt_state, loss = out[:3]
        losses.append(np.asarray(loss))
        if guarded:
            assert not np.asarray(out[3]).any()
    return jax.tree.map(np.asarray, params), np.stack(losses)


def _run_port(variables, mode, impl, kw, inp, tgt):
    model = _port_model(mode, impl, variables)
    backend = bt.StackedBackend(N_DP, device="cpu")
    params = bt.rank_major(model.state(release=True), backend)
    opt = torch.optim.Adam(params.values(), lr=LR)
    kw = dict(kw)
    guarded = kw.pop("guard", False)
    if guarded:
        kw["guard"] = bt.GuardConfig()
    step = bt.build_train_step(
        llama_loss_fn(model), opt, backend, comm_mode="atc",
        topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(N_DP)),
        sp_axis=bt.SeqAxis("sp", N_SP),
        batch_specs=("bf", None, "sp"), **kw)
    batch = (torch.from_numpy(inp), torch.from_numpy(tgt))
    losses = []
    for s in range(STEPS):
        args = (params, opt, batch, s)
        if guarded:
            args = args + (step.default_comm_weights,)
        out = step(*args)
        params, opt, loss = out[:3]
        assert loss.shape == (N_DP,)
        losses.append(loss.numpy().copy())
        if guarded:
            assert not out[3].any()
    return model.cfg, params, np.stack(losses)


@pytest.mark.parametrize("name", sorted(MODES))
def test_dp_sp_train_step_matches_jax(name):
    mode, impl, kw = MODES[name]
    variables = _variables()
    raw = _tokens((N_DP, B, T + 1))
    inp, tgt = raw[..., :-1], raw[..., 1:]
    j_params, j_loss = _run_jax(variables, mode, "xla", kw, inp, tgt)
    cfg, t_params, t_loss = _run_port(variables, mode, impl, kw, inp, tgt)
    np.testing.assert_allclose(t_loss, j_loss, rtol=0, atol=1e-5)
    for r in range(N_DP):
        _close_leaves({k: v[r] for k, v in t_params.items()},
                      jax.tree.map(lambda x: x[r], j_params), cfg, 1e-4,
                      f"params rank {r}")
    # the step-0 loss is the unsharded model's on the same weights
    plain = bt.Llama(bt.LlamaConfig.tiny(dtype=torch.float32), device="cpu",
                     param_dtype=torch.float32)
    plain.load_state_dict(llama_params_from_flax(variables, plain.cfg,
                                                 device="cpu"))
    with torch.no_grad():
        ref = [llama_loss_fn(plain)(
            dict(plain.named_parameters()),
            (torch.from_numpy(inp[r]), torch.from_numpy(tgt[r]))).item()
            for r in range(N_DP)]
    np.testing.assert_allclose(t_loss[0], ref, rtol=0, atol=1e-5)


def _refusals():
    """Every refusal of the training path that is left: none.  The step
    profiler's HLO reading (``hlo_op_breakdown`` and the overlap
    accounting) reads a profiled run instead; the model axes run
    since slice 17 (``tests/test_torch_tp.py``), the pipeline and the
    expert step over a sequence axis since slice 18, the per-device
    wires under model-parallel specs since slice 19
    (``tests/test_torch_wire_shard.py``)."""
    from bluefog_tpu_torch import observe

    prof = observe.profile_step(lambda: None, link_bytes_per_s=1e9,
                                publish=False)
    assert observe.hlo_op_breakdown(prof) == prof.op_breakdown
    assert prof.overlap is not None
    return []


def test_refusals_name_item_10_only():
    """No refusal naming a ROADMAP.md Queue 1 item is left (the last
    two, item 13's, now answer): item 10 is done (the per-device wires
    under model-parallel specs build and step: an int8 step over a tp
    spec runs here); what slice 18 ported runs or raises JAX's errors: the
    pipeline's builders
    (``llama_pp_loss_fn``, ``llama_circular_layout``,
    ``llama_param_specs(pp_axis=)``), the step's ``pp_axis`` (JAX's
    ``ValueError`` without ``param_specs``) and the expert step over a
    sequence axis; an sp_axis given as a bare name is refused (the axis
    object holds the size)."""
    assert _refusals() == []
    backend = bt.StackedBackend(2, device="cpu")
    p = bt.rank_major({"w": torch.zeros(4)}, backend)
    opt = torch.optim.SGD(p.values(), lr=0.1)
    step = bt.build_train_step(
        lambda p, b: p["w"].square().sum(), opt, backend, comm_mode="atc",
        topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(2)),
        compress="int8", mesh_axes=(bt.MeshAxis("tp", 2),),
        param_specs={"w": ("bf", "tp")})
    step(p, opt, torch.zeros(2), 0)
    assert torch.isfinite(p["w"]).all()
    cfg = bt.LlamaConfig.tiny(scan_layers=True)
    assert callable(bt.models.llama_pp_loss_fn(cfg, pp_axis="pp",
                                               n_stages=2, n_micro=2))
    state = bt.Llama(cfg, device="cpu").state()
    circ = bt.models.llama_circular_layout(state, 2, 1)
    assert circ["layers.1.attention.wq.kernel"] is \
        state["layers.1.attention.wq.kernel"]
    specs = bt.models.llama_param_specs(state, pp_axis="pp")
    assert specs["layers.0.attention_norm.scale"] == (("bf", "pp"),)
    assert specs["norm.scale"] == ("bf",)
    with pytest.raises(ValueError, match="pp_axis requires param_specs"):
        bt.build_train_step(lambda p, b: p["w"].sum(), opt, backend,
                            comm_mode="none", pp_axis="pp")
    step = bt.build_train_step(
        lambda p, b: p["w"].sum(), opt, backend, comm_mode="atc",
        topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(2)),
        moe=bt.MoEConfig(2, 2), sp_axis=bt.SeqAxis("sp", 2))
    assert step.moe_config.n_experts == 2
    with pytest.raises(TypeError, match="SeqAxis"):
        bt.build_train_step(lambda p, b: p["w"].sum(),
                            torch.optim.SGD(p.values(), lr=0.1), backend,
                            comm_mode="none", sp_axis="sp")
    with pytest.raises(ValueError, match="rank axis"):
        bt.build_train_step(lambda p, b: p["w"].sum(),
                            torch.optim.SGD(p.values(), lr=0.1), backend,
                            comm_mode="none", sp_axis=bt.SeqAxis("sp", 2),
                            batch_specs=(None, "sp"))
    # splash does not compose with ring/ulysses; tp_seq_shard neither
    with pytest.raises(ValueError, match="splash"):
        bt.LlamaConfig.tiny(attn_mode="ring", sp_axis="sp",
                            attn_impl="splash")
    with pytest.raises(ValueError, match="tp_seq_shard"):
        bt.LlamaConfig.tiny(attn_mode="ring", sp_axis="sp", tp_axis="tp",
                            tp_size=2, vocab_parallel=True,
                            tp_seq_shard=True)
    # a ring model called with its axis unbound raises, as axis_index
    model = bt.Llama(bt.LlamaConfig.tiny(attn_mode="ring", sp_axis="sp"),
                     device="cpu")
    with pytest.raises(NameError, match="unbound axis name"):
        model(torch.zeros(2, 1, 8, dtype=torch.long))


def test_sp_step_splits_the_batch_and_means_the_shards():
    """``batch_specs`` splits the named dim of every leaf into shard-major
    ``[S, ...]`` chunks (a spec that names none passes the leaf whole);
    a ``loss_fn`` returning each shard's loss ``[S]`` and one returning
    their mean as a scalar take the same step; another shape is refused."""
    backend = bt.StackedBackend(2, device="cpu")
    x = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    seen = []

    def per_shard(p, batch):
        seen.append(batch.shape)
        assert bt.parallel.collectives.bound_axis("sp").size == 4
        return ((batch * p["w"]) ** 2).mean(dim=(1, 2))

    def run(loss_fn, spec=("bf", None, "sp")):
        params = bt.rank_major({"w": torch.ones(2)}, backend)
        opt = torch.optim.SGD(params.values(), lr=1e-3)
        step = bt.build_train_step(loss_fn, opt, backend, comm_mode="none",
                                   sp_axis=bt.SeqAxis("sp", 4),
                                   batch_specs=spec)
        return step(params, opt, x, 0)

    p1, _, l1 = run(per_shard)
    assert seen == [(4, 3, 2)] * 2
    p2, _, l2 = run(lambda p, b: per_shard(p, b).mean())
    assert torch.equal(p1["w"], p2["w"]) and torch.equal(l1, l2)
    # the mean of the shards' losses is the mean over the whole rank
    np.testing.assert_allclose(
        l1.numpy(), (x ** 2).mean(dim=(1, 2)).numpy(), rtol=1e-6)
    seen.clear()
    with pytest.raises(ValueError, match=r"\[4\]"):
        run(lambda p, b: per_shard(p, b)[:2])
    whole = []
    run(lambda p, b: whole.append(b.shape) or (b * p["w"][:1]).pow(2).mean(),
        spec=("bf",))
    assert whole == [(3, 8)] * 2


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sp_flash_under_remat_matches_no_remat(mode):
    """The ring's ``autograd.Function`` (and Ulysses' flash call) under
    ``remat=True`` with policies "none" and "dots": the recompute re-runs
    the forward with the axis still bound and its saved tensors survive
    checkpointing; logits and gradients equal the model without remat
    (1e-6 of each leaf's largest entry: the same f32 operations)."""
    n = SP[mode]
    tok = torch.from_numpy(_tokens((2, n, 8), 5)).movedim(1, 0)
    axis = bt.SeqAxis("sp", n)
    out = {}
    for policy in (None, "none", "dots"):
        over = dict(remat=True, remat_policy=policy) if policy else {}
        cfg = bt.LlamaConfig.tiny(dtype=torch.float32, attn_mode=mode,
                                  sp_axis="sp", attn_impl="flash", **over)
        model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32,
                         generator=torch.Generator().manual_seed(2))
        params = {k: v.requires_grad_(True)
                  for k, v in model.state(release=True).items()}
        with bt.bind_axis(axis):
            logits = model.apply(params, tok,
                                 pos_offset=axis.index() * tok.shape[-1])
            grads = torch.autograd.grad((logits ** 2).mean(),
                                        list(params.values()))
        out[policy] = (logits.detach(), dict(zip(params, grads)))
    for policy in ("none", "dots"):
        torch.testing.assert_close(out[policy][0], out[None][0], rtol=0,
                                   atol=1e-6)
        for k, g in out[None][1].items():
            tol = 1e-6 * max(float(g.abs().max()), 1e-12)
            torch.testing.assert_close(out[policy][1][k], g, rtol=0,
                                       atol=tol, msg=f"{policy} {k}")

"""The port's routed MoE Llama (bluefog_tpu_torch/models/llama.py's
``MoEFeedForward`` and ``moe_combine_weights``) against the JAX model at
``ep_size = 1`` on ``LlamaConfig.tiny(n_experts=4, moe_top_k=2)`` in
f32: the same parameters (the JAX init, carried by
``llama_params_from_flax`` in the unrolled and the ``scan_layers``
layouts) and tokens give the same logits, aux loss, loss and gradients,
for both routers, with capacity drops and with grouped routing.

Tolerances (tests/test_moe.py's): loss rtol 1e-5, gradients 5e-5 of each
leaf's largest entry; logits 1e-4 (f32 products summed in another
order); the routing weights exactly.  The train step: 3 atc steps over
``StackedBackend(4)`` against JAX's 4-device mesh within
test_torch_train_step.py's 5e-4 of each leaf's largest entry.  Inputs
are random draws without exact ties in the router's probabilities."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import models as jm
from bluefog_tpu import topology as JT
from bluefog_tpu.models import llama as jllama
from bluefog_tpu.optim import functional as JF
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models import llama as tllama

B, T = 2, 16
AUX_W = 0.01


def _over(router="topk", **kw):
    base = dict(n_experts=4, moe_top_k=2, capacity_factor=2.0,
                moe_router=router, moe_aux_weight=AUX_W)
    if router == "expert_choice":
        base["allow_noncausal_router"] = True
    base.update(kw)
    return base


CASES = {
    "topk": _over(),
    "topk_drops_scan": _over(capacity_factor=0.5, scan_layers=True),
    "topk_grouped": _over(capacity_factor=1.0, moe_group_size=8),
    "expert_choice": _over("expert_choice"),
    "expert_choice_grouped_scan": _over("expert_choice", moe_group_size=8,
                                        capacity_factor=1.0,
                                        scan_layers=True),
}


@functools.lru_cache(maxsize=None)
def _variables(scan_layers):
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32, **_over(
        scan_layers=scan_layers))
    v = jm.Llama(cfg).init(jax.random.PRNGKey(1),
                           jnp.zeros((B, T), jnp.int32))
    # init also returns the sown intermediates; apply takes params only
    return {"params": jax.tree.map(np.asarray, v["params"])}


def _models(over):
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32, **over)
    variables = _variables(cfg.scan_layers)
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32, **over)
    model = bt.Llama(tcfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, tcfg,
                                                 device="cpu"))
    return cfg, variables, model


def _batch(seed=0):
    raw = np.random.RandomState(seed).randint(0, 256, (B, T + 1))
    return raw[:, :-1].astype(np.int32), raw[:, 1:].astype(np.int32)


def _jax_all(cfg, variables, inp, tgt):
    """JAX's logits, summed aux, loss (examples/llama_benchmark.py's: ce
    + moe_aux_weight * aux) and gradients."""
    model = jm.Llama(cfg)

    def loss_fn(params):
        logits, mut = model.apply(params, jnp.asarray(inp),
                                  mutable=["intermediates"])
        aux = sum(jnp.sum(v) for v in jax.tree.leaves(mut["intermediates"]))
        ce = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(tgt)))
        return ce + cfg.moe_aux_weight * aux, (logits, aux)

    (loss, (logits, aux)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables)
    return (np.asarray(logits), float(aux), float(loss),
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_llama_matches_jax(name):
    cfg, variables, model = _models(CASES[name])
    inp, tgt = _batch(1)
    j_logits, j_aux, j_loss, j_grads = _jax_all(cfg, variables, inp, tgt)
    params = {k: v.requires_grad_(True) for k, v in model.state().items()}
    logits, aux = model.apply(params, torch.from_numpy(inp),
                              return_aux=True)
    np.testing.assert_allclose(logits.detach().numpy(), j_logits,
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux.detach()), j_aux, rtol=1e-5)
    loss = tllama.llama_loss_fn(model)(
        params, (torch.from_numpy(inp), torch.from_numpy(tgt)))
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=1e-5)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    want = llama_params_from_flax(j_grads, model.cfg, device="cpu")
    assert set(grads) == set(want)
    assert any(".moe_ffn.w1" in k for k in want)
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-6)
        np.testing.assert_allclose(grads[k].numpy() / scale,
                                   w.numpy() / scale, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_combine_weights_match_jax(router):
    """The routing weights bit for bit (drops present: capacity 3 for 8
    tokens x top-2 over 4 experts), and their gradients."""
    rng = np.random.default_rng(4)
    probs = jax.nn.softmax(jnp.asarray(
        rng.normal(size=(2, 8, 4)).astype(np.float32) * 2.0), axis=-1)
    probs = np.asarray(probs)
    cot = rng.normal(size=(2, 8, 4, 3)).astype(np.float32)
    j_w = np.asarray(jllama.moe_combine_weights(jnp.asarray(probs), 2, 3,
                                                router))
    j_grad = np.asarray(jax.grad(lambda p: jnp.sum(
        jllama.moe_combine_weights(p, 2, 3, router) * cot))(
            jnp.asarray(probs)))
    p = torch.from_numpy(probs.copy()).requires_grad_(True)
    got = tllama.moe_combine_weights(p, 2, 3, router)
    assert got.shape == j_w.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.detach().numpy(), j_w)
    if router == "topk":
        # capacity 3 per expert and group for 16 picks: some dropped
        assert (j_w > 0).sum() < 2 * 8 * 2
    (g,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), p)
    np.testing.assert_allclose(g.numpy(), j_grad, rtol=1e-6, atol=1e-7)


def test_expert_choice_requires_acknowledgement():
    with pytest.raises(ValueError, match="non-causal"):
        bt.LlamaConfig.tiny(n_experts=4, moe_router="expert_choice")


@pytest.mark.parametrize("over", [
    dict(n_experts=4, ep_axis="ep", ep_size=2),
    dict(tp_axis="tp", tp_size=2)])
def test_model_axes_are_refused(over):
    """The model axes run since slice 17 (tests/test_torch_moe_ep.py,
    tests/test_torch_tp.py): an ep or tp config builds, needs its axis
    bound (as ``lax.psum`` outside ``shard_map``), and then gives the
    unsharded model's logits on the same weights."""
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, **over)
    plain = dataclasses.replace(cfg, tp_axis=None, tp_size=1, ep_axis=None,
                                ep_size=1)
    model = bt.Llama(cfg, device="cpu")
    ref = bt.Llama(plain, device="cpu")
    ref.load_state_dict(model.state_dict())
    tokens = torch.randint(0, 256, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        with pytest.raises(NameError, match="unbound axis name"):
            model(tokens)
        with bt.bind_axis(bt.MeshAxis(cfg.tp_axis or cfg.ep_axis, 2)):
            got = model(tokens)
        want = ref(tokens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_chunked_xent_refuses_moe_aux():
    model = bt.Llama(bt.LlamaConfig.tiny(dtype=torch.float32, **_over()),
                     device="cpu")
    with pytest.raises(ValueError, match="MoE aux"):
        tllama.llama_chunked_xent_loss_fn(model)


def test_grouped_routing_warns_when_the_group_collapses(monkeypatch):
    """An awkward token count (1 x 17, group 16: 17 is prime, the largest
    divisor not above 16 is 1) collapses the group; the port warns, as
    JAX does."""
    from bluefog_tpu_torch.logging_util import get_logger

    seen = []
    monkeypatch.setattr(get_logger(), "warning",
                        lambda msg, *a: seen.append(msg % a))
    model = bt.Llama(bt.LlamaConfig.tiny(dtype=torch.float32, **_over(
        moe_group_size=16)), device="cpu")
    model(torch.zeros(1, 17, dtype=torch.int64))
    assert seen and "collapsed to 1 " in seen[0]


# ------------------------------------------------------------------ #
# the MoE Llama through build_train_step, 4 ranks, atc
# ------------------------------------------------------------------ #
N, STEPS, LR = 4, 3, 0.1


def test_moe_llama_train_step_matches_jax():
    over = _over(capacity_factor=1.0)
    cfg, variables, _ = _models(over)
    raw = np.random.RandomState(5).randint(0, 256, (N, B, T + 1))
    inp, tgt = raw[..., :-1].astype(np.int32), raw[..., 1:].astype(np.int32)

    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))
    jmodel = jm.Llama(cfg)

    def loss_fn(params, batch):
        logits, mut = jmodel.apply(params, batch[0],
                                   mutable=["intermediates"])
        aux = sum(jnp.sum(v) for v in jax.tree.leaves(mut["intermediates"]))
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, batch[1])) + cfg.moe_aux_weight * aux

    opt = optax.sgd(LR, momentum=0.9)
    topo = dict(topology=JT.uniform_topology_spec(JT.ExponentialTwoGraph(N)))
    jstep = JF.build_train_step(loss_fn, opt, mesh, comm_mode="atc", **topo)
    jp = JF.rank_major(variables, mesh)
    jo = JF.rank_major(opt.init(variables), mesh)
    sh = NamedSharding(mesh, P("bf"))
    jbatch = (jax.device_put(jnp.asarray(inp), sh),
              jax.device_put(jnp.asarray(tgt), sh))
    j_losses = []
    for s in range(STEPS):
        jp, jo, loss = jstep(jp, jo, jbatch, jnp.int32(s))
        j_losses.append(np.asarray(loss))
    jp = jax.tree.map(np.asarray, jp)

    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32, **over)
    model = bt.Llama(tcfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, tcfg,
                                                 device="cpu"))
    backend = bt.StackedBackend(N, device="cpu")
    params = bt.rank_major(model.state(release=True), backend)
    topt = torch.optim.SGD(params.values(), lr=LR, momentum=0.9)
    step = bt.build_train_step(
        tllama.llama_loss_fn(model), topt, backend, comm_mode="atc",
        topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(N)))
    batch = (torch.from_numpy(inp), torch.from_numpy(tgt))
    t_losses = []
    for s in range(STEPS):
        params, topt, loss = step(params, topt, batch, s)
        t_losses.append(loss.numpy().copy())
    np.testing.assert_allclose(np.stack(t_losses), np.stack(j_losses),
                               rtol=0, atol=5e-4)
    for r in range(N):
        want = llama_params_from_flax(jax.tree.map(lambda x: x[r], jp),
                                      tcfg, device="cpu")
        for k, w in want.items():
            scale = max(float(w.abs().max()), 1e-12)
            np.testing.assert_allclose(
                params[k][r].numpy(), w.numpy(), rtol=0,
                atol=5e-4 * scale, err_msg=f"rank {r} {k}")


def test_moe_ring_shards_route_their_own_tokens_as_jax():
    """Under sequence parallelism (ring, sp 2) each shard routes its own
    tokens and has its own aux loss, as each device of JAX's
    ``shard_map`` does: per-shard logits, aux and loss against JAX's."""
    n, t_local = 2, T // 2
    over = _over(capacity_factor=1.0)
    variables = _variables(False)
    raw = np.random.RandomState(7).randint(0, 256, (B, T + 1)).astype(
        np.int32)
    inp, tgt = raw[:, :-1], raw[:, 1:]
    jmodel = jm.Llama(jm.LlamaConfig.tiny(
        dtype=jnp.float32, attn_mode="ring", sp_axis="sp", **over))
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))

    def shard_fn(params, inp, tgt):
        off = jax.lax.axis_index("sp") * t_local
        logits, mut = jmodel.apply(params, inp, pos_offset=off,
                                   mutable=["intermediates"])
        aux = sum(jnp.sum(v) for v in jax.tree.leaves(mut["intermediates"]))
        loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, tgt)) + AUX_W * aux
        return logits, aux[None], loss[None]

    j_logits, j_aux, j_loss = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(), P(None, "sp"), P(None, "sp")),
        out_specs=(P(None, "sp"), P("sp"), P("sp")), check_vma=False))(
            variables, inp, tgt)

    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, attn_mode="ring",
                              sp_axis="sp", **over)
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, cfg,
                                                 device="cpu"))
    params = model.state(release=True)
    axis = bt.SeqAxis("sp", n)
    shard = lambda x: torch.from_numpy(x).reshape(  # noqa: E731
        B, n, t_local).movedim(1, 0)
    with torch.no_grad(), bt.bind_axis(axis):
        logits, aux = model.apply(params, shard(inp),
                                  pos_offset=axis.index() * t_local,
                                  return_aux=True)
        losses = tllama.llama_loss_fn(model)(params,
                                             (shard(inp), shard(tgt)))
    np.testing.assert_allclose(
        logits.movedim(0, 1).reshape(B, T, 256).numpy(),
        np.asarray(j_logits), atol=2e-4, rtol=2e-4)
    assert aux.shape == (n,) and losses.shape == (n,)
    np.testing.assert_allclose(aux.numpy(), np.asarray(j_aux), rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_loss),
                               rtol=1e-5)

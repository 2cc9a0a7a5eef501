"""Experts over an ep axis (``ep_size = 2``) of the port's MoE Llama
against the JAX package's ``tests/test_moe.py:48-153``, on the same
weights (``llama_params_from_flax``) and numpy-seeded tokens:

* the loss and every gradient of the ep=2 model, for both routers (the
  expert psum's conjugate pair, the expert slice of the dispatch,
  expert_choice's top-k gate gradients), against JAX's ep=2 Llama under
  ``shard_map`` on the 4 x 2 ("bf", "ep") CPU mesh and against the
  port's ep=1 model;
* the param tree: expert tensors ``[n_experts, ...]``, the router a
  plain kernel, and their specs (the expert dim over "ep");
* a dp 4 x ep 2 cta step (``build_train_step(mesh_axes=, param_specs=,
  opt_state_specs=)``, SGD(0.3), ``RingGraph(4)``): the losses of 3
  steps against JAX's step.

Tolerances are JAX's (``tests/test_moe.py:86-98``): losses ``rtol =
1e-5``, gradients ``5e-5`` of each leaf's largest entry."""

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
from bluefog_tpu.topology import RingGraph, uniform_topology_spec
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models.llama import (llama_loss_fn,
                                            llama_param_specs)
from bluefog_tpu_torch.optim import functional as TF

N_BF, N_EP, B, T = 4, 2, 2, 16
EP = bt.MeshAxis("ep", N_EP)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module: its many tiny torch ops
    otherwise wait on torch's spinning thread pool whenever the host is
    shared (by the test run's other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _over(**kw):
    base = dict(n_experts=4, moe_top_k=2, capacity_factor=2.0)
    base.update(kw)
    if base.get("moe_router") == "expert_choice":
        base.setdefault("allow_noncausal_router", True)
    return base


def _mesh():
    return Mesh(np.array(jax.devices()[:8]).reshape(N_BF, N_EP),
                ("bf", "ep"))


_VARS = {}


def _variables():
    if "v" not in _VARS:
        cfg = jm.LlamaConfig.tiny(dtype=jnp.float32, **_over())
        _VARS["v"] = jax.tree.map(np.asarray, jax.jit(jm.Llama(cfg).init)(
            jax.random.PRNGKey(1), jnp.zeros((B, T), jnp.int32)))
    return _VARS["v"]


def _port_model(variables, **over):
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, **_over(**over))
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(
        {"params": variables["params"]}, cfg, device="cpu"))
    return cfg, model


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_moe_forward_and_grads_match_jax_and_ep1(router):
    """ep=2 loss AND gradients equal JAX's ep=2 shard_map and the port's
    ep=1 model for the same global params, for both routers."""
    v = {"params": _variables()["params"]}
    m2j = jm.Llama(jm.LlamaConfig.tiny(dtype=jnp.float32, **_over(
        moe_router=router, ep_axis="ep", ep_size=N_EP)))
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 256, (N_BF, B, T)).astype(np.int32)
    targets = rng.randint(0, 256, (N_BF, B, T)).astype(np.int32)
    mesh = _mesh()
    specs = j_specs(v, tp_axis=None, ep_axis="ep")
    params = JF.rank_major(v, mesh, specs=specs)

    def shard(p, toks, tgt):
        local = jax.tree.map(lambda l: l[0], p)
        loss, g = jax.value_and_grad(lambda q: jnp.mean(
            optax.softmax_cross_entropy_with_integer_labels(
                m2j.apply(q, toks[0]), tgt[0])))(local)
        return loss[None], jax.tree.map(lambda l: l[None], g)

    sm = jax.shard_map(shard, mesh=mesh,
                       in_specs=(specs, P("bf"), P("bf")),
                       out_specs=(P("bf"), specs), check_vma=False)
    sh = NamedSharding(mesh, P("bf"))
    j_loss, j_grads = jax.jit(sm)(params, jax.device_put(tokens, sh),
                                  jax.device_put(targets, sh))
    j_loss = np.asarray(j_loss)
    j_grads = jax.tree.map(np.asarray, j_grads)

    cfg1, m1 = _port_model(v, moe_router=router)
    _, m2 = _port_model(v, moe_router=router, ep_axis="ep", ep_size=N_EP)
    state = m1.state()
    for r in range(N_BF):
        toks = torch.from_numpy(tokens[r])
        tgt = torch.from_numpy(targets[r])
        out = {}
        for name, model, axis in (("ep1", m1, None), ("ep2", m2, EP)):
            p = {k: t.clone().requires_grad_(True)
                 for k, t in state.items()}
            with bt.bind_axis(axis) if axis else torch.enable_grad():
                loss = llama_loss_fn(model)(p, (toks, tgt))
                g = torch.autograd.grad(loss, list(p.values()))
            out[name] = (loss.item(), dict(zip(p, g)))
        np.testing.assert_allclose(out["ep2"][0], j_loss[r], rtol=1e-5)
        np.testing.assert_allclose(out["ep2"][0], out["ep1"][0], rtol=1e-5)
        want = llama_params_from_flax(
            {"params": jax.tree.map(lambda x: x[r], j_grads["params"])},
            cfg1, device="cpu")
        for what, ref_g in (("JAX", want), ("ep1", out["ep1"][1])):
            for k, w in ref_g.items():
                scale = max(float(w.abs().max()), 1e-6)
                np.testing.assert_allclose(
                    (out["ep2"][1][k] / scale).numpy(),
                    (w / scale).numpy(), rtol=0, atol=5e-5,
                    err_msg=f"{router} rank {r} against {what}: {k}")


def test_moe_param_tree_and_specs():
    """Expert tensors carry a leading [n_experts] dim and shard it over
    "ep"; the router is a plain kernel, replicated; the tree does not
    depend on ep_size."""
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, **_over())
    state = bt.Llama(cfg, device="cpu").state()
    assert state["layers.0.moe_ffn.w1"].shape == (4, cfg.dim, cfg.ffn_dim)
    assert state["layers.0.moe_ffn.w2"].shape == (4, cfg.ffn_dim, cfg.dim)
    assert state["layers.0.moe_ffn.router.kernel"].shape == (cfg.dim, 4)
    specs = llama_param_specs(state, tp_axis=None, ep_axis="ep")
    assert specs["layers.0.moe_ffn.w1"] == ("bf", "ep")
    assert specs["layers.0.moe_ffn.router.kernel"] == ("bf",)
    cfg2 = bt.LlamaConfig.tiny(dtype=torch.float32,
                               **_over(ep_axis="ep", ep_size=N_EP))
    state2 = bt.Llama(cfg2, device="cpu").state()
    assert {k: v.shape for k, v in state2.items()} == {
        k: v.shape for k, v in state.items()}


def test_moe_ep_train_step_matches_jax():
    """dp x ep decentralized training: the losses of 3 cta steps through
    the routed experts (experts over "ep", ring neighbor averaging over
    "bf") equal JAX's step."""
    v = {"params": _variables()["params"]}
    m2j = jm.Llama(jm.LlamaConfig.tiny(dtype=jnp.float32, **_over(
        ep_axis="ep", ep_size=N_EP)))
    mesh = _mesh()
    opt = optax.sgd(0.3)
    specs = j_specs(v, tp_axis=None, ep_axis="ep")
    ospecs = JF.optax_state_specs(opt, v, specs)
    step = JF.build_train_step(
        lambda p, b: jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            m2j.apply(p, b[0]), b[1])), opt, mesh, comm_mode="cta",
        topology=uniform_topology_spec(RingGraph(N_BF)), param_specs=specs,
        opt_state_specs=ospecs, donate=False)
    params = JF.rank_major(v, mesh, specs=specs)
    opt_state = JF.rank_major(opt.init(v), mesh, specs=ospecs)
    raw = np.random.RandomState(0).randint(0, 256, (N_BF, B, T + 1))
    sh = NamedSharding(mesh, P("bf"))
    batch = (jax.device_put(raw[..., :-1].astype(np.int32), sh),
             jax.device_put(raw[..., 1:].astype(np.int32), sh))
    j_losses = []
    for s in range(3):
        params, opt_state, loss = step(params, opt_state, batch,
                                       jnp.int32(s))
        j_losses.append(np.asarray(loss))

    _, model = _port_model(v, ep_axis="ep", ep_size=N_EP)
    backend = bt.StackedBackend(N_BF, device="cpu")
    state = model.state(release=True)
    t_specs = llama_param_specs(state, tp_axis=None, ep_axis="ep")
    t_params = bt.rank_major(state, backend, specs=t_specs)
    t_opt = torch.optim.SGD(t_params.values(), lr=0.3)
    t_step = bt.build_train_step(
        llama_loss_fn(model), t_opt, backend, comm_mode="cta",
        topology=TT.uniform_topology_spec(TT.RingGraph(N_BF)),
        mesh_axes=(EP,), param_specs=t_specs,
        opt_state_specs=TF.optax_state_specs(t_opt, state, t_specs))
    t_batch = (torch.from_numpy(raw[..., :-1].astype(np.int32)),
               torch.from_numpy(raw[..., 1:].astype(np.int32)))
    t_losses = []
    for s in range(3):
        t_params, t_opt, loss = t_step(t_params, t_opt, t_batch, s)
        t_losses.append(loss.numpy().copy())
    np.testing.assert_allclose(np.stack(t_losses), np.stack(j_losses),
                               rtol=1e-5)
    assert t_losses[-1].mean() < t_losses[0].mean()

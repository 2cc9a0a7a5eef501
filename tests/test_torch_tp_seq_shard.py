"""Sequence-parallel ACTIVATIONS under tp (``tp_seq_shard``) of the
port's Llama against the JAX package's ``tests/test_tp_seq_shard.py``,
on the same weights (``llama_params_from_flax``, both layer layouts) and
numpy-seeded tokens:

* the config guards (and the pipeline builder's ``ValueError`` for
  ``tp_seq_shard``, JAX's);
* the loss and EVERY gradient (the replicated norm scales, whose
  per-shard row-partial gradients must sum back to full, and the
  vocab-sharded embedding and head included) of the seq-sharded tp=2
  model against JAX's under ``shard_map`` on the 4 x 2 ("bf", "tp") CPU
  mesh and against the port's tp=1 model, for ``scan_layers`` False and
  True; the stream's seq-sharded layout ``[tp, B, T / tp, dim]``;
* dp 4 x tp 2 training through ``build_train_step(mesh_axes=,
  param_specs=, opt_state_specs=)`` (cta, Adam(1e-2), ``RingGraph(4)``):
  the losses of 3 steps against JAX's step.

Tolerances are JAX's (``tests/test_tp_seq_shard.py:100-111``): losses
``rtol = 1e-5`` (the losses of the steps too: Adam at 1e-2 moves each
weight by ~lr whatever the gradient's last bits, so the f32 noise of two
summation orders reaches the loss's 6th digit), gradients ``5e-5`` of
each leaf's largest entry."""

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

N_BF, N_TP, B, T = 4, 2, 2, 16
TP = bt.MeshAxis("tp", N_TP)
SEQ = dict(tp_axis="tp", tp_size=N_TP, vocab_parallel=True,
           tp_seq_shard=True)


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


def test_tp_seq_shard_guards():
    with pytest.raises(ValueError, match="tensor"):
        bt.LlamaConfig.tiny(tp_seq_shard=True)
    with pytest.raises(ValueError, match="vocab_parallel"):
        bt.LlamaConfig.tiny(tp_axis="tp", tp_size=2, tp_seq_shard=True)
    with pytest.raises(ValueError, match="redundant"):
        bt.LlamaConfig.tiny(attn_mode="ring", sp_axis="sp", **SEQ)
    with pytest.raises(ValueError, match="pipeline loss builder"):
        bt.models.llama_pp_loss_fn(
            bt.LlamaConfig.tiny(scan_layers=True, **SEQ), pp_axis="pp",
            n_stages=2, n_micro=2)


_REF = {}


def _ref(scan):
    """JAX's seq-sharded tp=2 losses and gradients per rank, one
    shard_map program per layer layout, shared by the module's tests."""
    if scan in _REF:
        return _REF[scan]
    cfg1 = jm.LlamaConfig.tiny(dtype=jnp.float32, scan_layers=scan)
    m2 = jm.Llama(jm.LlamaConfig.tiny(dtype=jnp.float32, scan_layers=scan,
                                      **SEQ))
    variables = jax.tree.map(np.asarray, jax.jit(jm.Llama(cfg1).init)(
        jax.random.PRNGKey(1), jnp.zeros((B, T), jnp.int32)))
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 256, (N_BF, B, T)).astype(np.int32)
    targets = rng.randint(0, 256, (N_BF, B, T)).astype(np.int32)
    mesh = _mesh()
    specs = j_specs(variables, vocab_axis="tp")
    params = JF.rank_major(variables, mesh, specs=specs)

    def shard(p, toks, tgt):
        local = jax.tree.map(lambda l: l[0], p)
        loss, g = jax.value_and_grad(
            lambda q: jm.vocab_parallel_xent(m2.apply(q, toks[0]), tgt[0],
                                             "tp"))(local)
        return loss[None], jax.tree.map(lambda l: l[None], g)

    sm = jax.shard_map(shard, mesh=mesh,
                       in_specs=(specs, P("bf"), P("bf")),
                       out_specs=(P("bf"), specs), check_vma=False)
    sh = NamedSharding(mesh, P("bf"))
    loss, grads = jax.jit(sm)(params, jax.device_put(tokens, sh),
                              jax.device_put(targets, sh))
    _REF[scan] = dict(variables=variables, tokens=tokens, targets=targets,
                      loss=np.asarray(loss),
                      grads=jax.tree.map(np.asarray, grads))
    return _REF[scan]


def _port_model(variables, scan, **over):
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, scan_layers=scan,
                              **over)
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, cfg,
                                                 device="cpu"))
    return cfg, model


@pytest.mark.parametrize("scan", [False, True])
def test_tp_seq_shard_loss_and_grads_match_jax_and_tp1(scan):
    """THE correctness test: the seq-sharded-activation loss AND every
    gradient equal JAX's and the port's unsharded model's for the same
    global params, unrolled and scanned layouts."""
    ref = _ref(scan)
    cfg1, m1 = _port_model(ref["variables"], scan)
    _, m2 = _port_model(ref["variables"], scan, **SEQ)
    params = m1.state()
    for r in range(N_BF):
        toks = torch.from_numpy(ref["tokens"][r])
        tgt = torch.from_numpy(ref["targets"][r])
        out = {}
        for name, model, axis in (("tp1", m1, None), ("tp2", m2, TP)):
            p = {k: v.clone().requires_grad_(True)
                 for k, v in params.items()}
            with bt.bind_axis(axis) if axis else torch.enable_grad():
                loss = llama_loss_fn(model)(p, (toks, tgt))
                g = torch.autograd.grad(loss, list(p.values()))
            out[name] = (loss.item(), dict(zip(p, g)))
        np.testing.assert_allclose(out["tp2"][0], ref["loss"][r],
                                   rtol=1e-5)
        np.testing.assert_allclose(out["tp2"][0], out["tp1"][0],
                                   rtol=1e-5)
        want = llama_params_from_flax(
            jax.tree.map(lambda x: x[r], ref["grads"]), cfg1, device="cpu")
        for what, ref_g in (("JAX", want), ("tp1", out["tp1"][1])):
            for k, w in ref_g.items():
                scale = max(float(w.abs().max()), 1e-6)
                np.testing.assert_allclose(
                    (out["tp2"][1][k] / scale).numpy(),
                    (w / scale).numpy(), rtol=0, atol=5e-5,
                    err_msg=f"rank {r} against {what}: {k}")


def test_tp_seq_shard_stream_is_seq_sharded():
    """The residual stream (``return_hidden``) lives seq-sharded,
    shard-major ``[tp, B, T / tp, dim]``: shard s holds rows s * T / tp
    .. of the unsharded model's hidden states; a length that does not
    divide by tp is refused."""
    ref = _ref(False)
    _, m1 = _port_model(ref["variables"], False)
    _, m2 = _port_model(ref["variables"], False, **SEQ)
    toks = torch.from_numpy(ref["tokens"][0])
    with torch.no_grad():
        want = m1(toks, return_hidden=True)
        with bt.bind_axis(TP):
            got = m2(toks, return_hidden=True)
            with pytest.raises(ValueError, match="divide"):
                m2(toks[:, :15])
    assert got.shape == (N_TP, B, T // N_TP, 64)
    np.testing.assert_allclose(got.movedim(0, 1).flatten(1, 2), want,
                               rtol=2e-4, atol=2e-4)


def test_tp_seq_shard_trains_like_jax():
    """dp 4 x tp 2 decentralized training with seq-sharded activations
    through the real build_train_step: the losses of 3 Adam steps equal
    JAX's step (scanned layout on the JAX side, as its test trains)."""
    ref = _ref(True)
    v = ref["variables"]
    m2 = jm.Llama(jm.LlamaConfig.tiny(dtype=jnp.float32, scan_layers=True,
                                      **SEQ))
    mesh = _mesh()
    opt = optax.adam(1e-2)
    specs = j_specs(v, vocab_axis="tp")
    ospecs = JF.optax_state_specs(opt, v, specs)
    step = JF.build_train_step(
        lambda p, b: jm.vocab_parallel_xent(m2.apply(p, b[0]), b[1], "tp"),
        opt, mesh, comm_mode="cta",
        topology=uniform_topology_spec(RingGraph(N_BF)),
        batch_specs=P("bf"), param_specs=specs, opt_state_specs=ospecs,
        donate=False)
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

    _, model = _port_model(v, True, **SEQ)
    backend = bt.StackedBackend(N_BF, device="cpu")
    state = model.state(release=True)
    t_specs = llama_param_specs(state, vocab_axis="tp")
    t_params = bt.rank_major(state, backend, specs=t_specs)
    t_opt = torch.optim.Adam(t_params.values(), lr=1e-2)
    t_step = bt.build_train_step(
        llama_loss_fn(model), t_opt, backend, comm_mode="cta",
        topology=TT.uniform_topology_spec(TT.RingGraph(N_BF)),
        mesh_axes=(TP,), batch_specs=("bf",), param_specs=t_specs,
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

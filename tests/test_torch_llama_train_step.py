"""Decentralized Llama training through the port's ``build_train_step``
(stacked backend) against the JAX package's on a 2-device CPU mesh: the
tiny f32 Llama with ``attn_impl="flash"`` (JAX: the Pallas kernels in
interpret mode; the port: the kernels' plain versions on CPU tensors),
the plain next-token loss (``llama_loss_fn`` /
``examples/llama_benchmark.py``'s), SGD(0.1, momentum 0.9) on both sides
(``optax.sgd`` / ``torch.optim.SGD(dampening=0)``), the same initial
parameters (``llama_params_from_flax``) and different per-rank batches,
3 steps of none / atc / cta / gradient_allreduce.

Tolerance: 1e-4 of each leaf's largest entry, for params and momentum
(the accumulated gradients), per rank; losses 1e-5 (f32 matmuls summed
in another order, carried through three momentum steps)."""

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

N, B, T, STEPS, LR = 2, 2, 32, 3, 0.1
OVER = dict(attn_impl="flash", attn_flash_block_size=16,
            attn_flash_block_k=16, scan_layers=True)


def _setup():
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32, **OVER)
    variables = jax.tree.map(np.asarray, jm.Llama(cfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32)))
    raw = np.random.RandomState(0).randint(0, 256, (N, B, T + 1))
    return cfg, variables, raw[..., :-1].astype(np.int32), \
        raw[..., 1:].astype(np.int32)


def _topo(mode, mod):
    if mode in ("atc", "cta"):
        return dict(topology=mod.uniform_topology_spec(
            mod.ExponentialTwoGraph(N)))
    return {}


def _run_jax(cfg, variables, inp, tgt, mode):
    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))
    model = jm.Llama(cfg)

    def loss_fn(params, batch):
        logits = model.apply(params, batch[0])
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, batch[1]))

    opt = optax.sgd(LR, momentum=0.9)
    step = JF.build_train_step(loss_fn, opt, mesh, comm_mode=mode,
                               **_topo(mode, JT))
    params = JF.rank_major(variables, mesh)
    opt_state = JF.rank_major(opt.init(variables), mesh)
    sh = NamedSharding(mesh, P("bf"))
    batch = (jax.device_put(jnp.asarray(inp), sh),
             jax.device_put(jnp.asarray(tgt), sh))
    losses = []
    for s in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch,
                                       jnp.int32(s))
        losses.append(np.asarray(loss))
    return (jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, opt_state[0].trace), np.stack(losses))


def _run_port(variables, inp, tgt, mode):
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32, **OVER)
    model = bt.Llama(tcfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, tcfg,
                                                 device="cpu"))
    backend = bt.StackedBackend(N, device="cpu")
    params = bt.rank_major(model.state(release=True), backend)
    opt = torch.optim.SGD(params.values(), lr=LR, momentum=0.9)
    step = bt.build_train_step(llama_loss_fn(model), opt, backend,
                               comm_mode=mode, **_topo(mode, bt))
    batch = (torch.from_numpy(inp), torch.from_numpy(tgt))
    losses = []
    for s in range(STEPS):
        params, opt, loss = step(params, opt, batch, s)
        assert loss.shape == (N,) and loss.dtype == torch.float32
        losses.append(loss.numpy().copy())
    mom = {k: opt.state[p]["momentum_buffer"] for k, p in params.items()}
    return tcfg, params, mom, np.stack(losses)


@pytest.mark.parametrize("mode", ["none", "atc", "cta",
                                  "gradient_allreduce"])
def test_llama_train_step_matches_jax(mode):
    cfg, variables, inp, tgt = _setup()
    j_params, j_mom, j_loss = _run_jax(cfg, variables, inp, tgt, mode)
    tcfg, t_params, t_mom, t_loss = _run_port(variables, inp, tgt, mode)
    np.testing.assert_allclose(t_loss, j_loss, rtol=0, atol=1e-5)
    for what, jt, tt in (("params", j_params, t_params),
                         ("momentum", j_mom, t_mom)):
        for r in range(N):
            want = llama_params_from_flax(
                jax.tree.map(lambda x: x[r], jt), tcfg, device="cpu")
            for k, w in want.items():
                scale = max(float(w.abs().max()), 1e-12)
                np.testing.assert_allclose(
                    tt[k][r].numpy(), w.numpy(), rtol=0, atol=1e-4 * scale,
                    err_msg=f"{what} rank {r} {k}")
    if mode in ("atc", "gradient_allreduce"):
        # the last thing each step does is average the 2 ranks (atc: one
        # neighbor at weight 1/2) or update both from the mean gradient
        assert float(bt.consensus_distance(t_params)) < 1e-10

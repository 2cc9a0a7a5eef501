"""``remat_policy="dots"`` in the port's Llama (bluefog_tpu_torch/models/
llama.py): JAX's ``checkpoint_dots_with_no_batch_dims`` as a selective
activation-checkpoint policy.  On ``LlamaConfig.tiny`` in f32 it gives
the loss and gradients of no remat (1e-6 of each leaf's largest entry:
the same f32 operations, the recompute included) and of the JAX model
under the same policy with carried-over weights (1e-5: f32 sums in
another order), and what it saves are the outputs of the projections,
the ``aten.mm`` calls: its backward recomputes none of them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from bluefog_tpu import models as jm
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models import llama as tllama

B, T = 2, 128   # splash needs a multiple of 128


@functools.lru_cache(maxsize=None)
def _variables():
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    return jax.tree.map(np.asarray, jm.Llama(cfg).init(
        jax.random.PRNGKey(5), jnp.zeros((B, 8), jnp.int32)))


def _model(**over):
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, **over)
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(_variables(), cfg,
                                                 device="cpu"))
    return model


def _batch():
    raw = np.random.RandomState(3).randint(0, 256, (B, T + 1))
    return raw[:, :-1].astype(np.int32), raw[:, 1:].astype(np.int32)


def _loss_and_grads(model, backward_mode=None):
    params = {k: v.requires_grad_(True) for k, v in model.state().items()}
    inp, tgt = (torch.from_numpy(x) for x in _batch())
    loss = tllama.llama_loss_fn(model)(params, (inp, tgt))
    if backward_mode is None:
        grads = torch.autograd.grad(loss, list(params.values()))
    else:
        with backward_mode:
            grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def _close(got, want, rel):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=rel * float(w.abs().max()) + 1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "flash", "splash"])
def test_dots_gives_the_gradients_of_no_remat(impl):
    over = dict(attn_impl=impl)
    a_loss, a = _loss_and_grads(_model(**over))
    b_loss, b = _loss_and_grads(_model(remat=True, remat_policy="dots",
                                       **over))
    assert abs(a_loss - b_loss) <= 1e-6 * abs(a_loss)
    _close(b, a, 1e-6)


def test_dots_matches_jax_dots():
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32, remat=True,
                              remat_policy="dots")
    inp, tgt = _batch()

    def loss_fn(p):
        logits = jm.Llama(cfg).apply(p, jnp.asarray(inp))
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(tgt)))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(_variables())
    model = _model(remat=True, remat_policy="dots")
    t_loss, t_grads = _loss_and_grads(model)
    assert abs(t_loss - float(j_loss)) < 1e-5
    want = llama_params_from_flax(jax.tree.map(np.asarray, j_grads),
                                  model.cfg, device="cpu")
    _close(t_grads, want, 1e-5)


class _CountMM(TorchDispatchMode):
    """Counts the ``aten.mm`` calls run under it."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func == torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def test_dots_saves_the_projections_and_recomputes_the_rest(monkeypatch):
    """The policy marks exactly the seven projections of each block
    (``aten.mm``) to be saved, and batched products (``aten.bmm``, the
    xla attention) to be recomputed; the backward under "dots" runs the
    mm calls of no remat, where a full recompute re-runs the projections
    (all but the block's last, whose output the backward does not need:
    the recompute stops early)."""
    seen = []
    policy = tllama._dots_policy

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append((op, decision))
        return decision

    monkeypatch.setattr(tllama, "_dots_policy", recording)
    n_layers = bt.LlamaConfig.tiny().n_layers
    counts = {}
    for name, over in (("plain", {}), ("dots", dict(remat=True,
                                                    remat_policy="dots")),
                       ("none", dict(remat=True))):
        mode = _CountMM()
        _loss_and_grads(_model(**over), mode)
        counts[name] = mode.mm
    saved = [op for op, d in seen if d == CheckpointPolicy.MUST_SAVE]
    assert saved == [torch.ops.aten.mm.default] * (7 * n_layers)
    assert torch.ops.aten.bmm.default in {
        op for op, d in seen if d == CheckpointPolicy.PREFER_RECOMPUTE}
    assert counts["dots"] == counts["plain"]
    assert counts["none"] >= counts["plain"] + 6 * n_layers

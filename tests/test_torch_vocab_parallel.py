"""Vocab parallelism of the port's Llama against the JAX package's
``tests/test_vocab_parallel.py`` (its pipeline case, tp x pp, is
``tests/test_torch_pp_compose.py``'s), on the same weights
(``llama_params_from_flax``) and numpy-seeded tokens:

* the config guards and ``llama_param_specs(vocab_axis="tp")``;
* ``vocab_parallel_xent`` alone, its loss and logit gradients against
  JAX's on a 2-device ("tp",) mesh;
* the loss and every gradient of the vocab-parallel tp=2 model (the
  sharded embedding lookup, the tp blocks, the sharded head and the
  exact cross-entropy) against JAX's under ``shard_map`` on the 4 x 2
  ("bf", "tp") CPU mesh and against the port's tp=1 plain
  cross-entropy; its shard-major logits columns are the tp=1 logits;
* a vocab-parallel checkpoint decoding under the tp=1 decode layout.

Tolerances are JAX's (``tests/test_vocab_parallel.py:90-101``): losses
``rtol = 1e-5``, gradients ``5e-5`` of each leaf's largest entry; logits
``2e-4`` (``tests/test_tp.py:58``)."""

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
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models.llama import (llama_loss_fn,
                                            llama_param_specs,
                                            vocab_parallel_xent)

N_BF, N_TP, B, T = 4, 2, 2, 16
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


def test_vocab_parallel_requires_tp():
    with pytest.raises(ValueError, match="tensor"):
        bt.LlamaConfig.tiny(vocab_parallel=True)
    with pytest.raises(ValueError, match="decode"):
        bt.LlamaConfig.tiny(tp_axis="tp", tp_size=2, vocab_parallel=True,
                            decode=True)
    with pytest.raises(ValueError, match="divide"):
        bt.LlamaConfig.tiny(tp_axis="tp", tp_size=3, n_heads=6,
                            n_kv_heads=3, hidden_dim=96, vocab_size=256,
                            vocab_parallel=True)


def test_vocab_parallel_specs():
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    state = bt.Llama(cfg, device="cpu").state()
    specs = llama_param_specs(state, vocab_axis="tp")
    assert specs["tok_embeddings.embedding"] == ("bf", "tp")
    assert specs["output.kernel"] == ("bf", None, "tp")
    jcfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.Llama(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    want = j_specs(shapes, vocab_axis="tp")["params"]
    assert tuple(want["tok_embeddings"]["embedding"]) == ("bf", "tp")
    assert tuple(want["output"]["kernel"]) == ("bf", None, "tp")


def test_vocab_parallel_xent_matches_jax():
    """The exact cross-entropy over vocab-sharded logits: its loss and
    each shard's logit gradient equal JAX's ``vocab_parallel_xent`` under
    ``shard_map`` (one pmax without gradient, two psums)."""
    rng = np.random.RandomState(5)
    v = 64
    logits = (rng.randn(B, T, v) * 3).astype(np.float32)
    targets = rng.randint(0, v, (B, T)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:N_TP]), ("tp",))

    def shard(lg, tgt):
        return jax.value_and_grad(
            lambda x: jm.vocab_parallel_xent(x, tgt, "tp"))(lg)

    loss, grad = jax.jit(jax.shard_map(
        shard, mesh=mesh, in_specs=(P(None, None, "tp"), P()),
        out_specs=(P(), P(None, None, "tp")), check_vma=False))(
            logits, targets)
    local = torch.from_numpy(logits).unflatten(-1, (N_TP, v // N_TP))
    local = local.movedim(-2, 0).contiguous().requires_grad_(True)
    got = vocab_parallel_xent(local, torch.from_numpy(targets), TP)
    (g,) = torch.autograd.grad(got, [local])
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-6)
    np.testing.assert_allclose(g.movedim(0, -2).flatten(-2).numpy(),
                               np.asarray(grad), rtol=0, atol=1e-7)
    plain = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits).reshape(-1, v),
        torch.from_numpy(targets).reshape(-1).long())
    np.testing.assert_allclose(got.item(), float(plain), rtol=1e-6)


@pytest.fixture(scope="module")
def ref():
    """The tiny f32 Llama's init, tokens, and JAX's vocab-parallel tp=2
    loss and gradients per rank (one shard_map program)."""
    cfg1 = jm.LlamaConfig.tiny(dtype=jnp.float32)
    cfg2 = jm.LlamaConfig.tiny(dtype=jnp.float32, tp_axis="tp",
                               tp_size=N_TP, vocab_parallel=True)
    m2 = jm.Llama(cfg2)
    variables = jax.tree.map(np.asarray, jax.jit(jm.Llama(cfg1).init)(
        jax.random.PRNGKey(1), jnp.zeros((B, T), jnp.int32)))
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 256, (N_BF, B, T)).astype(np.int32)
    targets = rng.randint(0, 256, (N_BF, B, T)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(N_BF, N_TP),
                ("bf", "tp"))
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
    return dict(variables=variables, tokens=tokens, targets=targets,
                loss=np.asarray(loss), grads=jax.tree.map(np.asarray, grads))


def _port_model(variables, **over):
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, **over)
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, cfg,
                                                 device="cpu"))
    return cfg, model


def test_vocab_parallel_loss_and_grads_match_jax_and_tp1(ref):
    """Loss AND gradients through the vocab-parallel model equal JAX's
    vocab-parallel tp=2 shard_map and the port's unsharded model's CE
    for the same global params; the shard-major logits columns, put
    side by side, are the unsharded logits."""
    cfg1, m1 = _port_model(ref["variables"])
    _, m2 = _port_model(ref["variables"], tp_axis="tp", tp_size=N_TP,
                        vocab_parallel=True)
    params = m1.state()
    for r in range(N_BF):
        toks = torch.from_numpy(ref["tokens"][r])
        tgt = torch.from_numpy(ref["targets"][r])
        out = {}
        for name, model, axis in (("tp1", m1, None), ("tp2", m2, TP)):
            p = {k: v.clone().requires_grad_(True)
                 for k, v in params.items()}
            with bt.bind_axis(axis) if axis else torch.enable_grad():
                logits = model.apply(p, toks).detach()
                loss = llama_loss_fn(model)(p, (toks, tgt))
                g = torch.autograd.grad(loss, list(p.values()))
            out[name] = (logits, loss.item(), dict(zip(p, g)))
        logits2 = out["tp2"][0]
        assert logits2.shape == (N_TP, B, T, 256 // N_TP)
        np.testing.assert_allclose(logits2.movedim(0, -2).flatten(-2),
                                   out["tp1"][0], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out["tp2"][1], ref["loss"][r],
                                   rtol=1e-5)
        np.testing.assert_allclose(out["tp2"][1], out["tp1"][1],
                                   rtol=1e-5)
        want = llama_params_from_flax(
            jax.tree.map(lambda x: x[r], ref["grads"]), cfg1, device="cpu")
        for what, ref_g in (("JAX", want), ("tp1", out["tp1"][2])):
            for k, w in ref_g.items():
                scale = max(float(w.abs().max()), 1e-6)
                np.testing.assert_allclose(
                    (out["tp2"][2][k] / scale).numpy(),
                    (w / scale).numpy(), rtol=0, atol=5e-5,
                    err_msg=f"rank {r} against {what}: {k}")


def test_vocab_parallel_checkpoint_decodes(ref):
    """The prescribed flow: train with vocab_parallel, serve through the
    replicated head: ``llama_generate`` clears the training-only layout
    knob (the param tree is identical), and decodes as the tp=1 config."""
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, tp_axis="tp",
                              tp_size=2, vocab_parallel=True)
    _, m1 = _port_model(ref["variables"])
    state = m1.state()
    prompt = torch.from_numpy(ref["tokens"][0][:1, :4])
    out = bt.llama_generate(state, cfg, prompt, 4, device="cpu")
    assert out.shape == (1, 8)
    plain = bt.llama_generate(state, bt.LlamaConfig.tiny(
        dtype=torch.float32), prompt, 4, device="cpu")
    assert torch.equal(out, plain)

"""The port's Llama training forward and losses (bluefog_tpu_torch/models/
llama.py) against the JAX model on ``LlamaConfig.tiny`` in f32, T <= 64
with 16-wide attention blocks: the same parameters (the JAX init,
converted by ``llama_params_from_flax``) and the same tokens give the
same logits for ``attn_impl`` xla and flash (the JAX flash kernels in
interpret mode; the port's on CPU tensors run their plain versions),
``attn_mode="blockwise"``, llama3 rope and both layer layouts (atol =
rtol = 1e-4: f32 matmuls summed in another order), and the same loss and
gradient of every leaf (1e-4 of each leaf's largest entry)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bluefog_tpu import models as jm
from bluefog_tpu.models import llama as jllama
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models import llama as tllama

B, T = 2, 32
BLOCKS = dict(attn_flash_block_size=16, attn_flash_block_k=16,
              attn_block_size=16)


@functools.lru_cache(maxsize=None)
def _variables(scan_layers):
    """The JAX init (numpy leaves) of the tiny f32 model; the other knobs
    do not change the param tree."""
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32, scan_layers=scan_layers)
    return jax.tree.map(np.asarray, jm.Llama(cfg).init(
        jax.random.PRNGKey(2), jnp.zeros((B, 8), jnp.int32)))


def _models(**over):
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32, **BLOCKS, **over)
    variables = _variables(cfg.scan_layers)
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32, **BLOCKS, **over)
    model = bt.Llama(tcfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, tcfg,
                                                 device="cpu"))
    return cfg, variables, model


def _batch(seed=0, t=T):
    raw = np.random.RandomState(seed).randint(0, 256, (B, t + 1))
    return raw[:, :-1].astype(np.int32), raw[:, 1:].astype(np.int32)


CONFIGS = {
    "xla": {},
    "flash": dict(attn_impl="flash"),
    "blockwise": dict(attn_mode="blockwise"),
    "flash_llama3_scan": dict(attn_impl="flash", rope_scaling_kind="llama3",
                              rope_scaling_original_max_len=64,
                              scan_layers=True),
    "xla_scan_bf16_head": dict(scan_layers=True, logits_dot_in_fp32=False),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_training_logits_match_jax(name):
    cfg, variables, model = _models(**CONFIGS[name])
    inp, _ = _batch()
    ref = jax.jit(lambda v, x: jm.Llama(cfg).apply(v, x, pos_offset=5))(
        variables, jnp.asarray(inp))
    out = model(torch.from_numpy(inp), pos_offset=5)
    assert out.shape == (B, T, 256) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
    # return_hidden stops before the head: the logits are its product
    hidden = model(torch.from_numpy(inp), pos_offset=5, return_hidden=True)
    head = hidden.to(model.output.dtype) @ model.output.kernel.to(
        model.output.dtype)
    assert torch.equal(head.float(), out)


def _jax_loss_and_grads(cfg, variables, inp, tgt):
    model = jm.Llama(cfg)

    def loss_fn(params):
        logits = model.apply(params, jnp.asarray(inp))
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(tgt)))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables)
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(model, loss_fn, inp, tgt):
    params = {k: v.requires_grad_(True) for k, v in model.state().items()}
    loss = loss_fn(params, (torch.from_numpy(inp), torch.from_numpy(tgt)))
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def _close_leaves(got, want, rel=1e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.numpy() if isinstance(w, torch.Tensor) else w
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=rel * scale, err_msg=k)


@pytest.mark.parametrize("name", ["xla", "flash", "flash_llama3_scan"])
def test_loss_and_gradients_match_jax(name):
    cfg, variables, model = _models(**CONFIGS[name])
    inp, tgt = _batch(1)
    j_loss, j_grads = _jax_loss_and_grads(cfg, variables, inp, tgt)
    t_loss, t_grads = _port_loss_and_grads(
        model, tllama.llama_loss_fn(model), inp, tgt)
    assert abs(t_loss - j_loss) < 1e-5
    want = llama_params_from_flax(j_grads, model.cfg, device="cpu")
    _close_leaves(t_grads, want)


@pytest.mark.parametrize("policy", ["none", "everything"])
def test_remat_gives_the_same_gradients(policy):
    """``remat=True`` recomputes each block in the backward; the
    gradients are those without it (the same f32 operations)."""
    _, _, plain = _models(attn_impl="flash")
    _, _, remat = _models(attn_impl="flash", remat=True,
                          remat_policy=policy)
    inp, tgt = _batch(2)
    a_loss, a = _port_loss_and_grads(plain, tllama.llama_loss_fn(plain),
                                     inp, tgt)
    b_loss, b = _port_loss_and_grads(remat, tllama.llama_loss_fn(remat),
                                     inp, tgt)
    assert a_loss == b_loss
    _close_leaves(b, a, rel=1e-6)


@pytest.mark.parametrize("fp32", [True, False])
def test_chunked_xent_equals_the_plain_loss(fp32):
    """``llama_chunked_xent_loss_fn`` gives the plain loss and its
    gradients (the same f32 softmax over each chunk), and matches the
    JAX ``chunked_xent`` on the same hidden states."""
    _, _, model = _models(attn_impl="flash", logits_dot_in_fp32=fp32)
    inp, tgt = _batch(3)
    p_loss, p_grads = _port_loss_and_grads(
        model, tllama.llama_loss_fn(model), inp, tgt)
    c_loss, c_grads = _port_loss_and_grads(
        model, tllama.llama_chunked_xent_loss_fn(model, n_chunks=4), inp,
        tgt)
    assert abs(c_loss - p_loss) < 1e-6
    _close_leaves(c_grads, p_grads, rel=1e-5)
    rng = np.random.RandomState(4)
    h = rng.randn(B, T, 64).astype(np.float32)
    w = (rng.randn(64, 256) * 0.1).astype(np.float32)
    ref = jllama.chunked_xent(jnp.asarray(h), jnp.asarray(w),
                              jnp.asarray(tgt), n_chunks=4,
                              dot_in_fp32=fp32)
    out = tllama.chunked_xent(torch.from_numpy(h), torch.from_numpy(w),
                              torch.from_numpy(tgt), n_chunks=4,
                              dot_in_fp32=fp32)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    with pytest.raises(ValueError, match="n_chunks"):
        tllama.chunked_xent(torch.from_numpy(h), torch.from_numpy(w),
                            torch.from_numpy(tgt), n_chunks=5)


def test_f32_masters_load_without_rounding():
    """A bf16-compute model with ``param_dtype=torch.float32`` holds the
    flax f32 params bit for bit (flax's ``param_dtype=float32``); the
    default serving layout stores the projections in bf16."""
    variables = _variables(False)   # flax's params are f32 at any dtype
    tcfg = bt.LlamaConfig.tiny()
    state = llama_params_from_flax(variables, tcfg, device="cpu")
    model = bt.Llama(tcfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(state)
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32, k
        assert torch.equal(v, state[k]), k
    serving = bt.Llama(tcfg, device="cpu")
    assert serving.layers[0].attention.wq.kernel.dtype == torch.bfloat16
    assert serving.output.kernel.dtype == torch.float32


def test_released_state_is_the_one_copy():
    """``state(release=True)`` hands the parameters over: the module
    keeps meta placeholders and still runs ``apply`` on the state."""
    _, _, model = _models(attn_impl="flash")
    inp, _ = _batch(5)
    want = model(torch.from_numpy(inp)).detach()
    params = model.state(release=True)
    assert all(p.is_meta for p in model.parameters())
    assert not any(v.is_meta for v in params.values())
    got = model.apply(params, torch.from_numpy(inp))
    assert torch.equal(got, want)


@pytest.mark.parametrize("over,match", [
    (dict(tp_size=2, tp_axis="tp"), "tensor parallelism"),
    (dict(tp_size=2, tp_axis="tp", vocab_parallel=True), "TP decode"),
    (dict(n_experts=2, moe_top_k=1, ep_axis="ep", ep_size=2), "MoE"),
    (dict(n_experts=2, ep_axis="ep", ep_size=2), "moe/"),
])
def test_unported_training_knobs_raise_naming_their_item(over, match):
    """splash (K5), remat_policy="dots", ring/Ulysses attention and the
    routed MoE at ep_size 1 are ported (tests/test_torch_splash.py,
    tests/test_torch_remat.py, tests/test_torch_llama_sp.py,
    tests/test_torch_moe.py), and since slice 17 the model axes
    (``match``: tensor parallelism, its vocab-parallel head, MoE over an
    expert axis; tests/test_torch_tp.py, tests/test_torch_moe_ep.py):
    each config now trains, its loss and gradients with the axis bound
    equal to the unsharded model's on the same weights."""
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, **over)
    plain = dataclasses.replace(cfg, tp_axis=None, tp_size=1, ep_axis=None,
                                ep_size=1, vocab_parallel=False)
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32)
    ref = bt.Llama(plain, device="cpu", param_dtype=torch.float32)
    params = model.state()
    g = torch.Generator().manual_seed(1)
    batch = (torch.randint(0, 256, (2, 8), generator=g),
             torch.randint(0, 256, (2, 8), generator=g))
    out = []
    for m, axis in ((model, cfg.tp_axis or cfg.ep_axis), (ref, None)):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        with bt.bind_axis(bt.MeshAxis(axis, 2)) if axis else \
                torch.enable_grad():
            loss = tllama.llama_loss_fn(m)(p, batch)
            out.append((loss.item(), torch.autograd.grad(
                loss, list(p.values()))))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5,
                               err_msg=match)
    for k, a, b in zip(params, out[0][1], out[1][1]):
        scale = max(float(b.abs().max()), 1e-6)
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                   rtol=0, atol=5e-5, err_msg=k)


def test_decode_config_needs_a_cache():
    model = bt.Llama(bt.LlamaConfig.tiny(decode=True), device="cpu")
    with pytest.raises(ValueError, match="KVCache"):
        model(torch.zeros(1, 4, dtype=torch.long))

"""The port's ViT (bluefog_tpu_torch/models/vit.py) against the JAX model
(bluefog_tpu/models/vit.py) on ``ViTConfig.tiny``: the same parameters
(the JAX init, converted by ``interop.vit_params_from_flax``) and the
same numpy images give the same logits and the same gradient of every
leaf.  Attention ``xla`` and ``blockwise`` hold 1e-5 (f32 sums in
another order); ``flash`` holds 1e-4 against the JAX flash kernels in
interpret mode (the port's wrappers run their plain versions on CPU
tensors), the tolerance of ``tests/test_models.py``'s flash case.
Gradients are held to the same fraction of each leaf's largest entry
(plus a floor for the leaves that are zero in exact arithmetic).
The register-token counts and both poolings follow the JAX model."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.models import vit as jvit
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import vit_params_from_flax

B = 2


def _images(seed=0, size=32):
    return np.random.RandomState(seed).randn(B, size, size, 3).astype(
        np.float32)


def _cfgs(**over):
    jcfg = jvit.ViTConfig.tiny(dtype=jnp.float32, **over)
    tcfg = bt.ViTConfig.tiny(dtype=torch.float32, **over)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _variables(pool="cls", n_register_tokens="auto"):
    """The JAX init (numpy leaves); attention knobs do not change it."""
    jcfg, _ = _cfgs(pool=pool, n_register_tokens=n_register_tokens)
    return jax.tree.map(np.asarray, jvit.ViT(jcfg).init(
        jax.random.PRNGKey(3), jnp.asarray(_images())))


def _models(**over):
    jcfg, tcfg = _cfgs(**over)
    variables = _variables(over.get("pool", "cls"),
                           over.get("n_register_tokens", "auto"))
    model = bt.ViT(tcfg, device="cpu")
    model.load_state_dict(vit_params_from_flax(variables, model,
                                               device="cpu"))
    return jcfg, variables, model


CONFIGS = {
    "xla": ({}, 1e-5),
    "blockwise": (dict(attn_mode="blockwise", attn_block_size=12), 1e-5),
    "flash": (dict(attn_impl="flash", attn_block_size=8), 1e-4),
    "gap": (dict(pool="gap"), 1e-5),
}


def _jax_loss_and_grads(jcfg, variables, images, labels):
    model = jvit.ViT(jcfg)

    def loss_fn(params):
        logits = model.apply(params, jnp.asarray(images))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels)[:, None], axis=1))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_and_gradients_match_jax(name):
    over, tol = CONFIGS[name]
    jcfg, variables, model = _models(**over)
    images = _images(1)
    labels = np.array([3, 7])
    ref = jax.jit(lambda v, x: jvit.ViT(jcfg).apply(v, x))(
        variables, jnp.asarray(images))
    out = model(torch.from_numpy(images))
    assert out.shape == (B, 10) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol,
                               rtol=tol)

    j_loss, j_grads = _jax_loss_and_grads(jcfg, variables, images, labels)
    params = {k: v.requires_grad_(True) for k, v in model.state().items()}
    logits = model.apply(params, torch.from_numpy(images))
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(labels))
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    assert abs(float(loss.detach()) - j_loss) < tol
    want = vit_params_from_flax(j_grads, model, device="cpu")
    assert set(grads) == set(want)
    # the key bias's gradient is zero in exact arithmetic (softmax does
    # not see a shift shared by every key): f32 noise, held to a floor of
    # 1e-6 of the model's largest gradient entry
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(
            grads[k].numpy(), w.numpy(), rtol=0,
            atol=tol * float(w.abs().max()) + floor, err_msg=k)


@pytest.mark.parametrize("pool,regs,n_reg", [
    ("cls", "auto", 7),     # 16 patches + cls = 17 tokens -> 24
    ("gap", "auto", 0),     # 16 tokens: already 8-aligned
    ("cls", 0, 0),
    ("gap", 3, 3),
])
def test_register_tokens_follow_the_geometry(pool, regs, n_reg):
    """"auto" pads the token count to a multiple of 8 from the geometry
    alone; ``pos_embed`` covers the tokens before the registers; the
    parameter tree is the JAX model's (the converter checks every
    shape), and the logits agree."""
    _, variables, model = _models(pool=pool, n_register_tokens=regs)
    t = 16 + (pool == "cls")
    assert model.n_reg == n_reg and model.n_tokens == t
    assert model.pos_embed.shape == (1, t, 64)
    assert ("reg_tokens" in dict(model.named_parameters())) == bool(n_reg)
    assert ("cls_token" in dict(model.named_parameters())) == (pool == "cls")
    jcfg, _ = _cfgs(pool=pool, n_register_tokens=regs)
    images = _images(2)
    ref = jvit.ViT(jcfg).apply(variables, jnp.asarray(images))
    np.testing.assert_allclose(model(torch.from_numpy(images)).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_registers_are_dropped_before_pooling():
    """The registers shape the tokens' attention but are never pooled:
    with "gap", changing a register token moves the logits only through
    attention, and a model whose registers are zeroed differs from one
    without registers (they are attended to)."""
    _, _, model = _models(pool="gap", n_register_tokens=3)
    images = torch.from_numpy(_images(4))
    base = model(images)
    with torch.no_grad():
        model.reg_tokens.zero_()
    moved = model(images)
    assert not torch.allclose(base, moved)


def test_bf16_compute_matches_jax_bf16():
    """bf16 compute over f32 params in both packages (LayerNorm statistics
    in f32, Dense products and bias adds in bf16, the f32 head).
    Tolerance: 2e-2 of the logits' scale, bf16's rounding through two
    blocks."""
    jcfg = jvit.ViTConfig.tiny(dtype=jnp.bfloat16)
    tcfg = bt.ViTConfig.tiny(dtype=torch.bfloat16)
    variables = _variables()
    model = bt.ViT(tcfg, device="cpu")
    model.load_state_dict(vit_params_from_flax(variables, model,
                                               device="cpu"))
    images = _images(5)
    ref = np.asarray(jvit.ViT(jcfg).apply(variables, jnp.asarray(images)))
    out = model(torch.from_numpy(images))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())


def test_layernorm_is_flax_layernorm():
    """eps 1e-6 and f32 statistics, against flax's LayerNorm directly."""
    from flax import linen as nn

    x = (np.random.RandomState(6).randn(3, 5, 64) * 3 + 1).astype(
        np.float32)
    ln = nn.LayerNorm(dtype=jnp.float32, param_dtype=jnp.float32)
    variables = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = ln.apply(variables, jnp.asarray(x))
    port = bt.models.vit.LayerNorm(64, torch.float32, "cpu")
    assert port.eps == 1e-6
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_odd_image_size_pads_like_flax_same():
    """An image side that the patch does not divide is padded as flax's
    "SAME" conv pads it (36 / 8 -> 5 patches per side)."""
    jcfg, tcfg = (dataclasses.replace(c, image_size=36) for c in _cfgs())
    images = np.random.RandomState(7).randn(B, 36, 36, 3).astype(np.float32)
    variables = jax.tree.map(np.asarray, jvit.ViT(jcfg).init(
        jax.random.PRNGKey(4), jnp.asarray(images)))
    model = bt.ViT(tcfg, device="cpu")
    model.load_state_dict(vit_params_from_flax(variables, model,
                                               device="cpu"))
    assert model.n_tokens == 26
    ref = jvit.ViT(jcfg).apply(variables, jnp.asarray(images))
    np.testing.assert_allclose(model(torch.from_numpy(images)).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_factories_and_refusals():
    assert bt.ViTConfig.base().dim == 768 and bt.ViTConfig.small().n_heads == 6
    assert bt.ViTConfig.base().head_dim == 64
    model = bt.ViT_S16(device="cpu", image_size=32, num_classes=5)
    assert model.cfg.dim == 384 and model.n_tokens == 5 and model.n_reg == 3
    # the factories fix depth, as the JAX ones do
    with pytest.raises(TypeError, match="depth"):
        bt.ViTConfig.small(depth=1)
    with pytest.raises(ValueError, match="attn_impl"):
        bt.ViT(bt.ViTConfig.tiny(attn_impl="splash"), device="cpu")

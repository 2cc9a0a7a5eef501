"""The port's splash attention (bluefog_tpu_torch/parallel/splash.py)
against the JAX package's (bluefog_tpu/parallel/splash.py).

The six tests of ``tests/test_splash.py`` are mirrored: the same numpy
inputs go through the JAX wrapper around the TPU library's splash kernel
(in interpret mode, under ``jax.enable_x64(False)`` as the library
needs) and through the port's ``splash_attention`` on CPU tensors, where
the K5 wrapper runs its plain version.  Tolerances are the JAX tests'
own, 2e-2 for the output and 5e-2 for the gradients: the library keeps
its operands in bf16.  The JAX outputs are computed once per module.
The JAX wrapper's refusal of ``jax_enable_x64`` is a JAX artifact with
no torch counterpart; its slot holds the port's other refusal, a length
that is not a multiple of 128.

Tighter checks of the port alone: against JAX's dense ``full_attention``
and ``jax.grad`` within 1e-5 of the largest entry (both f32);
``splash_backward_plain`` equal to ``flash_backward_plain`` within 1e-6;
the card check's bound (``flash_check.mismatch``) passing a CPU emulation
of K5's dQ summation order (64-key partials and 256-key spans) and
rejecting K5's planted faults at both; and the
tiny Llama with ``attn_impl="splash"`` against the JAX model's xla path
with carried-over weights (loss 1e-5, gradients 1e-4 of each leaf's
largest entry)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bluefog_tpu import models as jm
from bluefog_tpu.parallel import ring_attention as jra
from bluefog_tpu.parallel.splash import splash_attention as jsplash
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.parallel import flash_attention as tfa
from bluefog_tpu_torch.parallel import flash_check
from bluefog_tpu_torch.parallel import splash as tsp

# (B, T, H, KV, D): the JAX test's shape, and the tiny Llama's head dim
SHAPES = {"d64": (2, 256, 4, 2, 64), "d16": (2, 128, 4, 2, 16)}


def _qkv(name):
    b, t, h, kv, d = SHAPES[name]
    rng = np.random.RandomState(7)
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, t, kv, d).astype(np.float32),
            rng.randn(b, t, kv, d).astype(np.float32))


def _loss_jax(q, k, v):
    o = jsplash(q, k, v, causal=True, block_q=128, block_kv=128)
    return (o.astype(jnp.float32) ** 2).sum()


@pytest.fixture(scope="module")
def jax_splash():
    """name -> (out, (dq, dk, dv)) of the JAX splash, numpy."""
    out = {}
    with jax.enable_x64(False):
        for name in SHAPES:
            q, k, v = (jnp.asarray(x) for x in _qkv(name))
            o = jsplash(q, k, v, causal=True, block_q=128, block_kv=128)
            grads = jax.grad(_loss_jax, argnums=(0, 1, 2))(q, k, v)
            out[name] = (np.asarray(o), [np.asarray(g) for g in grads])
    return out


def _port(name):
    """The port's out and (dq, dk, dv) for loss = sum(out²)."""
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _qkv(name))
    o = tsp.splash_attention(q, k, v, causal=True, block_q=128,
                             block_kv=128)
    grads = torch.autograd.grad((o.float() ** 2).sum(), (q, k, v))
    return o.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_splash_forward_matches_jax_splash(name, jax_splash):
    out, _ = _port(name)
    assert out.shape == SHAPES[name][:3] + SHAPES[name][4:]
    np.testing.assert_allclose(out, jax_splash[name][0], atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_splash_gradients_match_jax_splash(name, jax_splash):
    _, grads = _port(name)
    for a, b, which in zip(grads, jax_splash[name][1], "qkv"):
        np.testing.assert_allclose(a, b, atol=5e-2, rtol=5e-2,
                                   err_msg=f"d{which} mismatch")


def test_splash_non_causal_refused():
    q, k, v = (torch.from_numpy(x) for x in _qkv("d16"))
    with pytest.raises(NotImplementedError, match="causal"):
        tsp.splash_attention(q, k, v, causal=False)


def test_splash_length_refused():
    """T % 128 is refused, as in the JAX wrapper (its kv blocks are whole
    128-lane tiles there; the card's kernels mask any T, so the refusal is
    kept for parity only)."""
    q, k, v = (torch.from_numpy(x[:, :100]) for x in _qkv("d16"))
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        tsp.splash_attention(q, k, v)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_splash_matches_dense_attention_tightly(name):
    """In f32 the port has no bf16 step: output and gradients agree with
    JAX's dense ``full_attention`` under ``jax.grad`` within 1e-5 of the
    largest entry."""
    q, k, v = _qkv(name)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref = jra.full_attention(jq, jk, jv, causal=True)
    jgrads = jax.jit(jax.grad(lambda *a: (jra.full_attention(
        *a, causal=True) ** 2).sum(), argnums=(0, 1, 2)))(jq, jk, jv)
    out, grads = _port(name)
    for got, want in zip([out] + grads, [ref] + list(jgrads)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_splash_backward_plain_is_flash_backward_plain():
    """K5's function is K3a's and K3b's together (causal, no offsets)."""
    g = torch.Generator().manual_seed(1)
    q, do = (torch.randn(2, 96, 4, 32, generator=g) for _ in range(2))
    k, v = (torch.randn(2, 96, 2, 32, generator=g) for _ in range(2))
    out, lse = tfa.flash_forward_plain(q, k, v)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    got = tsp.splash_backward(q, k, v, do, lse, delta)
    want = tfa.flash_backward_plain(q, k, v, do, lse, delta)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6)


def test_query_is_prescaled_in_its_own_dtype():
    """As in the JAX wrapper, q · scale is rounded to q's dtype before
    the kernels, which then run with scale 1: at D = 128 the scale 1/√128
    is not a bf16 number, and the rounding shows."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 128, 2, 128, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(1, 128, 1, 128, generator=g).to(torch.bfloat16)
            for _ in range(2))
    out = tsp.splash_attention(q, k, v)
    qs = q * torch.tensor(128 ** -0.5, dtype=torch.bfloat16)
    assert torch.equal(out, tfa.flash_forward_plain(qs, k, v, True, 1.0)[0])
    assert not torch.equal(out, tfa.flash_attention(q, k, v))


def test_cpu_path_counts_no_launches():
    tsp.reset_launch_counts()
    tfa.reset_launch_counts()
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _qkv("d16"))
    tsp.splash_attention(q, k, v).sum().backward()
    assert tsp.splash_backward.launches == 0
    assert tfa.flash_forward.launches == 0


@pytest.fixture(scope="module")
def bf16_at_1b_shape():
    """bf16 inputs at the Llama-1B training length and head dim (T =
    2048, D = 64, GQA rep 4), one kv head wide, with the plain versions'
    outputs and the bound's term sizes."""
    g = torch.Generator().manual_seed(17)
    q, do = (torch.randn(1, 2048, 4, 64, generator=g).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(1, 2048, 1, 64, generator=g).to(torch.bfloat16)
            for _ in range(2))
    out, lse = tfa.flash_forward_plain(q, k, v)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    ref = dict(zip(("dq", "dk", "dv"),
                   tfa.flash_backward_plain(q, k, v, do, lse, delta)))
    terms = flash_check.term_sizes(q, k, v, do, lse, delta)
    return q, k, v, do, lse, delta, ref, terms


@pytest.mark.parametrize("span", [64, 256])
def test_kernel_check_passes_k5_dq_order(bf16_at_1b_shape, span):
    """K5's dQ is a sum of f32 partials, one per ``span`` keys, taken in
    span order and scaled at the end, from dS rounded once to bf16: the
    64-key partials of the mma.sync kernel (bf16 at D 16/32) and the
    256-key spans of the wgmma kernel (D 64/128).  An emulation of each
    order passes the card check's bound against the plain version (one f32
    sum over all keys)."""
    q, k, v, do, lse, delta, ref, terms = bf16_at_1b_shape
    b, t, h, d = q.shape
    p = tfa._probs(q, k, lse, True, d ** -0.5, 0, 0)
    ds = tfa._dscores(p, v, do, delta).to(torch.bfloat16).float()
    kf = k.float().transpose(1, 2)[:, :, None]           # [B, KV, 1, S, D]
    acc = torch.zeros(*ds.shape[:-1], d)
    for j in range(0, t, span):
        acc += ds[..., j:j + span] @ kf[..., j:j + span, :]
    tiled = tfa._heads(acc * d ** -0.5, b, t, h).to(torch.bfloat16)
    assert not torch.equal(tiled, ref["dq"])
    assert flash_check.mismatch(tiled, ref["dq"], terms["dq"]) <= 1


def test_packed_partials_hold_the_written_rows():
    """The packed dQ partials hold rows j·span .. T - 1 of partial j: at
    the 1B length the wgmma kernel's 8 partials of 256 keys take 4.5 rows
    of T where 32 unpacked 64-key partials took 32; at most 8 a row."""
    assert tsp.partial_rows(2048, 256) == 9216
    assert tsp.partial_rows(2048, 64) == sum(2048 - 64 * j
                                             for j in range(32))
    assert tsp.partial_rows(100, 64) == 136
    assert tsp.partial_rows(1, 256) == 1
    assert -(-2048 // 256) == 8


@pytest.mark.parametrize("tile,rows", [(64, 32), (256, 64)])
def test_kernel_check_rejects_k5_planted_faults(bf16_at_1b_shape, tile,
                                                rows):
    """The same bound rejects wrong K5 kernels whose error lies only past
    T/2: a dQ sum one partial short, a skipped diagonal query step; at the
    mma.sync kernel's 64-key partials and 32-row steps, and at the wgmma
    kernel's 256-key spans and 64-row steps."""
    *inputs, ref, terms = bf16_at_1b_shape
    faults = flash_check.splash_planted_faults(*inputs, ref, tile=tile,
                                               rows=rows)
    assert [key for _, key, _ in faults] == ["dq", "dk", "dv"]
    for fault, key, bad in faults:
        assert flash_check.mismatch(bad, ref[key], terms[key]) > 1, \
            (fault, key)
        half = bad.shape[1] // 2
        assert torch.equal(bad[:, :half], ref[key][:, :half])


def _llama_loss_and_grads_jax(cfg, variables, tokens):
    model = jm.Llama(cfg)

    def loss(p):
        logits = model.apply(p, jnp.asarray(tokens))
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], jnp.asarray(tokens)[:, 1:]))

    value, grads = jax.jit(jax.value_and_grad(loss))(variables)
    return float(value), jax.tree.map(np.asarray, grads)


def test_llama_splash_matches_xla_loss():
    """Model level: ``attn_impl="splash"`` in the port gives the loss and
    gradients of the JAX model's xla path on the tiny config (T = 128,
    the same weights), and of the port's own xla path."""
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    tokens = np.random.RandomState(0).randint(0, 256, (2, 128)).astype(
        np.int32)
    variables = jax.tree.map(np.asarray, jm.Llama(cfg).init(
        jax.random.PRNGKey(1), jnp.asarray(tokens)))
    j_loss, j_grads = _llama_loss_and_grads_jax(cfg, variables, tokens)
    results = {}
    for impl in ("splash", "xla"):
        tcfg = bt.LlamaConfig.tiny(dtype=torch.float32, attn_impl=impl)
        model = bt.Llama(tcfg, device="cpu", param_dtype=torch.float32)
        model.load_state_dict(llama_params_from_flax(variables, tcfg,
                                                     device="cpu"))
        params = {k: v.requires_grad_(True)
                  for k, v in model.state().items()}
        t = torch.from_numpy(tokens)
        logits = model.apply(params, t)
        loss = torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, 256), t[:, 1:].reshape(-1).long())
        grads = torch.autograd.grad(loss, list(params.values()))
        results[impl] = (float(loss.detach()), dict(zip(params, grads)))
    want = llama_params_from_flax(j_grads, tcfg, device="cpu")
    for impl, (loss, grads) in results.items():
        assert abs(loss - j_loss) < 1e-5, impl
        for key, w in want.items():
            np.testing.assert_allclose(
                grads[key].numpy(), w.numpy(), rtol=0,
                atol=1e-4 * float(w.abs().max()) + 1e-9,
                err_msg=f"{impl} {key}")


def test_splash_config_guards():
    assert tsp.library_supports_head_dim(64)
    assert not tsp.library_supports_head_dim(48)
    with pytest.raises(ValueError, match="splash"):
        bt.LlamaConfig.tiny(attn_impl="splash", attn_mode="ring",
                            sp_axis="sp")
    with pytest.raises(ValueError, match="attn_impl"):
        bt.LlamaConfig.tiny(attn_impl="bogus")

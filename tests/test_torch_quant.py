"""The port's int8 weights (bluefog_tpu_torch/models/quant.py and
``QuantDense``, the quantized head and the w8a8 integer attention in
models/llama.py) against the JAX package's on ``LlamaConfig.tiny``,
mirroring tests/test_quant.py.

Tolerances: the quantizer is bit-equal to JAX's; ``QuantDense`` and
``_cached_attention_int8`` agree with JAX's within f32 rounding of
equal integer products (1e-5 relative); the model's logits within 1e-5
of JAX's; quantized decode tracks full precision as tests/test_quant.py
requires (logits within 0.15 (1 + max|logit|), first greedy token equal,
more than half of 16 greedy tokens)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu import models as jm
from bluefog_tpu.models import llama as jl
from bluefog_tpu.models import quant as jq
from bluefog_tpu.models.generate import _decode_cfg, init_cache as j_cache
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models import llama as tl
from bluefog_tpu_torch.models.generate import (build_model, decode_config,
                                               init_cache)
from bluefog_tpu_torch.models.quant import (QUANT_KERNELS,
                                            is_quantized_params,
                                            quantize_llama_params)

CPU = torch.device("cpu")


def _weights(dtype):
    cfg = jm.LlamaConfig.tiny(dtype=getattr(jnp, dtype), max_seq_len=96)
    variables = jm.Llama(cfg).init(jax.random.PRNGKey(7),
                                   jnp.zeros((2, 8), jnp.int32))
    tcfg = bt.LlamaConfig.tiny(dtype=getattr(torch, dtype), max_seq_len=96)
    state = llama_params_from_flax(jax.tree.map(np.asarray, variables),
                                   tcfg, device="cpu")
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                              (2, 12)).astype(np.int32)
    return cfg, variables, tcfg, state, prompt


@pytest.fixture(scope="module")
def trained():
    """f32 compute, for the comparisons with JAX's logits."""
    return _weights("float32")


@pytest.fixture(scope="module")
def trained_bf16():
    """tests/test_quant.py's fixture (bf16 compute), for its token
    criteria."""
    return _weights("bfloat16")


def _port_logits(state, tcfg, prompt, kv_quant="none",
                 weight_quant="none"):
    dcfg = decode_config(tcfg, prompt.shape[1] + 1, kv_quant=kv_quant,
                         weight_quant=weight_quant)
    model = build_model(state, dcfg, CPU)
    cache = init_cache(dcfg, prompt.shape[0], prompt.shape[1] + 1,
                       kv_quant=kv_quant, device="cpu")
    return model(torch.from_numpy(prompt), cache)[:, -1]


def _jax_logits(variables, cfg, prompt, kv_quant="none",
                weight_quant="none"):
    dcfg = _decode_cfg(cfg, prompt.shape[1] + 1, kv_quant=kv_quant,
                       weight_quant=weight_quant)
    cache = j_cache(dcfg, prompt.shape[0], prompt.shape[1] + 1,
                    kv_quant=kv_quant)
    logits, _ = jm.Llama(dcfg).apply({**variables, "cache": cache},
                                     jnp.asarray(prompt), mutable=["cache"])
    return np.asarray(logits[:, -1])


def test_quantize_params_bit_equal_to_jax(trained):
    """Structure and values of ``quantize_llama_params`` equal JAX's,
    carried through ``from_jax`` (tests/test_quant.py:
    test_quantize_params_structure)."""
    _, variables, tcfg, state, _ = trained
    qstate = quantize_llama_params(state)
    want = llama_params_from_flax(
        jax.tree.map(np.asarray, jq.quantize_llama_params(variables)),
        tcfg, device="cpu")
    assert set(qstate) == set(want)
    for key, t in want.items():
        assert qstate[key].dtype == t.dtype, key
        assert torch.equal(qstate[key], t), key
    assert is_quantized_params(qstate) and not is_quantized_params(state)
    wq = qstate["layers.0.attention.wq.kernel"]
    scale = qstate["layers.0.attention.wq.scale"]
    assert wq.dtype == torch.int8 and scale.dtype == torch.float32
    assert scale.shape == (wq.shape[-1],)
    n_scales = sum(k.endswith(".scale") and k.split(".")[-2]
                   in QUANT_KERNELS for k in qstate)
    assert n_scales == 7 * tcfg.n_layers + 1
    assert qstate["tok_embeddings.embedding"].dtype == torch.float32
    # the dequantized kernel is within half an int8 step of the original
    orig = state["layers.0.attention.wq.kernel"]
    deq = wq.float() * scale[None, :]
    assert (deq - orig).abs().max() <= scale.max() * 0.5 + 1e-8


@pytest.mark.parametrize("act_quant,out_f32,dtype", [
    (False, False, "float32"), (True, False, "float32"),
    (False, True, "float32"), (True, True, "float32"),
    (False, False, "bfloat16")])
def test_quant_dense_matches_jax(act_quant, out_f32, dtype):
    """``QuantDense`` against JAX's on the same int8 kernel, scale and
    input: weight-only and w8a8 (s8 x s8 -> s32 through torch._int_mm on
    the CPU), f32 out for the head.  1e-5 relative in f32, 2 bf16 ulps
    (1.6e-2) in bf16."""
    rs = np.random.RandomState(5)
    w = rs.randn(40, 24).astype(np.float32)
    q, scale = jq._quantize_kernel(jnp.asarray(w))
    x = rs.randn(2, 3, 40).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jl.QuantDense(24, dtype=jdt, out_f32=out_f32,
                         act_quant=act_quant).apply(
        {"params": {"kernel": q, "scale": scale}},
        jnp.asarray(x).astype(jdt))
    layer = tl.QuantDense(40, 24, tdt, CPU, out_f32=out_f32,
                          act_quant=act_quant)
    layer.load_state_dict({"kernel": torch.from_numpy(np.array(q)),
                           "scale": torch.from_numpy(np.array(scale))})
    assert layer.kernel.shape == (40, 24) and layer.kernel.stride() == (1, 40)
    got = layer(torch.from_numpy(x).to(tdt))
    assert got.dtype == (torch.float32 if out_f32 else tdt)
    tol = 1e-5 if dtype == "float32" or out_f32 else 1.6e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol * np.abs(want).max())


def test_cached_attention_int8_matches_jax():
    """``_cached_attention_int8`` against JAX's on equal int8 caches,
    scales and queries (T = 5 queries at position 9 of a 16-long cache):
    the integer products are exact on both sides, so the outputs agree
    within f32 rounding (1e-5 relative)."""
    rs = np.random.RandomState(1)
    b, t, n_kv, rep, s, d = 2, 5, 2, 2, 16, 16
    q = rs.randn(b, t, n_kv * rep, d).astype(np.float32)
    k = rs.randn(b, n_kv, s, d).astype(np.float32)
    v = rs.randn(b, n_kv, s, d).astype(np.float32)
    kq, ks = jl._amax_quantize(jnp.asarray(k))
    vq, vs = jl._amax_quantize(jnp.asarray(v))
    ks, vs = ks[..., 0], vs[..., 0]
    want = jl._cached_attention_int8(jnp.asarray(q), kq, ks, vq, vs,
                                     jnp.int32(9))
    got = tl._cached_attention_int8(
        torch.from_numpy(q), *(torch.from_numpy(np.array(a))
                               for a in (kq, ks, vq, vs)),
        torch.tensor([9, 9], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="131072"):
        tl._cached_attention_int8(
            torch.zeros(1, 1, 1, 1), torch.zeros(1, 1, 131073, 1),
            None, None, None, 0)


def test_int8_products_exact_in_f32_under_the_gate():
    """The f32 route of the w8a8 attention: at the gate's worst case
    (every code ±127, head_dim 128 and a 1024-long cache) each sum of
    products of int8 codes is an integer below 2^24, so f32 gives the
    int32 product bit for bit; past the gate the route is f64."""
    for n in (128, 1024):
        a = torch.full((3, n), 127, dtype=torch.int8)
        a[1] = -127
        a[2] = torch.from_numpy(np.random.RandomState(n).randint(
            -127, 128, n).astype(np.int8))
        b = torch.full((n, 2), -127, dtype=torch.int8)
        exact = a.long() @ b.long()
        assert tl._exact_float(CPU, n) == torch.float32
        assert torch.equal((a.float() @ b.float()).long(), exact)
        assert torch.equal(tl.int8_matmul(a, b).long(), exact)
    assert 127 * 127 * 1024 < 2 ** 24 <= 127 * 127 * 1041
    assert tl._exact_float(CPU, 1041) == torch.float64


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_weight_quant_logits_close(trained, mode):
    """tests/test_quant.py:test_weight_quant_logits_close, and the
    quantized logits against JAX's (1e-5)."""
    cfg, variables, tcfg, state, prompt = trained
    qstate = quantize_llama_params(state)
    ref = _port_logits(state, tcfg, prompt)
    got = _port_logits(qstate, tcfg, prompt, weight_quant=mode)
    assert (got - ref).abs().max() < 0.15 * (1.0 + ref.abs().max())
    jgot = _jax_logits(jq.quantize_llama_params(variables), cfg, prompt,
                       weight_quant=mode)
    np.testing.assert_allclose(got.numpy(), jgot, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_quant_generate_matches_full_precision_tokens(trained_bf16, mode):
    """tests/test_quant.py:test_quant_generate_matches_full_precision_
    tokens on its bf16 config, with the int8 K/V cache (for w8a8 the
    integer attention runs on every prefill); the first quantized token
    also equals JAX's."""
    cfg, variables, tcfg, state, prompt = trained_bf16
    full = bt.llama_generate(state, tcfg, prompt, 16, device="cpu").numpy()
    qstate = quantize_llama_params(state)
    both = bt.llama_generate(qstate, tcfg, prompt, 16, kv_quant="int8",
                             weight_quant=mode, device="cpu").numpy()
    assert full.shape == both.shape
    np.testing.assert_array_equal(full[:, :12], both[:, :12])
    gen_f, gen_q = full[:, 12:], both[:, 12:]
    assert (gen_f[:, 0] == gen_q[:, 0]).all()
    assert (gen_f == gen_q).mean() > 0.5
    jboth = np.asarray(jm.llama_generate(
        jq.quantize_llama_params(variables), cfg, jnp.asarray(prompt), 2,
        kv_quant="int8", weight_quant=mode))
    np.testing.assert_array_equal(both[:, :13], jboth[:, :13])


def test_w8a8_attention_int8_logits_close(trained):
    """tests/test_quant.py:test_w8a8_attention_int8_logits_close: the
    multi-token prefill through ``_cached_attention_int8`` tracks the
    unquantized path and agrees on the argmax; and equals JAX's logits
    (1e-5)."""
    cfg, variables, tcfg, state, prompt = trained
    qstate = quantize_llama_params(state)
    ref = _port_logits(state, tcfg, prompt)
    got = _port_logits(qstate, tcfg, prompt, kv_quant="int8",
                       weight_quant="w8a8")
    assert (got - ref).abs().max() < 0.2 * (1.0 + ref.abs().max())
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    jgot = _jax_logits(jq.quantize_llama_params(variables), cfg, prompt,
                       kv_quant="int8", weight_quant="w8a8")
    np.testing.assert_allclose(got.numpy(), jgot, rtol=1e-5, atol=1e-5)


def test_weight_quant_tree_mismatch_raises(trained):
    _, _, tcfg, state, prompt = trained
    with pytest.raises(ValueError, match="quantize_llama_params"):
        bt.llama_generate(state, tcfg, prompt, 2, weight_quant="int8",
                          device="cpu")
    with pytest.raises(ValueError, match="mismatched"):
        bt.llama_generate(quantize_llama_params(state), tcfg, prompt, 2,
                          device="cpu")

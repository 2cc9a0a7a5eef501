"""The port's Llama decode layout (bluefog_tpu_torch/models/llama.py and
interop/from_jax.py) against the JAX model on ``LlamaConfig.tiny`` in
f32: the same parameters (the JAX init, converted by
``llama_params_from_flax``) and the same tokens give the same prefill
and decode-step logits in both layer layouts, within atol = rtol = 1e-4
(the f32 matmuls sum in another order).  Rotary embedding with llama3
scaling matches, ``_amax_quantize`` is bit-identical, and the int8 cache
written after prefill is that quantizer's output bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu import models as jm
from bluefog_tpu.models import generate as jgen
from bluefog_tpu.models import llama as jllama
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models import generate as tgen
from bluefog_tpu_torch.models import llama as tllama

B, T_PROMPT, N_STEPS, MAX_LEN = 2, 7, 8, 32
TOL = dict(atol=1e-4, rtol=1e-4)


def _models(scan_layers=False, **over):
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32, scan_layers=scan_layers,
                              **over)
    variables = jm.Llama(cfg).init(jax.random.PRNGKey(1),
                                   jnp.zeros((B, 4), jnp.int32))
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32,
                               scan_layers=scan_layers, **over)
    model = bt.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_flax(
        jax.tree.map(np.asarray, variables), tcfg, device="cpu"))
    return cfg, variables, tcfg, model


def _prompt(seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (B, T_PROMPT)).astype(np.int32)


def _run_both(kv_quant, scan_layers=False):
    """Prefill + N_STEPS greedy decode steps through both packages (the
    JAX side fed the JAX argmax, the port the same tokens).  Returns
    both logit lists and both caches."""
    cfg, variables, tcfg, model = _models(scan_layers)
    dcfg = jgen.decode_config(cfg, MAX_LEN, kv_quant=kv_quant,
                              decode_attn="pallas")
    jmodel = jm.Llama(dcfg)
    jcache = jgen.init_cache(dcfg, B, MAX_LEN, kv_quant=kv_quant)
    tcache = tgen.init_cache(tgen.decode_config(tcfg, MAX_LEN), B, MAX_LEN,
                             kv_quant=kv_quant, device="cpu")
    prompt = _prompt()
    jl, jcache = jgen.prefill_cache(jmodel, variables["params"], jcache,
                                    jnp.asarray(prompt))
    tl, tcache = tgen.prefill_cache(model, tcache, torch.from_numpy(prompt))
    j_logits, t_logits = [np.asarray(jl)], [tl.numpy()]
    caches = (jax.tree.map(np.asarray, jcache), tcache)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for _ in range(N_STEPS):
        jl, jcache = jgen.decode_token_step(jmodel, variables["params"],
                                            jcache, jnp.asarray(tok[:, None]))
        tl, tcache = tgen.decode_token_step(model, tcache,
                                            torch.from_numpy(tok[:, None]))
        j_logits.append(np.asarray(jl))
        t_logits.append(tl.numpy())
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    return j_logits, t_logits, caches


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("scan_layers", [False, True])
def test_prefill_and_decode_logits_match_jax(scan_layers, kv_quant):
    j_logits, t_logits, _ = _run_both(kv_quant, scan_layers)
    assert t_logits[0].shape == (B, 1, 256)
    for j, t in zip(j_logits, t_logits):
        assert t.dtype == np.float32
        np.testing.assert_allclose(t, j, **TOL)


def test_int8_cache_after_prefill_is_bit_exact():
    """Layer 0 sees the same inputs whatever the cache layout, so its
    full-precision cache holds exactly the keys/values its int8 cache
    quantizes.  Bit for bit: the port's int8 layer-0 cache is the port's
    quantizer applied to the port's full-precision one, and the JAX
    int8 layer-0 cache is the port's quantizer applied to the JAX
    full-precision one (same quantizer, same layout, same codes and
    scales).  Between the packages the cached values themselves differ
    by f32 ulps (another matmul order), so port against JAX the codes
    agree up to a rounding-boundary flip of 1 and the scales within
    1e-6, in every layer."""
    cfg, variables, tcfg, model = _models()
    prompt = _prompt()
    jax_c, port_c = {}, {}
    for kvq in ("none", "int8"):
        dcfg = jgen.decode_config(cfg, MAX_LEN, kv_quant=kvq)
        _, c = jgen.prefill_cache(
            jm.Llama(dcfg), variables["params"],
            jgen.init_cache(dcfg, B, MAX_LEN, kv_quant=kvq),
            jnp.asarray(prompt))
        jax_c[kvq] = jax.tree.map(np.asarray, c)
        port_c[kvq] = tgen.init_cache(tcfg, B, MAX_LEN, kv_quant=kvq,
                                      device="cpu")
        tgen.prefill_cache(model, port_c[kvq], torch.from_numpy(prompt))
    fp, q8 = port_c["none"], port_c["int8"]
    written = slice(0, T_PROMPT)
    for kind, full, codes, scales in (
            ("key", fp.key, q8.key, q8.key_scale),
            ("value", fp.value, q8.value, q8.value_scale)):
        want_c, want_s = tllama._amax_quantize(full[0, :, :, written])
        assert torch.equal(codes[0, :, :, written], want_c)
        assert torch.equal(scales[0, :, :, written], want_s[..., 0])
        j_fp = jax_c["none"]["layer_0"]["attention"][f"cached_{kind}"]
        j_q8 = jax_c["int8"]["layer_0"]["attention"]
        want_c, want_s = tllama._amax_quantize(
            torch.from_numpy(np.array(j_fp[:, :, written])))
        np.testing.assert_array_equal(
            want_c.numpy(), j_q8[f"cached_{kind}"][:, :, written])
        np.testing.assert_array_equal(
            want_s[..., 0].numpy(),
            j_q8[f"cached_{kind}_scale"][:, :, written])
        # the unwritten tail stays zero
        assert not codes[:, :, :, T_PROMPT:].any()
        assert not scales[:, :, :, T_PROMPT:].any()
        for layer in range(cfg.n_layers):
            j = jax_c["int8"][f"layer_{layer}"]["attention"]
            assert np.abs(codes[layer].numpy().astype(np.int32)
                          - j[f"cached_{kind}"]).max() <= 1
            np.testing.assert_allclose(scales[layer].numpy(),
                                       j[f"cached_{kind}_scale"],
                                       rtol=1e-6, atol=0)
    assert q8.index.tolist() == [T_PROMPT] * B


def test_amax_quantize_bit_identical():
    """Same codes and scales as JAX, round half to even included (rows
    whose amax is 127 make x / scale land exactly on .5)."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6, 32).astype(np.float32) * 3.0
    x[0, 0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[0, 0, 6:] = 0.0
    x[1, 1] = 0.0  # an all-zero row takes the eps floor
    jq, js = jllama._amax_quantize(jnp.asarray(x))
    tq, ts = tllama._amax_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq[0, 0, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("kind", ["none", "llama3"])
def test_rotary_embed_matches_jax(kind):
    cfg = bt.LlamaConfig.tiny(rope_scaling_kind=kind,
                              rope_scaling_original_max_len=64)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 3, 32).astype(np.float32)
    pos = np.arange(100, 109, dtype=np.int32)
    ref = jllama.rotary_embed(jnp.asarray(x), jnp.asarray(pos),
                              cfg.rope_theta, cfg.rope_scaling)
    out = tllama.rotary_embed(torch.from_numpy(x), torch.from_numpy(pos),
                              cfg.rope_theta, cfg.rope_scaling)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    # per-row positions [B, T] == the [T] form row by row
    rows = torch.from_numpy(np.stack([pos, pos + 7]))
    both = tllama.rotary_embed(torch.from_numpy(x), rows, cfg.rope_theta,
                               cfg.rope_scaling)
    np.testing.assert_array_equal(both[0].numpy(), out[0].numpy())
    np.testing.assert_array_equal(
        both[1].numpy(),
        tllama.rotary_embed(torch.from_numpy(x), torch.from_numpy(pos + 7),
                            cfg.rope_theta, cfg.rope_scaling)[1].numpy())


def test_llama3_scaled_freqs_match_jax():
    freqs = (1.0 / (500000.0 ** (np.arange(0, 128, 2) / 128))
             ).astype(np.float32)
    args = (8.0, 1.0, 4.0, 8192)
    ref = jllama._llama3_scaled_freqs(jnp.asarray(freqs), *args)
    out = tllama._llama3_scaled_freqs(torch.from_numpy(freqs), *args)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_cached_attention_matches_jax_for_prefill_chunks():
    """Multi-token cached attention (the prefill path) at a nonzero
    cache index, scalar and per-row."""
    rng = np.random.RandomState(5)
    q = rng.randn(2, 5, 4, 16).astype(np.float32)
    k = rng.randn(2, 2, 24, 16).astype(np.float32)
    v = rng.randn(2, 2, 24, 16).astype(np.float32)
    ref = jllama._cached_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.int32(6))
    out = tllama._cached_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    rows = tllama._cached_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.tensor([6, 6], dtype=torch.int32))
    np.testing.assert_array_equal(rows.numpy(), out.numpy())


def test_config_maps_one_to_one():
    """Every JAX config field exists in the port with the same default,
    and the named configs agree."""
    jf = {f.name: f.default for f in dataclasses.fields(jm.LlamaConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(bt.LlamaConfig)}
    assert set(jf) == set(tf)
    for name in jf:
        if name != "dtype":
            assert jf[name] == tf[name], name
    for fn in ("llama3_8b", "tiny"):
        a, b = getattr(jm.LlamaConfig, fn)(), getattr(bt.LlamaConfig, fn)()
        assert (a.head_dim, a.ffn_dim, a.n_layers, a.vocab_size) == (
            b.head_dim, b.ffn_dim, b.n_layers, b.vocab_size)
    assert bt.LlamaConfig(dtype="float32").dtype == torch.float32
    with pytest.raises(ValueError, match="kv_quant"):
        bt.LlamaConfig.tiny(kv_quant="int4", decode=True)


@pytest.mark.parametrize("over,match", [
    (dict(tp_axis="tp", tp_size=2), "tensor parallelism"),
    (dict(n_experts=4, ep_axis="ep", ep_size=2), "MoE"),
    (dict(decode=True, n_experts=4, capacity_factor=4.0, ep_axis="ep",
          ep_size=2), "MoE"),
])
def test_unported_knobs_raise_naming_the_slice(over, match):
    """Splash (K5) trains since slice 4 (tests/test_torch_splash.py),
    ring and Ulysses attention since slice 13
    (tests/test_torch_llama_sp.py), the routed MoE at ep_size 1 since
    slice 15 (tests/test_torch_moe.py): MoE over an expert axis waits."""
    with pytest.raises(NotImplementedError, match=match):
        bt.Llama(bt.LlamaConfig.tiny(**over), device="cpu")


def test_decode_config_with_flash_serves_like_xla():
    """The JAX package takes ``decode=True, attn_impl="flash"`` (decode
    never reads ``attn_impl``): the port serves it, with the same greedy
    tokens as ``attn_impl="xla"``."""
    state = bt.Llama(bt.LlamaConfig.tiny(dtype=torch.float32),
                     device="cpu").state_dict()
    outs = []
    for impl in ("xla", "flash"):
        cfg = bt.LlamaConfig.tiny(dtype=torch.float32, decode=True,
                                  attn_impl=impl)
        outs.append(bt.llama_generate(state, cfg, _prompt(), 6,
                                      max_len=MAX_LEN, device="cpu"))
    assert outs[0].shape == (B, T_PROMPT + 6)
    assert torch.equal(outs[0], outs[1])


def test_param_tree_mismatch_raises():
    cfg, variables, tcfg, _ = _models()
    tree = jax.tree.map(np.asarray, variables)["params"]
    bigger = bt.LlamaConfig.tiny(dtype=torch.float32, n_layers=3)
    with pytest.raises(ValueError, match="missing"):
        llama_params_from_flax(tree, bigger, device="cpu")
    wider = bt.LlamaConfig.tiny(dtype=torch.float32, hidden_dim=96)
    with pytest.raises(ValueError, match="shape"):
        llama_params_from_flax(tree, wider, device="cpu")


def test_random_init_is_seeded_at_flax_scales():
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    a = bt.Llama(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    b = bt.Llama(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.layers[0].feed_forward.w2.kernel
    assert abs(float(w.std()) * cfg.ffn_dim ** 0.5 - 1.0) < 0.1
    assert torch.all(a.norm.scale == 1)

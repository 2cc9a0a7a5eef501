"""The port's HuggingFace Llama importer (bluefog_tpu_torch/interop/
hf_llama.py) against ``transformers`` and against the JAX package's
importer, mirroring tests/test_hf_import.py on a tiny random
``LlamaForCausalLM`` (f32, built here; nothing is downloaded).

Tolerances: logits within 2e-4 of ``transformers``' (the JAX test's);
the imported state dict equals the JAX importer's tree carried through
``from_jax`` bit for bit (the mapping is a permutation); greedy tokens
equal ``transformers``'."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from bluefog_tpu.interop import hf_llama as jhf  # noqa: E402
import bluefog_tpu_torch as bt  # noqa: E402
from bluefog_tpu_torch.interop import (llama_config_from_hf,  # noqa: E402
                                       llama_params_from_flax,
                                       llama_params_from_hf)

B, T = 2, 12


def _tiny_hf(**over):
    kw = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2,
              intermediate_size=128, max_position_embeddings=256,
              rope_theta=500000.0, rms_norm_eps=1e-5, attention_bias=False,
              mlp_bias=False, tie_word_embeddings=False)
    kw.update(over)
    hf_cfg = transformers.LlamaConfig(**kw)
    torch.manual_seed(0)
    return hf_cfg, transformers.LlamaForCausalLM(hf_cfg).float().eval()


def _hf_logits(hf_model, tokens):
    with torch.no_grad():
        out = hf_model(input_ids=torch.from_numpy(tokens).long())
    return out.logits.float().numpy()


def _port_logits(state, cfg, tokens):
    model = bt.Llama(cfg, device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        return model(torch.from_numpy(tokens)).numpy()


@pytest.mark.parametrize("source", ["model", "numpy_state_dict"])
def test_hf_logits_match(source):
    """Imported weights reproduce ``transformers``' logits, from the
    model or from a state dict of numpy arrays; they equal the JAX
    importer's bit for bit; the port's cached greedy decode emits
    ``transformers``' greedy tokens."""
    hf_cfg, hf_model = _tiny_hf()
    cfg = llama_config_from_hf(hf_cfg, dtype=torch.float32)
    src = hf_model if source == "model" else {
        k: v.numpy() for k, v in hf_model.state_dict().items()}
    state = llama_params_from_hf(src, cfg, device="cpu")
    tokens = np.random.RandomState(0).randint(0, 256, (B, T)).astype(
        np.int32)
    np.testing.assert_allclose(_port_logits(state, cfg, tokens),
                               _hf_logits(hf_model, tokens), rtol=2e-4,
                               atol=2e-4)
    jcfg = jhf.llama_config_from_hf(hf_cfg, dtype=jnp.float32)
    jvars = jhf.llama_params_from_hf(hf_model, jcfg)
    want = llama_params_from_flax(jax.tree.map(np.asarray, jvars), cfg,
                                  device="cpu")
    assert set(state) == set(want)
    for key, t in want.items():
        assert torch.equal(state[key], t), key
    if source == "model":
        got = bt.llama_generate(state, cfg, tokens, 6, device="cpu")
        with torch.no_grad():
            want = hf_model.generate(torch.from_numpy(tokens).long(),
                                     max_new_tokens=6, do_sample=False)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_hf_config_mapping():
    """Any object with the config's attributes maps: a
    ``transformers.LlamaConfig`` or a ``SimpleNamespace``; the result is
    the JAX mapping's field for field."""
    hf_cfg, _ = _tiny_hf()
    cfg = llama_config_from_hf(hf_cfg)
    assert cfg.dim == 64 and cfg.n_layers == 2
    assert cfg.n_heads == 4 and cfg.n_kv_heads == 2
    assert cfg.ffn_dim == 128 and cfg.rope_theta == 500000.0
    ns = SimpleNamespace(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=256, rms_norm_eps=1e-5)
    small = llama_config_from_hf(ns, dtype=torch.float32)
    assert small.n_kv_heads == 4 and small.rope_theta == 10000.0
    jcfg = jhf.llama_config_from_hf(hf_cfg)
    for field in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "hidden_dim", "max_seq_len", "rope_theta", "norm_eps",
                  "rope_scaling_kind"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


def test_hf_rope_scaled_logits_match():
    """A Llama-3.1-style rope-scaled checkpoint (rope_type='llama3')
    converts and reproduces ``transformers``' logits; without the
    scaling the logits move (so it was not silently dropped)."""
    hf_cfg, hf_model = _tiny_hf(rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 32})
    cfg = llama_config_from_hf(hf_cfg, dtype=torch.float32)
    assert cfg.rope_scaling_kind == "llama3"
    assert cfg.rope_scaling == (8.0, 1.0, 4.0, 32)
    state = llama_params_from_hf(hf_model, cfg, device="cpu")
    tokens = np.random.RandomState(0).randint(0, 256, (B, 48)).astype(
        np.int32)
    theirs = _hf_logits(hf_model, tokens)
    np.testing.assert_allclose(_port_logits(state, cfg, tokens), theirs,
                               rtol=2e-4, atol=2e-4)
    plain = llama_config_from_hf(hf_cfg, dtype=torch.float32,
                                 rope_scaling_kind="none")
    unscaled = _port_logits(state, plain, tokens)
    assert np.abs(unscaled - theirs).max() > 1e-3


def test_hf_unsupported_features_raise():
    """What the port does not implement fails loudly, as in JAX: other
    rope scalings, llama3 scaling with missing fields, projection
    biases; and a state dict of another geometry."""
    hf_cfg, hf_model = _tiny_hf()
    hf_cfg.rope_scaling = {"rope_type": "yarn", "factor": 8.0}
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        llama_config_from_hf(hf_cfg)
    hf_cfg.rope_scaling = {"rope_type": "llama3", "factor": 8.0}
    with pytest.raises(ValueError, match="missing required"):
        llama_config_from_hf(hf_cfg)
    hf_cfg.rope_scaling = None
    hf_cfg.attention_bias = True
    with pytest.raises(NotImplementedError, match="attention_bias"):
        llama_config_from_hf(hf_cfg)
    hf_cfg.attention_bias = False
    hf_cfg.mlp_bias = True
    with pytest.raises(NotImplementedError, match="mlp_bias"):
        llama_config_from_hf(hf_cfg)
    other = bt.LlamaConfig.tiny(n_kv_heads=4)
    with pytest.raises(ValueError, match="geometry"):
        llama_params_from_hf(hf_model, other, device="cpu")


def test_hf_tied_embeddings_and_dtype():
    """Without ``lm_head.weight`` the head takes the embedding's rows
    (tied embeddings); ``dtype=`` casts every tensor."""
    hf_cfg, hf_model = _tiny_hf()
    sd = dict(hf_model.state_dict())
    del sd["lm_head.weight"]
    cfg = llama_config_from_hf(hf_cfg, dtype=torch.float32)
    state = llama_params_from_hf(sd, cfg, dtype=torch.bfloat16,
                                 device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    assert torch.equal(state["output.kernel"],
                       sd["model.embed_tokens.weight"].bfloat16().T)

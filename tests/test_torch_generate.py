"""The port's generation loop (bluefog_tpu_torch/models/generate.py)
against the JAX package on ``LlamaConfig.tiny`` in f32, same weights:
greedy ``llama_generate`` is token-exact with JAX ``llama_generate``
under both of its decode lowerings (``decode_attn="pallas"`` in
interpret mode, and ``"xla"``) and both cache layouts.  Temperature
sampling is deterministic for a generator seed, and EOS freezing keeps
the contract that tests/test_generate.py states (checked on the port's
own output)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu import models as jm
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models.generate import (check_decode_attn,
                                               decode_config)

B, T_PROMPT, NEW = 2, 7, 9


@pytest.fixture(scope="module")
def weights():
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    variables = jm.Llama(cfg).init(jax.random.PRNGKey(1),
                                   jnp.zeros((B, 4), jnp.int32))
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    model = bt.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_flax(
        jax.tree.map(np.asarray, variables), tcfg, device="cpu"))
    prompt = np.random.RandomState(0).randint(
        0, 256, (B, T_PROMPT)).astype(np.int32)
    return cfg, variables, tcfg, model, prompt


def _port(weights, n=NEW, **kw):
    _, _, tcfg, model, prompt = weights
    return bt.llama_generate(model, tcfg, prompt, n, device="cpu",
                             **kw).numpy()


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("decode_attn", ["pallas", "xla"])
def test_greedy_token_exact_with_jax(weights, kv_quant, decode_attn):
    cfg, variables, _, _, prompt = weights
    want = np.asarray(jm.llama_generate(
        variables, cfg, jnp.asarray(prompt), NEW, kv_quant=kv_quant,
        decode_attn=decode_attn))
    got = _port(weights, kv_quant=kv_quant)
    assert got.dtype == np.int32 and got.shape == (B, T_PROMPT + NEW)
    np.testing.assert_array_equal(got, want)


def test_state_dict_variables_same_as_module(weights):
    _, _, tcfg, model, prompt = weights
    got = bt.llama_generate(model.state_dict(), tcfg, prompt, 4,
                            device="cpu").numpy()
    np.testing.assert_array_equal(got, _port(weights, 4))


def test_generate_single_token(weights):
    cfg, variables, _, _, prompt = weights
    want = np.asarray(jm.llama_generate(variables, cfg,
                                        jnp.asarray(prompt), 1))
    np.testing.assert_array_equal(_port(weights, 1), want)


def test_temperature_sampling_deterministic_for_a_seed(weights):
    def draw(seed):
        return _port(weights, temperature=1.0,
                     rng=torch.Generator().manual_seed(seed))
    a, b = draw(7), draw(7)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (B, T_PROMPT + NEW)
    assert np.all((a >= 0) & (a < 256))
    np.testing.assert_array_equal(a[:, :T_PROMPT], weights[4])
    assert any(not np.array_equal(draw(s), a) for s in (8, 9, 10))


def test_eos_freezes_finished_rows(weights):
    """The contract of tests/test_generate.py::test_eos_freezes_finished_
    rows: once a row emits eos_id, its later positions are eos_id; the
    output up to and including the first eos is the unstopped one; a
    row that never emits it is unchanged."""
    plain = _port(weights)
    gen = plain[:, T_PROMPT:]
    # the first (row, step) whose token has not appeared earlier in
    # that row, so that it is where the row first emits it
    row, step = next((r, i) for r in range(B) for i in range(2, NEW - 1)
                     if gen[r, i] not in gen[r, :i])
    eos = int(gen[row, step])
    got = _port(weights, eos_id=eos)
    np.testing.assert_array_equal(got[row, :T_PROMPT + step + 1],
                                  plain[row, :T_PROMPT + step + 1])
    assert np.all(got[row, T_PROMPT + step + 1:] == eos)
    for r in range(B):
        if eos not in gen[r]:
            np.testing.assert_array_equal(got[r], plain[r])


def test_eos_unseen_matches_unstopped_path(weights):
    plain = _port(weights)
    unseen = [t for t in range(256) if t not in plain[:, T_PROMPT:]][0]
    np.testing.assert_array_equal(_port(weights, eos_id=unseen), plain)


def test_generate_validates_inputs(weights):
    with pytest.raises(ValueError, match="max_len"):
        _port(weights, max_len=T_PROMPT)
    with pytest.raises(ValueError, match="rng"):
        _port(weights, temperature=0.7)
    with pytest.raises(ValueError, match="max_new_tokens"):
        _port(weights, 0)
    # mesh= takes the tp axis itself, for a tp config (a tp=1 config
    # ignores it, as JAX's does)
    with pytest.raises(TypeError, match="tp axis"):
        bt.llama_generate(weights[3], dataclasses.replace(
            weights[2], tp_axis="tp", tp_size=2), np.zeros((1, 2), np.int32),
            2, mesh=object(), device="cpu")
    # weight_quant is ported: full-precision weights are refused for it
    with pytest.raises(ValueError, match="quantize_llama_params"):
        _port(weights, weight_quant="int8")


def test_decode_attn_on_card_takes_only_the_kernel(weights):
    """'auto' resolves to the kernel ('pallas'); on a CUDA device any
    other lowering is refused (checked on the config, no card needed),
    while on the CPU every value runs the plain version."""
    tcfg = weights[2]
    cuda = torch.device("cuda", 0)
    assert decode_config(tcfg, 32).decode_attn == "pallas"
    check_decode_attn(decode_config(tcfg, 32, decode_attn="auto"), cuda)
    with pytest.raises(ValueError, match="decode_attn='xla'"):
        check_decode_attn(decode_config(tcfg, 32, decode_attn="xla"), cuda)
    check_decode_attn(decode_config(tcfg, 32, decode_attn="xla"),
                      torch.device("cpu"))
    # keep_tp keeps the tp layout of a tp config (TP decode, slice 17)
    tp_cfg = dataclasses.replace(tcfg, tp_axis="tp", tp_size=2)
    assert decode_config(tp_cfg, 32, keep_tp=True).tp_size == 2
    assert decode_config(tp_cfg, 32).tp_size == 1

"""The tp-sharded decode of the port against the JAX package's
``tests/test_generate.py:109-166`` and ``tests/test_quant.py:160-181``,
on the same weights (``llama_params_from_flax``) and numpy prompts:

* a tp-trained config without ``mesh=`` decodes replicated (the
  model-axis knobs cleared), token for token the no-cache rollout and
  JAX's ``llama_generate``;
* ``llama_generate(..., mesh=MeshAxis("tp", 2))`` (sharded heads,
  per-shard caches, psum-merged logits) equals the no-cache rollout and
  JAX's tp decode over a 2-device ("tp",) mesh, token for token;
* sampling under tp: every shard draws from the same replicated logits
  with the one generator, the same stream as the tp=1 decode;
* weight- and KV-quantized tp decode (per-output-channel scales shard
  with their kernel) reproduces the replicated quantized decode;
* the per-shard cache layout and the tp decode config.

Greedy tokens are compared exactly, as in JAX's tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from bluefog_tpu import models as jm
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models import generate as TG
from bluefog_tpu_torch.models.quant import quantize_llama_params

B, T_PROMPT, NEW = 2, 7, 9
TP = bt.MeshAxis("tp", 2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module: its many tiny torch ops
    otherwise wait on torch's spinning thread pool whenever the host is
    shared (by the test run's other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jax.jit(jm.Llama(cfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((B, 4), jnp.int32)))
    prompt = np.random.RandomState(0).randint(
        0, 256, (B, T_PROMPT)).astype(np.int32)
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    state = llama_params_from_flax(variables, tcfg, device="cpu")
    jtp = jm.LlamaConfig.tiny(dtype=jnp.float32, tp_axis="tp", tp_size=2)
    mesh = Mesh(np.array(jax.devices()[:2]), ("tp",))
    j_tp = np.asarray(jm.llama_generate(variables, jtp,
                                        jnp.asarray(prompt), NEW,
                                        mesh=mesh))
    j_plain = np.asarray(jm.llama_generate(variables, jtp,
                                           jnp.asarray(prompt), 4))
    return dict(variables=variables, prompt=prompt, state=state,
                j_tp=j_tp, j_plain=j_plain)


def _tp_cfg(**over):
    return bt.LlamaConfig.tiny(dtype=torch.float32, tp_axis="tp",
                               tp_size=2, **over)


def _rollout(state, prompt, new):
    """Greedy decoding without a cache: the whole forward on the growing
    sequence, the argmax of the last position."""
    model = bt.Llama(bt.LlamaConfig.tiny(dtype=torch.float32),
                     device="cpu")
    model.load_state_dict(state)
    seq = torch.from_numpy(prompt).long()
    with torch.no_grad():
        for _ in range(new):
            nxt = model(seq)[:, -1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    return seq.numpy()


def test_generate_clears_model_parallel_axes(weights):
    """A tp-trained config decodes with replicated params when no mesh
    is given: the model-axis knobs are training-time layouts, cleared."""
    got = bt.llama_generate(weights["state"], _tp_cfg(),
                            torch.from_numpy(weights["prompt"]), 4,
                            device="cpu").numpy()
    np.testing.assert_array_equal(got, _rollout(weights["state"],
                                                weights["prompt"], 4))
    np.testing.assert_array_equal(got, weights["j_plain"])


def test_tp_sharded_decode_matches_rollout_and_jax(weights):
    """K/V-cached generation under tp=2 (sharded heads, per-shard
    caches, psum-merged logits) equals the replicated no-cache rollout
    and JAX's tp decode, token for token; a module passed in decodes in
    the tp layout too (the same weights, retargeted)."""
    prompt = torch.from_numpy(weights["prompt"])
    got = bt.llama_generate(weights["state"], _tp_cfg(), prompt, NEW,
                            mesh=TP, device="cpu").numpy()
    np.testing.assert_array_equal(got, _rollout(weights["state"],
                                                weights["prompt"], NEW))
    np.testing.assert_array_equal(got, weights["j_tp"])
    model = bt.Llama(TG.decode_config(bt.LlamaConfig.tiny(
        dtype=torch.float32), T_PROMPT + NEW), device="cpu")
    model.load_state_dict(weights["state"])
    again = bt.llama_generate(model, _tp_cfg(), prompt, NEW, mesh=TP,
                              device="cpu").numpy()
    np.testing.assert_array_equal(again, got)
    assert model.cfg.tp_size == 1   # the caller's module is left as it was
    with pytest.raises(TypeError, match="MeshAxis"):
        bt.llama_generate(weights["state"], _tp_cfg(), prompt, 2,
                          mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="tp axis"):
        bt.llama_generate(weights["state"], _tp_cfg(), prompt, 2,
                          mesh=bt.MeshAxis("tp", 4), device="cpu")


def test_tp_sharded_decode_sampling_equals_tp1(weights):
    """Temperature sampling under tp: every shard draws from the SAME
    replicated logits with the one generator: the tp=1 stream."""
    prompt = torch.from_numpy(weights["prompt"])
    a = bt.llama_generate(weights["state"], _tp_cfg(), prompt, 5,
                          temperature=0.8, mesh=TP, device="cpu",
                          rng=torch.Generator().manual_seed(7))
    b = bt.llama_generate(weights["state"], bt.LlamaConfig.tiny(
        dtype=torch.float32), prompt, 5, temperature=0.8, device="cpu",
        rng=torch.Generator().manual_seed(7))
    assert torch.equal(a, b)


def test_tp_sharded_quant_decode():
    """weight_quant + kv_quant compose with the tp-sharded decode:
    per-output-channel scales shard with their kernel's output dim
    (``llama_param_specs``), each shard's row-parallel partial applies
    the replicated scale, and the sharded decode reproduces the
    replicated one's tokens (``tests/test_quant.py:160-181``: its
    config, init and prompt, weight-only int8 as there; under w8a8 each
    shard quantizes its own slice of a row, as a JAX device does, which
    is another rounding than the replicated row's)."""
    weight_quant = "int8"
    jcfg = jm.LlamaConfig.tiny(max_seq_len=96)
    variables = jax.tree.map(np.asarray, jax.jit(jm.Llama(jcfg).init)(
        jax.random.PRNGKey(7), jnp.zeros((2, 8), jnp.int32)))
    prompt = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (2, 12)).astype(np.int32))
    cfg0 = bt.LlamaConfig.tiny(max_seq_len=96)
    qstate = quantize_llama_params(llama_params_from_flax(
        variables, cfg0, device="cpu"))
    cfg = dataclasses.replace(cfg0, tp_axis="tp", tp_size=2)
    ref = bt.llama_generate(qstate, cfg0, prompt, 8, kv_quant="int8",
                            weight_quant=weight_quant, device="cpu")
    got = bt.llama_generate(qstate, cfg, prompt, 8, mesh=TP,
                            kv_quant="int8", weight_quant=weight_quant,
                            device="cpu")
    assert torch.equal(got, ref)


def test_tp_cache_is_per_shard():
    """``init_cache(keep_tp=True)`` holds each shard's own kv heads,
    folded into the batch shard-major, with one index per row; the tp
    decode config keeps the tp knobs and clears the training layouts."""
    cfg = _tp_cfg(vocab_parallel=True)
    dcfg = TG.decode_config(cfg, 32, keep_tp=True)
    assert (dcfg.tp_axis, dcfg.tp_size, dcfg.vocab_parallel) == ("tp", 2,
                                                                 False)
    assert TG.decode_config(cfg, 32).tp_size == 1
    cache = bt.init_cache(dcfg, 3, 32, keep_tp=True, device="cpu")
    assert cache.shards == 2
    assert cache.key.shape == (2, 6, 1, 32, 16)
    assert cache.index.shape == (3,)
    q = bt.init_cache(dcfg, 3, 32, keep_tp=True, kv_quant="int8",
                      device="cpu")
    assert q.key.dtype == torch.int8 and q.key_scale.shape == (2, 6, 1, 32)
    with pytest.raises(ValueError, match="row views"):
        cache.rows(0, 1)
    plain = bt.init_cache(dcfg, 3, 32, device="cpu")
    assert plain.shards == 1 and plain.key.shape == (2, 3, 2, 32, 16)

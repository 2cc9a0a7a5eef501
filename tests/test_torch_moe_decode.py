"""MoE decode in the port (bluefog_tpu_torch/models/generate.py and the
serving engine) against the JAX package (tests/test_moe_decode.py) on
``LlamaConfig.tiny(n_experts=4, moe_top_k=2)`` in f32, the JAX init
carried by ``llama_params_from_flax``:

* the port's greedy ``llama_generate`` gives JAX's tokens exactly;
* the cached decode equals a no-cache dropless rollout (one group,
  capacity factor = ``n_experts``) token for token, the contract of
  tests/test_moe_decode.py (run on the port: JAX's rollout re-jits at
  every length);
* the int8 K/V cache gives the same first token;
* ``decode_config``'s guards;
* ``ServingEngine`` serves the MoE config token-equal to
  ``llama_generate``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu import models as jm
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models.generate import decode_config
from bluefog_tpu_torch.serving import Request, ServingEngine

pytestmark = pytest.mark.moe

NEW = 12


def _over(**kw):
    return dict(n_experts=4, moe_top_k=2, max_seq_len=96, **kw)


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32, **_over())
    variables = jm.Llama(cfg).init(jax.random.PRNGKey(3),
                                   jnp.zeros((2, 8), jnp.int32))
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32, **_over())
    model = bt.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_flax(
        jax.tree.map(np.asarray, variables), tcfg, device="cpu"))
    return cfg, variables, tcfg, model


def _prompt(seed, b=2, t=10):
    return np.random.RandomState(seed).randint(0, 256, (b, t)).astype(
        np.int32)


def test_moe_generate_equals_jax_and_the_dropless_rollout():
    cfg, variables, tcfg, model = _weights()
    prompt = _prompt(0)
    want = np.asarray(jm.llama_generate(variables, cfg,
                                        jnp.asarray(prompt), NEW))
    got = bt.llama_generate(model, tcfg, prompt, NEW, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    # no-cache greedy rollout under the decode path's dropless semantics
    ref_cfg = dataclasses.replace(tcfg, moe_group_size=0,
                                  capacity_factor=float(tcfg.n_experts))
    ref = bt.Llama(ref_cfg, device="cpu")
    ref.load_state_dict(model.state_dict())
    seq = torch.from_numpy(prompt)
    with torch.no_grad():
        for _ in range(NEW):
            nxt = ref(seq)[:, -1].argmax(-1).to(torch.int32)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(got, seq.numpy())


def test_moe_decode_with_quantized_cache():
    _, _, tcfg, model = _weights()
    prompt = _prompt(1)
    full = bt.llama_generate(model, tcfg, prompt, 10, device="cpu").numpy()
    quant = bt.llama_generate(model, tcfg, prompt, 10, kv_quant="int8",
                              device="cpu").numpy()
    assert full.shape == quant.shape
    # the first decoded token agrees (quant noise can flip later
    # near-ties)
    assert (full[:, 10] == quant[:, 10]).all()


def test_moe_decode_config_and_guards():
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32, moe_group_size=64,
                               **_over())
    dcfg = decode_config(tcfg, 64)
    assert dcfg.capacity_factor == 4.0 and dcfg.moe_group_size == 64
    assert dcfg.decode and dcfg.max_seq_len == 64
    ec = bt.LlamaConfig.tiny(moe_router="expert_choice",
                             allow_noncausal_router=True, **_over())
    with pytest.raises(NotImplementedError, match="expert_choice"):
        bt.llama_generate({}, ec, np.zeros((1, 4), np.int32), 2,
                          device="cpu")
    with pytest.raises(ValueError, match="DROPLESS"):
        bt.LlamaConfig.tiny(decode=True, capacity_factor=1.25, **_over())


def test_engine_serves_moe_like_generate():
    _, _, tcfg, model = _weights()
    eng = ServingEngine(model, tcfg, capacity=2, max_len=64,
                        prefill_chunk=4, device="cpu")
    prompts = [_prompt(s, b=1, t=t)[0] for s, t in ((2, 5), (3, 9), (4, 3))]
    budgets = [6, 4, 7]
    reqs = [Request(p, n) for p, n in zip(prompts, budgets)]
    eng.submit(reqs[0])
    eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    eng.run()
    for r, p, n in zip(reqs, prompts, budgets):
        assert r.state == "completed"
        want = bt.llama_generate(model, tcfg, p[None], n, max_len=64,
                                 device="cpu").numpy()[0]
        np.testing.assert_array_equal(r.output(), want)

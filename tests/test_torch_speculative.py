"""Speculative decoding in the port's engine (``SpeculativeConfig``, the
draft/verify step and ``verify_window``) on ``LlamaConfig.tiny`` in f32,
mirroring the speculative tests of tests/test_fleet_serving.py: at
temperature 0 the speculative stream is bit for bit the plain engine's,
the port's one-shot ``llama_generate`` and the JAX package's, with the
target as its own draft and with an independently drawn draft; sampled
streams complete and repeat per seed, a sampled self-draft accepts every
proposal, and the rejection step gives the target's distribution; submit
reserves the lookahead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu import models as jm
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models.generate import (decode_config, init_cache,
                                               prefill_cache, verify_window)
from bluefog_tpu_torch.observe.registry import MetricsRegistry
from bluefog_tpu_torch.serving import (Request, ServingEngine,
                                       SpeculativeConfig)

MAX_LEN = 48


def _state(seed, tcfg):
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    variables = jm.Llama(cfg).init(jax.random.PRNGKey(seed),
                                   jnp.zeros((2, 4), jnp.int32))
    return cfg, variables, llama_params_from_flax(
        jax.tree.map(np.asarray, variables), tcfg, device="cpu")


@pytest.fixture(scope="module")
def weights():
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    cfg, variables, state = _state(1, tcfg)
    draft = _state(7, tcfg)[2]
    model = bt.Llama(tcfg, device="cpu")
    model.load_state_dict(state)
    return cfg, variables, tcfg, model, draft


def _spec_engine(weights, draft, lookahead=3, **kw):
    tcfg, model = weights[2], weights[3]
    spec = SpeculativeConfig(variables=draft, cfg=tcfg, lookahead=lookahead)
    kw.setdefault("capacity", 2)
    return ServingEngine(model, tcfg, max_len=MAX_LEN, prefill_chunk=4,
                         speculative=spec, registry=MetricsRegistry(),
                         device="cpu", **kw)


def _one_shot(weights, prompt, n):
    tcfg, model = weights[2], weights[3]
    return bt.llama_generate(model, tcfg, prompt[None], n, max_len=MAX_LEN,
                             device="cpu").numpy()[0]


def _jax_one_shot(weights, prompt, n):
    cfg, variables = weights[:2]
    return np.asarray(jm.llama_generate(variables, cfg,
                                        jnp.asarray(prompt[None]), n,
                                        max_len=MAX_LEN))[0]


def _prompts(sizes, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (n,)).astype(np.int32) for n in sizes]


# The f32 window's bound, in grid steps of the logits' largest entry
# (eps * max|logits|).  The window runs every projection and the head as
# one GEMM over its 6 rows, a prefill of i + 1 tokens over i + 1 rows,
# and the BLAS library picks its kernel, and so its summation order, by
# the row count and the host's CPU: the two paths part by a few grid
# steps (5.6 on an AMD EPYC host with MKL).  32 steps hold that with
# room; a position off by one moves the logits by O(1).
F32_GRID_STEPS = 32


def _window_and_prefills(tcfg, param_dtype=None):
    """verify_window's logits over 6 tokens, and for each position i the
    last logits of a prefill of the first i + 1 tokens ([1, 6, V] each);
    the window's and a whole prefill's caches must be equal."""
    model = bt.Llama(tcfg, device="cpu", param_dtype=param_dtype,
                     generator=torch.Generator().manual_seed(3))
    dcfg = decode_config(tcfg, 16)
    toks = torch.from_numpy(_prompts((6,), 5)[0][None])
    c1 = init_cache(dcfg, 1, 16, device="cpu")
    logits, _ = verify_window(model, c1, toks)
    assert logits.shape == (1, 6, tcfg.vocab_size)
    c2 = init_cache(dcfg, 1, 16, device="cpu")
    prefill_cache(model, c2, toks)
    assert torch.equal(c1.key, c2.key) and torch.equal(c1.index, c2.index)
    lasts = []
    for i in range(6):
        ci = init_cache(dcfg, 1, 16, device="cpu")
        last, _ = prefill_cache(model, ci, toks[:, :i + 1])
        lasts.append(last[:, -1])
    return logits, torch.stack(lasts, 1)


def _worst_ratio(logits, prefills, tol, shift=0):
    """The largest |window - prefill| over ``tol`` (a scalar or the
    entries' own allowance), position i against the prefill of the first
    i + 1 + ``shift`` tokens (``shift`` != 0: the planted off-by-one)."""
    idx = [i + shift for i in range(6) if 0 <= i + shift < 6]
    pos = [i for i in range(6) if 0 <= i + shift < 6]
    gap = (logits[:, pos] - prefills[:, idx]).abs()
    if not isinstance(tol, float):
        tol = tol[:, idx]
    return float((gap / tol).max())


def test_verify_window_keeps_every_position():
    """``verify_window`` writes the K/V ``prefill_cache`` writes and keeps
    every position's logits: position i equals a prefill of the first
    i + 1 tokens in f32 within ``F32_GRID_STEPS`` grid steps of the
    largest logit, and a planted off-by-one position (either way) is
    rejected."""
    logits, prefills = _window_and_prefills(
        bt.LlamaConfig.tiny(dtype=torch.float32))
    assert logits.dtype == torch.float32
    tol = F32_GRID_STEPS * torch.finfo(torch.float32).eps * float(
        prefills.abs().max())
    assert _worst_ratio(logits, prefills, tol) <= 1.0
    for shift in (-1, 1):
        assert _worst_ratio(logits, prefills, tol, shift) > 1.0, shift


def test_verify_window_keeps_every_position_f64():
    """The same contract where f32 rounding cannot reach it: the tiny
    config in float64 with the head in float64 too
    (``logits_dot_in_fp32=False``; the default f32 head is itself a GEMM
    over the window's rows), at rtol = atol = 1e-12; a planted
    off-by-one position is rejected."""
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float64, logits_dot_in_fp32=False)
    logits, prefills = _window_and_prefills(tcfg, torch.float64)
    tol = 1e-12 + 1e-12 * prefills.abs()
    assert _worst_ratio(logits, prefills, tol) <= 1.0
    for shift in (-1, 1):
        assert _worst_ratio(logits, prefills, tol, shift) > 1.0, shift


def test_speculative_self_draft_exact_and_fast(weights):
    """Target as its own draft at temperature 0: every window verifies,
    so each step emits lookahead + 1 tokens, and the stream is bit-exact
    with the port's plain engine, its one-shot path and the JAX
    package's one-shot path."""
    prompts = _prompts((5, 9, 3), 0)
    eng = _spec_engine(weights, weights[3])
    plain = ServingEngine(weights[3], weights[2], capacity=2,
                          max_len=MAX_LEN, prefill_chunk=4, device="cpu",
                          registry=MetricsRegistry())
    reqs = [eng.submit(Request(p, 8)) for p in prompts]
    preqs = [plain.submit(Request(p, 8)) for p in prompts]
    eng.run()
    plain.run()
    for r, pr, p in zip(reqs, preqs, prompts):
        np.testing.assert_array_equal(r.output(), pr.output())
        np.testing.assert_array_equal(r.output(), _one_shot(weights, p, 8))
        np.testing.assert_array_equal(r.output(),
                                      _jax_one_shot(weights, p, 8))
    m = eng.metrics.summary()
    assert m["spec_steps"] > 0 and m["accepted_per_step"] == 4.0
    assert m["decode_steps"] == m["spec_steps"]
    assert eng.nonfinite_logit_rows() == 0


def test_speculative_independent_draft_exact(weights):
    """A draft drawn from another seed disagrees almost everywhere (the
    rejection path dominates), and the output is still bit-exact at
    temperature 0, with the prefix cache on: target and draft pools
    restore in lockstep."""
    prompts = _prompts((9, 3, 9), 1)
    prompts[2][:8] = prompts[0][:8]     # a shared 8-token prefix
    eng = _spec_engine(weights, weights[4], prefix_cache=True)
    reqs = [eng.submit(Request(p, 6)) for p in prompts]
    eng.run()
    for r, p in zip(reqs, prompts):
        np.testing.assert_array_equal(r.output(), _one_shot(weights, p, 6))
        np.testing.assert_array_equal(r.output(),
                                      _jax_one_shot(weights, p, 6))
    m = eng.metrics.summary()
    assert 1.0 <= m["accepted_per_step"] < 2.0
    assert m["prefix_chunks_restored"] == 2
    assert len(eng._draft_pool.prefix) == len(eng.pool.prefix) == 2


def test_speculative_sampled_path_completes(weights):
    """temperature > 0 goes through rejection sampling and the residual
    resample: streams complete within budget, and repeat bit for bit
    for the same seeds (distribution equality is the algorithm's
    guarantee; the draws are the port's generators, not jax.random's)."""
    prompts = _prompts((5, 5), 2)
    outs = []
    for _ in range(2):
        eng = _spec_engine(weights, weights[4])
        reqs = [eng.submit(Request(p, 6, temperature=0.8, seed=3 + i))
                for i, p in enumerate(prompts)]
        eng.run()
        for r, p in zip(reqs, prompts):
            assert r.state == "completed"
            assert r.output().size == p.size + 6
            assert (r.output() >= 0).all()
        outs.append([r.output() for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_speculative_sampled_self_draft_accepts_every_proposal(weights):
    """At temperature > 0 with the target as its own draft, p == q at
    every proposal, so the acceptance ratio is 1 and every window is
    accepted whole: lookahead + 1 tokens a step, as at temperature 0."""
    prompts = _prompts((5, 9), 4)
    eng = _spec_engine(weights, weights[3])
    reqs = [eng.submit(Request(p, 8, temperature=0.9, seed=11 + i))
            for i, p in enumerate(prompts)]
    eng.run()
    assert all(r.state == "completed" for r in reqs)
    m = eng.metrics.summary()
    assert m["spec_steps"] > 0 and m["accepted_per_step"] == 4.0


# chi-square 0.999 quantiles for 5 degrees of freedom (6 bins) and the
# normal tail used for the acceptance rate
_CHI2_5_999 = 20.515
_Z = 4.0


def _chi2(counts, probs):
    n = counts.sum()
    want = n * probs
    return float(((counts - want) ** 2 / want).sum())


def test_speculative_rejection_sampling_matches_the_target(weights):
    """The rejection step on its own, over a 6-token vocabulary and 4000
    seeds: proposals drawn as the engine draws them from a draft q,
    accepted with probability min(1, p/q), and the correction drawn from
    the residual max(0, p - q), give a first emitted token distributed
    as the target's p[0] (chi-square at 0.999), a second one (given the
    first proposal was accepted) as p[1], and an acceptance rate of
    sum(min(p[0], q[0])) within 4 standard deviations."""
    eng = _spec_engine(weights, weights[3], lookahead=2)
    temp = 0.7
    rs = np.random.RandomState(0)
    vlogits = torch.from_numpy(rs.randn(3, 6).astype(np.float32) * 1.5)
    dlg = torch.from_numpy(rs.randn(3, 6).astype(np.float32) * 1.5)
    p = torch.softmax(vlogits / temp, dim=-1).double().numpy()
    q = torch.softmax(dlg / temp, dim=-1).double().numpy()
    n = 4000
    first = np.zeros(6)
    second = np.zeros(6)
    accepted = 0
    # tens of thousands of ops on a few elements each: one intra-op
    # thread, or on a loaded host every op waits for the pool's threads
    # (the draws are sequential per generator either way)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reqs = [Request(np.zeros(1, np.int32), 4, temperature=temp,
                        seed=seed) for seed in range(n)]
        # every seed's proposals in one _sample call a position: each row
        # draws from its own request's (seed, position, salt) generator,
        # as the one-row calls do
        slots = dict(enumerate(reqs))
        all_props = torch.stack([
            eng._sample(dlg[i:i + 1].expand(n, -1), slots, i, salt=1)
            for i in range(3)], 1)
        for seed, req in enumerate(reqs):
            props = all_props[seed]
            n_acc, corr = eng._spec_sampled(req, vlogits, dlg, props, 2)
            n_acc = int(n_acc)
            emitted = [int(t) for t in props[:n_acc]] + [int(corr)]
            first[emitted[0]] += 1
            if n_acc >= 1:
                accepted += 1
                second[emitted[1]] += 1
    finally:
        torch.set_num_threads(threads)
    assert _chi2(first, p[0]) < _CHI2_5_999
    assert _chi2(second, p[1]) < _CHI2_5_999
    rate = np.minimum(p[0], q[0]).sum()
    assert abs(accepted - n * rate) < _Z * np.sqrt(n * rate * (1 - rate))
    # the test has power: the draft's own distribution is far from p
    assert _chi2(first, q[0]) > 10 * _CHI2_5_999


def test_speculative_headroom_reservation(weights):
    """submit() reserves lookahead positions past the budget: a prompt
    that fits the plain engine is refused by the speculative one, and
    the config is checked."""
    tcfg, model = weights[2], weights[3]
    prompt = np.arange(MAX_LEN - 8, dtype=np.int32)
    plain = ServingEngine(model, tcfg, capacity=1, max_len=MAX_LEN,
                          prefill_chunk=4, device="cpu")
    plain.submit(Request(prompt, 8))  # exactly fits
    eng = _spec_engine(weights, model)
    with pytest.raises(ValueError, match="headroom"):
        eng.submit(Request(prompt, 8))
    with pytest.raises(ValueError, match="decode_horizon"):
        _spec_engine(weights, model, decode_horizon=2)
    with pytest.raises(ValueError, match="lookahead"):
        _spec_engine(weights, model, lookahead=0)
    with pytest.raises(ValueError, match="weight_quant"):
        ServingEngine(model, tcfg, capacity=1, max_len=MAX_LEN,
                      prefill_chunk=4, device="cpu",
                      speculative=SpeculativeConfig(
                          model, tcfg, weight_quant="int8"))

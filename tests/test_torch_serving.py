"""The port's continuous-batching engine (bluefog_tpu_torch/serving/)
on ``LlamaConfig.tiny`` in f32, mirroring tests/test_serving.py: for any
arrival pattern a greedy request's output is token-exact with the port's
one-shot ``llama_generate(prompt[None], n, max_len=pool_max_len)`` and
with the JAX ``ServingEngine`` serving the same weights; plus slot
reuse, EOS retirement, deadlines, cancellation, backpressure,
``decode_horizon`` invariance and the int8 cache."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu import models as jm
from bluefog_tpu import serving as jserving
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.serving import (FifoScheduler, Request,
                                       RequestRejected, ServingEngine,
                                       SlotPool)

MAX_LEN = 48


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def weights():
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    variables = jm.Llama(cfg).init(jax.random.PRNGKey(1),
                                   jnp.zeros((2, 4), jnp.int32))
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    model = bt.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_flax(
        jax.tree.map(np.asarray, variables), tcfg, device="cpu"))
    return cfg, variables, tcfg, model


def _engine(weights, **kw):
    _, _, tcfg, model = weights
    kw.setdefault("capacity", 2)
    kw.setdefault("prefill_chunk", 4)
    return ServingEngine(model, tcfg, max_len=MAX_LEN, device="cpu", **kw)


def _one_shot(weights, prompt, n, **kw):
    _, _, tcfg, model = weights
    return bt.llama_generate(model, tcfg, prompt[None], n, max_len=MAX_LEN,
                             device="cpu", **kw).numpy()[0]


def _prompts(sizes, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (n,)).astype(np.int32) for n in sizes]


def _staggered(eng, reqs):
    """The arrival pattern of test_serving.py: r0, two steps, r1, a
    step, then r2 and r3 together."""
    eng.submit(reqs[0])
    eng.step()
    eng.step()
    eng.submit(reqs[1])
    eng.step()
    for r in reqs[2:]:
        eng.submit(r)
    eng.run()


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_staggered_arrivals_match_one_shot_and_jax_engine(weights,
                                                          kv_quant):
    cfg, variables = weights[:2]
    prompts = _prompts((5, 9, 3, 1))
    budgets = [6, 4, 8, 5]
    eng = _engine(weights, kv_quant=kv_quant)
    reqs = [Request(p, b) for p, b in zip(prompts, budgets)]
    _staggered(eng, reqs)
    jeng = jserving.ServingEngine(variables, cfg, capacity=2,
                                  max_len=MAX_LEN, prefill_chunk=4,
                                  kv_quant=kv_quant)
    jreqs = [jserving.Request(p, b) for p, b in zip(prompts, budgets)]
    _staggered(jeng, jreqs)
    for r, jr, p, b in zip(reqs, jreqs, prompts, budgets):
        assert r.state == "completed"
        np.testing.assert_array_equal(
            r.output(), _one_shot(weights, p, b, kv_quant=kv_quant))
        np.testing.assert_array_equal(r.output(), jr.output())
    assert eng.nonfinite_logit_rows() == 0


def test_slot_reuse_is_invisible(weights):
    prompts = _prompts((7, 5), seed=3)
    eng = _engine(weights, capacity=1)
    r0 = eng.submit(Request(prompts[0], 6))
    eng.step()  # r0 admitted into slot 0, mid-flight
    r1 = eng.submit(Request(prompts[1], 6))
    eng.run()
    assert r0.slot is None and r1.slot is None
    assert eng.pool.n_free == 1
    for r, p in zip((r0, r1), prompts):
        np.testing.assert_array_equal(r.output(),
                                      _one_shot(weights, p, 6))


@pytest.mark.parametrize("zero_on_free", [False, True])
def test_zero_on_free_both_ways_exact(weights, zero_on_free):
    prompts = _prompts((6, 4, 8), seed=13)
    eng = _engine(weights, capacity=1, zero_on_free=zero_on_free)
    reqs = [eng.submit(Request(p, 5)) for p in prompts]
    eng.run()
    for r, p in zip(reqs, prompts):
        np.testing.assert_array_equal(r.output(),
                                      _one_shot(weights, p, 5))
    assert (int(torch.count_nonzero(eng.pool.cache.key)) == 0) \
        == zero_on_free


def test_eos_retires_slot_and_truncates(weights):
    (prompt,) = _prompts((5,), seed=1)
    full = _one_shot(weights, prompt, 10)
    gen = full[prompt.size:]
    stop = next(i for i in range(2, 10) if gen[i] not in gen[:i])
    eos = int(gen[stop])
    eng = _engine(weights, capacity=1)
    r0 = eng.submit(Request(prompt, 10, eos_id=eos))
    r1 = eng.submit(Request(prompt, 2))  # waits for r0's slot
    eng.run()
    assert r0.state == "completed"
    assert len(r0.tokens) == stop + 1 and r0.tokens[-1] == eos
    np.testing.assert_array_equal(r0.output(),
                                  full[:prompt.size + stop + 1])
    assert r1.state == "completed" and len(r1.tokens) == 2


def test_decode_horizon_invariant(weights):
    prompts = _prompts((5, 9, 3), seed=11)
    budgets = [7, 4, 6]
    gen = _one_shot(weights, prompts[0], 10)[prompts[0].size:]
    eos = int(gen[next(i for i in range(2, 10) if gen[i] not in gen[:i])])

    def serve(horizon):
        eng = _engine(weights, decode_horizon=horizon)
        reqs = [Request(prompts[0], 10, eos_id=eos)] + \
            [Request(p, b) for p, b in zip(prompts[1:], budgets[1:])]
        eng.submit(reqs[0])
        eng.step()
        for r in reqs[1:]:
            eng.submit(r)
        eng.run()
        assert eng.metrics.summary()["decode_steps"] > 0
        return [r.output() for r in reqs]

    a, b = serve(1), serve(4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for y, p, n in zip(b[1:], prompts[1:], budgets[1:]):
        np.testing.assert_array_equal(y, _one_shot(weights, p, n))


def test_temperature_sampling_deterministic_and_independent(weights):
    """A sampled stream is a function of (seed, token index) only: the
    same request served alone or co-batched, at any horizon, gives the
    same tokens."""
    prompts = _prompts((5, 6), seed=7)

    def serve(reqs, capacity, horizon=1):
        eng = _engine(weights, capacity=capacity, decode_horizon=horizon)
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.output() for r in reqs]

    a = serve([Request(prompts[0], 6, temperature=0.8, seed=5),
               Request(prompts[1], 6, temperature=1.2, seed=9)], 2)
    b = serve([Request(prompts[0], 6, temperature=0.8, seed=5)], 1, 3)
    np.testing.assert_array_equal(a[0], b[0])
    assert np.all((a[1] >= 0) & (a[1] < 256))
    c = serve([Request(prompts[0], 6, temperature=0.8, seed=6)], 1)
    assert not np.array_equal(a[0], c[0])


def test_deadline_cancels_running_and_queued(weights):
    clock = VirtualClock()
    prompts = _prompts((4, 4), seed=2)
    eng = _engine(weights, capacity=1, clock=clock)
    r0 = eng.submit(Request(prompts[0], 20, deadline=1.0))
    r1 = eng.submit(Request(prompts[1], 2, deadline=0.5))
    steps = 0
    while eng.step():
        clock.advance(1.0)
        steps += 1
        assert steps < 50
    assert r0.state == "cancelled"
    assert 0 < len(r0.tokens) < 20
    assert r1.state == "cancelled" and r1.tokens == []
    assert eng.pool.n_free == 1


def test_deadline_cancels_mid_prefill(weights):
    clock = VirtualClock()
    long_prompt, short_prompt = _prompts((17, 4), seed=5)
    eng = _engine(weights, capacity=1, prefill_chunk=2, clock=clock)
    r0 = eng.submit(Request(long_prompt, 8, deadline=2.5))
    r1 = eng.submit(Request(short_prompt, 3))
    saw_prefill = False
    steps = 0
    while eng.step():
        saw_prefill = saw_prefill or r0.state == "prefill"
        clock.advance(1.0)
        steps += 1
        assert steps < 50
    assert saw_prefill
    assert r0.state == "cancelled"
    assert r0.tokens == [] and r0.slot is None
    assert r1.state == "completed"
    assert eng.pool.n_free == 1
    np.testing.assert_array_equal(r1.output(),
                                  _one_shot(weights, short_prompt, 3))
    assert eng.metrics.summary()["outcomes"].get("cancelled") == 1


def test_explicit_cancellation(weights):
    prompts = _prompts((4, 4), seed=4)
    eng = _engine(weights, capacity=1, prefill_chunk=8)
    r0 = eng.submit(Request(prompts[0], 20))
    r1 = eng.submit(Request(prompts[1], 3))
    eng.step()
    assert eng.cancel(r0)
    eng.run()
    assert r0.state == "cancelled"
    assert r1.state == "completed"
    assert not eng.cancel(r0)


def test_pool_full_rejects_with_queue_depth(weights):
    (prompt,) = _prompts((4,))
    eng = _engine(weights, capacity=1, prefill_chunk=8, max_queue=2)
    eng.submit(Request(prompt, 4))
    eng.step()
    eng.submit(Request(prompt, 4))
    eng.submit(Request(prompt, 4))
    with pytest.raises(RequestRejected) as ei:
        eng.submit(Request(prompt, 4))
    assert ei.value.queue_depth == 2 and ei.value.max_queue == 2
    assert "queue depth 2/2" in str(ei.value)
    assert eng.metrics.summary()["n_rejected"] == 1
    eng.run()


def test_submit_validates_slot_capacity(weights):
    (prompt,) = _prompts((40,))
    eng = _engine(weights, capacity=1, prefill_chunk=8)
    big = Request(prompt, MAX_LEN)
    with pytest.raises(ValueError, match="cache positions"):
        eng.submit(big)
    assert big.state == "rejected" and big.done
    assert eng.metrics.summary()["n_rejected"] == 1
    with pytest.raises(ValueError, match="max_new_tokens"):
        Request(prompt, 0)
    with pytest.raises(ValueError, match="divide max_len"):
        _engine(weights, capacity=1, prefill_chunk=32)


def test_prompt_filling_the_slot_is_exact(weights):
    (prompt,) = _prompts((MAX_LEN - 6,), seed=12)
    eng = _engine(weights, capacity=1, prefill_chunk=8)
    r = eng.submit(Request(prompt, 6))
    eng.run()
    np.testing.assert_array_equal(r.output(), _one_shot(weights, prompt, 6))


def test_unported_options_raise(weights):
    for kw in (dict(speculative=object()), dict(prefix_cache=True),
               dict(weight_quant="int8")):
        with pytest.raises(NotImplementedError):
            _engine(weights, **kw)
    eng = _engine(weights)
    with pytest.raises(NotImplementedError):
        eng.drain()
    with pytest.raises(NotImplementedError):
        eng.profile()
    other = bt.LlamaConfig.tiny(dtype=torch.float32, n_layers=3)
    with pytest.raises(ValueError, match="another config"):
        ServingEngine(weights[3], other, capacity=1, max_len=MAX_LEN,
                      prefill_chunk=4, device="cpu")


def test_kv_pool_alloc_free(weights):
    pool = SlotPool(weights[2], capacity=3, max_len=16, device="cpu")
    slots = [pool.alloc() for _ in range(3)]
    assert sorted(slots) == [0, 1, 2]
    assert pool.alloc() is None and pool.n_free == 0
    assert pool.occupancy() == 1.0
    pool.cache.index[slots[1]] = 5
    pool.free(slots[1])
    assert pool.n_free == 1 and int(pool.cache.index[slots[1]]) == 0
    assert pool.alloc() == slots[1]
    pool.free(slots[0])
    with pytest.raises(ValueError, match="not allocated"):
        pool.free(slots[0])
    assert tuple(pool.cache.key.shape) == (2, 3, 2, 16, 16)
    q8 = SlotPool(weights[2], capacity=2, max_len=16, kv_quant="int8",
                  device="cpu")
    assert q8.cache.key.dtype == torch.int8
    assert tuple(q8.cache.key_scale.shape) == (2, 2, 2, 16)


def test_scheduler_fifo_and_expiry():
    class R:
        def __init__(self, deadline=None):
            self.deadline = deadline

    s = FifoScheduler(max_queue=3)
    a, b, c = R(), R(deadline=1.0), R()
    for r in (a, b, c):
        s.submit(r)
    with pytest.raises(RequestRejected):
        s.submit(R())
    assert s.admit(now=2.0) is a
    assert s.admit(now=2.0) is c
    assert s.admit(now=2.0) is None


def test_metrics_and_timeline_spans(weights, tmp_path):
    from bluefog_tpu_torch import timeline

    clock = VirtualClock()
    path = str(tmp_path / "serve_tl")
    timeline.start_timeline(path)
    try:
        eng = _engine(weights, clock=clock)
        reqs = [eng.submit(Request(p, 4)) for p in _prompts((5, 6), seed=8)]
        while eng.step():
            clock.advance(0.25)
    finally:
        timeline.stop_timeline()
    m = eng.metrics.summary()
    assert m["n_finished"] == 2
    assert m["tokens_generated"] == 8
    assert m["tokens_per_sec"] > 0
    assert 0 < m["ttft_p50"] <= m["ttft_p99"]
    assert 0 < m["latency_p50"] <= m["latency_p99"]
    assert 0 < m["mean_slot_occupancy"] <= 1.0
    assert m["decode_steps"] >= 4 and m["decode_step_ms_p50"] > 0
    events = json.load(open(path + "0.json"))
    names = {e.get("name") for e in events}
    for phase in ("admission", "prefill", "decode", "retire"):
        assert phase in names, (phase, names)
    tracks = {e.get("tid") for e in events}
    for r in reqs:
        assert f"request.{r.rid}" in tracks

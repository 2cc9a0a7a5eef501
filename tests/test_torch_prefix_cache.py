"""The port's prefix cache (bluefog_tpu_torch/serving/prefix_cache.py and
the ``SlotPool`` hooks) on ``LlamaConfig.tiny`` in f32, mirroring the
prefix-cache and zero-on-free tests of tests/test_fleet_serving.py: the
chain-hash keys equal the JAX package's, the LRU keeps its byte bound,
and an engine that restores cached chunks emits bit for bit what a cold
engine emits (and, with the full-precision cache, what the JAX engine
with the prefix cache emits, with the same restored-chunk counts)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu import models as jm
from bluefog_tpu import serving as jserving
from bluefog_tpu.observe.registry import MetricsRegistry as JRegistry
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.observe.registry import MetricsRegistry
from bluefog_tpu_torch.serving import (PrefixCache, Request, ServingEngine,
                                       SlotPool)
from bluefog_tpu_torch.serving.prefix_cache import seq_axes

MAX_LEN = 48


@pytest.fixture(scope="module")
def weights():
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    variables = jm.Llama(cfg).init(jax.random.PRNGKey(1),
                                   jnp.zeros((2, 4), jnp.int32))
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    state = llama_params_from_flax(jax.tree.map(np.asarray, variables),
                                   tcfg, device="cpu")
    return cfg, variables, tcfg, state


def _engine(weights, **kw):
    tcfg, state = weights[2:]
    kw.setdefault("capacity", 1)
    kw.setdefault("prefill_chunk", 4)
    return ServingEngine(state, tcfg, max_len=MAX_LEN, device="cpu",
                         registry=MetricsRegistry(), **kw)


def _one_shot(weights, prompt, n):
    tcfg, state = weights[2:]
    return bt.llama_generate(state, tcfg, prompt[None], n, max_len=MAX_LEN,
                             device="cpu").numpy()[0]


def test_chunk_keys_are_chained():
    """Keys commit to the WHOLE prefix, only full chunks of prompt[:-1]
    are keyed, and they are the JAX package's keys."""
    pc = PrefixCache(chunk=4, capacity_bytes=1 << 20)
    a = np.arange(13, dtype=np.int32)            # 12 prefill tokens
    assert len(pc.chunk_keys(a)) == 3
    assert len(pc.chunk_keys(a[:12])) == 2       # 11 prefill -> 2 full
    assert len(pc.chunk_keys(a[:4])) == 0        # 3 prefill tokens
    b = a.copy()
    b[5] = 99                                    # differ inside chunk 1
    ka, kb = pc.chunk_keys(a), pc.chunk_keys(b)
    assert ka[0] == kb[0]
    assert ka[1] != kb[1] and ka[2] != kb[2]     # chain severed
    assert PrefixCache(chunk=8).chunk_keys(a)[0] != ka[0]
    assert ka == jserving.PrefixCache(chunk=4).chunk_keys(a)


def test_prefix_cache_lru_bound():
    """LRU eviction under the byte budget, refusal of an over-budget
    chunk, and the chain walk of match(), step for step with the JAX
    cache; torch payloads count their bytes as numpy ones do."""
    stats = []
    for cache, leaf, huge in (
            (PrefixCache(chunk=4, capacity_bytes=1000),
             torch.zeros(100), torch.zeros(1001, dtype=torch.uint8)),
            (jserving.PrefixCache(chunk=4, capacity_bytes=1000),
             np.zeros(100, np.float32), np.zeros(1001, np.uint8))):
        cache.insert("k0", [leaf])
        cache.insert("k1", [leaf])
        assert cache.match(["k0", "k1", "k2"]) == 2
        cache.insert("k2", [leaf])
        assert len(cache) == 2 and cache.nbytes == 800
        assert cache.match(["k0"]) == 0
        cache.insert("huge", [huge])
        assert len(cache) == 2
        assert cache.match(["k0", "k1"]) == 0
        assert "k1" in cache and cache.stats()["hits"] == 2  # no touch
        stats.append(cache.stats())
    assert stats[0] == stats[1]
    assert stats[0]["evictions"] == 1 and stats[0]["hit_rate"] < 1.0


def test_seq_axes_structural_detection(weights):
    """The sequence axis of each cache tensor comes from two layouts at
    two lengths: None for the index, axis 3 of ``[L, 1, KV, S, ...]``
    for the K/V codes and the int8 layout's scales."""
    tcfg = weights[2]
    assert seq_axes(tcfg, 16, "none") == (3, 3, None)
    assert seq_axes(tcfg, 16, "int8") == (3, 3, None, 3, 3)


def _families(seed):
    rs = np.random.RandomState(seed)
    prompts = []
    for _ in range(3):
        # a family: one prefix, continuations of random length
        prefix = rs.randint(0, 256, (rs.randint(3, 20),)).astype(np.int32)
        prompts.append(prefix)
        for _ in range(2):
            tail = rs.randint(0, 256, (rs.randint(1, 8),)).astype(np.int32)
            prompts.append(np.concatenate([prefix, tail]))
    return prompts, rs.permutation(len(prompts))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_prefix_admission_bitwise_exact_property(weights, kv_quant):
    """Shared-prefix prompt families (prefix lengths off the chunk grid,
    novel tails, capacity 1 recycling the slot between insert and
    restore): every output is bit-equal to a cold engine's.  With the
    full-precision cache the outputs and the restored-chunk counts are
    also the JAX engine's."""
    cfg, variables, tcfg, state = weights
    kw = {}
    if kv_quant == "int8":
        state = bt.models.quantize_llama_params(state)
        kw = dict(kv_quant="int8", weight_quant="int8")
    prompts, order = _families(42)
    eng = _engine((cfg, variables, tcfg, state), prefix_cache=True, **kw)
    cold = _engine((cfg, variables, tcfg, state), **kw)
    reqs = {}
    for i in order:
        reqs[i] = eng.submit(Request(prompts[i], 5))
        eng.run()
    for i, r in reqs.items():
        ref = cold.submit(Request(prompts[i], 5))
        cold.run()
        np.testing.assert_array_equal(r.output(), ref.output())
    m = eng.metrics.summary()
    assert m["prefix_chunks_restored"] > 0
    assert eng.pool.prefix.stats()["hits"] > 0
    assert cold.metrics.summary()["prefix_chunks_restored"] == 0
    if kv_quant == "none":
        jeng = jserving.ServingEngine(variables, cfg, capacity=1,
                                      max_len=MAX_LEN, prefill_chunk=4,
                                      prefix_cache=True,
                                      registry=JRegistry())
        for i in order:
            jr = jeng.submit(jserving.Request(prompts[i], 5))
            jeng.run()
            np.testing.assert_array_equal(reqs[i].output(), jr.output())
        jm_ = jeng.metrics.summary()
        for key in ("prefix_chunks_restored", "prefix_tokens_restored",
                    "prefill_chunks"):
            assert m[key] == jm_[key], key
        assert eng.pool.prefix.stats() == jeng.pool.prefix.stats()


def test_prefix_restore_skips_prefill_work(weights):
    """A warm admission computes only its novel tail (tests/
    test_fleet_serving.py:test_prefix_restore_skips_prefill_work)."""
    eng = _engine(weights, prefix_cache=True)
    rs = np.random.RandomState(7)
    prefix = rs.randint(0, 256, (16,)).astype(np.int32)
    a = np.concatenate([prefix, rs.randint(0, 256, (2,)).astype(np.int32)])
    b = np.concatenate([prefix, rs.randint(0, 256, (2,)).astype(np.int32)])
    eng.submit(Request(a, 4))
    eng.run()
    cold_chunks = eng.metrics.summary()["prefill_chunks"]
    rb = eng.submit(Request(b, 4))
    eng.run()
    m = eng.metrics.summary()
    # b's 17 prefill tokens = 4 cached chunks restored + 1 tail chunk
    assert m["prefix_chunks_restored"] == 4
    assert m["prefix_tokens_restored"] == 16
    assert m["prefill_chunks"] == cold_chunks + 1
    assert 0 < m["prefix_hit_rate"] < 1
    np.testing.assert_array_equal(rb.output(), _one_shot(weights, b, 4))


def test_prefix_chunk_must_match_engine_chunk(weights):
    with pytest.raises(ValueError, match="chunk"):
        _engine(weights, prefix_cache=PrefixCache(chunk=8))
    with pytest.raises(ValueError, match="divide"):
        SlotPool(weights[2], 1, 18, device="cpu",
                 prefix=PrefixCache(chunk=4))


@pytest.mark.parametrize("zero_on_free", [False, True])
def test_slot_reuse_exact_both_free_modes(weights, zero_on_free):
    """Index-reset and full-zero free both keep slot reuse bit-exact,
    with the prefix cache on (its chunks are stashed as they prefill,
    before any free)."""
    prompts = [p.astype(np.int32) for p in
               (np.arange(5) + 3, np.arange(9) * 2 + 1,
                np.arange(9) * 2 + 1)]
    eng = _engine(weights, zero_on_free=zero_on_free, prefix_cache=True)
    assert eng.pool.zero_on_free is zero_on_free
    for p in prompts:
        r = eng.submit(Request(p, 6))
        eng.run()
        np.testing.assert_array_equal(r.output(),
                                      _one_shot(weights, p, 6))
    assert eng.metrics.summary()["prefix_chunks_restored"] == 2


def test_free_modes_differ_only_in_retention(weights, monkeypatch):
    """After free the default leaves the K/V in place and resets only the
    index; zero-on-free wipes the slot; ``BLUEFOG_KV_ZERO_ON_FREE``
    selects the mode when the argument is None."""
    def run_one(zero):
        eng = _engine(weights, zero_on_free=zero)
        eng.submit(Request(np.arange(9, dtype=np.int32), 4))
        eng.run()
        cache = eng.pool.cache
        assert not cache.index.any()          # always reset
        return float(cache.key.abs().sum() + cache.value.abs().sum())

    assert run_one(zero=False) > 0.0         # bytes retained
    assert run_one(zero=True) == 0.0         # slot wiped
    tcfg = weights[2]
    monkeypatch.setenv("BLUEFOG_KV_ZERO_ON_FREE", "1")
    assert SlotPool(tcfg, 1, 16, device="cpu").zero_on_free
    monkeypatch.setenv("BLUEFOG_KV_ZERO_ON_FREE", "0")
    assert not SlotPool(tcfg, 1, 16, device="cpu").zero_on_free
    monkeypatch.setenv("BLUEFOG_PREFIX_CACHE_MB", "3")
    assert PrefixCache(4).capacity_bytes == 3 << 20

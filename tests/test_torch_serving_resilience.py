"""Serving resilience in the port (bluefog_tpu_torch/serving/resilience.py,
the engine's drain, ``EXPIRED``/``FAILOVER``, and the copied
``resilience/faults``, ``observe/blackbox`` and ``sim``) on
``LlamaConfig.tiny`` in f32, mirroring tests/test_serving_resilience.py:
serving fault plans behave as the JAX package's; a replica killed with a
mid-decode, a mid-prefill and a queued request fails over to a survivor
sharing the prefix cache, and every output (greedy and sampled) is bit
for bit a fault-free run's; a drain completes its residents in place or
hands them off token-exactly.  The JAX tests' zero-recompile assertions
have no counterpart (the port compiles no programs).  The router tests
are tests/test_torch_fleet_serving.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bluefog_tpu import models as jm
from bluefog_tpu.observe import blackbox as jblackbox
from bluefog_tpu.resilience import faults as jfaults
from bluefog_tpu.serving import resilience as jresilience
from bluefog_tpu.sim import engine as jsim
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.observe import blackbox
from bluefog_tpu_torch.observe.registry import MetricsRegistry
from bluefog_tpu_torch.resilience import ServingFault, ServingFaultPlan
from bluefog_tpu_torch.resilience import faults
from bluefog_tpu_torch.resilience.faults import REPLICA_DEATH
from bluefog_tpu_torch.serving import (FaultyReplica, PrefixCache, Request,
                                       RequestRejected, ServingEngine,
                                       backoff_sleep, failover_stranded,
                                       seeded_backoff)
from bluefog_tpu_torch.sim import engine as sim

MAX_LEN = 48


@pytest.fixture(scope="module")
def weights():
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    variables = jm.Llama(cfg).init(jax.random.PRNGKey(1),
                                   jnp.zeros((2, 4), jnp.int32))
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    model = bt.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_flax(
        jax.tree.map(np.asarray, variables), tcfg, device="cpu"))
    return tcfg, model


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _engine(weights, clock, prefix=None, **kw):
    tcfg, model = weights
    kw.setdefault("capacity", 2)
    kw.setdefault("max_queue", 8)
    kw.setdefault("prefill_chunk", 4)
    return ServingEngine(model, tcfg, max_len=MAX_LEN, clock=clock,
                         registry=MetricsRegistry(), device="cpu",
                         prefix_cache=(prefix if prefix is not None
                                       else False), **kw)


def _requests(rs, n=3, prompt_len=(6, 14), max_new=6):
    """Mixed temperatures: the sampled requests prove failover continues
    the per-request seed chain, not just the greedy argmax."""
    reqs = []
    for i in range(n):
        plen = int(rs.randint(*prompt_len))
        prompt = rs.randint(0, 256, (plen,)).astype(np.int32)
        reqs.append(Request(prompt, max_new, temperature=(0.0, 0.9)[i % 2],
                            seed=100 + i))
    return reqs


def _clone(req):
    return Request(req.prompt.copy(), req.max_new_tokens, eos_id=req.eos_id,
                   temperature=req.temperature, seed=req.seed)


def _reference(weights, reqs):
    eng = _engine(weights, _Clock())
    ref = [eng.submit(_clone(r)) for r in reqs]
    eng.run()
    return [r.output().copy() for r in ref]


def test_serving_fault_plan_semantics():
    """tests/test_serving_resilience.py:test_serving_fault_plan_semantics,
    and every query answered as the JAX package's plan answers it."""
    with pytest.raises(ValueError):
        ServingFault(0, 0, "nan")
    with pytest.raises(ValueError):
        ServingFault(-1, 0, REPLICA_DEATH)
    with pytest.raises(ValueError):
        ServingFaultPlan(2, [ServingFault(0, 2, REPLICA_DEATH)])
    plans = []
    for mod in (faults, jfaults):
        plans.append(mod.ServingFaultPlan.replica_death(3, 1, step=5).merged(
            mod.ServingFaultPlan.replica_stall(3, 2, step=2, duration=3,
                                               stall_seconds=0.5)).merged(
            mod.ServingFaultPlan.submit_rejection(3, 0, step=4,
                                                  duration=2)))
    plan, jplan = plans
    assert not plan.is_dead(1, 4)
    assert plan.is_dead(1, 5) and plan.is_dead(1, 500)
    assert plan.dead_replicas(5) == [1] and plan.dead_replicas(0) == []
    assert plan.stall_seconds(2, 2) == 0.5 and plan.stall_seconds(2, 5) == 0
    assert plan.rejects_submit(0, 4) and not plan.rejects_submit(0, 6)
    assert plan.last_onset() == 5
    assert [f.step for f in plan.faults] == [2, 4, 5]
    for r in range(3):
        for s in range(8):
            assert plan.is_dead(r, s) == jplan.is_dead(r, s)
            assert plan.stall_seconds(r, s) == jplan.stall_seconds(r, s)
            assert plan.rejects_submit(r, s) == jplan.rejects_submit(r, s)
    assert ServingFaultPlan.healthy(4).active(10) == []
    with pytest.raises(ValueError):
        plan.merged(ServingFaultPlan.healthy(2))


def test_seeded_backoff_deterministic_and_bounded():
    a = [seeded_backoff(k, base=0.05, cap=1.0, seed=7, salt=3)
         for k in range(8)]
    assert a == [jresilience.seeded_backoff(k, base=0.05, cap=1.0, seed=7,
                                            salt=3) for k in range(8)]
    assert a != [seeded_backoff(k, base=0.05, cap=1.0, seed=7, salt=4)
                 for k in range(8)]
    assert all(0.0 < d <= 1.0 for d in a)
    assert a[3] > a[0]
    slept = []
    d = backoff_sleep(2, base=0.05, seed=7, salt=3, sleep=slept.append)
    assert slept == [d] == [seeded_backoff(2, base=0.05, seed=7, salt=3)]


def test_copied_host_modules_match_the_jax_package():
    """The copies of ``sim.engine.canonical_detail`` and
    ``observe/blackbox`` give the JAX package's results on the same
    inputs: the byte-stable rendering of nested details, and the flight
    recorder's chain digest and explanation."""
    detail = dict(b=True, n=np.int64(3), x=np.float32(0.1), t=1 / 3,
                  nested={"z": [1, 2.5, "s"], "a": (False, 7)})
    assert sim.canonical_detail(**detail) == jsim.canonical_detail(**detail)
    assert (sim.canonical_detail(**detail)
            == "b=1 n=3 nested={a=[0 7] z=[1 2.5 s]} t=0.333333333 "
               "x=0.100000001")

    chains = []
    for mod in (blackbox, jblackbox):
        bb = mod.BlackBox(capacity=8)
        root = bb.record("serving", "failover", step=4,
                         telemetry={"moved": 2, "expired": 1})
        bb.record("serving", "drain", step=5, parent=root,
                  telemetry={"handed_off": 3}, winner="handoff")
        chains.append((bb.chain_digest(), bb.explain(root.event_id)))
    assert chains[0] == chains[1]


def test_faulty_replica_death_stall_and_reject(weights):
    clock = _Clock()
    eng = _engine(weights, clock)
    plan = ServingFaultPlan.replica_death(2, 0, step=2).merged(
        ServingFaultPlan.replica_stall(2, 0, step=1, duration=1,
                                       stall_seconds=0.25)).merged(
        ServingFaultPlan.submit_rejection(2, 0, step=1, duration=1))
    slept = []
    rep = FaultyReplica(eng, plan, 0, sleep=slept.append)
    rep.submit(Request(np.arange(5, dtype=np.int32), 3))
    assert rep.step() is True and rep.steps == 1
    with pytest.raises(RequestRejected):
        rep.submit(Request(np.arange(5, dtype=np.int32), 3))
    assert rep.step() is True
    assert slept == [0.25]
    assert rep.step() is False and rep.dead
    assert rep.step() is False
    with pytest.raises(RequestRejected):
        rep.submit(Request(np.arange(5, dtype=np.int32), 3))
    assert rep.metrics is eng.metrics and rep.pool is eng.pool
    with pytest.raises(ValueError):
        FaultyReplica(eng, plan, 2)


def test_failover_is_token_exact(weights):
    """Kill a replica holding a mid-decode request (with emitted
    tokens), a mid-prefill request and a queued one behind a
    ``FaultyReplica``; fail everything over to a survivor sharing the
    prefix cache.  Every output is bit-equal to a fault-free run, and
    the survivor restored prompt chunks instead of recomputing them."""
    rs = np.random.RandomState(11)
    reqs = _requests(rs, n=3, prompt_len=(9, 14))
    ref_out = _reference(weights, reqs)
    prefix = PrefixCache(4, 1 << 24)
    clock = _Clock()
    e0 = _engine(weights, clock, prefix=prefix)
    e1 = _engine(weights, clock, prefix=prefix)
    rep = FaultyReplica(e0, ServingFaultPlan.replica_death(2, 0, step=6),
                        0)
    live = [rep.submit(_clone(r)) for r in reqs]
    while rep.step():
        clock.advance(0.01)
    assert rep.dead and rep.steps == 6
    assert any(r.tokens and not r.done for r in live)
    assert any(r.state == "queued" for r in live)
    pre_counts = {r.rid: len(r.tokens) for r in live}
    moved, expired = failover_stranded(rep, e1.submit)
    assert expired == []
    assert sorted(r.rid for r in moved) == sorted(r.rid for r in live)
    assert e0.metrics.summary()["n_failovers"] == 3
    for r in live:
        assert len(r.tokens) == pre_counts[r.rid]
        assert r.state == "queued" and r.slot is None
    while e1.step():
        clock.advance(0.01)
    for r, want in zip(live, ref_out):
        assert r.state == "completed"
        np.testing.assert_array_equal(r.output(), want)
    assert e1.metrics.summary()["prefix_chunks_restored"] > 0


def test_expired_on_dead_replica_retires_with_metrics(weights):
    clock = _Clock()
    eng = _engine(weights, clock)
    ok = eng.submit(Request(np.arange(6, dtype=np.int32), 4))
    late = eng.submit(Request(np.arange(7, dtype=np.int32), 4,
                              deadline=1.0))
    for _ in range(2):
        eng.step()
    assert not ok.done and not late.done
    clock.advance(5.0)
    resubmitted = []
    moved, expired = failover_stranded(eng, resubmitted.append)
    assert [r.rid for r in moved] == [ok.rid]
    assert [r.rid for r in expired] == [late.rid]
    assert late.state == "expired" and late.done and late.slot is None
    assert [r.rid for r in resubmitted] == [ok.rid]
    m = eng.metrics.summary()
    assert m["outcomes"].get("expired") == 1
    assert m["outcomes"].get("failover") == 1
    assert m["n_failovers"] == 1


def test_drain_completes_mixed_residents_in_place(weights):
    clock = _Clock()
    prefix = PrefixCache(4, 1 << 24)
    eng = _engine(weights, clock, prefix=prefix)
    rs = np.random.RandomState(4)
    a = eng.submit(Request(rs.randint(0, 256, (6,)).astype(np.int32), 4))
    b = eng.submit(Request(rs.randint(0, 256, (13,)).astype(np.int32), 4))
    c = eng.submit(Request(rs.randint(0, 256, (6,)).astype(np.int32), 4))
    for _ in range(3):
        eng.step()
    assert a.state == "decode" and a.tokens
    assert b.state == "prefill" and not b.done
    assert c.state == "queued"
    bb = blackbox.BlackBox(capacity=16)
    blackbox._global_blackbox, old = bb, blackbox._global_blackbox
    try:
        summary = eng.drain()
    finally:
        blackbox._global_blackbox = old
    assert a.state == "completed" and b.state == "completed"
    assert c.state == "rejected"
    assert summary["completed"] == 2
    assert summary["rejected_queue"] == 1
    assert summary["handed_off"] == 0
    assert summary["flushed_chunks"] > 0
    assert len(prefix) >= summary["flushed_chunks"]
    with pytest.raises(RequestRejected, match="draining"):
        eng.submit(Request(np.arange(5, dtype=np.int32), 2))
    assert eng.metrics.summary()["outcomes"].get("rejected") == 1
    (ev,) = bb.events()
    assert (ev.plane, ev.kind, ev.winner) == ("serving", "drain", "complete")


def test_drain_hands_off_token_exact(weights):
    rs = np.random.RandomState(21)
    reqs = _requests(rs, n=3, prompt_len=(9, 14))
    ref_out = _reference(weights, reqs)
    prefix = PrefixCache(4, 1 << 24)
    clock = _Clock()
    e0 = _engine(weights, clock, prefix=prefix)
    e1 = _engine(weights, clock, prefix=prefix)
    live = [e0.submit(_clone(r)) for r in reqs]
    for _ in range(5):
        clock.advance(0.01)
        e0.step()
    assert any(r.tokens for r in live)
    summary = e0.drain(handoff=e1.submit)
    assert summary["handed_off"] == 3 and summary["completed"] == 0
    assert not e0._running and e0._admitting is None
    assert e0.scheduler.queue_depth == 0
    while e1.step():
        clock.advance(0.01)
    for r, want in zip(live, ref_out):
        assert r.state == "completed"
        np.testing.assert_array_equal(r.output(), want)
    assert e1.metrics.summary()["prefix_chunks_restored"] > 0

"""The port's simulated serving fleet (bluefog_tpu_torch/sim/serving.py)
against a REAL lockstep fleet of the port's ``ServingEngine``, on the
CPU: ``tests/test_sim.py:340`` with the port on both sides.

Three real replicas of a tiny f32 Llama behind the port's
``FleetRouter``, on one ``VirtualClock``, take the same trace as the
port's ``SimServingFleet`` with the same router seed: every routing
decision must agree bit for bit, and ticks, makespan, per-request
tokens and the virtual-time TTFTs exactly.  The calibration seam
(``measure_step_cost``, ``CostModel.from_engine``) runs on a real engine
of the same model with an injected, scripted timer.
"""

import re

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch.benchutil import poisson_arrivals
from bluefog_tpu_torch.observe import MetricsRegistry
from bluefog_tpu_torch.serving import FleetRouter, Request, ServingEngine
from bluefog_tpu_torch.sim import (CostModel, EventLog, RequestTrace,
                                   SimReplica, SimServingFleet, Simulation,
                                   VirtualClock, measure_step_cost)

pytestmark = pytest.mark.sim

_COST = CostModel(step_s=2e-3, gossip_round_s=0.0)
_ENGINE = dict(capacity=4, max_len=64, prefill_chunk=8, max_queue=64)
_ROUTE_RE = re.compile(r" route replica-(\d+) rid=(\d+)$")


def _model():
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    model = bt.Llama(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    return cfg, model


def _trace(n=48, rate=900.0, seed=6):
    return RequestTrace.build(poisson_arrivals(rate, n, seed),
                              seed=seed + 1, prompt_len=(2, 12),
                              new_tokens=(2, 10))


def _real_fleet_run(cfg, model, trace, *, n_rep, step_s, seed):
    """The real-engine mirror of ``SimServingFleet.run``: real
    ``ServingEngine`` replicas on one shared virtual clock, one router
    poll per arrival tick, the same idle jump."""
    clock = VirtualClock()
    regs = [MetricsRegistry() for _ in range(n_rep)]
    engines = [ServingEngine(model, cfg, clock=clock, registry=regs[i],
                             device="cpu", **_ENGINE)
               for i in range(n_rep)]
    router = FleetRouter(engines, registries=regs, clock=clock,
                         sleep=clock.advance, seed=seed)
    rs = np.random.RandomState(99)     # token VALUES: control-irrelevant
    reqs = [Request(rs.randint(0, cfg.vocab_size,
                               (int(trace.prompt_lens[k]),)).astype(
                                   np.int32),
                    int(trace.budgets[k]), rid=k)
            for k in range(trace.n)]
    dead = np.zeros(n_rep, bool)
    route, ticks, i = [], 0, 0
    arr = trace.arrivals
    while True:
        if i < trace.n and arr[i] <= clock.t:
            snap = router.poll(dead_mask=dead)
            while i < trace.n and arr[i] <= clock.t:
                j, _ = router.submit(reqs[i], snapshot=snap, dead_mask=dead)
                route.append(j)
                i += 1
        busy = any(e._running or e._admitting or e.scheduler.queue_depth
                   for e in engines)
        if not busy:
            if i >= trace.n:
                break
            clock.jump_to(float(arr[i]))
            continue
        for e in engines:
            e.step()
        clock.advance(step_s)
        ticks += 1
        assert ticks < 10_000, "real fleet did not converge"
    ttfts = sorted(t for e in engines for t in e.metrics.ttfts())
    return dict(route=route, ticks=ticks, makespan=clock.t,
                tokens={r.rid: len(r.tokens) for r in reqs},
                states={r.rid: r.state for r in reqs}, ttfts=ttfts)


def _sim_fleet(trace, *, n_rep, seed):
    clock = VirtualClock()
    reps = [SimReplica(f"replica-{i}", clock=clock, cost=_COST, **_ENGINE)
            for i in range(n_rep)]
    fleet = SimServingFleet(reps, cost=_COST,
                            sim=Simulation(clock=clock, log=EventLog()),
                            router_kwargs=dict(seed=seed))
    return fleet, fleet.run(trace)


def test_sim_vs_real_serving_lockstep_bit_equal_routing():
    """With the same clock, trace and router seed, the port's simulated
    fleet and a lockstep REAL 3-replica fleet of the port's engines agree
    bit for bit on every routing decision, and exactly on ticks,
    makespan, per-request token counts and the virtual-time TTFTs."""
    cfg, model = _model()
    tr = _trace()
    real = _real_fleet_run(cfg, model, tr, n_rep=3, step_s=_COST.step_s,
                           seed=11)
    fleet, s = _sim_fleet(tr, n_rep=3, seed=11)
    sim_route = {}
    for line in fleet.log.lines:
        m = _ROUTE_RE.search(line)
        if m:
            sim_route[int(m.group(2))] = int(m.group(1))
    assert [sim_route[k] for k in range(tr.n)] == real["route"]
    assert len(set(real["route"])) == 3       # every replica took work
    assert s["ticks"] == real["ticks"]
    assert s["virtual_seconds"] == real["makespan"]
    assert s["completed"] == tr.n
    assert all(st == "completed" for st in real["states"].values())
    assert [real["tokens"][k] for k in range(tr.n)] == \
        [int(b) for b in tr.budgets]
    assert s["tokens_total"] == float(sum(real["tokens"].values()))
    sim_ttfts = sorted(
        v for rep in fleet.replicas
        for name, kind, _h, _l, m in rep.registry.collect()
        if name == "bf_serving_ttft_seconds" and kind == "histogram"
        for v in m.window_values)
    assert sim_ttfts == real["ttfts"]


def test_measure_step_cost_on_a_real_engine():
    """The calibration seam on a real engine: full slots, warm-up steps
    uncounted, the median of the timed steps, read through the injected
    timer only (here a scripted clock: the five timed steps take 2, 5, 1,
    4 and 3 ms)."""
    cfg, model = _model()
    eng = ServingEngine(model, cfg, device="cpu", **_ENGINE)
    reads = iter([0.0, 0.002, 1.0, 1.005, 2.0, 2.001, 3.0, 3.004,
                  4.0, 4.003])
    prompts = [np.arange(3 + i, dtype=np.int32) for i in range(4)]
    cost = measure_step_cost(eng, prompts, timer=lambda: next(reads),
                             new_tokens=16, warmup=2, reps=5)
    assert next(reads, None) is None      # two reads a timed step, no more
    assert cost == pytest.approx(0.003, abs=1e-12)
    assert len(eng._running) == 4     # the timed steps ran at full slots
    cm = CostModel.from_engine(
        ServingEngine(model, cfg, device="cpu", **_ENGINE), prompts,
        timer=lambda: 0.0, new_tokens=8, warmup=1, reps=3,
        gossip_round_s=0.0)
    assert cm.step_s == cm.prefill_chunk_s == 0.0
    assert cm.gossip_round_s == 0.0 and cm.train_step_s == 1e-3

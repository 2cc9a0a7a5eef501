"""The port's exporters and step profiler (bluefog_tpu_torch/observe/
{export,stepprof}.py and ``ServingEngine.profile``), mirroring
tests/test_observe.py: the exporters give the JAX exporters' bytes on
registries and tracers holding the same events; the observe package
exports every name the JAX package's does; ``profile_step`` counts the
FLOPs and the exchanges of a step; ``ServingEngine.profile`` returns the
JAX engine's program set with FLOPs > 0, JSON-serializable, and leaves a
live engine's later streams bit-equal.  The card's profile is
tests/test_torch_observe_cuda.py."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bluefog_tpu import models as jm
from bluefog_tpu import observe as jobserve
from bluefog_tpu.observe.registry import MetricsRegistry as JRegistry
from bluefog_tpu.observe.tracer import Tracer as JTracer
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import observe
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.observe.registry import MetricsRegistry
from bluefog_tpu_torch.observe.tracer import Tracer
from bluefog_tpu_torch.serving import (PrefixCache, Request, ServingEngine,
                                       SpeculativeConfig)

MAX_LEN = 32


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _fill(reg):
    reg.counter("bf_ops_total", "eager op dispatches", op="allreduce").inc(2)
    reg.counter("bf_ops_total", "eager op dispatches", op="broadcast").inc()
    reg.gauge("bf_hostile", 'a "quoted"\nback\\slash help',
              path='we"ird\nva\\lue').set(1)
    h = reg.histogram("bf_lat_seconds", "latency")
    for v in (0.5, 1.0, 3.0):
        h.observe(v)
    reg.gauge("bf_depth", "queue depth").set(4)


def _trace(tr):
    with tr.span("track", "phase"):
        tr.instant("tick", track="track")
    tr.begin("request.1", "admission")
    tr.end("request.1")


def test_observe_exports_every_jax_name():
    assert set(jobserve.__all__) <= set(observe.__all__)
    for name in jobserve.__all__:
        assert getattr(observe, name) is not None
    with pytest.raises(NotImplementedError, match="item 13"):
        observe.hlo_op_breakdown("HloModule m")
    # the contract check reads a profiled step's tally, not HLO text
    with pytest.raises(TypeError, match="StepProfile"):
        observe.verify_collective_contract("HloModule m", {}, 4)
    with pytest.raises(NotImplementedError, match="item 13"):
        observe.profile_step(lambda: None, link_bytes_per_s=1e9)


def test_exporters_match_the_jax_exporters():
    """Prometheus text, the JSONL log and the Chrome trace are byte-equal
    to the JAX exporters' over the same metrics and the same events at
    the same timestamps."""
    reg, jreg = MetricsRegistry(), JRegistry()
    _fill(reg)
    _fill(jreg)
    text = observe.prometheus_text(reg)
    assert text == jobserve.prometheus_text(jreg)
    assert 'bf_ops_total{op="allreduce"} 2.0' in text
    assert 'bf_lat_seconds{quantile="0.5"} 1.0' in text
    assert r'path="we\"ird\nva\\lue"' in text
    tr, jtr = Tracer(clock=_Clock(), pid=3), JTracer(clock=_Clock(), pid=3)
    _trace(tr)
    _trace(jtr)
    assert observe.jsonl_events(tr) == jobserve.jsonl_events(jtr)
    assert observe.chrome_trace(tr) == jobserve.chrome_trace(jtr)
    objs = [json.loads(ln) for ln in observe.jsonl_events(tr).splitlines()]
    assert [o["ph"] for o in objs] == ["B", "i", "E", "B", "E"]


def test_snapshot_writes_the_three_files(tmp_path):
    observe.get_registry().gauge("bf_snapshot_probe", "probe").set(7)
    snap = observe.snapshot(str(tmp_path / "dump"))
    assert sorted(snap["files"]) == ["events.jsonl", "metrics.prom",
                                     "trace.json"]
    prom = (tmp_path / "dump" / "metrics.prom").read_text()
    assert "bf_snapshot_probe 7.0" in prom
    assert prom == observe.prometheus_text()
    json.loads((tmp_path / "dump" / "trace.json").read_text())
    assert snap["trace"]["n_events"] >= 0
    assert "bf_snapshot_probe" in snap["metrics"]


def test_profile_step_counts_flops_and_exchanges():
    """A 4-rank atc step over ExponentialTwoGraph(4): the flop counter's
    FLOPs of the step's products, one collective-permute per shift
    class of one rank's flat buffer, and the gauges it publishes."""
    backend = bt.StackedBackend(4, device="cpu")
    params = bt.rank_major({"b": torch.zeros(8), "w": torch.eye(8)},
                           backend)
    opt = torch.optim.SGD(params.values(), lr=0.05)

    def loss_fn(p, batch):
        return ((batch @ p["w"] + p["b"]) ** 2).mean()

    topo = bt.uniform_topology_spec(bt.ExponentialTwoGraph(4))
    step = bt.build_train_step(loss_fn, opt, backend, comm_mode="atc",
                               topology=topo)
    batch = torch.randn(4, 16, 8, generator=torch.Generator().manual_seed(0))
    reg = MetricsRegistry()
    prof = observe.profile_step(step, params, opt, batch, 0, name="toy",
                                publish=False)
    prof.publish(reg)
    # per rank: the forward's product (2 x 16 x 8 x 8) and the weight's
    # gradient (the same again; the batch takes none)
    assert prof.flops == 4 * 2 * 2 * 16 * 8 * 8
    n_classes = len(topo.shift_classes)
    assert prof.collective_bytes == {"collective-permute": {
        "count": n_classes, "bytes": n_classes * (8 + 64) * 4}}
    assert prof.peak_flops == 0.0 and prof.mfu() == 0.0
    assert prof.step_seconds > 0 and prof.op_breakdown
    assert prof.windows == [] and prof.overlap is None
    snap = reg.snapshot()
    assert snap["bf_step_flops"][0]["value"] == prof.flops
    assert snap["bf_step_collective_bytes"][0]["labels"] == {
        "step": "toy", "kind": "collective-permute"}
    json.dumps(prof.to_dict())


@pytest.fixture(scope="module")
def weights():
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32)
    variables = jm.Llama(cfg).init(jax.random.PRNGKey(1),
                                   jnp.zeros((2, 4), jnp.int32))
    tcfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    model = bt.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_flax(
        jax.tree.map(np.asarray, variables), tcfg, device="cpu"))
    return tcfg, model, variables


def _engine(weights, **kw):
    tcfg, model, _ = weights
    return ServingEngine(model, tcfg, capacity=2, max_len=MAX_LEN,
                         prefill_chunk=4, registry=MetricsRegistry(),
                         clock=lambda: 0.0, device="cpu", **kw)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_engine_profile_emits_step_profiles(weights, spec):
    """The JAX engine's program set (tests/test_observe.py:
    test_engine_profile_emits_step_profiles, and the speculative set of
    tests/test_fleet_serving.py), each with FLOPs > 0 and
    JSON-serializable; the JAX engine's own profile names the same
    programs."""
    from bluefog_tpu.serving import ServingEngine as JEngine
    from bluefog_tpu.serving import SpeculativeConfig as JSpec

    tcfg, model, variables = weights
    kw = {"speculative": SpeculativeConfig(model, tcfg, lookahead=2)} \
        if spec else {}
    profs = _engine(weights, **kw).profile(publish=False)
    jkw = ({"speculative": JSpec(variables, jm.LlamaConfig.tiny(
        dtype=jnp.float32), lookahead=2)} if spec else {})
    jeng = JEngine(variables, jm.LlamaConfig.tiny(dtype=jnp.float32),
                   capacity=2, max_len=MAX_LEN, prefill_chunk=4, **jkw)
    want = ({"prefill_chunk", "draft_prefill_chunk", "spec_step"} if spec
            else {"prefill_chunk", "decode_step"})
    assert set(profs) == want == set(jeng._resident)
    for name, p in profs.items():
        assert p.flops > 0 and p.name == f"serving.{name}"
        assert p.op_breakdown and p.step_seconds > 0
    # a decode program of the port runs the whole capacity batch
    step = profs["spec_step" if spec else "decode_step"]
    assert step.flops > profs["prefill_chunk"].flops / 4
    json.dumps({k: p.to_dict() for k, p in profs.items()})


def _state(eng):
    pools = [eng.pool] + ([eng._draft_pool] if eng._draft_pool else [])
    return ([p.cache.index.clone() for p in pools],
            [list(p._free) for p in pools],
            len(eng.pool.prefix) if eng.pool.prefix is not None else None,
            eng.metrics.summary(), int(eng._nonfinite))


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_profile_leaves_a_live_engine_bit_equal(weights, spec):
    """profile() mid-run leaves the engine's slots, pool, prefix cache,
    metrics and sampling streams as they were: the later streams (greedy
    and sampled) equal those of a run without the call, bit for bit."""
    tcfg, model, _ = weights
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 256, (int(n),)).astype(np.int32)
               for n in rs.randint(5, 14, 3)]

    def run(call_profile):
        kw = {"speculative": SpeculativeConfig(model, tcfg, lookahead=2)} \
            if spec else {}
        eng = _engine(weights, prefix_cache=PrefixCache(4, 1 << 20), **kw)
        reqs = [eng.submit(Request(p, 6, temperature=(0.0, 0.9)[i % 2],
                                   seed=40 + i))
                for i, p in enumerate(prompts)]
        for _ in range(4):
            eng.step()
        if call_profile:
            before = _state(eng)
            eng.profile(publish=False)
            after = _state(eng)
            for a, b in zip(before[0], after[0]):
                assert torch.equal(a, b)
            assert before[1:] == after[1:]
        eng.run()
        return [r.output() for r in reqs]

    for a, b in zip(run(False), run(True)):
        np.testing.assert_array_equal(a, b)

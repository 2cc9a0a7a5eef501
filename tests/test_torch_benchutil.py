"""The port's ``benchutil`` beyond the arrivals and the contract check:
every public name of the JAX module; the bench gate (``bench_headline``,
``bench_compare``, ``bench_regression_gate`` and their helpers) held to
JAX's on records built here from a seed, the previous rounds written to
``tmp_path``; the card figures and their overrides against JAX's; ``mfu``;
the timers' argument orders and seconds on the CPU; ``latency_hiding_xla
_flags`` refusing by name; and the profiler parts on a CPU step
(``compiled_step_flops``, ``hlo_collective_bytes``)."""

import ast
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bluefog_tpu import benchutil as JB
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import benchutil as B
from bluefog_tpu_torch import observe

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module (its timed loops and tiny ops
    otherwise wait on torch's spinning pool on a shared host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _public_names(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in out if not n.startswith("_")}


def test_every_public_name_of_the_jax_module():
    want = _public_names(ROOT / "bluefog_tpu" / "benchutil.py")
    assert want <= set(dir(B)), sorted(want - set(dir(B)))
    assert set(JB.__all__) <= set(B.__all__)
    for name in want:
        assert getattr(B, name) is not None


def _records(seed):
    """Two bench records of every shape the gate reads (a bare line, the
    BENCH wrapper, sections, nested names, non-headline keys, a bool), the
    current one drifted from the previous by seeded factors."""
    rs = np.random.RandomState(seed)
    keys = list(JB._HEADLINE_HIGHER) + list(JB._HEADLINE_LOWER)
    sections = ["continuous", "chaos", "moe", "replay", "fleet_two"]

    def draw():
        rec = {k: float(rs.uniform(1, 100)) for k in
               rs.choice(keys, 6, replace=False)}
        rec["metric"] = "img_per_sec"
        rec["flag"] = True
        rec["note"] = "text"
        for s in rs.choice(sections, 2, replace=False):
            rec[s] = {k: float(rs.uniform(1, 100)) for k in
                      rs.choice(keys, 4, replace=False)}
            rec[s]["count"] = int(rs.randint(1, 9))
        return rec

    prev = draw()
    cur = json.loads(json.dumps(prev))

    def drift(d):
        for k, v in d.items():
            if isinstance(v, dict):
                drift(v)
            elif isinstance(v, float):
                d[k] = v * float(rs.choice([0.9, 0.97, 1.0, 1.02, 1.2]))

    drift(cur)
    cur["extra"] = {"p50": 3.0}
    return cur, prev


@pytest.mark.parametrize("seed", range(6))
def test_bench_gate_equals_jax(seed, tmp_path, capsys):
    cur, prev = _records(seed)
    wrapped = {"parsed": prev, "round": 4}
    for rec in (cur, prev, wrapped, {"parsed": "x", "value": 2.0}):
        assert B.bench_headline(rec) == JB.bench_headline(rec)
        assert B._record_sections(rec) == JB._record_sections(rec)
    for name in ("value", "chaos.p99", "moe.ttft_p50", "x.mismatches"):
        assert B._direction(name) == JB._direction(name)
    for tol, tols in ((0.05, None), (0.15, {"value": 0.5}), (0.0, None)):
        assert B.bench_compare(cur, prev, tol, tols) == \
            JB.bench_compare(cur, prev, tol, tols)
    files = {"bench_r07.json": prev, "plain.json": wrapped,
             "other.json": {"unrelated": {"x": 1.0}},
             "bare.json": {"parsed": {"round": 12, "value": 1.0}}}
    for fname, rec in files.items():
        path = str(tmp_path / fname)
        with open(path, "w") as fh:
            json.dump(rec, fh)
        assert B._record_round(path, rec) == JB._record_round(path, rec)
        for tol in (0.05, 0.3):
            ok = B.bench_regression_gate(cur, path, tol)
            port = capsys.readouterr().out
            assert ok == JB.bench_regression_gate(cur, path, tol)
            assert port == capsys.readouterr().out
            assert port.startswith("[bench-gate]")


def test_card_figures_and_their_overrides(monkeypatch):
    monkeypatch.delenv("BLUEFOG_CHIP_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("BLUEFOG_CHIP_HBM_GBPS", raising=False)
    assert B.chip_peak_flops("cpu") == 0.0
    assert B.chip_hbm_bandwidth(torch.device("cpu")) == 0.0
    if not torch.cuda.is_available():
        assert B.chip_peak_flops() == 0.0 == B.chip_hbm_bandwidth()
    for name, peak, rate in (("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
                             ("NVIDIA H100 PCIe", 756e12, 2.0e12),
                             ("NVIDIA H100 NVL", 835e12, 3.9e12),
                             ("NVIDIA H200", 989e12, 4.8e12),
                             ("NVIDIA A100-SXM4-80GB", 0.0, 0.0)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, _n=name: _n)
        assert B.chip_peak_flops("cuda:0") == peak
        assert B.chip_hbm_bandwidth(0) == rate
    monkeypatch.setenv("BLUEFOG_CHIP_PEAK_TFLOPS", "123.5")
    monkeypatch.setenv("BLUEFOG_CHIP_HBM_GBPS", "2048")
    assert B.chip_peak_flops("cpu") == 123.5e12 == JB.chip_peak_flops()
    assert B.chip_hbm_bandwidth("cpu") == 2048e9 == JB.chip_hbm_bandwidth()
    assert B.mfu(1e12, 0.5) == JB.mfu(1e12, 0.5)
    monkeypatch.setenv("BLUEFOG_CHIP_PEAK_TFLOPS", "")
    assert B.chip_peak_flops("cpu") == 0.0
    for args in ((2e12, 0.25, 1e13), (1e9, 0.0, 1e12), (5.0, 1.0, 0.0),
                 (3e11, 2.0, None)):
        assert B.mfu(*args) == JB.mfu(*args)


def test_timers_argument_orders_and_seconds():
    """``chain_time`` and ``fwd_bwd_time`` call ``f(params, x)`` (JAX's
    order), chain every iteration and return seconds per iteration;
    ``timed`` subtracts the overhead it is given; ``device_fetch`` hands
    back numpy (bf16 as float32)."""
    calls = []
    w = torch.full((4, 5), 0.5)
    x0 = torch.ones(3, 4)

    def f(params, x):
        calls.append((tuple(params.shape), tuple(x.shape)))
        time.sleep(0.002)
        return x @ params

    per = B.chain_time(f, w, x0, n=4, reps=2)
    assert calls and all(c == ((4, 5), (3, 4)) for c in calls)
    assert len(calls) == 4 * (1 + 2)
    assert 0.0015 < per < 0.5
    calls.clear()
    g = B.fwd_bwd_time(f, w, x0, n=3, reps=2)
    assert len(calls) == 3 * (1 + 2)
    assert all(c == ((4, 5), (3, 4)) for c in calls)
    assert 0.0015 < g < 0.5
    # another output shape is reduced over its last dim
    assert B.chain_time(lambda p, x: x @ p, w, x0, n=2, reps=1) > 0
    # params as a tree: every floating leaf gets a gradient
    tree = {"a": torch.eye(4), "b": (torch.ones(4), 3)}
    assert B.fwd_bwd_time(lambda p, x: x @ p["a"] + p["b"][0] * p["b"][1],
                          tree, x0, n=2, reps=1) > 0
    with pytest.raises(RuntimeError):     # the swapped order
        B.chain_time(lambda x, p: x @ p, w, x0, n=1, reps=1)
    secs = B.timed(lambda: time.sleep(0.01), lambda: torch.zeros(2),
                   overhead=0.0)
    assert 0.009 < secs < 1.0
    assert B.timed(lambda: None, lambda: torch.zeros(1), overhead=1.0) \
        == 1e-9
    assert 0.0 < B.fetch_overhead(2) < 0.5
    out = B.device_fetch(torch.ones(2, dtype=torch.bfloat16))
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    assert B.device_fetch(torch.arange(3)).dtype == np.int64


def test_latency_hiding_xla_flags_refuses_by_name():
    assert B.LATENCY_HIDING_XLA_FLAGS == ()
    with pytest.raises(NotImplementedError,
                       match="latency_hiding_xla_flags"):
        B.latency_hiding_xla_flags()
    with pytest.raises(NotImplementedError,
                       match="latency_hiding_xla_flags"):
        B.latency_hiding_xla_flags(("--xla_flag=1",))


def test_step_flops_and_collective_bytes_read_a_run():
    """``compiled_step_flops`` runs the step under the flop counter (the
    count ``profile_step`` takes); ``hlo_collective_bytes`` reads a
    profile's tally, and HLO text is refused."""
    backend = bt.StackedBackend(2, device="cpu")
    params = bt.rank_major({"w": torch.eye(8), "b": torch.zeros(8)},
                           backend)
    opt = torch.optim.SGD(params.values(), lr=0.05)
    step = bt.build_train_step(
        lambda p, b: ((b @ p["w"] + p["b"]) ** 2).mean(), opt, backend,
        comm_mode="atc",
        topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(2)))
    batch = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(0))
    flops = B.compiled_step_flops(step, params, opt, batch, 0)
    assert flops == 2 * 2 * 2 * 16 * 8 * 8
    prof = observe.profile_step(step, params, opt, batch, 1, publish=False)
    assert prof.flops == flops
    assert B.hlo_collective_bytes(prof) == prof.collective_bytes == {
        "collective-permute": {"count": 1, "bytes": (64 + 8) * 4}}
    assert B.hlo_collective_bytes(
        {"all-reduce": {"count": 2, "bytes": 8, "payloads": [4, 4]}}) == {
        "all-reduce": {"count": 2, "bytes": 8}}
    with pytest.raises(TypeError, match="hlo_collective_bytes"):
        B.hlo_collective_bytes("HloModule m")

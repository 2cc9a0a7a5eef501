"""``benchutil`` on the card: the timers time CUDA tensors by CUDA events
(a host sleep inside the timed region does not read as device time) and
refuse to put a card's work on the host clock; the card's figures read its
name; a bucketed cta step's exchange windows lie on the side stream, with
compute beside them, and on the compute stream with none when the step is
forced onto one stream.  Marked ``cuda``: without an NVIDIA card the tests
skip.  The file imports torch and the port only:

    python -m pytest --noconftest -q tests/test_torch_benchutil_cuda.py
"""

import contextlib
import time

import pytest
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import benchutil as B
from bluefog_tpu_torch import observe

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def test_timers_use_cuda_events_on_the_card():
    _card()
    w = torch.randn(512, 512, device="cuda")
    x0 = torch.randn(64, 512, device="cuda")

    def f(p, x):
        time.sleep(0.005)      # host time: no device work
        return x @ p

    # the host sleeps 5 ms an iteration: the events, in the stream, span
    # the device's wait for each launch, so a product shorter than its
    # launch reads the launch's pace (chain_time's docstring)
    per = B.chain_time(f, w, x0, n=4, reps=2)
    assert 0.004 < per < 0.05
    assert B.fwd_bwd_time(lambda p, x: x @ p, w, x0, n=2, reps=2) > 0
    secs = B.timed(lambda: [w @ w for _ in range(8)],
                   lambda: (w @ w).sum(), overhead=0.0)
    assert 0 < secs < 1.0
    assert 0 < B.fetch_overhead(2, device="cuda") < 0.01
    with pytest.raises(ValueError, match="x0 on the host"):
        B.chain_time(f, w, x0.cpu(), n=1, reps=1)
    name = torch.cuda.get_device_name(0)
    if "H100" in name:
        assert B.chip_peak_flops() > 0 and B.chip_hbm_bandwidth() > 0


def _step():
    backend = bt.StackedBackend(2, device="cuda")
    g = torch.Generator("cuda").manual_seed(0)
    base = {f"w{i}": torch.randn(2048, 2048, generator=g, device="cuda")
            * 0.02 for i in range(4)}
    params = bt.rank_major(base, backend)
    opt = torch.optim.SGD(params.values(), lr=0.01)

    def loss_fn(p, batch):
        h = batch
        for i in range(4):
            h = torch.tanh(h @ p[f"w{i}"])
        return h.square().mean()

    step = bt.build_train_step(
        loss_fn, opt, backend, comm_mode="cta",
        topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(2)),
        overlap="bucketed", overlap_buckets=4)
    batch = torch.randn(2, 4096, 2048, generator=g, device="cuda")
    return step, params, opt, batch


@contextlib.contextmanager
def _one_stream():
    real = torch.cuda.stream
    torch.cuda.stream = lambda stream: contextlib.nullcontext()
    try:
        yield
    finally:
        torch.cuda.stream = real


def test_bucketed_windows_on_the_side_stream():
    """One window per bucket with the tally's payload; the cta step's lie
    on one stream other than the compute stream's, the forced one-stream
    step's see no compute beside them."""
    _card()
    step, params, opt, batch = _step()
    step(params, opt, batch, 0)
    prof = observe.profile_step(step, params, opt, batch, 1,
                                link_bytes_per_s=1e12, publish=False)
    wins = prof.windows
    assert [w["bytes"] for w in wins] == \
        prof.collective_payloads["collective-permute"]
    assert len({w["stream"] for w in wins}) == 1
    assert all(w["window_ms"] > 0 for w in wins)
    assert prof.overlap["bytes_total"] == sum(w["bytes"] for w in wins)
    step2, params2, opt2, batch2 = _step()
    with _one_stream():
        flat = observe.profile_step(step2, params2, opt2, batch2, 0,
                                    link_bytes_per_s=1e12, publish=False)
    assert all(w["compute_ms"] == 0.0 for w in flat.windows)
    assert flat.overlap["fraction"] == 0.0
    assert flat.windows[0]["stream"] != wins[0]["stream"]
    kernels = B.hlo_op_breakdown(prof)
    assert sum(r["flops"] for r in kernels.values()) > 0


class _EventsOnly:
    """The same finished profile seen through ``events()`` alone."""

    def __init__(self, prof):
        self.events, self.key_averages = prof.events, prof.key_averages


def test_breakdown_reads_the_raw_results_as_events_would_on_the_card():
    """A card's profile without flops is read from the profiler's raw
    results: the same kernels, counts and device times as through
    ``events()``, in a session that opens with ``profiler_warm_up`` (its
    launches left out) and in a CUDA-only one."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1024, 1024, device="cuda")
    sessions = ([ProfilerActivity.CPU, ProfilerActivity.CUDA], True), \
        ([ProfilerActivity.CUDA], False)
    for activities, warm in sessions:
        with profile(activities=activities) as prof:
            if warm:
                B.profiler_warm_up(x.device)
            for _ in range(10):
                x = torch.relu(x @ x) / 1024
            torch.cuda.synchronize()
        got = B.hlo_op_breakdown(prof)
        want = B.hlo_op_breakdown(_EventsOnly(prof))
        assert got.keys() == want.keys() and got
        for k, r in want.items():
            assert got[k]["count"] == r["count"], k
            assert got[k]["device_ms"] == pytest.approx(r["device_ms"]), k
        assert sum(r["count"] for r in got.values()) < B._WARMUP_LAUNCHES

"""The port's overlap accounting (``benchutil.scheduled_collective_windows``
and ``overlap_accounting``) and the step profiler's parts that refused
before: ``overlap_accounting`` held to JAX's on the windows JAX's
``scheduled_collective_windows`` reads from a JAX bucketed step's HLO (and
from an async fixture); the port's CPU bucketed step giving one window per
bucket, each with the exchange tally's payload; a card profile's windows
read from its events (the span on the exchange's stream, the compute of
other streams inside it, none when the exchange runs on the compute
stream); ``profile_step(link_bytes_per_s=)`` and ``hlo_op_breakdown``
answering where they raised."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import benchutil as JB
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.topology import one_peer_dynamic_schedule
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import benchutil as B
from bluefog_tpu_torch import observe

N = 8

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module (its tiny ops otherwise wait on
    torch's spinning thread pool whenever the host is shared)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

_ASYNC = """\
HloModule overlap_fixture, is_scheduled=true

ENTRY %main (p0: f32[1024,256], p1: f32[256,256]) -> f32[1024,256] {
  %p0 = f32[1024,256]{1,0} parameter(0)
  %p1 = f32[256,256]{1,0} parameter(1)
  %cps = (f32[1024,256]{1,0}, f32[1024,256]{1,0}) collective-permute-start(f32[1024,256]{1,0} %p0), source_target_pairs={{0,1},{1,0}}
  %hide = f32[1024,256]{1,0} dot(f32[1024,256]{1,0} %p0, f32[256,256]{1,0} %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %cpd = f32[1024,256]{1,0} collective-permute-done((f32[1024,256]{1,0}, f32[1024,256]{1,0}) %cps)
  %cps.2 = (f32[1024,256]{1,0}, f32[1024,256]{1,0}) collective-permute-start(f32[1024,256]{1,0} %hide), source_target_pairs={{0,1},{1,0}}
  %cpd.2 = f32[1024,256]{1,0} collective-permute-done((f32[1024,256]{1,0}, f32[1024,256]{1,0}) %cps.2)
  ROOT %out = f32[1024,256]{1,0} add(f32[1024,256]{1,0} %cpd, f32[1024,256]{1,0} %cpd.2)
}
"""

_HLO = {}


def _jax_hlo(which):
    """The HLO text of ``which``: the async fixture, or the JAX package's
    bucketed train step (4 buckets, one-peer round) under cta or atc on
    the 8-device CPU mesh."""
    if which == "async":
        return _ASYNC
    if which not in _HLO:
        mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))
        base = {f"w{i}": jnp.eye(16) * 0.5 for i in range(4)}
        base.update({f"b{i}": jnp.zeros((16,)) for i in range(4)})

        def loss_fn(params, batch):
            h = batch
            for i in range(4):
                h = jnp.tanh(h @ params[f"w{i}"] + params[f"b{i}"])
            return jnp.mean((h - 1.0) ** 2)

        opt = optax.sgd(0.05)
        step = JF.build_train_step(
            loss_fn, opt, mesh, donate=False, comm_mode=which,
            topology=one_peer_dynamic_schedule(N)[0], overlap="bucketed",
            overlap_buckets=4)
        params = JF.rank_major(base, mesh)
        ostate = JF.rank_major(opt.init(base), mesh)
        batch = jax.device_put(np.zeros((N, 8, 16)),
                               NamedSharding(mesh, P("bf")))
        _HLO[which] = step.lower(params, ostate, batch,
                                 jnp.int32(0)).compile().as_text()
    return _HLO[which]


FIGURES = [dict(peak_flops_per_s=1e12, link_bytes_per_s=1e10),
           dict(peak_flops_per_s=1e12, link_bytes_per_s=1e6),
           dict(peak_flops_per_s=1e6, link_bytes_per_s=1e12),
           dict(peak_flops_per_s=1e15, link_bytes_per_s=1.0),
           dict(peak_flops_per_s=2e9, link_bytes_per_s=3e9,
                hbm_bytes_per_s=8e11, congestion=2.0),
           dict(peak_flops_per_s=1e12, link_bytes_per_s=1e10,
                kinds=("all-reduce",))]


@pytest.mark.parametrize("which", ["async", "cta", "atc"])
def test_overlap_accounting_equals_jax_on_jax_windows(which):
    """The arithmetic on a list of windows gives JAX's dict on the same
    HLO at every set of figures (the async basis, and the CPU lowering's
    dataflow basis)."""
    hlo = _jax_hlo(which)
    windows = JB.scheduled_collective_windows(hlo)
    assert windows
    fractions = set()
    for fig in FIGURES:
        want = JB.overlap_accounting(hlo, **fig)
        assert B.overlap_accounting(windows, **fig) == want
        fractions.add(want["fraction"])
    assert {0.0} < fractions or which == "async"
    with pytest.raises(ValueError, match="peak_flops_per_s"):
        B.overlap_accounting(windows, 0.0, 1e9)
    with pytest.raises(ValueError, match="link_bytes_per_s"):
        B.overlap_accounting(windows, 1e12, 0.0)


def _bucketed_step(comm_mode, buckets):
    backend = bt.StackedBackend(2, device="cpu")
    g = torch.Generator().manual_seed(0)
    base = {f"w{i}": torch.randn(16, 16, generator=g) * 0.25
            for i in range(4)}
    base.update({f"b{i}": torch.zeros(16) for i in range(4)})
    params = bt.rank_major(base, backend)
    opt = torch.optim.SGD(params.values(), lr=0.05)

    def loss_fn(p, batch):
        h = batch
        for i in range(4):
            h = torch.tanh(h @ p[f"w{i}"] + p[f"b{i}"])
        return ((h - 1.0) ** 2).mean()

    step = bt.build_train_step(
        loss_fn, opt, backend, comm_mode=comm_mode,
        topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(2)),
        overlap="bucketed", overlap_buckets=buckets)
    batch = torch.randn(2, 8, 16, generator=g)
    return step, params, opt, batch


@pytest.mark.parametrize("comm_mode", ["cta", "atc"])
def test_port_bucketed_step_one_window_per_bucket(comm_mode):
    """A bucketed step over one shift class: one window per bucket, in
    the tally's order with its payload; on the CPU each window is its
    exchange range's host time with no compute beside it, so nothing is
    overlappable at any link rate; the breakdown counts the products."""
    from bluefog_tpu_torch.optim.fusion import EpiloguePlan

    step, params, opt, batch = _bucketed_step(comm_mode, 4)
    plan = EpiloguePlan.for_leaves(list(params.values()), 4,
                                   skip_leading_axis=True)
    prof = observe.profile_step(step, params, opt, batch, 0,
                                publish=False, link_bytes_per_s=1e12)
    payloads = prof.collective_payloads["collective-permute"]
    assert len(payloads) == len(plan.buckets) >= 4
    assert sorted(payloads) == sorted(b.nbytes for b in plan.buckets)
    assert [w["bytes"] for w in prof.windows] == payloads
    assert all(w["kind"] == "collective-permute" and w["async"]
               and w["window_ms"] > 0 and w["compute_ms"] == 0.0
               and w["computation"] == "host" for w in prof.windows)
    starts = [w["start_ms"] for w in prof.windows]
    assert starts == sorted(starts)
    acc = prof.overlap
    assert acc["basis"] == "scheduled" and acc["fraction"] == 0.0
    assert acc["bytes_total"] == sum(payloads)
    assert acc == B.overlap_accounting(prof.windows, 0.0, 1e12)
    ops = B.hlo_op_breakdown(prof)
    assert ops == prof.op_breakdown
    assert ops["aten::mm"]["flops"] > 0 and ops["aten::mm"]["count"] > 0
    assert all(set(r) == {"count", "flops", "device_ms"}
               for r in ops.values())


def test_profile_step_with_a_link_and_the_breakdown_answer():
    """Where ``profile_step(link_bytes_per_s=)`` and ``hlo_op_breakdown``
    raised NotImplementedError they answer: a step with no exchange has
    no windows and nothing to overlap; HLO text is refused by type."""
    prof = observe.profile_step(lambda: None, link_bytes_per_s=1e9,
                                publish=False)
    assert prof.windows == []
    assert prof.overlap["bytes_total"] == 0
    assert prof.overlap["fraction"] == 0.0
    assert observe.hlo_op_breakdown(prof) == prof.op_breakdown
    with pytest.raises(TypeError, match="StepProfile"):
        observe.hlo_op_breakdown("HloModule m")


class _Ev(SimpleNamespace):
    """A finished profile's event, as ``profile.events()`` lists them."""

    def __init__(self, name, start, end, cuda=False, id=0, stream=0,
                 annotation=False):
        super().__init__(
            name=name, time_range=SimpleNamespace(start=start, end=end),
            device_type=(torch.autograd.DeviceType.CUDA if cuda
                         else torch.autograd.DeviceType.CPU),
            thread=1, id=id, device_resource_id=stream,
            is_user_annotation=annotation, kernels=[], flops=0)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events

    def key_averages(self):
        raise AssertionError("a card's breakdown reads its device events")


def _card_profile(exchange_stream):
    """An exchange range (10-20 us on the host, id 5) whose marker says
    4096 bytes and whose device span, recorded by the profiler under the
    range's id, is 100-150 us on ``exchange_stream`` (with its copy
    kernel there); compute kernels on stream 7 at 90-130 and 140-200 us.
    A kernel's own id may equal the range's (another id space)."""
    ex = "bf.backend.exchange"
    return _Prof([
        _Ev(ex, 10, 20, id=5, annotation=True),
        _Ev(ex + "/collective-permute/4096", 11, 11, id=6,
            annotation=True),
        _Ev("cudaMemcpyAsync", 12, 13, id=41),
        _Ev(ex, 100, 150, cuda=True, id=5, stream=exchange_stream,
            annotation=True),
        _Ev("Memcpy DtoD", 100, 150, cuda=True, id=41,
            stream=exchange_stream),
        _Ev("gemm", 90, 130, cuda=True, id=5, stream=7),
        _Ev("gemm", 140, 200, cuda=True, id=43, stream=7),
    ])


def test_card_windows_read_the_exchange_stream_and_the_compute():
    """On a card's events: the window is the exchange's device span on
    its own stream (50 us), the compute inside it the union of the other
    stream's kernels there (30 + 10 us); with the exchange on the compute
    stream itself (``on_side=False``) nothing hides it; the same window
    where the profiler recorded no span for the range."""
    side = B.scheduled_collective_windows(_card_profile(13))
    assert len(side) == 1
    w = side[0]
    assert (w["kind"], w["bytes"], w["stream"]) == ("collective-permute",
                                                   4096, 13)
    assert w["start_ms"] == pytest.approx(0.1)
    assert w["window_ms"] == pytest.approx(0.05)
    assert w["compute_ms"] == pytest.approx(0.04)
    same = B.scheduled_collective_windows(_card_profile(7))[0]
    assert same["window_ms"] == pytest.approx(0.05)
    # the gemms on stream 7 now share the exchange's stream: run in order
    # with it, they hide nothing
    assert same["compute_ms"] == 0.0
    # 4096 bytes at 1e8 B/s is 41 us: hidden by 40 us of compute? no;
    # at 2e8 B/s (20 us) yes; never on the compute stream
    assert B.overlap_accounting(side, 0.0, 1e8)["fraction"] == 0.0
    assert B.overlap_accounting(side, 0.0, 2e8)["fraction"] == 1.0
    assert B.overlap_accounting([same], 0.0, 2e8)["fraction"] == 0.0
    # without the range's device span the work is traced through its
    # launch (the runtime call of its correlation id, inside the range);
    # without either the profile is refused
    cuda = torch.autograd.DeviceType.CUDA
    bare = [e for e in _card_profile(13).events()
            if not (e.is_user_annotation and e.device_type == cuda)]
    assert B.scheduled_collective_windows(_Prof(bare)) == side
    with pytest.raises(RuntimeError, match="no device work"):
        B.scheduled_collective_windows(_Prof(
            [e for e in bare if e.name != "cudaMemcpyAsync"]))


def test_card_breakdown_leaves_the_profiler_warm_up_out():
    """A card session starts with ``profiler_warm_up``'s launches (the
    profiler drops a long-lived process's first device activities): the
    breakdown counts the profiled work's kernels only, and a session
    whose last warm-up launch went unrecorded is flagged."""
    warm = "bf.profile_step.warmup"
    events = [_Ev(warm, 0, 5, annotation=True),
              _Ev("cudaLaunchKernel", 1, 2, id=1),
              _Ev("cudaLaunchKernel", 3, 4, id=2),
              _Ev("cudaLaunchKernel", 6, 7, id=3),
              _Ev("fill", 10, 11, cuda=True, id=1, stream=7),
              _Ev("fill", 12, 13, cuda=True, id=2, stream=7),
              _Ev("gemm", 20, 50, cuda=True, id=3, stream=7),
              _Ev("fill", 60, 61, cuda=True, id=4, stream=7)]
    assert B.hlo_op_breakdown(_Prof(events)) == {
        "gemm": {"count": 1, "flops": 0.0, "device_ms": 0.03},
        "fill": {"count": 1, "flops": 0.0, "device_ms": 0.001}}
    assert B._warm_up_launches(events) == (frozenset({1, 2}), True)
    lost = [e for e in events if not (e.name == "fill" and e.id == 2)]
    assert B._warm_up_launches(lost)[1] is False


_EPOCH_NS = 1_792_382_912_918_416_123


class _RawEv:
    """One of the profiler's raw results (``kineto_results.events()``),
    made from an ``_Ev``: epoch times in ns, every attribute a method."""

    def __init__(self, ev, hidden=False):
        self._ev, self._hidden = ev, hidden

    def name(self):
        return self._ev.name

    def device_type(self):
        return self._ev.device_type

    def correlation_id(self):
        return self._ev.id

    def is_user_annotation(self):
        return self._ev.is_user_annotation

    def is_hidden_event(self):
        return self._hidden

    def start_ns(self):
        return _EPOCH_NS + round(self._ev.time_range.start * 1e3)

    def duration_ns(self):
        return round((self._ev.time_range.end - self._ev.time_range.start)
                     * 1e3)


class _RawProf:
    """A finished profile that keeps its raw results; ``events()`` (which
    builds every CPU op's event) is refused."""

    with_flops = False

    def __init__(self, raw):
        self.profiler = SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: raw))

    def events(self):
        raise AssertionError("a card's breakdown reads the raw results")

    key_averages = events


def test_card_breakdown_reads_the_raw_results_as_events_would():
    """Where the profile keeps its raw results the breakdown reads them
    (and never ``events()``): the same kernels, counts and times as from
    ``events()``, to the nanosecond though the raw times are epoch
    nanoseconds, the warm-up left out; host ops other than the runtime
    calls and hidden events are not read."""
    warm = "bf.profile_step.warmup"
    events = [_Ev(warm, 0, 5, annotation=True),
              _Ev("cudaLaunchKernel", 1, 2, id=1),
              _Ev("aten::fill_", 1, 2, id=9),
              _Ev("cudaLaunchKernel", 6, 7, id=3),
              _Ev("fill", 10.007, 11.13, cuda=True, id=1, stream=7),
              _Ev("gemm", 20.011, 50.134, cuda=True, id=3, stream=7),
              _Ev("Optimizer.step", 20, 60, cuda=True, id=8, stream=7,
                  annotation=True),
              _Ev("fill", 60.001, 61.09, cuda=True, id=4, stream=7)]
    want = B.hlo_op_breakdown(_Prof(events))
    assert {k: r["count"] for k, r in want.items()} == {"gemm": 1,
                                                         "fill": 1}
    assert want["gemm"]["device_ms"] == pytest.approx(0.030123)
    assert want["fill"]["device_ms"] == pytest.approx(0.001089)
    raw = [_RawEv(e) for e in events]
    raw.append(_RawEv(_Ev("gemm", 70, 90, cuda=True, id=5), hidden=True))
    got = B.hlo_op_breakdown(_RawProf(raw))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k]["count"] == want[k]["count"]
        assert got[k]["device_ms"] == pytest.approx(want[k]["device_ms"])
    assert [e.name for e in B._breakdown_events(_RawProf(raw))] == [
        warm, "cudaLaunchKernel", "cudaLaunchKernel", "fill", "gemm",
        "Optimizer.step", "fill"]

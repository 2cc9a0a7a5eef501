"""Benchmark helpers of the port: card figures, timing on CUDA events,
the step profiler's accounting (FLOPs, exchange bytes, kernels, overlap
windows), the bench regression gate, seeded arrival traces and the
collective contract check.

Port of ``bluefog_tpu/benchutil.py``, every public name of it.  The JAX
module reads XLA's compiled module; the port compiles no program, so
its HLO parts read what a run of the step did:

* :func:`compiled_step_flops` runs the step once under torch's flop
  counter, each hand-written kernel's work added by the formula of its
  bound (the count :func:`~bluefog_tpu_torch.observe.profile_step`
  takes);
* :func:`hlo_collective_bytes` reads a profiled step's exchange tally
  (one device's payload per exchange, JAX's per-device convention);
* :func:`hlo_op_breakdown` is a ``torch.profiler`` run's breakdown by
  kernel name (by host op on the CPU): ``{name: {"count", "flops",
  "device_ms"}}``;
* :func:`scheduled_collective_windows` gives one window per exchange
  (each ``bf.backend.exchange`` range): its span on its own stream and
  the compute-stream kernel time inside it, where JAX reads an HLO
  schedule's start/done pairs;
* :func:`overlap_accounting` scores a list of windows with JAX's
  arithmetic: the port's on their measured compute time, JAX's on
  their flops and bytes;
* :func:`latency_hiding_xla_flags` has no counterpart (there is no XLA)
  and raises.

The timers (:func:`device_fetch`, :func:`fetch_overhead`, :func:`timed`,
:func:`chain_time`, :func:`fwd_bwd_time`) keep JAX's argument orders and
return seconds: by CUDA events where the work's tensors lie on a card
(``chip_smoke.py``'s ``time_ms`` is the model), by ``time.perf_counter``
on the CPU.  Work on a CUDA tensor is never timed by the host clock.
The bench gate, the arrival generators and the card table are host
code.
"""

from __future__ import annotations

import re
import time
from types import SimpleNamespace

import numpy as np
import torch

from bluefog_tpu_torch import config as bfconfig

__all__ = ["device_fetch", "fetch_overhead", "timed",
           "chain_time", "fwd_bwd_time", "poisson_arrivals",
           "diurnal_arrivals", "flash_crowd_arrivals",
           "chip_peak_flops", "chip_hbm_bandwidth", "compiled_step_flops",
           "mfu", "hlo_collective_bytes", "hlo_op_breakdown",
           "scheduled_collective_windows", "overlap_accounting",
           "LATENCY_HIDING_XLA_FLAGS", "latency_hiding_xla_flags",
           "bench_headline", "bench_compare", "bench_regression_gate",
           "verify_collective_contract"]

# Dense bf16 peak FLOP/s and memory bytes/s by card name (NVIDIA data
# sheets); the first key the device's name contains wins.  Override with
# BLUEFOG_CHIP_PEAK_TFLOPS / BLUEFOG_CHIP_HBM_GBPS for a card not listed.
_CARDS = (("H100 NVL", 835e12, 3.9e12), ("H100 PCIe", 756e12, 2.0e12),
          ("H100", 989e12, 3.35e12), ("H200", 989e12, 4.8e12))


def _card_figure(device, column: int) -> float:
    """Column 1 (the peak) or 2 (the memory rate) of ``_CARDS`` for the
    card ``device`` names (the current card when None and one is
    present; an int is a card index); 0.0 on the CPU or for a card the
    table does not list."""
    if device is None:
        if not torch.cuda.is_available():
            return 0.0
        device = torch.device("cuda", torch.cuda.current_device())
    elif isinstance(device, int):
        device = torch.device("cuda", device)
    else:
        device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device)
    return next((row[column] for row in _CARDS if row[0] in name), 0.0)


def chip_peak_flops(device=None) -> float:
    """Peak dense bf16 FLOP/s of one card, or 0.0 when unknown (the CPU,
    a card not in the table).  Override: BLUEFOG_CHIP_PEAK_TFLOPS."""
    override = bfconfig.chip_peak_tflops_override()
    if override:
        return override * 1e12
    return _card_figure(device, 1)


def chip_hbm_bandwidth(device=None) -> float:
    """Memory bandwidth of one card in bytes/s, or 0.0 when unknown.
    Override: BLUEFOG_CHIP_HBM_GBPS."""
    override = bfconfig.chip_hbm_gbps_override()
    if override:
        return override * 1e9
    return _card_figure(device, 2)


def compiled_step_flops(fn, *args, **kwargs) -> float:
    """FLOPs of one run of ``fn(*args, **kwargs)``: torch's flop counter
    over aten's ops plus each hand-written kernel's work by the formula
    of its bound, the count ``profile_step`` takes.  Where JAX asks XLA's
    cost analysis of the compiled module and runs nothing, this RUNS
    ``fn`` once (a train step advances its state by a step)."""
    from bluefog_tpu_torch.observe import stepprof

    flops, kernel_ops = stepprof.counted_run(fn, args, kwargs)
    return flops + sum(kernel_ops.values())


def mfu(flops_per_step: float, step_seconds: float,
        peak_per_chip: float = None) -> float:
    """Model FLOPs utilization: achieved FLOP/s over peak FLOP/s.
    ``flops_per_step`` is per card (as ``compiled_step_flops`` reports);
    returns 0.0 when the peak is unknown."""
    if peak_per_chip is None:
        peak_per_chip = chip_peak_flops()
    if not peak_per_chip or step_seconds <= 0:
        return 0.0
    return flops_per_step / step_seconds / peak_per_chip


def hlo_collective_bytes(profile) -> dict:
    """``{kind: {"count", "bytes"}}`` of the exchanges a profiled step
    made, from a :class:`~bluefog_tpu_torch.observe.StepProfile`'s
    exchange tally (or the tally dict): one device's payload per
    exchange, JAX's per-device result bytes.  JAX parses an optimized
    HLO module's text here, which the port does not have."""
    return {kind: {"count": int(rec["count"]), "bytes": int(rec["bytes"])}
            for kind, rec in _tally_of(profile,
                                       "hlo_collective_bytes").items()}


# Every exchange of the port runs in a profiler range of this name
# (parallel/collectives.py ``EXCHANGE``); while a profile counts, each
# one also leaves a zero-length marker ``<EXCHANGE>/<kind>/<bytes>``
# inside its range (``collectives._tally_exchange``).
_EXCHANGE = "bf.backend.exchange"

# {wrapper name prefix: the symbols of the CUDA kernels it launches}:
# where a hand-written kernel's work (``stepprof.count_kernel``, by its
# wrapper's name) lands in a breakdown by kernel name
_KERNEL_SYMBOLS = (("conv1x1_backward", ("k1_",)),
                   ("decode_attention", ("decode_split_kernel",
                                         "decode_merge_kernel")),
                   ("flash_forward", ("k2_",)),
                   ("flash_backward_dq", ("k3a_",)),
                   ("flash_backward_dkv", ("k3b_",)),
                   ("splash_backward", ("k5_",)))


# A long-lived process's profiler loses the first device activities of
# profiling session (none in a fresh process, 11 after 150 s of idling,
# 68 at phase 28 of chip_smoke.py, on an H100 with torch 2.11 and CUDA
# 12.8, whatever the pause before the work).  A session on a card therefore starts with this many
# throwaway launches in a range of this name (``profiler_warm_up``),
# which the breakdown leaves out and whose last launch must be recorded.
_WARMUP = "bf.profile_step.warmup"
_WARMUP_LAUNCHES = 1024


def profiler_warm_up(device) -> None:
    """The first thing a ``torch.profiler`` session on a card runs:
    ``_WARMUP_LAUNCHES`` tiny kernels in a ``bf.profile_step.warmup``
    range, then a sync, so that the device activities the profiler drops
    at a session's start are these, not the profiled work's."""
    with torch.profiler.record_function(_WARMUP):
        x = torch.empty(1, device=device)
        for _ in range(_WARMUP_LAUNCHES):
            x.fill_(0)
        torch.cuda.synchronize(device)


def _warm_up_launches(events) -> tuple:
    """(the correlation ids of the runtime calls made inside the session's
    warm-up range, whether the device event of the last of them was
    recorded); (an empty set, True) without a warm-up."""
    cpu_t = torch.autograd.DeviceType.CPU
    cpu = [e for e in events if e.device_type == cpu_t]
    warm = [e for e in cpu if e.name == _WARMUP]
    if not warm:
        return frozenset(), True
    a, b = warm[0].time_range.start, warm[0].time_range.end
    calls = sorted((e for e in cpu if e.name.startswith("cu")
                    and a <= e.time_range.start <= b),
                   key=lambda e: e.time_range.start)
    recorded = {e.id for e in events if e.device_type != cpu_t
                and not getattr(e, "is_user_annotation", False)}
    last = [e for e in calls if e.name.startswith("cudaLaunch")][-1:]
    return frozenset(e.id for e in calls), all(e.id in recorded
                                               for e in last)


def _breakdown_events(profile) -> list:
    """What the breakdown reads of a finished profile: ``events()``, or,
    where the profile keeps its raw results and recorded no flops, its
    device events and the host's runtime calls and warm-up range read
    from those, with the attributes ``events()`` gives them.  Building
    ``events()`` makes an event of every CPU op of the window first, which
    takes seconds for one 4-rank ResNet-50 step's profile."""
    raw = getattr(getattr(profile, "profiler", None), "kineto_results",
                  None)
    if raw is None or getattr(profile, "with_flops", False):
        return profile.events()
    cpu = torch.autograd.DeviceType.CPU
    out = []
    base = None
    for ev in raw.events():
        name = ev.name()
        kind = ev.device_type()
        if (kind == cpu and name != _WARMUP and not name.startswith("cu")) \
                or getattr(ev, "is_hidden_event", lambda: False)():
            continue
        # us from the first event read, as events() counts them from the
        # trace's start: an epoch time in us as a float keeps only
        # quarter microseconds
        start = ev.start_ns()
        base = start if base is None else base
        out.append(SimpleNamespace(
            name=name, id=ev.correlation_id(), device_type=kind,
            is_user_annotation=ev.is_user_annotation(),
            time_range=SimpleNamespace(
                start=(start - base) / 1e3,
                end=(start - base + ev.duration_ns()) / 1e3)))
    return out


def _profiled_on_card(events) -> bool:
    want = torch.autograd.DeviceType.CUDA
    return any(e.device_type == want for e in events)


def hlo_op_breakdown(profile, kernel_flops=None) -> dict:
    """``{name: {"count", "flops", "device_ms"}}`` of a profiled run.

    ``profile`` is a finished ``torch.profiler.profile`` (or a
    :class:`~bluefog_tpu_torch.observe.StepProfile`, whose breakdown is
    returned).  On a card the names are the device kernels' and
    ``device_ms`` their summed device time (a ``profiler_warm_up``'s
    kernels left out); on the CPU the host ops' and their own host time.  ``flops``: each hand-written kernel's work
    (``kernel_flops``, ``{wrapper: operations}`` as ``count_kernel``
    reports it) spread over its kernels by their time, plus aten's count
    of each matmul and convolution call (``profile(with_flops=True)``)
    spread over the kernels that call launched.  JAX counts per HLO op
    kind with its flop estimator."""
    if hasattr(profile, "op_breakdown"):
        return {k: dict(v) for k, v in profile.op_breakdown.items()}
    if isinstance(profile, str) or not hasattr(profile, "key_averages"):
        raise TypeError(
            "hlo_op_breakdown reads a finished torch.profiler run or a "
            "StepProfile; there is no HLO text in the port")
    events = _breakdown_events(profile)
    cuda = _profiled_on_card(events)
    if not cuda:
        events = profile.events()
    out = {}
    if cuda:
        # each device event of the profiled work (not the warm-up's)
        skip, _ = _warm_up_launches(events)
        for e in events:
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)
                    or e.id in skip):
                continue
            rec = out.setdefault(e.name, {"count": 0, "flops": 0.0,
                                          "device_ms": 0.0})
            rec["count"] += 1
            rec["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3
    for e in () if cuda else profile.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CPU
                or getattr(e, "is_user_annotation", False)):
            continue
        out[e.key] = {"count": int(e.count), "flops": 0.0,
                      "device_ms": e.self_cpu_time_total / 1e3}
    cpu = torch.autograd.DeviceType.CPU
    for e in events:
        f = float(getattr(e, "flops", 0) or 0)
        if not f or e.device_type != cpu:
            continue
        if not cuda:
            if e.name in out:
                out[e.name]["flops"] += f
            continue
        launched = [k for k in e.kernels if k.name in out]
        total = sum(k.duration for k in launched)
        for k in launched:
            out[k.name]["flops"] += f * (k.duration / total if total
                                         else 1.0 / len(launched))
    for wrapper, ops in (kernel_flops or {}).items():
        syms = next((s for key, s in _KERNEL_SYMBOLS
                     if wrapper.startswith(key)), (wrapper,))
        names = [k for k in out if any(s in k for s in syms)]
        total = sum(out[k]["device_ms"] for k in names)
        for k in names:
            out[k]["flops"] += ops * (out[k]["device_ms"] / total if total
                                      else 1.0 / len(names))
    return out


def _union_inside(spans, lo: float, hi: float) -> float:
    """Length of the union of ``spans`` ([(start, end)]) inside [lo, hi]."""
    cut = sorted((max(a, lo), min(b, hi)) for a, b in spans
                 if b > lo and a < hi)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in cut:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def scheduled_collective_windows(profile) -> list:
    """One record per exchange of a finished ``torch.profiler`` run (the
    port's counterpart of JAX's per-collective records of a scheduled
    HLO module), in the order they ran::

        {kind, computation, bytes, async, window_flops,
         window_bytes_accessed, independent_flops,
         independent_bytes_accessed, stream, start_ms, window_ms,
         compute_ms}

    ``kind`` and ``bytes`` (one device's payload) come from the exchange
    tally's marker in the exchange's ``bf.backend.exchange`` range, so
    the run must have been taken while ``profile_step`` counts (it is,
    inside ``profile_step``).  On a card the window is the span, on its
    own stream, of the device work the range launched (``stream``,
    ``start_ms``, ``window_ms``: the device event the profiler records
    for the range), and ``compute_ms`` the time inside that span in
    which kernels of other streams that belong to no exchange ran: the
    compute that hid the exchange.  An exchange on the compute
    stream itself has none.  On the CPU the window is the range's host
    time and ``compute_ms`` 0.0 (one host thread).  ``async`` is True:
    every window is scored on what ran (JAX's "scheduled" basis); the
    flop and byte fields, JAX's estimates, are 0.0."""
    events = profile.events()
    cuda = _profiled_on_card(events)
    cpu_t = torch.autograd.DeviceType.CPU
    cpu = [e for e in events if e.device_type == cpu_t]

    def span(e):
        return e.time_range.start, e.time_range.end

    # the outermost exchange ranges of each thread
    ranges = sorted((e for e in cpu if e.name == _EXCHANGE), key=span)
    top, reach = [], {}
    for r in ranges:
        a, b = span(r)
        if a < reach.get(r.thread, float("-inf")):
            continue
        reach[r.thread] = b
        top.append(r)
    marks = sorted((e for e in cpu if e.name.startswith(_EXCHANGE + "/")),
                   key=span)

    index = {id(r): i for i, r in enumerate(top)}

    def enclosing(m):
        # the profile's tree of host events: the marker's outermost
        # exchange ancestor; else the outermost range around it in time
        outer, p = None, getattr(m, "cpu_parent", None)
        while p is not None:
            if p.name == _EXCHANGE:
                outer = p
            p = getattr(p, "cpu_parent", None)
        if outer is not None and id(outer) in index:
            return index[id(outer)]
        t = m.time_range.start
        return next((i for i, r in enumerate(top) if r.thread == m.thread
                     and r.time_range.start <= t <= r.time_range.end), None)

    owner = [enclosing(m) for m in marks]
    spans, others = {}, []
    if cuda:
        dev_t = torch.autograd.DeviceType.CUDA
        device = [e for e in events if e.device_type == dev_t]
        work = [e for e in device
                if not getattr(e, "is_user_annotation", False)]
        # a range's device work: the span the profiler records for it (an
        # event of the range's name and id on each stream its work ran
        # on; ids of other kinds of event may coincide with it) ...
        by_id = {r.id: i for i, r in enumerate(top)}
        for e in device:
            if getattr(e, "is_user_annotation", False) \
                    and e.name == _EXCHANGE and e.id in by_id:
                spans.setdefault(by_id[e.id], []).append(
                    (e.device_resource_id, *span(e)))
        # ... and where it recorded none (it can miss a side stream's
        # work), the device events whose launch, the runtime call of
        # their correlation id, the host made while the range was open
        launches = {e.id: e for e in cpu if e.name.startswith("cu")}
        open_ = sorted((*span(top[i]), i) for i in range(len(top))
                       if i not in spans)
        for k in work if open_ else ():
            src = launches.get(k.id)
            t = None if src is None else src.time_range.start
            i = next((i for a, b, i in open_ if t is not None
                      and a <= t <= b), None)
            if i is not None:
                spans.setdefault(i, []).append(
                    (k.device_resource_id, *span(k)))
        bounds = [b for v in spans.values() for b in v]

        def exchange_work(k):
            a, b = span(k)
            return any(st == k.device_resource_id and lo <= a and b <= hi
                       for st, lo, hi in bounds)

        others = [k for k in work if not exchange_work(k)]
        if any(o is not None for o in owner) and not any(
                o in spans for o in owner if o is not None):
            raise RuntimeError(
                "scheduled_collective_windows: the card's profile ran "
                f"{len(marks)} exchanges, but no device work could be "
                f"traced to their ranges ({len(device)} device events)")
    out = []
    for m, i in zip(marks, owner):
        _, kind, nbytes = m.name.rsplit("/", 2)
        rec = {"kind": kind, "computation": "host", "bytes": int(nbytes),
               "async": True, "window_flops": 0.0,
               "window_bytes_accessed": 0.0, "independent_flops": 0.0,
               "independent_bytes_accessed": 0.0, "stream": None,
               "start_ms": m.time_range.start / 1e3, "window_ms": 0.0,
               "compute_ms": 0.0}
        if i is not None and cuda and i in spans:
            busy = {}
            for st, a, b in spans[i]:
                busy[st] = busy.get(st, 0.0) + b - a
            stream = max(busy, key=busy.get)
            lo = min(a for st, a, _ in spans[i] if st == stream)
            hi = max(b for st, _, b in spans[i] if st == stream)
            hidden = _union_inside(
                [span(k) for k in others if k.device_resource_id != stream],
                lo, hi)
            rec.update(computation=f"stream {stream}", stream=stream,
                       start_ms=lo / 1e3, window_ms=(hi - lo) / 1e3,
                       compute_ms=hidden / 1e3)
        elif i is not None and not cuda:
            a, b = span(top[i])
            rec.update(start_ms=a / 1e3, window_ms=(b - a) / 1e3)
        out.append(rec)
    return out


def overlap_accounting(windows,
                       peak_flops_per_s: float = 0.0,
                       link_bytes_per_s: float = 0.0,
                       hbm_bytes_per_s: float = 0.0,
                       congestion: float = 1.0,
                       kinds: tuple = ("collective-permute",)) -> dict:
    """Overlappable-bytes accounting for the exchanges of ``kinds`` over
    ``windows`` (a list of window records, or anything with a
    ``windows`` list: a StepProfile), the JAX package's arithmetic on a
    list where JAX parses the windows from HLO first.

    An exchange's payload is overlappable when the compute that can hide
    it runs at least as long as its transfer over the link::

        hidden seconds >= payload_bytes * congestion / link_bytes_per_s

    The hidden seconds of a window the port measured are its
    ``compute_ms``.  A JAX window (no ``compute_ms``) is scored as JAX
    scores it: ``max(flops / peak, bytes_accessed / hbm_bw)`` over its
    start->done window when it is async, over its dataflow-independent
    compute when not (so ``peak_flops_per_s`` must be positive then).
    ``basis`` is ``"scheduled"`` (all async), ``"dataflow"`` (all sync)
    or ``"mixed"``.  Returns per-kind and total bytes, overlappable
    bytes, the byte-weighted fraction and the windows scored."""
    windows = getattr(windows, "windows", windows)
    windows = [w for w in windows if w["kind"] in kinds]
    if link_bytes_per_s <= 0:
        raise ValueError("link_bytes_per_s must be positive: the wire "
                         "rate a payload's transfer is scored against")
    if peak_flops_per_s <= 0 and any("compute_ms" not in w
                                     for w in windows):
        raise ValueError("peak_flops_per_s must be positive to score "
                         "windows by their flops (pass the target card's "
                         "figures when auditing from a host)")
    n_async = sum(1 for w in windows if w["async"])
    basis = ("scheduled" if n_async == len(windows) and windows else
             "dataflow" if n_async == 0 else "mixed")
    per_kind: dict = {}
    for w in windows:
        rec = per_kind.setdefault(
            w["kind"], {"count": 0, "bytes": 0, "bytes_overlappable": 0})
        rec["count"] += 1
        rec["bytes"] += w["bytes"]
        if "compute_ms" in w:
            hide_s = w["compute_ms"] / 1e3
        else:
            if w["async"]:
                flops, touched = (w["window_flops"],
                                  w["window_bytes_accessed"])
            else:
                flops, touched = (w["independent_flops"],
                                  w["independent_bytes_accessed"])
            hide_s = flops / peak_flops_per_s
            if hbm_bytes_per_s > 0:
                hide_s = max(hide_s, touched / hbm_bytes_per_s)
        transfer_s = w["bytes"] * congestion / link_bytes_per_s
        if hide_s >= transfer_s and w["bytes"] > 0:
            rec["bytes_overlappable"] += w["bytes"]
    total = sum(r["bytes"] for r in per_kind.values())
    good = sum(r["bytes_overlappable"] for r in per_kind.values())
    return {
        "basis": basis,
        "per_kind": per_kind,
        "bytes_total": int(total),
        "bytes_overlappable": int(good),
        "fraction": (good / total) if total else 0.0,
        "windows": windows,
    }


# No XLA runs in the port, so no scheduler flags exist to merge.
LATENCY_HIDING_XLA_FLAGS = ()


def latency_hiding_xla_flags(extra: tuple = ()) -> str:
    """Raises: the JAX package merges XLA's latency-hiding scheduler
    flags into ``XLA_FLAGS`` here.  The port runs no XLA; its exchanges
    overlap compute on a CUDA side stream where the step puts them
    (``build_train_step(overlap="bucketed")``)."""
    raise NotImplementedError(
        "latency_hiding_xla_flags: the port runs no XLA, so there are no "
        "scheduler flags to set; the bucketed step overlaps its exchanges "
        "on a CUDA side stream (overlap_accounting measures it)")


def _on_card(*trees) -> bool:
    """Whether any tensor in ``trees`` lies on a card."""
    return any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in torch.utils._pytree.tree_leaves(trees))


def device_fetch(a) -> np.ndarray:
    """Synchronize by materializing ``a`` on the host (a tensor's dtypes
    numpy lacks, such as bf16, arrive as float32)."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    a = a.detach().cpu()
    try:
        return a.numpy()
    except TypeError:
        return a.float().numpy()


def fetch_overhead(repeats: int = 3, device=None) -> float:
    """Median seconds of a fresh trivial computation (``x + i``) and its
    fetch: the per-sync overhead to subtract from timed loops.  On a
    card (``device``), its device time by CUDA events; on the CPU (the
    default), its wall time."""
    dev = torch.device(device) if device is not None else torch.device(
        "cpu")
    x = torch.zeros(1, dtype=torch.float32, device=dev)
    device_fetch(x + 1.0)  # first use outside the timing
    times = []
    for i in range(repeats):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = x + float(i + 2)
            end.record()
            device_fetch(y)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            device_fetch(x + float(i + 2))
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def timed(run_steps, sync_value_fn, overhead: float = None) -> float:
    """Run ``run_steps()`` (which enqueues work), sync on
    ``sync_value_fn()`` (a value computed from that work) and return its
    seconds with ``overhead`` (default :func:`fetch_overhead` on the
    value's device) subtracted.  When the value lies on a card the
    seconds are the CUDA-event time from before ``run_steps`` to after
    the value, on that card's current stream (the value must lie on the
    current card); otherwise wall time."""
    start = None
    if torch.cuda.is_available():
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        here = torch.cuda.current_device()
    t0 = time.perf_counter()
    run_steps()
    value = sync_value_fn()
    if isinstance(value, torch.Tensor) and value.is_cuda:
        if value.device.index != here:
            raise ValueError(
                f"timed: the sync value lies on {value.device}, the events "
                f"were recorded on cuda:{here}; time on the current card")
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
        if overhead is None:
            overhead = fetch_overhead(device=value.device)
    else:
        device_fetch(value)
        seconds = time.perf_counter() - t0
        if overhead is None:
            overhead = fetch_overhead()
    return max(seconds - overhead, 1e-9)


def _per_iteration(chained, x0, n: int, reps: int) -> float:
    """Median seconds per iteration of ``chained()`` (``n`` iterations)
    over ``reps`` runs after one warm-up run: CUDA events when ``x0``
    lies on a card, else wall time less the fetch overhead."""
    device_fetch(chained()[..., :1])
    times = []
    if x0.is_cuda:
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chained()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / n)
        return float(np.median(times))
    ov = fetch_overhead()
    for _ in range(reps):
        t0 = time.perf_counter()
        device_fetch(chained()[..., :1])
        times.append((time.perf_counter() - t0 - ov) / n)
    return float(np.median(times))


def _check_placement(what, params, x0) -> None:
    if _on_card(params) and not x0.is_cuda:
        raise ValueError(f"{what}: params lie on a card and x0 on the "
                         "host; put x0 on the card, whose work is timed "
                         "by CUDA events")


def chain_time(f, params, x0, n=20, reps=3):
    """Per-iteration seconds of ``x <- x0 + f(params, x) * 1e-30``
    iterated ``n`` times (each iteration reads the last one's output, so
    the work runs in order and none is skipped; an output of another
    shape is reduced over its last dim first, every element consumed),
    the median of ``reps`` runs.  On a card: the CUDA-event time of the
    ``n`` iterations launched from a host loop, so a kernel shorter than
    its launch reads its launch rate (JAX iterates inside one compiled
    loop).  On the CPU: wall time less the fetch overhead."""
    _check_placement("chain_time", params, x0)

    @torch.no_grad()
    def chained():
        x = x0
        for _ in range(n):
            y = f(params, x)
            if y.shape != x0.shape:
                y = y.float().mean(-1, keepdim=True)
            x = torch.add(x0, y.to(x0.dtype), alpha=1e-30)
        return x

    return _per_iteration(chained, x0, n, reps)


def fwd_bwd_time(f, params, x0, n=20, reps=3):
    """Forward + backward seconds of ``y = f(params, x)`` with gradients
    of ``sum(y ** 2)`` with respect to every floating tensor of
    ``params`` and to ``x``, chained through ``dx`` (every gradient
    consumed), the median of ``reps`` runs of ``n`` iterations: the same
    argument order as :func:`chain_time`, timed the same way."""
    _check_placement("fwd_bwd_time", params, x0)
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    grad_at = [i for i, t in enumerate(leaves)
               if isinstance(t, torch.Tensor) and t.is_floating_point()]

    def chained():
        x = x0
        for _ in range(n):
            live = list(leaves)
            for i in grad_at:
                live[i] = leaves[i].detach().requires_grad_(True)
            xi = x.detach().requires_grad_(True)
            with torch.enable_grad():
                y = f(torch.utils._pytree.tree_unflatten(live, spec), xi)
                grads = torch.autograd.grad(y.float().square().sum(),
                                            [live[i] for i in grad_at]
                                            + [xi])
            with torch.no_grad():
                dp = sum((g.float().sum() for g in grads[:-1]),
                         torch.zeros((), device=x0.device))
                x = (grads[-1].float() * 1e-30 + dp * 1e-30).to(
                    x0.dtype) + x0
        return x

    return _per_iteration(chained, x0, n, reps)


# --------------------------------------------------------------------- #
# The bench regression gate, the JAX package's host code copied: compare
# a fresh run's headline numbers against a prior record (per-metric
# tolerance, a one-line delta table, False on a regression, on which the
# caller exits nonzero).
# --------------------------------------------------------------------- #
# headline fields worth gating, with their GOOD direction
_HEADLINE_HIGHER = ("value", "mfu", "tokens_per_sec", "useful_tokens",
                    "speedup_tokens_per_sec", "vs_baseline",
                    "compiled_advantage", "hit_rate",
                    "accepted_per_step", "fleet_speedup",
                    "throughput_recovery", "tp_overlap_fraction",
                    "cost_to_consensus_advantage", "decisions_replayed")
_HEADLINE_LOWER = ("ttft_p50", "ttft_p99", "latency_p50", "latency_p99",
                   "makespan_s", "p99", "p50", "cost_to_consensus",
                   "post_rejoin_floor", "dcn_bytes_per_step",
                   "lost_requests", "step_time_ratio",
                   "consensus_floor", "mean_drift", "detect_to_swap_s",
                   "cost_to_dispatch", "mismatches")


def bench_headline(record: dict) -> dict:
    """Extract the gateable headline metrics of a bench JSON record as
    ``{name: float}``.  Understands the three shapes this repo emits:
    the raw ``bench.py`` line (``{"metric", "value", "mfu", ...}``),
    a ``BENCH_*.json`` wrapper (the same dict under
    ``"parsed"``), and section records like ``serving_bench``'s
    (headline fields under ``"continuous"``)."""
    if isinstance(record.get("parsed"), dict):
        record = record["parsed"]
    keys = set(_HEADLINE_HIGHER) | set(_HEADLINE_LOWER)
    out: dict = {}

    def grab(d: dict, prefix: str) -> None:
        for k, v in d.items():
            if (k in keys and isinstance(v, (int, float))
                    and not isinstance(v, bool)):
                out[prefix + k] = float(v)

    grab(record, "")
    for section in ("continuous", "static", "chaos", "straggler",
                    "rejoin", "pod_4x8", "pod_8x16", "fleet_one",
                    "fleet_two", "prefix", "speculative",
                    "hierarchical", "fault_free", "chaos_serving",
                    "drain", "adaptation", "congested", "shrink",
                    "rollback", "compressed", "sim_training",
                    "sim_serving", "moe", "measured", "replay"):
        if isinstance(record.get(section), dict):
            grab(record[section], section + ".")
    return out


def _direction(name: str) -> int:
    """+1 = higher is better, -1 = lower is better (latency tails)."""
    base = name.rsplit(".", 1)[-1]
    return -1 if base in _HEADLINE_LOWER else +1


def bench_compare(current: dict, previous: dict, tolerance: float = 0.05,
                  tolerances: dict = None) -> tuple:
    """Compare two bench records' shared headline metrics.

    Returns ``(ok, rows)``: ``rows`` is one dict per shared metric
    (``name, prev, cur, delta_frac, tol, regressed``); ``ok`` is False
    iff any metric moved more than its tolerance in the BAD direction
    (improvements never fail the gate).  ``tolerances`` overrides the
    per-metric relative tolerance by headline name."""
    cur_h = bench_headline(current)
    prev_h = bench_headline(previous)
    rows = []
    ok = True
    for name in sorted(set(cur_h) & set(prev_h)):
        prev, cur = prev_h[name], cur_h[name]
        tol = float((tolerances or {}).get(name, tolerance))
        denom = max(abs(prev), 1e-12)
        delta = (cur - prev) / denom
        regressed = (-delta if _direction(name) > 0 else delta) > tol
        ok = ok and not regressed
        rows.append(dict(name=name, prev=prev, cur=cur,
                         delta_frac=delta, tol=tol, regressed=regressed))
    return ok, rows


def _record_round(path: str, record: dict) -> str:
    """The baseline record's round, for gate attribution: the ``_r<N>``
    filename convention first (``fleet_sim_r20.json`` -> ``r20``), then
    an explicit ``round`` field, else ``r?``."""
    m = re.search(r"_r(\d+)", path.rsplit("/", 1)[-1])
    if m:
        return "r" + m.group(1)
    rec = record.get("parsed") if isinstance(record.get("parsed"),
                                             dict) else record
    rnd = rec.get("round") if isinstance(rec, dict) else None
    return f"r{rnd}" if rnd is not None else "r?"


def _record_sections(record: dict) -> str:
    """Comma-joined section names (dict-valued keys) of a bench record —
    what a no-shared-metrics mismatch message lists for each side."""
    if isinstance(record.get("parsed"), dict):
        record = record["parsed"]
    secs = sorted(k for k, v in record.items() if isinstance(v, dict))
    return ",".join(secs) if secs else "-"


def bench_regression_gate(current: dict, prev_path: str,
                          tolerance: float = 0.05,
                          tolerances: dict = None) -> bool:
    """Gate ``current`` against the record stored at ``prev_path``:
    prints the one-line delta table (naming the baseline file and its
    record round, so a failing gate says exactly which artifact it
    compared against) and returns False on regression (callers
    ``sys.exit(1)``)."""
    import json as _json

    with open(prev_path) as fh:
        previous = _json.load(fh)
    rnd = _record_round(prev_path, previous)
    ok, rows = bench_compare(current, previous, tolerance, tolerances)
    if not rows:
        print(f"[bench-gate] no shared headline metrics with {prev_path} "
              f"({rnd}): current sections [{_record_sections(current)}] "
              f"vs baseline sections [{_record_sections(previous)}]")
        return True
    cells = []
    for r in rows:
        mark = "REGRESSED" if r["regressed"] else "ok"
        cells.append(f"{r['name']} {r['prev']:.4g}->{r['cur']:.4g} "
                     f"({r['delta_frac']:+.1%} {mark})")
    print(f"[bench-gate] vs {prev_path} ({rnd}): " + " | ".join(cells))
    return ok


def poisson_arrivals(rate: float, n: int, seed: int = 0) -> np.ndarray:
    """Arrival times (seconds, ascending, starting at 0.0) of ``n``
    Poisson arrivals at ``rate`` requests/s: the cumulative sum of
    seeded exponential inter-arrival gaps.  Pure function of
    ``(rate, n, seed)`` — no wall clock anywhere — so every caller
    replays the SAME trace."""
    if rate <= 0:
        raise ValueError(f"rate ({rate}) must be positive")
    if n < 1:
        return np.zeros((0,), np.float64)
    gaps = np.random.RandomState(seed).exponential(1.0 / rate, size=n)
    gaps[0] = 0.0
    return np.cumsum(gaps)


def _unit_poisson_targets(n: int, seed: int) -> np.ndarray:
    """Unit-rate Poisson cumulative targets — the shared substrate of
    the non-homogeneous generators below (inversion method: arrival
    *i* lands where the cumulative rate function crosses target *i*).
    Same convention as :func:`poisson_arrivals`: first arrival at 0."""
    gaps = np.random.RandomState(seed).exponential(1.0, size=n)
    gaps[0] = 0.0
    return np.cumsum(gaps)


def diurnal_arrivals(rate: float, n: int, seed: int = 0, *,
                     period: float = 60.0, depth: float = 0.5,
                     phase: float = 0.0) -> np.ndarray:
    """Arrival times of ``n`` requests from a sinusoidally modulated
    Poisson process — the diurnal load shape: instantaneous rate
    ``rate * (1 + depth * sin(2*pi*t/period + phase))`` requests/s.
    Exact inversion of the cumulative rate function (vectorized
    bisection), so counts over any window match its integral in
    expectation and the trace is a pure function of the arguments —
    no thinning, no wall clock, no resampling loop.  ``0 <= depth < 1``
    keeps the rate strictly positive."""
    if rate <= 0:
        raise ValueError(f"rate ({rate}) must be positive")
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"depth ({depth}) must be in [0, 1)")
    if period <= 0:
        raise ValueError(f"period ({period}) must be positive")
    if n < 1:
        return np.zeros((0,), np.float64)
    targets = _unit_poisson_targets(n, seed)
    w = 2.0 * np.pi / period
    amp = rate * depth / w

    def cum_rate(t):
        return rate * t + amp * (np.cos(phase) - np.cos(w * t + phase))

    # cum_rate(t) >= rate*t - 2*amp, so t <= (target + 2*amp)/rate
    lo = np.zeros(n, np.float64)
    hi = (targets + 2.0 * amp) / rate + 1.0
    for _ in range(64):  # bisection to ~1 ulp of the window width
        mid = 0.5 * (lo + hi)
        below = cum_rate(mid) < targets
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    out = 0.5 * (lo + hi)
    out[0] = 0.0
    return out


def flash_crowd_arrivals(rate: float, n: int, seed: int = 0, *,
                         at: float = 0.0, factor: float = 4.0,
                         duration: float = 1.0) -> np.ndarray:
    """Arrival times of ``n`` requests from a Poisson process at
    ``rate`` requests/s with one flash crowd: inside ``[at, at +
    duration)`` the rate jumps to ``rate * factor``.  The cumulative
    rate function is piecewise linear, so the inversion is closed-form
    and exact; outside the burst the trace statistics match
    :func:`poisson_arrivals` at the same base rate.  Deterministic in
    ``(rate, n, seed, at, factor, duration)``."""
    if rate <= 0:
        raise ValueError(f"rate ({rate}) must be positive")
    if factor <= 0:
        raise ValueError(f"factor ({factor}) must be positive")
    if duration < 0 or at < 0:
        raise ValueError(f"burst window (at={at}, duration={duration}) "
                         f"must be non-negative")
    if n < 1:
        return np.zeros((0,), np.float64)
    targets = _unit_poisson_targets(n, seed)
    c1 = rate * at                           # cum rate at burst start
    c2 = c1 + rate * factor * duration       # cum rate at burst end
    out = np.where(
        targets < c1, targets / rate,
        np.where(targets < c2,
                 at + (targets - c1) / (rate * factor),
                 at + duration + (targets - c2) / rate))
    return out.astype(np.float64)


def _tally_of(profile, what: str = "verify_collective_contract") -> dict:
    """``{kind: {"count", "bytes", "payloads", "groups"?}}`` of a
    StepProfile (its ``collective_bytes``, ``collective_payloads`` and
    ``collective_groups``) or of a tally dict as it is."""
    if isinstance(profile, str) or hasattr(profile, "as_text"):
        raise TypeError(
            f"{what} reads a StepProfile (or its exchange tally) of a step "
            "the port ran; there is no HLO text in the port")
    if not hasattr(profile, "collective_bytes"):
        return profile
    out = {}
    for kind, rec in profile.collective_bytes.items():
        out[kind] = dict(rec, payloads=list(
            profile.collective_payloads.get(kind, ())))
        if kind in profile.collective_groups:
            out[kind]["groups"] = profile.collective_groups[kind]
    return out


def verify_collective_contract(profile, predicted, payload_bytes,
                               *, round_index=None) -> list:
    """Hold a step's exchanges to their declared collective sketch: the
    JAX package's ``verify_collective_contract``, on what the port's
    step ran instead of a lowered program.

    ``profile`` is a :class:`~bluefog_tpu_torch.observe.StepProfile` (or
    its tally, ``{kind: {"count", "bytes", "payloads", "groups"}}``):
    one device's view of each exchange, as JAX's HLO is one device's
    program.  ``predicted`` is a ``CompiledTopology.predicted_collectives
    (payload_bytes)`` / ``CompiledHierarchicalTopology`` dict, or one
    built from ``train_step.mix_wire_layout``.  A profile covers the
    steps it ran, so ``round_index=None`` holds it to the per-period
    totals (a profile of one step is one period of a one-round
    schedule) and ``round_index=i`` to ``per_round[i]`` (a step that ran
    round ``i``).

    Returns a list of mismatch strings, empty when the contract holds:
    the prediction's internal consistency, the permute count, every
    permute payload admissible (``payload_bytes``, one size or a
    collection: compressed mixing moves one size per bucket), the total
    bytes, and for hierarchical predictions the grouped all-reduce count
    and its machine groups (recorded in the tally where JAX reads
    ``replica_groups``)."""
    tally = _tally_of(profile)
    problems = []

    per_round = predicted.get("per_round", [])
    # internal consistency of the prediction itself: the per-period
    # totals must be the per-round sum, or the dict was tampered/stale
    if per_round:
        tot_p = sum(r["permutes"] for r in per_round)
        if tot_p != predicted["permutes_per_period"]:
            problems.append(
                f"prediction inconsistent: per_round permutes sum {tot_p}"
                f" != permutes_per_period "
                f"{predicted['permutes_per_period']}")
        tot_b = float(sum(r["permutes"] * r["bytes_per_permute"]
                          for r in per_round))
        if tot_b != predicted["bytes_per_period"]:
            problems.append(
                f"prediction inconsistent: per_round bytes sum {tot_b}"
                f" != bytes_per_period {predicted['bytes_per_period']}")

    permutes = tally.get("collective-permute", {})
    payloads = [int(b) for b in permutes.get("payloads", ())]
    if round_index is None:
        want_p = predicted["permutes_per_period"]
        want_bytes = predicted["bytes_per_period"]
        want_r = predicted.get("all_reduces_per_period")
    else:
        rp = per_round[round_index]
        want_p = rp["permutes"]
        want_bytes = rp["permutes"] * rp["bytes_per_permute"]
        want_r = rp.get("all_reduces")
        payload_bytes = rp.get("bytes_per_permute", payload_bytes)

    where = ("step" if round_index is None else f"round {round_index}")
    if len(payloads) != want_p:
        problems.append(
            f"{where}: {len(payloads)} collective-permutes ran, "
            f"predicted {want_p}")
    admissible = (set(int(p) for p in payload_bytes)
                  if isinstance(payload_bytes, (set, frozenset, list,
                                                tuple))
                  else {int(payload_bytes)})
    bad = [b for b in payloads if b not in admissible]
    if bad:
        problems.append(
            f"{where}: permute payloads {bad} not in predicted "
            f"{sorted(admissible)} bytes")
    got_bytes = sum(payloads)
    if got_bytes != want_bytes:
        problems.append(
            f"{where}: {got_bytes} permute bytes ran, predicted "
            f"{want_bytes}")
    if want_r is not None:
        reduces = tally.get("all-reduce", {})
        got_r = int(reduces.get("count", 0))
        if got_r != want_r:
            problems.append(
                f"{where}: {got_r} all-reduces ran, predicted {want_r}")
        groups = predicted.get("all_reduce_groups")
        size = predicted.get("all_reduce_group_size")
        if got_r and groups and size and size > 1:
            expect = tuple(tuple(range(g * size, (g + 1) * size))
                           for g in range(groups))
            if expect not in [tuple(tuple(x) for x in gs)
                              for gs in reduces.get("groups", ())]:
                problems.append(
                    f"{where}: grouped all-reduce missing machine "
                    f"decomposition {[list(g) for g in expect]}")
    return problems

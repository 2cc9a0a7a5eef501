"""Step profiler on ``torch.profiler``: one supported attribution path.

Port of ``bluefog_tpu/observe/stepprof.py``, rebuilt.  The JAX profiler
reads XLA's view of a compiled module (its cost analysis, the HLO
collectives and their scheduled overlap windows) and executes nothing.
The port compiles no program, so :func:`profile_step` executes ``fn``
twice:

1. a warm-up run under ``torch.utils.flop_counter.FlopCounterMode``: the
   FLOPs of every aten op, plus each hand-written kernel's work by the
   formula of its bound (the operations ``chip_smoke.py`` phase 2 holds
   it to), which the kernel's wrapper reports through
   :func:`count_kernel` where it launches (the flop counter sees a
   ctypes launch as nothing);
2. a run under ``torch.profiler`` (CUDA activity on the card): device
   time and count by kernel name (``op_breakdown``; on the CPU, host
   time by op), the exchanges the collectives made inside their
   ``bf.backend.exchange`` ranges (``collective_bytes``, the JAX
   package's per-device convention: one rank's row for a permute or a
   sum, every rank's rows for a gather), and the run's wall seconds.

    prof = profile_step(train_step, params, stats, opt, batch, step)
    prof.flops                 # aten FLOPs + hand-written kernels' work
    prof.collective_bytes      # {kind: {count, bytes}} per execution
    prof.op_breakdown          # {kernel: {count, ms}}
    prof.mfu()                 # against the card's bf16 peak

Each exchange's payload is kept beside the totals
(``collective_payloads``, one device's bytes per exchange, in order), and
a grouped all-reduce's rank groups (``collective_groups``): what
``benchutil``'s :func:`verify_collective_contract` holds a step to,
where the JAX package reads the HLO's permutes and ``replica_groups``.

What the JAX profiler does that this one cannot: XLA's ahead-of-time
cost analysis (``cost_bytes_accessed`` stays 0.0, so
``hbm_utilization`` is 0.0), and the HLO schedule's per-collective
overlap windows (``windows`` is empty, ``overlap`` None).
:func:`hlo_op_breakdown` reads HLO text and raises
``NotImplementedError``; its place is ROADMAP.md Queue 1, item 13's port
of ``benchutil``.  ``fn`` runs twice, so it must be safe to repeat (a
train step takes two steps).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from bluefog_tpu_torch.benchutil import verify_collective_contract
from bluefog_tpu_torch.observe.registry import enabled, get_registry

__all__ = ["StepProfile", "profile_step", "hlo_op_breakdown",
           "verify_collective_contract", "count_kernel"]

# Dense bf16 peak and memory rate by card name (NVIDIA data sheets);
# the first key the device's name contains wins.
_CARDS = (("H100 NVL", 835e12, 3.9e12), ("H100 PCIe", 756e12, 2.0e12),
          ("H100", 989e12, 3.35e12), ("H200", 989e12, 4.8e12))

# {kernel: operations} of the run profile_step counts; None otherwise.
# Module state because the kernel wrappers, deep inside the profiled
# call, have nothing else to report into; profile_step resets it.
_kernel_ops: Optional[Dict[str, float]] = None


def count_kernel(name: str, ops: Callable[[], float]) -> None:
    """Called by a kernel's wrapper where it launches the kernel: while
    :func:`profile_step` counts, adds ``ops()`` (the launch's operations,
    by the formula of the kernel's bound) under ``name``."""
    if _kernel_ops is not None:
        _kernel_ops[name] = _kernel_ops.get(name, 0.0) + float(ops())


def _card(device: torch.device) -> tuple:
    """(dense bf16 FLOP/s, memory bytes/s) of the card by its name, 0.0
    each on the CPU or for a card not in the table."""
    if device.type != "cuda":
        return 0.0, 0.0
    name = torch.cuda.get_device_name(device)
    return next(((peak, rate) for key, peak, rate in _CARDS if key in name),
                (0.0, 0.0))


def _benchutil(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"{name} reads XLA's HLO text, which the port does not have; "
            "its counterpart waits for ROADMAP.md Queue 1, item 13's port "
            "of benchutil")
    stub.__name__ = stub.__qualname__ = name
    return stub


hlo_op_breakdown = _benchutil("hlo_op_breakdown")


@dataclasses.dataclass
class StepProfile:
    """The attribution record :func:`profile_step` returns (the JAX
    package's field names).  ``flops`` and ``collective_bytes`` are per
    execution; ``op_breakdown`` is ``{kernel: {"count", "ms"}}`` of the
    profiled run (device kernels on the card, host ops on the CPU);
    ``kernel_flops`` the hand-written kernels' share of ``flops``;
    ``step_seconds`` the caller's, else the profiled run's wall time;
    ``device_seconds`` the summed kernel time of that run (0.0 on the
    CPU); ``collective_payloads`` each exchange's bytes by kind, in
    order, and ``collective_groups`` the rank groups of the grouped
    all-reduces (machine means)."""

    name: str
    flops: float
    cost_bytes_accessed: float          # no cost analysis here: 0.0
    collective_bytes: Dict[str, dict]   # kind -> {count, bytes}
    op_breakdown: Dict[str, dict]       # kernel -> {count, ms}
    windows: List[dict]                 # no HLO schedule here: []
    overlap: Optional[dict]
    peak_flops: float                   # card peak (0.0 on the CPU)
    hbm_bandwidth: float                # card bytes/s (0.0 on the CPU)
    step_seconds: Optional[float] = None
    device_seconds: float = 0.0
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_payloads: Dict[str, list] = dataclasses.field(
        default_factory=dict)
    collective_groups: Dict[str, list] = dataclasses.field(
        default_factory=dict)

    def mfu(self, step_seconds: Optional[float] = None) -> float:
        """Achieved FLOP/s over peak; 0.0 when either is unknown."""
        s = step_seconds if step_seconds is not None else self.step_seconds
        if not s or not self.peak_flops:
            return 0.0
        return self.flops / s / self.peak_flops

    def hbm_utilization(self, step_seconds: Optional[float] = None) -> float:
        """Cost-analysis bytes over (memory rate x step time): 0.0, as
        the port has no cost analysis."""
        s = step_seconds if step_seconds is not None else self.step_seconds
        if not s or not self.hbm_bandwidth or not self.cost_bytes_accessed:
            return 0.0
        return self.cost_bytes_accessed / s / self.hbm_bandwidth

    def kernel_ms(self, *keys: str) -> float:
        """Summed ms of the kernels whose name contains any of ``keys``."""
        return sum(rec["ms"] for op, rec in self.op_breakdown.items()
                   if any(k in op for k in keys))

    def to_dict(self) -> dict:
        """JSON-ready dict."""
        out = dataclasses.asdict(self)
        out["mfu"] = self.mfu()
        out["hbm_utilization"] = self.hbm_utilization()
        return out

    def publish(self, registry=None) -> None:
        """Write the headline figures as registry gauges
        (``bf_step_*{step=name}``)."""
        reg = registry if registry is not None else get_registry()
        reg.gauge("bf_step_flops", "per-device FLOPs of one execution",
                  step=self.name).set(self.flops)
        for kind, rec in self.collective_bytes.items():
            reg.gauge("bf_step_collective_bytes",
                      "per-device collective payload bytes per execution",
                      step=self.name, kind=kind).set(rec["bytes"])
        if self.step_seconds:
            reg.gauge("bf_step_seconds", "measured step wall seconds",
                      step=self.name).set(self.step_seconds)
            reg.gauge("bf_step_mfu", "model FLOPs utilization",
                      step=self.name).set(self.mfu())


def _device_of(args, kwargs) -> torch.device:
    """The card when any tensor among the arguments lies on one, else
    the CPU."""
    leaves = torch.utils._pytree.tree_leaves((args, kwargs))
    for t in leaves:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return t.device
    return torch.device("cpu")


def _breakdown(prof, cuda: bool) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    want = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    for e in prof.key_averages():
        if e.device_type != want or getattr(e, "is_user_annotation", False):
            continue
        us = e.self_device_time_total if cuda else e.self_cpu_time_total
        out[e.key] = {"count": int(e.count), "ms": us / 1e3}
    return out


def profile_step(fn, *args, name: str = "step",
                 step_seconds: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 hbm_bytes_per_s: Optional[float] = None,
                 link_bytes_per_s: Optional[float] = None,
                 device=None, publish: bool = True,
                 **kwargs: Any) -> StepProfile:
    """Run ``fn(*args, **kwargs)`` twice (counted, then profiled) and
    return its :class:`StepProfile`.

    ``device`` is where ``fn`` runs (default: the card if any tensor
    argument lies on one, else the CPU).  Card figures default to the
    card's dense bf16 peak and memory rate by its name (H100 SXM: 989e12
    FLOP/s, 3.35e12 B/s; 0.0 on the CPU).  ``link_bytes_per_s`` (the JAX package's overlap
    accounting, which reads the HLO schedule) raises
    ``NotImplementedError``.  The profile is published to the registry as
    gauges unless ``publish=False`` or ``BLUEFOG_OBSERVE=0``."""
    global _kernel_ops
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from bluefog_tpu_torch.parallel import collectives as C

    if link_bytes_per_s:
        raise NotImplementedError(
            "overlap accounting reads the HLO schedule's collective "
            "windows; it waits for ROADMAP.md Queue 1, item 13's port of "
            "benchutil")
    dev = torch.device(device) if device is not None else _device_of(
        args, kwargs)
    cuda = dev.type == "cuda"
    peak, rate = _card(dev)
    peak_flops = peak if peak_flops is None else peak_flops
    hbm_bytes_per_s = rate if hbm_bytes_per_s is None else hbm_bytes_per_s

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    counter = FlopCounterMode(display=False)
    _kernel_ops = {}
    try:
        with counter:
            fn(*args, **kwargs)
        kernel_ops = _kernel_ops
    finally:
        _kernel_ops = None
    sync()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    C._exchange_tally = {}
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            sync()
            wall = time.perf_counter() - t0
        tally = C._exchange_tally
    finally:
        C._exchange_tally = None
    breakdown = _breakdown(prof, cuda)
    prof_rec = StepProfile(
        name=name,
        flops=float(counter.get_total_flops()) + sum(kernel_ops.values()),
        cost_bytes_accessed=0.0,
        collective_bytes={k: {"count": r["count"], "bytes": r["bytes"]}
                          for k, r in tally.items()},
        op_breakdown=breakdown,
        windows=[],
        overlap=None,
        peak_flops=peak_flops,
        hbm_bandwidth=hbm_bytes_per_s,
        step_seconds=step_seconds if step_seconds is not None else wall,
        device_seconds=(sum(r["ms"] for r in breakdown.values()) / 1e3
                        if cuda else 0.0),
        kernel_flops=kernel_ops,
        collective_payloads={k: r["payloads"] for k, r in tally.items()},
        collective_groups={k: [[list(g) for g in gs] for gs in r["groups"]]
                           for k, r in tally.items() if "groups" in r},
    )
    if publish and enabled():
        prof_rec.publish()
    return prof_rec

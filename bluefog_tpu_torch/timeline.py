"""Chrome-tracing timeline — a thin exporter over the span tracer.

Port of ``bluefog_tpu/timeline.py``.  A :class:`Timeline` is a tracer
(:class:`bluefog_tpu_torch.observe.tracer.Tracer`) plus a file-writer
**sink** (the writers' ``record(name, tid, phase)`` surface is exactly
the tracer's sink protocol).  ``start_timeline`` attaches the writer to
the process-global tracer, so every subsystem that publishes spans (the
serving engine's request lifecycles, the resilient training loop's
``resilience.*`` instants, the eager op layer) lands in the Chrome-trace
file automatically.

Two writer backends:

* **native** (default when it builds) — the C++ lock-free SPSC ring +
  writer thread of ``native/bf_native.cc`` (:mod:`bluefog_tpu_torch.
  native`), the direct equivalent of the reference's boost::lockfree
  design; its drop count reaches the gauge at ``close()``;
* **python** — a bounded queue.Queue + thread, always available.  The
  queue REFUSES events when the writer thread falls behind and counts
  the drops; the count flushes to the ``bf_timeline_dropped_events``
  registry gauge every ``BLUEFOG_TIMELINE_FLUSH_EVERY`` writer drains,
  whenever the queue drains to empty with undisclosed drops, and once at
  ``close()``.

Set ``BLUEFOG_TIMELINE_NATIVE=0`` to force the Python backend.
"""

from __future__ import annotations

import atexit
import json
import queue
import threading
import time
from typing import Optional

from bluefog_tpu_torch import config as bfconfig
from bluefog_tpu_torch.observe import registry as _obs_registry
from bluefog_tpu_torch.observe import tracer as _obs_tracer

__all__ = ["Timeline", "get_timeline", "start_timeline", "stop_timeline"]


class _PyWriter:
    """The Python writer: bounded queue.Queue + daemon thread (a full
    queue drops the event and counts it, the native ring's contract; the
    bound defaults to ``BLUEFOG_TIMELINE_QUEUE_CAPACITY``).

    ``on_drop_flush(count)`` is called from the WRITER thread every
    ``BLUEFOG_TIMELINE_FLUSH_EVERY`` drained events — and on any drain
    to empty with new drops — so a saturated queue surfaces on the
    metrics side while the run is still going."""

    def __init__(self, path: str, rank: int, capacity: Optional[int] = None,
                 on_drop_flush=None):
        self.rank = rank
        self._t0 = time.perf_counter()
        if capacity is None:
            capacity = bfconfig.timeline_queue_capacity()
        self._queue: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._dropped = 0
        self._on_drop_flush = on_drop_flush
        # defensive parse (malformed env falls back, never crashes
        # timeline creation)
        self._flush_every = bfconfig.timeline_flush_every()
        self._drained = 0
        self._last_flushed = 0
        self._file = open(path, "w")
        self._file.write("[\n")
        self._first = True
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _maybe_flush_drops(self):
        if self._on_drop_flush is None:
            return
        dropped = self._dropped
        if dropped != self._last_flushed:
            self._last_flushed = dropped
            try:
                self._on_drop_flush(dropped)
            except Exception:  # the metrics side must never kill the
                pass           # writer thread

    def _writer(self):
        while not self._stop.is_set() or not self._queue.empty():
            try:
                event = self._queue.get(timeout=0.1)
            except queue.Empty:
                # idle: disclose any drops accumulated since the last
                # flush (a burst followed by silence must not hide)
                self._maybe_flush_drops()
                continue
            if not self._first:
                self._file.write(",\n")
            self._first = False
            self._file.write(json.dumps(event))
            self._file.flush()
            self._drained += 1
            if self._drained % self._flush_every == 0:
                self._maybe_flush_drops()

    def _put(self, event: dict) -> None:
        try:
            self._queue.put_nowait(event)
        except queue.Full:
            self._dropped += 1

    def record(self, name: str, tid: str, phase: str):
        ts = self._now_us()
        if phase == "B":
            self._put({"name": name, "cat": tid, "ph": "B", "ts": ts,
                       "pid": self.rank, "tid": tid})
        elif phase == "E":
            self._put({"ph": "E", "ts": ts, "pid": self.rank,
                       "tid": tid})
        else:
            self._put({"name": name, "ph": "i", "ts": ts,
                       "pid": self.rank, "s": "p"})

    def dropped(self) -> int:
        return self._dropped

    def close(self):
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=2.0)
        try:
            self._file.write("\n]\n")
            self._file.close()
        except ValueError:
            pass


def _make_writer(path: str, rank: int, use_native: Optional[bool],
                 on_drop_flush=None):
    """(writer, "native" | "python").  ``use_native=None`` reads
    ``BLUEFOG_TIMELINE_NATIVE`` and falls back to the Python writer when
    the native library does not build; ``True`` raises instead."""
    explicit = use_native is True
    if use_native is None:
        use_native = bfconfig.timeline_native()
    if use_native:
        from bluefog_tpu_torch import native

        try:
            return native.NativeTimelineWriter(path, rank), "native"
        except (OSError, RuntimeError) as exc:
            if explicit:
                raise
            from bluefog_tpu_torch.logging_util import get_logger

            get_logger().warning(
                "native timeline writer unavailable (%s); using the Python "
                "backend", exc)
    return _PyWriter(path, rank, on_drop_flush=on_drop_flush), "python"


class Timeline:
    """A Chrome-trace file fed by a :class:`Tracer`.

    With ``tracer=None`` the timeline owns a private tracer (standalone
    use, e.g. tests); ``start_timeline`` passes the process-global
    tracer instead, making the file a live export of everything the
    framework publishes.  ``start_activity``/``end_activity``/``instant``
    are the eager op layer's span calls (``api.timeline_*``)."""

    def __init__(self, path: str, rank: int = 0,
                 use_native: Optional[bool] = None, tracer=None):
        self.path = f"{path}{rank}.json"
        self.rank = rank
        self._writer, self.backend = _make_writer(
            self.path, rank, use_native,
            on_drop_flush=self._flush_dropped_gauge)
        self.tracer = tracer if tracer is not None else _obs_tracer.Tracer(
            pid=rank)
        self.tracer.add_sink(self._writer)
        self._closed = False
        atexit.register(self.close)

    def start_activity(self, tensor_name: str, activity: str):
        self.tracer.begin(tensor_name, activity)

    def end_activity(self, tensor_name: str):
        self.tracer.end(tensor_name)

    def instant(self, name: str):
        self.tracer.instant(name)

    def dropped_events(self) -> int:
        return self._writer.dropped()

    def _flush_dropped_gauge(self, dropped: int) -> None:
        """Land the drop count in the registry gauge — called
        periodically from the Python writer thread (every
        ``BLUEFOG_TIMELINE_FLUSH_EVERY`` drains) and once at close."""
        if _obs_registry.enabled():
            _obs_registry.get_registry().gauge(
                "bf_timeline_dropped_events",
                "events the timeline writer dropped (saturated queue/ring)",
                rank=self.rank).set(dropped)

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.tracer.remove_sink(self._writer)
        dropped = self._writer.dropped()
        self._writer.close()
        # flush the FINAL drop count where a dashboard can see it —
        # mid-run flushes only fire every BLUEFOG_TIMELINE_FLUSH_EVERY
        # drains, and the native ring only reports here
        self._flush_dropped_gauge(dropped)


_timeline: Optional[Timeline] = None


def get_timeline() -> Optional[Timeline]:
    return _timeline


def start_timeline(path: str, rank: int = 0) -> Timeline:
    """Open the Chrome-trace file and attach it to the process-global
    tracer: from here on, every published span/instant streams to
    ``<path><rank>.json`` until :func:`stop_timeline`.

    Under ``BLUEFOG_OBSERVE=0`` (checked at start time) the timeline
    binds a PRIVATE tracer instead — span producers fall back to it
    (``observe.tracer.effective_tracer``), so the timeline still
    records the file while the observe layer's global buffers stay
    empty, honoring the opt-out."""
    global _timeline
    if _timeline is not None:
        _timeline.close()
    tracer = _obs_tracer.get_tracer() if _obs_registry.enabled() else None
    _timeline = Timeline(path, rank, tracer=tracer)
    return _timeline


def stop_timeline():
    global _timeline
    if _timeline is not None:
        _timeline.close()
        _timeline = None

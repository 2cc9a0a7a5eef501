"""Span tracer: nested spans, instant events, per-thread tracks.

Port of ``bluefog_tpu/observe/tracer.py`` (the whole module), copied
because importing anything under ``bluefog_tpu`` loads jax; only the
import of the registry changed.

Generalizes ``timeline.py``'s span machinery (itself the port of the
reference C++ ``Timeline``, bluefog/common/timeline.{h,cc}) into a
subsystem-neutral tracer.  Every producer — the serving engine's
request lifecycle (admission → prefill → decode → retire), the
resilience runner's skip/detect/heal/rollback events, the eager op
API's enqueue/compute spans, and ``build_train_step`` callers — reports
into ONE :class:`Tracer`; consumers attach as **sinks**:

* the Chrome-trace file writer (``timeline.py`` is now a thin exporter:
  its native/Python writers implement the sink protocol directly);
* the in-memory ring buffer every tracer carries (bounded — a tracer
  left running forever costs a fixed amount of memory), which feeds the
  JSONL and chrome-trace exporters in :mod:`bluefog_tpu_torch.observe.export`.

The sink protocol is the timeline writers' existing surface::

    sink.record(name: str, tid: str, phase: str)   # "B" | "E" | "i"

Spans nest per **track** (the Chrome-trace ``tid``): ``begin`` pushes,
``end`` pops, and the balanced B/E stream is what chrome://tracing
renders as stacked bars.  ``span()`` is the context-manager form; with
no explicit track it uses the calling thread's name, so concurrent
producers get separate rows for free.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from bluefog_tpu_torch.observe.registry import enabled, get_registry

__all__ = ["Tracer", "get_tracer", "publish_tracer", "effective_tracer"]

#: consecutive ``record()`` failures after which a sink is detached —
#: a persistently broken sink (full disk, closed pipe) must not keep
#: throwing inside every producer's span emission
SINK_ERROR_LIMIT = 3


class Tracer:
    """Span/event recorder with pluggable sinks and a bounded buffer.

    Args:
      clock: monotonic-seconds source (injectable for deterministic
        tests; default ``time.perf_counter``).  Timestamps are recorded
        as microseconds since the tracer's construction, matching the
        Chrome-trace ``ts`` convention.
      max_events: ring-buffer bound; the oldest events fall off first
        and :attr:`dropped_events` counts them (sinks see every event
        regardless — the bound protects memory, not the file).
      pid: the Chrome-trace ``pid`` field (the process/rank identity).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 max_events: int = 65536, pid: int = 0):
        self._clock = clock
        self._t0 = clock()
        self.pid = pid
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        self._n_emitted = 0
        self._sinks: List[object] = []
        # id(sink) -> consecutive record() failures; any success resets
        self._sink_errors: Dict[int, int] = {}
        self._open_spans: Dict[str, List[str]] = {}
        # per-thread (track, name) stack: which span THIS thread is
        # inside right now — the correlation source structured logs
        # join the trace on (active_span)
        self._tls = threading.local()

    # -- sinks --------------------------------------------------------- #
    def add_sink(self, sink) -> None:
        """Attach a ``record(name, tid, phase)`` consumer (e.g. a
        timeline file writer).  Idempotent."""
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)
            self._sink_errors.pop(id(sink), None)

    def remove_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)
            self._sink_errors.pop(id(sink), None)

    # -- core emit ----------------------------------------------------- #
    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _emit_locked(self, phase: str, name: str, track: str) -> None:
        """Append + fan out; the CALLER holds ``self._lock`` — span
        bookkeeping and event emission must be one atomic step (two
        lock acquisitions would let a concurrent producer interleave an
        E between a track's bookkeeping and its B record), and the
        native timeline writer is a single-producer ring, so sink
        fan-out must stay serialized too (the pre-tracer Timeline held
        the same lock around its writer)."""
        self._events.append((phase, name, track, self._now_us()))
        self._n_emitted += 1
        # sink fan-out is fault-isolated: one raising sink must not
        # break span emission for the producers (or starve the other
        # sinks), and the per-thread span stack stays consistent
        # because the event was already buffered above.  A sink that
        # fails SINK_ERROR_LIMIT times in a row is detached.
        for sink in list(self._sinks):
            try:
                sink.record(name, track, phase)
            except Exception:
                errs = self._sink_errors.get(id(sink), 0) + 1
                self._sink_errors[id(sink)] = errs
                if enabled():
                    get_registry().counter(
                        "bf_tracer_sink_errors_total",
                        "tracer sink record() failures",
                        sink=type(sink).__name__).inc()
                if errs >= SINK_ERROR_LIMIT:
                    if sink in self._sinks:
                        self._sinks.remove(sink)
                    self._sink_errors.pop(id(sink), None)
            else:
                self._sink_errors.pop(id(sink), None)

    # -- spans --------------------------------------------------------- #
    def begin(self, track: str, name: str) -> None:
        """Open a span named ``name`` on ``track`` (nested within the
        track's currently-open span, if any)."""
        with self._lock:
            self._open_spans.setdefault(track, []).append(name)
            self._emit_locked("B", name, track)
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append((track, name))

    def end(self, track: str) -> None:
        """Close the innermost open span on ``track`` (a no-op end on a
        track with no open span still records the E event so a foreign
        B/E producer — the flat timeline API — stays balanced)."""
        with self._lock:
            spans = self._open_spans.get(track)
            if spans:
                spans.pop()
            if not spans:
                # drop the empty per-track entry: tracks are often
                # unique (request.<rid>, <op>.noname.<handle>), so
                # keeping them would leak one dict entry per request
                # for the life of the default-on global tracer
                self._open_spans.pop(track, None)
            self._emit_locked("E", "", track)
        stack = getattr(self._tls, "stack", None)
        if stack:
            # remove the INNERMOST entry for that track — producers
            # like the eager op API end spans non-LIFO (begin A,
            # begin B, end A, end B: concurrent in-flight handles), and
            # a top-only pop would leak A's entry in the thread-local
            # stack forever.  A track this thread never began (foreign
            # B/E through the flat timeline API) removes nothing.
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == track:
                    del stack[i]
                    break

    def _prune_stale_locked(self, stack) -> None:
        """Drop trailing thread-local entries whose track has NO open
        span globally: a span begun on this thread may be ENDED by
        another (the nonblocking handle API dispatches on one thread
        and synchronizes on another), which closes ``_open_spans`` but
        cannot touch the beginner's TLS stack.  Pruned lazily here so
        the stack neither grows unboundedly nor mis-stamps log lines
        with long-closed spans.  Caller holds ``self._lock``."""
        while stack and stack[-1][0] not in self._open_spans:
            stack.pop()

    def active_span(self) -> Optional[tuple]:
        """The ``(track, name)`` of the innermost span the CALLING
        thread is inside, or ``None`` — what ``BLUEFOG_LOG_FORMAT=json``
        stamps on log lines so structured logs join the Chrome trace."""
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return None
        with self._lock:
            self._prune_stale_locked(stack)
        return stack[-1] if stack else None

    def instant(self, name: str, track: str = "") -> None:
        """A zero-duration marker event."""
        with self._lock:
            self._emit_locked("i", name, track)

    @contextmanager
    def span(self, track: Optional[str], name: str):
        """``with tracer.span("serving", "decode"): ...`` — the span
        covers the block; ``track=None`` uses the calling thread's name
        (per-thread tracks)."""
        if track is None:
            track = threading.current_thread().name
        self.begin(track, name)
        try:
            yield
        finally:
            self.end(track)

    def open_depth(self, track: str) -> int:
        """Current span-nesting depth on ``track`` (tests; a balanced
        producer returns to 0)."""
        with self._lock:
            return len(self._open_spans.get(track, ()))

    # -- buffer views -------------------------------------------------- #
    @property
    def dropped_events(self) -> int:
        """Events that fell off the ring buffer (sinks saw them; the
        in-memory view did not)."""
        with self._lock:
            return self._n_emitted - len(self._events)

    def events(self) -> List[tuple]:
        """The buffered ``(phase, name, track, ts_us)`` tuples, oldest
        first."""
        with self._lock:
            return list(self._events)

    @staticmethod
    def chrome_events(events: List[tuple], pid: int = 0) -> List[dict]:
        """Format ``(phase, name, track, ts_us)`` tuples as Chrome-trace
        JSON records — the same shape the timeline file writers stream
        (``ph``/``ts``/``pid``/``tid``; instants carry ``s: "p"``)."""
        out = []
        for phase, name, track, ts in events:
            if phase == "B":
                out.append({"name": name, "cat": track, "ph": "B",
                            "ts": ts, "pid": pid, "tid": track})
            elif phase == "E":
                out.append({"ph": "E", "ts": ts, "pid": pid,
                            "tid": track})
            else:
                out.append({"name": name, "ph": "i", "ts": ts,
                            "pid": pid, "s": "p"})
        return out

    def to_chrome_trace(self) -> List[dict]:
        """The buffered events in Chrome-trace JSON form."""
        return self.chrome_events(self.events(), self.pid)

    def clear(self) -> None:
        """Drop the buffered events (sinks and open-span bookkeeping
        are untouched)."""
        with self._lock:
            self._events.clear()
            self._n_emitted = 0


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer: what the built-in producers publish
    into and what ``start_timeline`` attaches the Chrome-trace file
    writer to."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def publish_tracer() -> Optional[Tracer]:
    """The tracer built-in producers should publish into, or ``None``
    when ``BLUEFOG_OBSERVE=0`` — callers guard with
    ``tr = publish_tracer();  if tr is not None: tr.instant(...)``."""
    if not enabled():
        return None
    return get_tracer()


def effective_tracer(timeline) -> Optional[Tracer]:
    """The ONE fallback policy for span producers that predate the
    tracer (eager ops, serving metrics): the global tracer when observe
    is enabled (a started timeline rides it as a file sink), else the
    caller's started ``timeline``'s PRIVATE tracer — so
    ``BLUEFOG_TIMELINE`` alone keeps recording spans under
    ``BLUEFOG_OBSERVE=0`` — else ``None``.  A timeline that was started
    while observe was ENABLED is bound to the global tracer; falling
    back to it would keep filling the observe buffers despite the
    opt-out, so that case yields ``None`` (flip ``BLUEFOG_OBSERVE``
    before ``start_timeline`` for the private-file mode)."""
    tr = publish_tracer()
    if tr is not None:
        return tr
    if timeline is not None and timeline.tracer is not _tracer:
        return timeline.tracer
    return None

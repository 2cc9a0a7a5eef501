"""Seeded discrete-event core: event heap, virtual clock, byte-stable log.

Port of ``bluefog_tpu/sim/engine.py``, copied unchanged (host
bookkeeping; importing it from the JAX package would load jax), so the
port's event lines and digests are byte-equal to the JAX package's.

The engine is the small deterministic kernel under every fleet-scale
simulation in this repo: a priority queue of ``(time, seq)``-ordered
events, a :class:`~bluefog_tpu_torch.sim.clock.VirtualClock` that only moves
when an event (or a lockstep driver) moves it, and an :class:`EventLog`
whose lines are formatted byte-stably and folded into a running SHA-256
— the "same seed ⇒ byte-equal event log" acceptance check costs O(1)
memory even across a million-request trace.

Two usage shapes coexist:

* **Heap-driven**: schedule callbacks with :meth:`Simulation.at` /
  :meth:`Simulation.after` and :meth:`Simulation.run` them in time
  order — churn, congestion windows, and flash crowds are this shape.
* **Lockstep**: a fleet driver advances the shared clock itself (every
  busy replica steps per tick, exactly like the real lockstep benches)
  and calls :meth:`Simulation.run` with ``until=clock.t`` between ticks
  to deliver any control events that came due.

Both log through the same :class:`EventLog`, so a mixed run still has
one totally ordered record.  No wall-clock reads, no unseeded
randomness: ``Simulation.rng`` is the only entropy source, and ties are
broken by insertion sequence — a heap pop order that is a pure function
of the schedule calls.
"""

from __future__ import annotations

import hashlib
import heapq
from typing import Callable, List, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.sim.clock import VirtualClock

__all__ = ["EventLog", "Simulation", "canonical_detail", "format_event"]


def _fmt_value(v) -> str:
    """One deterministic rendering per value type.  Floats go through
    ``%.9g`` (enough digits to distinguish any two virtual times the
    sim produces, few enough that the text is platform-stable); bools
    before ints because ``bool`` is an ``int`` subclass."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return format(float(v), ".9g")
    return str(v)


def canonical_detail(**detail) -> str:
    """The sorted-key ``k=v`` tail of the canonical event rendering,
    with every value through :func:`_fmt_value` (``%.9g`` floats).
    Nested dicts canonicalize recursively as ``{k=v ...}`` and
    lists/tuples as ``[v ...]``, so a telemetry snapshot digests
    byte-stably too.  Shared by :func:`format_event` and the decision
    flight recorder (:mod:`bluefog_tpu_torch.observe.blackbox`), which must
    agree on what "byte-stable" means."""

    def render(v) -> str:
        if isinstance(v, dict):
            inner = " ".join(
                f"{k}={render(v[k])}" for k in sorted(v, key=str))
            return "{" + inner + "}"
        if isinstance(v, (list, tuple)):
            return "[" + " ".join(render(x) for x in v) + "]"
        return _fmt_value(v)

    return " ".join(f"{k}={render(detail[k])}" for k in sorted(detail))


def format_event(t: float, kind: str, actor: str = "", **detail) -> str:
    """The canonical one-line event rendering:
    ``<t sec> <kind> <actor> k=v ...`` with detail keys sorted — the
    byte-stable unit the log digest folds."""
    parts = [format(float(t), ".9f"), str(kind)]
    if actor:
        parts.append(str(actor))
    if detail:
        parts.append(canonical_detail(**detail))
    return " ".join(parts)


class EventLog:
    """Append-only event record with a streaming SHA-256 digest.

    ``keep_lines=True`` (the default) retains the formatted lines for
    inspection/assertions; the million-request bench passes ``False``
    and relies on the digest alone — the memory cost of the log is then
    one hash state regardless of trace length."""

    def __init__(self, keep_lines: bool = True):
        self._sha = hashlib.sha256()
        self.lines: Optional[List[str]] = [] if keep_lines else None
        self.n = 0

    def record(self, t: float, kind: str, actor: str = "",
               **detail) -> str:
        line = format_event(t, kind, actor, **detail)
        self._sha.update(line.encode("utf-8"))
        self._sha.update(b"\n")
        if self.lines is not None:
            self.lines.append(line)
        self.n += 1
        return line

    def digest(self) -> str:
        """Hex SHA-256 over every line recorded so far — the
        machine-checked determinism claim: two runs with the same seed
        must produce the same digest, byte for byte."""
        return self._sha.hexdigest()


class Simulation:
    """Seeded event heap over a shared :class:`VirtualClock`.

    Events are ``(t, seq, kind, actor, fn, detail)``; ``seq`` is the
    insertion counter, so simultaneous events fire in schedule order —
    no hash/dict iteration order anywhere near the pop sequence.  Every
    pop jumps the clock to the event time, records the event, then runs
    ``fn(sim, t)`` (which may schedule more).  ``rng`` is the one
    entropy source actors may draw from."""

    def __init__(self, *, seed: int = 0,
                 clock: Optional[VirtualClock] = None,
                 log: Optional[EventLog] = None):
        self.clock = clock if clock is not None else VirtualClock()
        self.log = log if log is not None else EventLog()
        self.rng = np.random.RandomState(seed)
        self._heap: List[Tuple] = []
        self._seq = 0

    @property
    def pending(self) -> int:
        return len(self._heap)

    def at(self, t: float, kind: str,
           fn: Optional[Callable] = None,
           actor: str = "", **detail) -> None:
        """Schedule ``kind`` (and optional callback ``fn(sim, t)``) at
        absolute virtual time ``t`` — which must not be in the past:
        the log is append-only in time."""
        t = float(t)
        if t < self.clock.t:
            raise ValueError(
                f"cannot schedule at t={t} behind the clock "
                f"(now={self.clock.t})")
        heapq.heappush(self._heap,
                       (t, self._seq, str(kind), str(actor), fn, detail))
        self._seq += 1

    def after(self, dt: float, kind: str,
              fn: Optional[Callable] = None,
              actor: str = "", **detail) -> None:
        """Schedule ``dt`` virtual seconds from now."""
        self.at(self.clock.t + float(dt), kind, fn, actor=actor,
                **detail)

    def run(self, until: Optional[float] = None,
            max_events: Optional[int] = None) -> int:
        """Pop and deliver events in time order.  ``until`` bounds the
        delivered window INCLUSIVELY (events at exactly ``until`` fire)
        and the clock lands on ``until`` even if the heap ran dry
        first; without it the heap drains completely.  Returns the
        number of events delivered."""
        delivered = 0
        while self._heap:
            if max_events is not None and delivered >= max_events:
                break
            t = self._heap[0][0]
            if until is not None and t > until:
                break
            t, _, kind, actor, fn, detail = heapq.heappop(self._heap)
            self.clock.jump_to(t)
            self.log.record(t, kind, actor, **detail)
            if fn is not None:
                fn(self, t)
            delivered += 1
        if until is not None:
            self.clock.jump_to(until)
        return delivered

"""Request admission for the serving engine: FIFO + backpressure +
deadlines.

Port of ``bluefog_tpu/serving/scheduler.py`` (the whole module, copied
unchanged: it is host bookkeeping, but importing it from the JAX
package would load jax).

Policy (deliberately boring — the measurable wins live in the engine's
batching, not in clever queueing):

* **FIFO admission.**  Requests are admitted to K/V slots in arrival
  order; nothing overtakes (so TTFT percentiles reflect load, not luck).
* **Backpressure, not stalls.**  A full slot pool queues the request; a
  full queue REJECTS the submit immediately with the current queue depth
  attached (:class:`RequestRejected`) — the graceful-degradation policy:
  a loaded server tells callers to back off rather than accumulating
  unbounded latency.
* **Deadlines.**  A request may carry an absolute deadline (engine-clock
  seconds).  Expired queued requests are dropped at admission time;
  expired RUNNING requests are cancelled by the engine between decode
  steps.  Explicit :meth:`cancel` works on both.

The scheduler owns no device state and never touches the device — it is
plain host bookkeeping the engine consults once per step.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional

__all__ = ["FifoScheduler", "RequestRejected"]


class RequestRejected(RuntimeError):
    """Submit refused under overload.  Carries the backpressure signal a
    client needs to back off intelligently."""

    def __init__(self, msg: str, queue_depth: int, max_queue: int):
        super().__init__(f"{msg} (queue depth {queue_depth}/{max_queue})")
        self.queue_depth = queue_depth
        self.max_queue = max_queue


class FifoScheduler:
    def __init__(self, max_queue: int = 64):
        if max_queue < 0:
            raise ValueError(f"max_queue ({max_queue}) must be >= 0")
        self.max_queue = max_queue
        self._queue: Deque = deque()

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def submit(self, request) -> None:
        """Enqueue, or raise :class:`RequestRejected` when the queue is
        at capacity (never blocks, never silently drops)."""
        if len(self._queue) >= self.max_queue:
            raise RequestRejected("serving queue full",
                                  queue_depth=len(self._queue),
                                  max_queue=self.max_queue)
        self._queue.append(request)

    def cancel(self, request) -> bool:
        """Remove a queued request; returns False if it is not queued
        (already admitted — the engine handles running cancellations)."""
        try:
            self._queue.remove(request)
            return True
        except ValueError:
            return False

    def expire(self, now: float) -> List:
        """Drop and return every queued request whose deadline has
        passed — a request that cannot start before its deadline is dead
        weight; shedding it in the queue costs zero device time."""
        expired = [r for r in self._queue
                   if r.deadline is not None and now >= r.deadline]
        for r in expired:
            self._queue.remove(r)
        return expired

    def drain(self) -> List:
        """Remove and return EVERY queued request, deadline-expired ones
        included — unlike :meth:`admit`, which silently sheds expired
        entries, drain/failover must see them all so each gets a
        terminal outcome (handed off, rejected, or expired)."""
        out = list(self._queue)
        self._queue.clear()
        return out

    def admit(self, now: float) -> Optional[object]:
        """Pop the next admissible request (FIFO after shedding expired
        ones), or ``None`` when the queue is empty.  The caller admits
        only while it has a free slot."""
        self.expire(now)
        if not self._queue:
            return None
        return self._queue.popleft()

"""Serving-side fault tolerance: chaos injection, token-exact failover,
and the seeded backoff the router retries with.

Port of ``bluefog_tpu/serving/resilience.py``, copied but for the package
name (host-side control flow around the engine).  The port has no
compiled programs, so the JAX package's zero-recompile contract has
nothing to hold here; on the card a resumed request's re-prefill can
flip a greedy argmax at a near-tie (see the engine's deviations).

The training stack proved the methodology (``resilience/faults.py``:
deterministic fault plans, shape-stable injection, machine-checked
chaos benches); this module is the serving twin.  Three pieces:

* :class:`FaultyReplica` — wraps one ``ServingEngine`` and injects a
  :class:`~bluefog_tpu_torch.resilience.faults.ServingFaultPlan` AROUND its
  ``step``/``submit``: a dead replica stops stepping (its heartbeat
  gauge goes stale, the router's staleness guard excises it), a stalled
  one sleeps host time before stepping, a rejecting one raises
  :class:`RequestRejected` before the scheduler sees the submit.
  Everything is host-side control flow around the unmodified engine.

* :func:`failover_stranded` — moves a dead replica's in-flight
  requests to survivors, token-exactly: each stranded request retires
  with outcome ``failover``, resets to QUEUED **keeping its emitted
  tokens**, and is resubmitted; the target replica re-prefills
  ``prompt ‖ tokens`` (chain-hash-matched chunks restore from the
  shared prefix cache, the novel tail computes cold) and its decode
  continues the per-request rng fold chain at ``len(tokens)`` — the
  resumed stream is bit-equal to a run that never faulted.  A request
  whose deadline passed while its replica was dead retires as
  ``expired`` instead (a terminal record, not a silent strand).

* :func:`seeded_backoff` / :func:`backoff_sleep` — the deterministic
  exponential-backoff-with-jitter every retry loop in this package must
  use: delays derive from (seed, salt, attempt), so chaos runs replay
  bit-identically.

The router's knobs (``BLUEFOG_REPLICA_STALE_S``,
``BLUEFOG_ROUTER_RETRIES``, ...) are read by
:class:`~bluefog_tpu_torch.serving.FleetRouter`.  Guide: docs/serving.md
(failure model).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.resilience.faults import ServingFaultPlan
from bluefog_tpu_torch.serving.engine import (EXPIRED, FAILOVER, Request,
                                        ServingEngine)
from bluefog_tpu_torch.serving.scheduler import RequestRejected

__all__ = ["FaultyReplica", "failover_stranded", "seeded_backoff",
           "backoff_sleep"]


def seeded_backoff(attempt: int, *, base: float = 0.05, cap: float = 2.0,
                   seed: int = 0, salt: int = 0) -> float:
    """Deterministic exponential backoff with jitter: attempt ``k``
    yields ``min(cap, base * 2**k * jitter)`` with ``jitter`` drawn
    uniformly from [0.5, 1.5) by a RandomState keyed on (seed, salt,
    attempt) — two routers with the same seed retrying the same request
    sleep the same schedule, so chaos runs replay exactly."""
    if attempt < 0:
        raise ValueError(f"attempt must be >= 0, got {attempt}")
    rs = np.random.RandomState(
        (seed * 1_000_003 + salt * 9_176 + attempt * 31) % (2 ** 32))
    jitter = 0.5 + rs.random_sample()
    return float(min(cap, base * (2.0 ** attempt) * jitter))


def backoff_sleep(attempt: int, *, base: float = 0.05, cap: float = 2.0,
                  seed: int = 0, salt: int = 0,
                  sleep: Optional[Callable[[float], None]] = None
                  ) -> float:
    """Sleep one :func:`seeded_backoff` delay (injectable ``sleep`` —
    the virtual-time bench passes its clock's advance) and return it."""
    delay = seeded_backoff(attempt, base=base, cap=cap, seed=seed,
                           salt=salt)
    (sleep if sleep is not None else time.sleep)(delay)
    return delay


class FaultyReplica:
    """One serving replica under a deterministic fault plan.

    Wraps a :class:`ServingEngine` (attribute access passes through, so
    the router and the fleet harness treat it as the engine) and applies
    ``plan``'s faults for ``replica`` keyed on the replica's OWN step
    counter:

    * ``replica_death`` at step s: from the s-th :meth:`step` call on,
      the replica never steps again (``step`` returns False without
      touching the engine) and refuses submits — the process is gone;
      its last-step heartbeat freezes and the router's staleness guard
      marks it suspect.  ``dead`` latches True so the harness can see
      the transition and trigger :func:`failover_stranded`.
    * ``replica_stall``: sleeps ``stall_seconds`` of host time before
      each active step (the replica is slow, not gone).
    * ``submit_reject``: every submit landing during the fault window
      raises :class:`RequestRejected` before the engine sees it — the
      transient-overload input the router's retry/backoff absorbs.
    """

    def __init__(self, engine: ServingEngine, plan: ServingFaultPlan,
                 replica: int, *,
                 sleep: Optional[Callable[[float], None]] = None):
        if not 0 <= replica < plan.size:
            raise ValueError(f"replica {replica} outside plan of size "
                             f"{plan.size}")
        self.engine = engine
        self.plan = plan
        self.replica = replica
        self.steps = 0
        self.dead = False
        self._sleep = sleep if sleep is not None else time.sleep

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def submit(self, request: Request) -> Request:
        sched = self.engine.scheduler
        if self.dead or self.plan.is_dead(self.replica, self.steps):
            self.dead = True
            raise RequestRejected(f"replica {self.replica} dead",
                                  queue_depth=sched.queue_depth,
                                  max_queue=sched.max_queue)
        if self.plan.rejects_submit(self.replica, self.steps):
            raise RequestRejected(
                f"replica {self.replica} injected submit rejection",
                queue_depth=sched.queue_depth,
                max_queue=sched.max_queue)
        return self.engine.submit(request)

    def step(self) -> bool:
        if self.dead or self.plan.is_dead(self.replica, self.steps):
            self.dead = True
            return False
        stall = self.plan.stall_seconds(self.replica, self.steps)
        if stall > 0:
            self._sleep(stall)
        out = self.engine.step()
        self.steps += 1
        return out


def failover_stranded(engine, resubmit: Callable[[Request], object], *,
                      now: Optional[float] = None
                      ) -> Tuple[List[Request], List[Request]]:
    """Move a dead replica's stranded requests to survivors.

    ``engine`` may be the :class:`ServingEngine` or its
    :class:`FaultyReplica` wrapper.  Every resident (mid-prefill or
    decoding, in slot order) and every queued request is given a
    terminal outcome on the dead replica:

    * deadline already passed -> retired with outcome ``expired`` (the
      satellite guarantee: a request that died WITH its replica still
      emits a terminal timeline span and a retired counter);
    * otherwise -> retired with outcome ``failover``, reset to QUEUED
      with its emitted tokens kept, and handed to ``resubmit`` (usually
      ``FleetRouter.submit``) — replay via the
      prefix-cache chain-hash path makes the resumed output bit-equal to
      an unfaulted run.

    Unlike :meth:`ServingEngine.drain`, nothing is flushed to the
    prefix cache here: the dead replica's device K/V is gone by
    definition — replay relies on the chunks the ORIGINAL prefill
    stashed into the shared cache, plus cold compute for the tail.

    Returns ``(moved, expired)`` request lists.
    """
    eng = getattr(engine, "engine", engine)
    if now is None:
        now = eng.clock()
    stranded = sorted(eng._running.values(), key=lambda r: r.slot)
    if eng._admitting is not None:
        stranded = sorted(stranded + [eng._admitting],
                          key=lambda r: r.slot)
    stranded += eng.scheduler.drain()
    moved: List[Request] = []
    expired: List[Request] = []
    for req in stranded:
        if req.deadline is not None and now >= req.deadline:
            eng._retire(req, EXPIRED, now)
            expired.append(req)
            continue
        eng._retire(req, FAILOVER, now)
        eng.metrics.on_failover(req.rid, now)
        req.reset_for_resume()
        resubmit(req)
        moved.append(req)
    if stranded:
        from bluefog_tpu_torch.observe.blackbox import record_decision

        record_decision(
            "serving", "failover", step=-1,
            telemetry={"moved": len(moved), "expired": len(expired)})
    return moved, expired

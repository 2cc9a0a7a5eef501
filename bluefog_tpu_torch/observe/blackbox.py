"""Decision flight recorder: a causal audit trail for every control plane.

Port of ``bluefog_tpu/observe/blackbox.py``, copied unchanged but for
the package name (host bookkeeping; importing it from the JAX package
would load jax).

The stack self-heals at every layer — topology hot-swaps, mix-ratio
ladder steps, dead-rank healing and elastic promotion, serving
failover/cooldown/excision, lazy a2a re-plans — and every one of those
autonomous transitions should be answerable to "why did it do that?".
This module is the answer: a process-local, bounded-ring **black box**
of :class:`DecisionEvent` records, each carrying the plane, the trigger
kind, a canonical digest of the telemetry inputs that drove it, the
candidates scored with their costs, the winner and margin, and the
eventual outcome — all causally chained by ``(parent_event_id, step)``
so :func:`explain` renders the full trigger→synthesize→swap→probation→
outcome story for any decision.

Design contracts:

* **Bounded**: the ring holds at most ``capacity`` events (default
  ``BLUEFOG_BLACKBOX_CAPACITY``); at capacity the oldest is evicted and
  counted (``bf_blackbox_dropped_events``).  O(1) memory however long
  the run.
* **Byte-stable**: every event folds one canonical line into a
  streaming SHA-256 (:meth:`BlackBox.chain_digest`) using
  :func:`bluefog_tpu_torch.sim.engine.canonical_detail` — the same sorted-key
  ``%.9g`` formatting the JAX package's sim event log uses, so "two
  same-seed runs produce byte-identical decision chains" is a
  machine-checkable claim (gated in ``benchmarks/fleet_sim.py``).
  Wall-clock timestamps and the free-form ``detail`` dict are carried
  on the event but **excluded** from the digested line: measured floats
  (probation health, wall time) may differ between a real run and its
  simulated twin without breaking chain equality.
* **Replayable**: a ``synthesize`` event records the full telemetry
  snapshot (edge-seconds deltas, z-scores, dead set, calibrated
  traffic) next to the scored candidates, so
  :meth:`TopologyControlPlane.replay_decision` can re-derive the same
  winner/cost/margin from the audit log alone.
* **Host-side only**: recording never touches a compiled program — jit
  cache sizes and step outputs are bit-identical with the recorder on
  vs off (tested with the PR-4 ``BLUEFOG_OBSERVE`` methodology).
  ``BLUEFOG_BLACKBOX=0`` disables the process-global recorder.
* **Anomaly dump**: recording an anomaly kind (``rollback``,
  ``rank_join_failed``, ``lost``, ``saturated``,
  ``bench_gate_failure``) emits a Chrome-trace instant
  (``blackbox.dump.<kind>``) and — when ``BLUEFOG_BLACKBOX_DUMP``
  names a directory — dumps the whole ring to
  ``<dir>/blackbox_<kind>.jsonl`` (first occurrence per kind, so a
  million lost requests cost one file write).

CLI::

    python -m bluefog_tpu_torch.observe.blackbox dump.jsonl            # all chains
    python -m bluefog_tpu_torch.observe.blackbox dump.jsonl --explain 7

See docs/observability.md "Decision audit".
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from bluefog_tpu_torch import config
from bluefog_tpu_torch.sim.engine import canonical_detail

__all__ = [
    "ANOMALY_KINDS",
    "BlackBox",
    "DecisionEvent",
    "explain",
    "get_blackbox",
    "record_decision",
]

# Terminal kinds resolve the outcome of their whole causal chain: a
# probation commit retroactively marks the trigger/synthesize/swap
# ancestors "committed" (rendering only — the digest is append-only).
_TERMINAL_OUTCOMES = {
    "commit": "committed",
    "rollback": "rolled_back",
    "kick": "kicked",
    "reject": "rejected",
    "lost": "lost",
    "expired": "expired",
}

#: Kinds whose recording dumps the ring (the "something went wrong,
#: preserve the evidence" set).
ANOMALY_KINDS = frozenset({
    "rollback", "rank_join_failed", "lost", "saturated",
    "bench_gate_failure",
})


@dataclass
class DecisionEvent:
    """One recorded control-plane transition.

    ``detail`` and ``t`` are carried for rendering but excluded from
    :meth:`canonical_line` — only the structural decision record
    (ids, step, plane, kind, telemetry digest, candidates, winner,
    cost, margin) is digested."""

    event_id: int
    parent_id: Optional[int]
    step: int
    plane: str
    kind: str
    telemetry: dict = field(default_factory=dict)
    telemetry_digest: str = ""
    candidates: Optional[Dict[str, float]] = None
    winner: Optional[str] = None
    winner_cost: Optional[float] = None
    margin: Optional[float] = None
    outcome: str = "pending"
    detail: dict = field(default_factory=dict)
    t: float = 0.0

    def canonical_line(self) -> str:
        """The byte-stable line the chain digest folds.  ``detail``
        and ``t`` are deliberately absent; ``outcome`` is digested as
        it stood AT RECORD TIME (always ``pending`` for non-terminal
        kinds) so later chain resolution never rewrites history."""
        return canonical_detail(
            id=self.event_id,
            parent="-" if self.parent_id is None else self.parent_id,
            step=self.step,
            plane=self.plane,
            kind=self.kind,
            telemetry=self.telemetry_digest or "-",
            candidates=self.candidates if self.candidates else "-",
            winner="-" if self.winner is None else str(self.winner),
            winner_cost=("-" if self.winner_cost is None
                         else self.winner_cost),
            margin="-" if self.margin is None else self.margin,
            outcome=_TERMINAL_OUTCOMES.get(self.kind, "pending"),
        )

    def to_json(self) -> dict:
        return {
            "event_id": self.event_id,
            "parent_id": self.parent_id,
            "step": self.step,
            "plane": self.plane,
            "kind": self.kind,
            "telemetry": self.telemetry,
            "telemetry_digest": self.telemetry_digest,
            "candidates": self.candidates,
            "winner": self.winner,
            "winner_cost": self.winner_cost,
            "margin": self.margin,
            "outcome": self.outcome,
            "detail": self.detail,
            "t": self.t,
        }

    @staticmethod
    def from_json(obj: dict) -> "DecisionEvent":
        return DecisionEvent(
            event_id=int(obj["event_id"]),
            parent_id=(None if obj.get("parent_id") is None
                       else int(obj["parent_id"])),
            step=int(obj.get("step", -1)),
            plane=str(obj.get("plane", "")),
            kind=str(obj.get("kind", "")),
            telemetry=dict(obj.get("telemetry") or {}),
            telemetry_digest=str(obj.get("telemetry_digest", "")),
            candidates=(None if obj.get("candidates") is None
                        else dict(obj["candidates"])),
            winner=obj.get("winner"),
            winner_cost=obj.get("winner_cost"),
            margin=obj.get("margin"),
            outcome=str(obj.get("outcome", "pending")),
            detail=dict(obj.get("detail") or {}),
            t=float(obj.get("t", 0.0)),
        )

    def describe(self) -> str:
        """One human line: ``[id] step=.. plane/kind`` plus whatever
        decision fields are set."""
        bits = [f"[{self.event_id}] step={self.step} "
                f"{self.plane}/{self.kind}"]
        if self.winner is not None:
            bits.append(f"winner={self.winner}")
        if self.winner_cost is not None:
            bits.append(f"cost={format(float(self.winner_cost), '.9g')}")
        if self.margin is not None:
            bits.append(f"margin={format(float(self.margin), '.9g')}")
        if self.candidates:
            bits.append(f"candidates={len(self.candidates)}")
        if self.telemetry_digest:
            bits.append(f"telemetry=sha256:{self.telemetry_digest[:12]}")
        for k in sorted(self.detail):
            bits.append(f"{k}={self.detail[k]}")
        bits.append(f"outcome={self.outcome}")
        return " ".join(bits)


def _digest_telemetry(telemetry: dict) -> str:
    if not telemetry:
        return ""
    line = canonical_detail(**telemetry)
    return hashlib.sha256(line.encode("utf-8")).hexdigest()


class BlackBox:
    """Bounded ring of :class:`DecisionEvent` with a streaming chain
    digest.

    Thread-safe: control planes record from the step loop, async
    synthesis threads, and serving pollers concurrently.  ``capacity``
    defaults to :func:`bluefog_tpu_torch.config.blackbox_capacity`.  Metrics
    publish to ``registry`` when given, else to the process registry
    gated by :func:`bluefog_tpu_torch.observe.registry.enabled`."""

    def __init__(self, capacity: Optional[int] = None, *,
                 registry=None):
        self._lock = threading.RLock()
        self.capacity = int(capacity if capacity is not None
                            else config.blackbox_capacity())
        if self.capacity < 1:
            raise ValueError("blackbox capacity must be >= 1")
        self._ring: "OrderedDict[int, DecisionEvent]" = OrderedDict()
        self._children: Dict[int, List[int]] = {}
        self._sha = hashlib.sha256()
        self._next_id = 0
        self.n_recorded = 0
        self.dropped = 0
        self._registry = registry
        self._dumped_kinds: set = set()
        # metric handles cached per (registry, labels): the registry's
        # labeled lookup costs ~20us and record() is the sim's inner
        # loop, so the handles are resolved once and reused
        self._counter_cache: dict = {}
        self._gauge_cache: dict = {}
        if registry is not None:
            registry.gauge(
                "bf_blackbox_dropped_events",
                "Decision events evicted from the flight recorder ring",
            ).set(0.0)

    # -- recording ----------------------------------------------------

    def record(self, plane: str, kind: str, *, step: int,
               parent: Union[None, int, DecisionEvent] = None,
               telemetry: Optional[dict] = None,
               candidates: Optional[Dict[str, float]] = None,
               winner: Optional[str] = None,
               winner_cost: Optional[float] = None,
               margin: Optional[float] = None,
               detail: Optional[dict] = None) -> DecisionEvent:
        """Append one decision to the ring and fold its canonical line
        into the chain digest.  Returns the event (its ``event_id`` is
        the causal handle for children)."""
        parent_id = (parent.event_id if isinstance(parent, DecisionEvent)
                     else parent)
        telemetry = dict(telemetry) if telemetry else {}
        with self._lock:
            ev = DecisionEvent(
                event_id=self._next_id,
                parent_id=parent_id,
                step=int(step),
                plane=str(plane),
                kind=str(kind),
                telemetry=telemetry,
                telemetry_digest=_digest_telemetry(telemetry),
                candidates=(dict(candidates) if candidates is not None
                            else None),
                winner=winner,
                winner_cost=(None if winner_cost is None
                             else float(winner_cost)),
                margin=None if margin is None else float(margin),
                detail=dict(detail) if detail else {},
                t=_now(),
            )
            self._next_id += 1
            self.n_recorded += 1
            self._sha.update(ev.canonical_line().encode("utf-8"))
            self._sha.update(b"\n")
            self._ring[ev.event_id] = ev
            if parent_id is not None:
                self._children.setdefault(parent_id, []).append(
                    ev.event_id)
            while len(self._ring) > self.capacity:
                old_id, _ = self._ring.popitem(last=False)
                self._children.pop(old_id, None)
                self.dropped += 1
            outcome = _TERMINAL_OUTCOMES.get(ev.kind)
            if outcome is not None:
                self._resolve_chain_locked(ev, outcome)
            self._publish(ev, outcome)
        if ev.kind in ANOMALY_KINDS:
            self._on_anomaly(ev)
        return ev

    def _resolve_chain_locked(self, ev: DecisionEvent,
                              outcome: str) -> None:
        """A terminal kind settles the whole ancestor chain's outcome
        (rendering only; digested lines are immutable)."""
        ev.outcome = outcome
        seen = set()
        pid = ev.parent_id
        while pid is not None and pid not in seen:
            seen.add(pid)
            anc = self._ring.get(pid)
            if anc is None:
                break
            if anc.outcome == "pending":
                anc.outcome = outcome
            pid = anc.parent_id

    def _publish(self, ev: DecisionEvent,
                 outcome: Optional[str]) -> None:
        reg = self._registry
        if reg is None:
            from bluefog_tpu_torch.observe import registry as _registry
            if not _registry.enabled():
                return
            reg = _registry.get_registry()
        key = (id(reg), ev.plane, ev.kind, outcome)
        ctr = self._counter_cache.get(key)
        if ctr is None:
            ctr = self._counter_cache[key] = reg.counter(
                "bf_decisions_total",
                "Control-plane decisions recorded by the flight "
                "recorder",
                plane=ev.plane, kind=ev.kind,
                outcome=outcome if outcome is not None else "pending")
        ctr.inc()
        gauge = self._gauge_cache.get(id(reg))
        if gauge is None:
            gauge = self._gauge_cache[id(reg)] = reg.gauge(
                "bf_blackbox_dropped_events",
                "Decision events evicted from the flight recorder ring")
        gauge.set(float(self.dropped))

    def _on_anomaly(self, ev: DecisionEvent) -> None:
        """Preserve the evidence: Chrome-trace instant always (when
        observe is on), ring dump to BLUEFOG_BLACKBOX_DUMP once per
        anomaly kind."""
        try:
            from bluefog_tpu_torch.observe.tracer import publish_tracer
            tracer = publish_tracer()
            if tracer is not None:
                tracer.instant(f"blackbox.dump.{ev.kind}", "blackbox")
        except Exception:
            pass
        dump_dir = config.blackbox_dump_dir()
        if not dump_dir:
            return
        with self._lock:
            if ev.kind in self._dumped_kinds:
                return
            self._dumped_kinds.add(ev.kind)
        try:
            os.makedirs(dump_dir, exist_ok=True)
            self.dump(os.path.join(dump_dir,
                                   f"blackbox_{ev.kind}.jsonl"))
        except OSError:
            pass

    # -- queries ------------------------------------------------------

    def events(self) -> List[DecisionEvent]:
        with self._lock:
            return list(self._ring.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def get(self, event_id: int) -> Optional[DecisionEvent]:
        with self._lock:
            return self._ring.get(int(event_id))

    def children(self, event_id: int) -> List[DecisionEvent]:
        with self._lock:
            return [self._ring[c]
                    for c in self._children.get(int(event_id), ())
                    if c in self._ring]

    def chain(self, event: Union[int, DecisionEvent]
              ) -> List[DecisionEvent]:
        """The full causal chain through ``event``: ancestors back to
        the root (oldest first), then the subtree below it in id
        order.  Evicted ancestors are simply absent — the chain is as
        deep as the ring still remembers."""
        ev = (event if isinstance(event, DecisionEvent)
              else self.get(event))
        if ev is None:
            return []
        with self._lock:
            up: List[DecisionEvent] = []
            seen = set()
            cur: Optional[DecisionEvent] = ev
            while cur is not None and cur.event_id not in seen:
                seen.add(cur.event_id)
                up.append(cur)
                cur = (self._ring.get(cur.parent_id)
                       if cur.parent_id is not None else None)
            up.reverse()
            down: List[DecisionEvent] = []
            stack = list(self._children.get(ev.event_id, ()))
            while stack:
                cid = stack.pop(0)
                child = self._ring.get(cid)
                if child is None or cid in seen:
                    continue
                seen.add(cid)
                down.append(child)
                stack.extend(self._children.get(cid, ()))
            return up + down

    def chain_digest(self) -> str:
        """Hex SHA-256 over every canonical line recorded so far —
        byte-identical across two same-seed runs, unaffected by ring
        eviction (streaming, like the JAX package's sim event log)."""
        with self._lock:
            return self._sha.hexdigest()

    # -- export -------------------------------------------------------

    def jsonl(self) -> str:
        """One JSON object per retained event, preceded by a meta line
        with counts and the chain digest."""
        with self._lock:
            meta = {"blackbox": {
                "n_recorded": self.n_recorded,
                "retained": len(self._ring),
                "dropped": self.dropped,
                "capacity": self.capacity,
                "chain_digest": self.chain_digest(),
            }}
            lines = [json.dumps(meta, sort_keys=True)]
            lines.extend(json.dumps(ev.to_json(), sort_keys=True)
                         for ev in self._ring.values())
        return "\n".join(lines) + "\n"

    def dump(self, path: str) -> str:
        payload = self.jsonl()
        with open(path, "w") as f:
            f.write(payload)
        return path

    def explain(self, event: Union[int, DecisionEvent]) -> str:
        """Render the causal chain through ``event`` as an indented
        tree — the "why did it do that?" answer."""
        chain = self.chain(event)
        if not chain:
            return "(no such decision in the ring)"
        lines = [f"decision chain ({len(chain)} events, "
                 f"plane={chain[0].plane}):"]
        for depth, ev in enumerate(chain):
            prefix = "  " + "   " * depth + ("└─ " if depth else "")
            lines.append(prefix + ev.describe())
        return "\n".join(lines)


def _now() -> float:
    import time
    return time.time()


_global_lock = threading.Lock()
_global_blackbox: Optional[BlackBox] = None


def get_blackbox() -> BlackBox:
    """The process-global flight recorder (capacity from
    ``BLUEFOG_BLACKBOX_CAPACITY`` at first use)."""
    global _global_blackbox
    bb = _global_blackbox
    if bb is None:
        with _global_lock:
            bb = _global_blackbox
            if bb is None:
                bb = BlackBox()
                _global_blackbox = bb
    return bb


def record_decision(plane: str, kind: str, *, step: int,
                    parent: Union[None, int, DecisionEvent] = None,
                    telemetry: Optional[dict] = None,
                    candidates: Optional[Dict[str, float]] = None,
                    winner: Optional[str] = None,
                    winner_cost: Optional[float] = None,
                    margin: Optional[float] = None,
                    blackbox: Union[None, bool, BlackBox] = None,
                    detail: Optional[dict] = None
                    ) -> Optional[DecisionEvent]:
    """The one emission seam every control plane calls (the
    ``decision-outside-recorder`` lint rule enforces it).

    ``blackbox=None`` records to the process-global ring, gated by
    ``BLUEFOG_BLACKBOX``; an explicit :class:`BlackBox` records
    unconditionally (benches inject their own for determinism checks);
    ``blackbox=False`` disables recording for this call — the "off"
    arm of the recorder-transparency check.  Returns the event, or
    ``None`` when disabled (callers thread ``None`` parents through
    untouched)."""
    if blackbox is False:
        return None
    if blackbox is None or blackbox is True:
        if not config.blackbox_enabled():
            return None
        blackbox = get_blackbox()
    return blackbox.record(
        plane, kind, step=step, parent=parent, telemetry=telemetry,
        candidates=candidates, winner=winner, winner_cost=winner_cost,
        margin=margin, detail=detail)


def explain(event: Union[int, DecisionEvent],
            blackbox: Optional[BlackBox] = None) -> str:
    """``bf.observe.explain(event)``: render the causal chain through
    ``event`` from the given (default process-global) recorder."""
    bb = blackbox if blackbox is not None else get_blackbox()
    return bb.explain(event)


# -- CLI --------------------------------------------------------------


def _load_dump(path: str) -> "BlackBox":
    bb = BlackBox(capacity=1 << 30)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "blackbox" in obj and "event_id" not in obj:
                continue
            ev = DecisionEvent.from_json(obj)
            bb._ring[ev.event_id] = ev
            if ev.parent_id is not None:
                bb._children.setdefault(ev.parent_id, []).append(
                    ev.event_id)
            bb.n_recorded += 1
    return bb


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.observe.blackbox",
        description="Render decision chains from a flight-recorder "
                    "JSONL dump (or the live process ring when no "
                    "file is given).")
    parser.add_argument("dump", nargs="?", default=None,
                        help="JSONL dump written by BlackBox.dump()")
    parser.add_argument("--explain", type=int, default=None,
                        metavar="ID",
                        help="render only the chain through event ID")
    args = parser.parse_args(argv)

    bb = _load_dump(args.dump) if args.dump else get_blackbox()
    events = bb.events()
    if not events:
        print("(empty ring)")
        return 0
    if args.explain is not None:
        print(bb.explain(args.explain))
        return 0 if bb.get(args.explain) is not None else 1
    roots = [ev for ev in events
             if ev.parent_id is None or bb.get(ev.parent_id) is None]
    for root in roots:
        print(bb.explain(root))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

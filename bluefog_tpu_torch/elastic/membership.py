"""Elastic membership: the LIVE -> DEAD -> JOINING -> LIVE lifecycle.

Port of ``bluefog_tpu/elastic/membership.py``: the state machine and the
weight renders are the JAX package's numpy, copied, so the tables are
byte-equal to JAX's; :meth:`MembershipController.comm_weights` hands
them over as float64 torch tensors.

``healing.py`` is one-directional: dead ranks are excised and the mesh
only ever shrinks.  This module adds the way back.  Membership is a
host-side state machine (:class:`MembershipController`) whose entire
device-visible output is runtime DATA — a ``[n_max]`` membership mask
plus re-planned ``(class_weights, self_weights)`` pairs in exactly the
shapes ``optim.functional.comm_weight_inputs`` emits — so one guarded
train step built at max fleet size serves every join / leave / rejoin.

The inverse of healing is :func:`grow_weights`.  Healing moved a dead
``src``'s in-edge mass onto each receiver's self-weight; growth must
give it back EXACTLY.  Floating-point subtraction cannot do that
(``(a + w) - w != a`` in general), so growth never subtracts: it
re-plans from the PRISTINE spec against the shrunken dead set, walking
the same ``(class, dst)`` order as :func:`healing.heal_weights`.  The
result is therefore byte-equal to a fresh heal of the remaining dead
set — and byte-equal to the original tables once everyone is back —
while staying row-stochastic at every intermediate step.

State machine::

    LIVE --mark_dead--> DEAD --admit--> JOINING --promote--> LIVE
                          ^                |
                          +-----kick------ +   (bootstrap failed /
                                               rollback invalidated it)

While JOINING, a rank is quarantined: live receivers keep their healed
(zero) weights for it, the :class:`~bluefog_tpu_torch.resilience.detector.
FailureDetector` still counts it dead (its skips must not trigger
fleet rollbacks), and only the joiner's OWN row pulls — the annealed
bootstrap schedule of :mod:`bluefog_tpu_torch.elastic.bootstrap`.  Promotion
calls ``FailureDetector.readmit`` so the returning rank is not
instantly re-excised by a latched suspicion.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import (Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

import torch

from bluefog_tpu_torch import config as _config
from bluefog_tpu_torch.resilience.healing import (
    heal_spec, heal_weights, mixing_matrix_from_weights)
from bluefog_tpu_torch.topology.spec import DynamicTopology, Topology

CommSpec = Union[Topology, DynamicTopology]

# This module legitimately constructs weight tables from scratch: the
# analysis lint's weight-matrix-bypass rule treats it as an authority
# (everywhere else, tables must come from the shared helpers here).
_WEIGHT_AUTHORITY = True

__all__ = [
    "LIVE",
    "DEAD",
    "JOINING",
    "ElasticConfig",
    "MembershipController",
    "grow_weights",
    "grow_spec",
    "grown_comm_weights",
]

LIVE, DEAD, JOINING = "live", "dead", "joining"
_CODE = {LIVE: 0, DEAD: 1, JOINING: 2}
_STATE = {v: k for k, v in _CODE.items()}

# steady-state (no joiner) weight tables are cached per membership
# pattern; bounded so a long churn history cannot grow host memory
_STEADY_CACHE_MAX = 16


def _as_ranks(ranks: Union[int, Sequence[int]]) -> List[int]:
    if isinstance(ranks, (int, np.integer)):
        return [int(ranks)]
    return [int(r) for r in ranks]


def grow_weights(spec: CommSpec, dead_mask,
                 rejoin_ranks: Union[int, Sequence[int]]) -> tuple:
    """Re-plan ``(class_weights [n_classes, n], self_weights [n])``
    after ``rejoin_ranks`` (a subset of the dead set) come back: their
    in-edge mass moves OFF the receivers' self-weights and back onto
    the edges, and their own rows are restored.

    Implementation note — growth is a re-plan from the PRISTINE spec
    against the shrunken dead set, never a subtraction from the healed
    tables: recomputing in :func:`healing.heal_weights`'s own iteration
    order makes ``heal -> grow`` round-trip BYTE-EQUAL (``grow(spec,
    dead, dead) == (pristine class/self tables)`` bit for bit, and any
    partial growth equals a fresh heal of the survivors' dead set),
    where ``(a + w) - w`` would leave rounding residue on every healed
    self-weight.  Row sums are preserved exactly at every step for the
    same reason heals preserve them."""
    n = spec.size
    dead = np.asarray(dead_mask, bool).reshape(-1).copy()
    if dead.shape[0] != n:
        raise ValueError(
            f"dead mask of length {dead.shape[0]} does not match "
            f"topology size {n}")
    for r in _as_ranks(rejoin_ranks):
        if not 0 <= r < n:
            raise ValueError(f"rank {r} outside topology of size {n}")
        if not dead[r]:
            raise ValueError(
                f"rank {r} is not dead — only dead ranks can rejoin")
        dead[r] = False
    return heal_weights(spec, dead)


def grow_spec(spec: CommSpec, dead_mask,
              rejoin_ranks: Union[int, Sequence[int]]) -> CommSpec:
    """A standalone re-grown spec of the same type (for eager ops and
    simulation) — :func:`healing.heal_spec` of the shrunken dead set,
    so ``heal_spec -> grow_spec`` with everyone rejoining reproduces
    the original weights exactly."""
    n = spec.size
    dead = np.asarray(dead_mask, bool).reshape(-1).copy()
    if dead.shape[0] != n:
        raise ValueError(
            f"dead mask of length {dead.shape[0]} does not match "
            f"topology size {n}")
    for r in _as_ranks(rejoin_ranks):
        if not 0 <= r < n:
            raise ValueError(f"rank {r} outside topology of size {n}")
        if not dead[r]:
            raise ValueError(
                f"rank {r} is not dead — only dead ranks can rejoin")
        dead[r] = False
    return heal_spec(spec, dead)


def grown_comm_weights(specs: Sequence[CommSpec], dead_mask,
                       rejoin_ranks: Union[int, Sequence[int]]) -> tuple:
    """The re-grown schedule as runtime data: one float64 tensor
    ``(class_weights, self_weights)`` pair per round, structurally
    identical to ``healing.healed_comm_weights`` — the growth-direction
    twin that restores rejoined ranks with the same step."""
    out = []
    for s in specs:
        cw, sw = grow_weights(s, dead_mask, rejoin_ranks)
        out.append((torch.from_numpy(cw), torch.from_numpy(sw)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Policy knobs for ``run_resilient(elastic=...)``.

    ``bootstrap_rounds``: mixing rounds a joiner's self-weight anneals
    over (0 -> its pristine weight); default
    ``BLUEFOG_ELASTIC_BOOTSTRAP_ROUNDS``.  ``quarantine_threshold``:
    max normalized bootstrap disagreement for promotion (joiner params
    vs the live mean, in units of the live ranks' own dispersion —
    :func:`bluefog_tpu_torch.elastic.bootstrap.disagreement`; <= 1.0 = inside
    the live consensus cloud); default
    ``BLUEFOG_ELASTIC_QUARANTINE_THRESHOLD``.
    ``max_quarantine_steps``: a joiner still above threshold after this
    many quarantined steps is kicked back to DEAD.  ``admit``: a
    ``step -> ranks`` callable naming ranks that want in at the top of
    a step; ``None`` derives it from the run's
    ``FaultPlan.rejoinable_ranks`` (deterministic replay).
    ``check_every``: disagreement-check cadence (steps) once the anneal
    has finished (the ``max_quarantine_steps`` deadline is enforced
    every step regardless).  ``sanitize``: zero non-finite entries on a
    joiner's state rows at admission (a real re-attached host arrives
    with garbage memory; the guard's frozen-finite invariant only
    covers ranks that died in-graph).  ``reset_opt_state``: zero the
    joiner's OPTIMIZER state rows at admission
    (:func:`bluefog_tpu_torch.elastic.bootstrap.zero_rank_rows`) — the
    promotion gate measures params only, so stale-but-finite
    pre-preemption moments would otherwise rejoin silently; zeroed
    moments rebuild from fresh gradients during quarantine."""

    bootstrap_rounds: Optional[int] = None
    quarantine_threshold: Optional[float] = None
    max_quarantine_steps: int = 64
    admit: Optional[Callable[[int], Sequence[int]]] = None
    check_every: int = 1
    sanitize: bool = True
    reset_opt_state: bool = True


class MembershipController:
    """Host-side membership state machine over a mixing schedule.

    The controller owns the rank lifecycle (LIVE / DEAD / JOINING) and
    renders it, on demand, into the two runtime-data views the guarded
    step consumes: :meth:`comm_weights` (per-round ``(class_weights,
    self_weights)`` pairs — healed around DEAD+JOINING receivers, with
    JOINING rows replaced by the annealed bootstrap pull of
    :func:`bluefog_tpu_torch.elastic.bootstrap.bootstrap_weights`) and
    :meth:`membership_mask` (a float ``[n]`` LIVE indicator).  It
    composes with a :class:`~bluefog_tpu_torch.resilience.detector.
    FailureDetector`: deaths are forwarded immediately, readmission
    only at PROMOTE time — while JOINING, the detector keeps the rank
    dead so bootstrap-window skips cannot trigger a fleet rollback.

    ``effective_dead_mask`` (everything not LIVE) is also the gossip
    mask: ``observe.fleet.FleetAggregator`` accepts the controller
    directly, so fleet telemetry heals and RE-GROWS in lockstep with
    the data plane."""

    def __init__(self, schedule, *,
                 bootstrap_rounds: Optional[int] = None,
                 quarantine_threshold: Optional[float] = None,
                 detector=None,
                 blackbox=None):
        if isinstance(schedule, (Topology, DynamicTopology)):
            schedule = [schedule]
        if not schedule:
            raise ValueError(
                "MembershipController needs a non-empty schedule")
        sizes = {s.size for s in schedule}
        if len(sizes) != 1:
            raise ValueError(f"schedule mixes topology sizes {sizes}")
        self.schedule: Tuple[CommSpec, ...] = tuple(schedule)
        self.size = sizes.pop()
        self.bootstrap_rounds = int(
            bootstrap_rounds if bootstrap_rounds is not None
            else _config.elastic_bootstrap_rounds())
        if self.bootstrap_rounds < 1:
            raise ValueError("bootstrap_rounds must be >= 1")
        self.quarantine_threshold = float(
            quarantine_threshold if quarantine_threshold is not None
            else _config.elastic_quarantine_threshold())
        self.detector = detector
        self._code = np.zeros(self.size, np.int8)
        self._progress = np.zeros(self.size, np.int64)
        self._steady: "OrderedDict[bytes, tuple]" = OrderedDict()
        # decision flight recorder: ``current_step`` is stamped by the
        # driving loop (run_resilient) so lifecycle
        # decisions carry the training step they happened at; each
        # joiner's admit event parents its eventual promote/kick, so
        # the audit chain reads admit→promote or admit→kick.
        self.blackbox = blackbox
        self.current_step = -1
        self._join_events: Dict[int, object] = {}

    # ------------------------------------------------------------- #
    # views
    # ------------------------------------------------------------- #
    def state(self, rank: int) -> str:
        return _STATE[int(self._code[self._check(rank)])]

    def states(self) -> List[str]:
        return [_STATE[int(c)] for c in self._code]

    def live_mask(self) -> np.ndarray:
        return self._code == _CODE[LIVE]

    def dead_mask(self) -> np.ndarray:
        return self._code == _CODE[DEAD]

    def joining_mask(self) -> np.ndarray:
        return self._code == _CODE[JOINING]

    def effective_dead_mask(self) -> np.ndarray:
        """Everything NOT live — the mask receivers (and the gossip
        layer) excise.  A JOINING rank is still excised here: it pulls
        but is not yet pulled from."""
        return self._code != _CODE[LIVE]

    def live_ranks(self) -> List[int]:
        return [int(r) for r in np.nonzero(self.live_mask())[0]]

    def dead_ranks(self) -> List[int]:
        return [int(r) for r in np.nonzero(self.dead_mask())[0]]

    def joining_ranks(self) -> List[int]:
        return [int(r) for r in np.nonzero(self.joining_mask())[0]]

    def is_live(self, rank: int) -> bool:
        return self._code[self._check(rank)] == _CODE[LIVE]

    def is_dead(self, rank: int) -> bool:
        return self._code[self._check(rank)] == _CODE[DEAD]

    def is_joining(self, rank: int) -> bool:
        return self._code[self._check(rank)] == _CODE[JOINING]

    def progress(self, rank: int) -> int:
        """Quarantined mixing rounds rank has participated in (0 for
        non-joining ranks)."""
        return int(self._progress[self._check(rank)])

    def counts(self) -> Dict[str, int]:
        return {s: int((self._code == c).sum()) for s, c in _CODE.items()}

    def _check(self, rank: int) -> int:
        r = int(rank)
        if not 0 <= r < self.size:
            raise ValueError(f"rank {r} outside world of size {self.size}")
        return r

    # ------------------------------------------------------------- #
    # transitions
    # ------------------------------------------------------------- #
    def seed_dead(self, dead_mask) -> None:
        """Adopt an existing dead set (e.g. ``detector.dead_mask()`` at
        loop start) without re-announcing the deaths."""
        dead = np.asarray(dead_mask, bool).reshape(-1)
        if dead.shape[0] != self.size:
            raise ValueError(
                f"dead mask of length {dead.shape[0]} does not match "
                f"world size {self.size}")
        self._code[dead] = _CODE[DEAD]
        self._progress[dead] = 0

    def mark_dead(self, ranks: Union[int, Sequence[int]]) -> None:
        """Any state -> DEAD (a JOINING rank that dies mid-bootstrap is
        simply dead again).  Forwarded to the detector immediately."""
        rs = [self._check(r) for r in _as_ranks(ranks)]
        for r in rs:
            self._code[r] = _CODE[DEAD]
            self._progress[r] = 0
        if rs and self.detector is not None:
            self.detector.declare_dead(
                [r for r in rs if not self.detector.dead_mask()[r]])
        for r in rs:
            self._decide("mark_dead", rank=r,
                         parent=self._join_events.pop(r, None))
        self._publish("dead", len(rs))

    def admit(self, ranks: Union[int, Sequence[int]]) -> None:
        """DEAD -> JOINING: start the quarantined bootstrap.  The
        detector deliberately still counts the rank dead (its skips
        must not look like live-rank failures); readmission happens at
        :meth:`promote`."""
        for r in _as_ranks(ranks):
            r = self._check(r)
            if self._code[r] != _CODE[DEAD]:
                raise ValueError(
                    f"rank {r} is {self.state(r)}, not dead — only dead "
                    "ranks can be admitted")
            self._code[r] = _CODE[JOINING]
            self._progress[r] = 0
            ev = self._decide("admit", rank=r)
            if ev is not None:
                self._join_events[r] = ev
        self._publish("joining", len(_as_ranks(ranks)))

    def promote(self, ranks: Union[int, Sequence[int]]) -> None:
        """JOINING -> LIVE: quarantine over.  Readmits the rank with
        the detector (clearing its latched streak/suspicion — without
        this ``suspects()`` would instantly re-excise it) and drops it
        from every subsequent healed view."""
        rs = []
        for r in _as_ranks(ranks):
            r = self._check(r)
            if self._code[r] != _CODE[JOINING]:
                raise ValueError(
                    f"rank {r} is {self.state(r)}, not joining — only "
                    "joining ranks can be promoted")
            rs.append(r)
        for r in rs:
            self._code[r] = _CODE[LIVE]
            self._progress[r] = 0
        if rs and self.detector is not None:
            self.detector.readmit(rs)
        for r in rs:
            self._decide("promote", rank=r,
                         parent=self._join_events.pop(r, None))
        self._publish("live", len(rs))

    def kick(self, ranks: Union[int, Sequence[int]]) -> None:
        """JOINING -> DEAD: bootstrap failed (over-threshold too long,
        or a rollback restored state that predates the bootstrap)."""
        for r in _as_ranks(ranks):
            r = self._check(r)
            if self._code[r] != _CODE[JOINING]:
                raise ValueError(
                    f"rank {r} is {self.state(r)}, not joining — only "
                    "joining ranks can be kicked")
            progress = int(self._progress[r])
            self._code[r] = _CODE[DEAD]
            self._progress[r] = 0
            self._decide("kick", rank=r,
                         parent=self._join_events.pop(r, None),
                         progress=progress)
        self._publish("dead", len(_as_ranks(ranks)))

    def tick(self) -> None:
        """One quarantined mixing round happened: advance every
        joiner's anneal progress."""
        self._progress[self._code == _CODE[JOINING]] += 1

    def reschedule(self, schedule) -> None:
        """Swap the topology schedule under the SAME membership: the
        topology control plane hot-swaps a re-planned schedule into a
        running step, and the membership weights must re-render over
        the new specs (re-plan from the pristine spec, then re-apply
        the current masks).  Rank states and joiner progress are
        untouched; the steady-weight cache is dropped — its entries
        were rendered over the old specs and keying is by membership
        pattern only."""
        if isinstance(schedule, (Topology, DynamicTopology)):
            schedule = [schedule]
        if not schedule:
            raise ValueError(
                "MembershipController.reschedule needs a non-empty "
                "schedule")
        sizes = {s.size for s in schedule}
        if sizes != {self.size}:
            raise ValueError(
                f"reschedule sizes {sizes} do not match world size "
                f"{self.size} — membership cannot survive a world "
                "resize")
        self.schedule = tuple(schedule)
        self._steady.clear()

    # ------------------------------------------------------------- #
    # runtime-data renders
    # ------------------------------------------------------------- #
    def anneal(self) -> Dict[int, float]:
        """Joining rank -> anneal fraction in [0, 1] (progress over
        ``bootstrap_rounds``, clamped)."""
        from bluefog_tpu_torch.elastic.bootstrap import anneal_fraction

        return {r: anneal_fraction(int(self._progress[r]),
                                   self.bootstrap_rounds)
                for r in self.joining_ranks()}

    def comm_weight_arrays(self) -> List[tuple]:
        """Per-round ``(class_weights, self_weights)`` float64 numpy
        pairs for the CURRENT membership: healed around every non-LIVE
        rank, with JOINING rows replaced by the annealed bootstrap
        pull.  Steady states (no joiner) are cached per membership
        pattern (bounded LRU — churn in both directions must not grow
        host memory); cached tables come back READ-ONLY, so treat them
        as immutable and copy before editing."""
        from bluefog_tpu_torch.elastic.bootstrap import bootstrap_weights

        anneal = self.anneal()
        live = self.live_mask()
        if not anneal:
            key = self._code.tobytes()
            hit = self._steady.get(key)
            if hit is not None:
                self._steady.move_to_end(key)
                return [tuple(p) for p in hit]
            out = [bootstrap_weights(s, live, {}) for s in self.schedule]
            # cached arrays are handed out on every later hit, so they
            # are frozen: a caller mutating a returned table gets a
            # loud ValueError instead of silently corrupting every
            # subsequent render of this membership pattern
            for cw, sw in out:
                cw.flags.writeable = False
                sw.flags.writeable = False
            self._steady[key] = tuple(out)
            while len(self._steady) > _STEADY_CACHE_MAX:
                self._steady.popitem(last=False)
            return out
        return [bootstrap_weights(s, live, anneal) for s in self.schedule]

    def comm_weights(self) -> tuple:
        """The membership as runtime data: one float64 tensor
        ``(class_weights, self_weights)`` pair per round, structurally
        identical to ``optim.functional.comm_weight_inputs(schedule)``
        — pass it straight into the guarded step."""
        return tuple((torch.from_numpy(np.array(cw)),
                      torch.from_numpy(np.array(sw)))
                     for cw, sw in self.comm_weight_arrays())

    def membership_mask(self) -> torch.Tensor:
        """The ``[n_max]`` LIVE mask (float32, 1.0 = live) — for step
        logic that weights by membership rather than by the mixing rows
        (e.g. masked metrics)."""
        return torch.from_numpy(self.live_mask().astype(np.float32))

    def mixing_matrices(self) -> List[np.ndarray]:
        """Per-round receiver-major mixing matrices of the current
        membership — the pure-numpy view ``consensus_simulation``-style
        harnesses iterate."""
        return [mixing_matrix_from_weights(s, cw, sw)
                for s, (cw, sw) in zip(self.schedule,
                                       self.comm_weight_arrays())]

    # ------------------------------------------------------------- #
    # observability
    # ------------------------------------------------------------- #
    def _decide(self, kind: str, *, rank: int, parent=None, **detail):
        """The one blackbox emission seam of the membership plane (the
        ``decision-outside-recorder`` lint rule holds every lifecycle
        transition to it)."""
        from bluefog_tpu_torch.observe import blackbox as _blackbox

        counts = self.counts()
        return _blackbox.record_decision(
            "membership", kind, step=self.current_step, parent=parent,
            telemetry={"rank": int(rank), "live": counts[LIVE],
                       "dead": counts[DEAD], "joining": counts[JOINING]},
            winner=str(int(rank)), blackbox=self.blackbox,
            detail=detail or None)

    def _publish(self, to_state: str, moved: int) -> None:
        from bluefog_tpu_torch import observe

        if not observe.enabled():
            return
        reg = observe.get_registry()
        if moved:
            reg.counter("bf_elastic_transitions_total",
                        "membership transitions",
                        to=to_state).inc(moved)
        for s, c in self.counts().items():
            reg.gauge(f"bf_elastic_{s}_ranks",
                      f"ranks currently {s}").set(float(c))

    def __repr__(self):
        c = self.counts()
        return (f"MembershipController(size={self.size}, live={c[LIVE]}, "
                f"dead={c[DEAD]}, joining={c[JOINING]})")

"""Guarded-rollback resilient training: the host-side control loop.

Port of ``bluefog_tpu/resilience/runner.py``.  ``run_resilient`` drives a
GUARDED train step (``build_train_step(..., guard=GuardConfig(...))``)
over its backend's ranks through a fault environment:

* every step's rank-major ``skipped`` flags feed the
  :class:`~bluefog_tpu_torch.resilience.detector.FailureDetector`;
* transient faults cost exactly the faulty rank's skipped steps —
  nothing else happens;
* after K (= ``guard.max_consecutive_bad``) consecutive steps with a
  LIVE-rank skip, the loop (1) declares the persistently-bad ranks dead,
  (2) heals the mixing weights (``healing.healed_comm_weights`` — new
  weight data for the same step), (3) rolls back to the last good
  :class:`~bluefog_tpu_torch.checkpoint.Checkpointer` state, and (4)
  sleeps an exponential backoff before resuming;
* checkpoints are taken every ``checkpoint_every`` steps, but only at
  steps with no live-rank skip — rollback always lands on a state the
  guard certified finite.

The port's step updates its state IN PLACE, so the loop's state never
changes objects: a checkpoint copies the state to host memory before the
next step runs, a rollback copies the saved values back into the live
tensors and the live optimizer (``Checkpointer.restore_latest(like=)``),
and the elastic row hygiene zeroes rows in place.  Each step makes ONE
host transfer: the skip flags and the losses together.  Under a
``ProcessBackend`` every process runs the loop; the flags and losses
are gathered from every rank first, so every process takes the same
decisions, and the checkpointer agrees on the step to restore.

Determinism contract: batches come from ``batch_fn(step)`` (a pure
function of the step index), so replayed steps after a rollback see the
SAME data — a run is reproducible fault plan included, which is what
lets tests parity-check the rollback against the saved checkpoint.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from bluefog_tpu_torch import observe
from bluefog_tpu_torch.context import BluefogError
from bluefog_tpu_torch.optim.functional import GuardConfig
from bluefog_tpu_torch.resilience.detector import FailureDetector
from bluefog_tpu_torch.resilience.faults import FaultPlan
from bluefog_tpu_torch.resilience.healing import (
    healed_comm_weights, healed_hierarchical_comm_weights)

__all__ = ["ResilienceEvent", "ResilientResult", "run_resilient"]


@dataclasses.dataclass(frozen=True)
class ResilienceEvent:
    """One entry of the run's event log: ``kind`` in {"checkpoint",
    "skip", "rank_dead", "rollback", "straggler",
    "bad_window_unattributed", "rank_joining", "rank_promoted",
    "rank_join_failed"}, plus the ``topology_*`` kinds of the topology
    control plane when the run was started with ``control=`` (their
    ``detail`` carries the plane's reason/schedule/score fields);
    ``step`` is the step index the event fired at;
    ``detail`` carries kind-specific fields (rollback:
    ``restored_step``, ``backoff``, ``dead``; straggler: ``ranks``,
    ``z``; the elastic kinds: ``rank``, plus ``disagreement``/``rounds``
    on promotion and ``reason`` on a failed join —
    ``"quarantine_expired"``, ``"rollback"`` for an in-flight joiner a
    rollback stranded, or ``"promotion_rolled_back"`` for a rank whose
    promotion postdates the restored checkpoint)."""

    kind: str
    step: int
    detail: dict


@dataclasses.dataclass
class ResilientResult:
    params: Any
    opt_state: Any
    step: int
    last_loss: Optional[np.ndarray]   # [n] every rank's, on the host
    total_skips: np.ndarray       # [n] skips per rank, replays included
    n_rollbacks: int
    dead_mask: np.ndarray         # [n] bool
    events: List[ResilienceEvent]
    # final per-rank membership states ("live"/"dead"/"joining") when
    # the run was elastic; None otherwise
    membership: Optional[List[str]] = None


def run_resilient(
    train_step: Callable,
    params: Any,
    opt_state: Any,
    batch_fn: Callable[[int], Any],
    *,
    steps: int,
    checkpointer,
    backend=None,
    guard: Optional[GuardConfig] = None,
    schedule: Optional[Sequence] = None,
    comm_weights: Optional[tuple] = None,
    fault_plan: Optional[FaultPlan] = None,
    detector: Optional[FailureDetector] = None,
    checkpoint_every: int = 10,
    sleep: Callable[[float], None] = time.sleep,
    on_event: Optional[Callable[[ResilienceEvent], None]] = None,
    straggler=None,
    step_times_fn: Optional[Callable[[int, float], Any]] = None,
    elastic=None,
    control=None,
) -> ResilientResult:
    """Train ``steps`` steps under faults; see the module docstring for
    the recovery semantics.

    ``train_step`` must be guard-built (it exposes
    ``default_comm_weights`` and returns the ``skipped`` vector).
    ``backend``: the step's :class:`~bluefog_tpu_torch.parallel.
    collectives.RankBackend` (default: the one the step was built over),
    in the place of the JAX package's ``mesh=``/``axis_name=``;
    ``batch_fn(step)`` returns the rows of the ranks this process holds.
    ``schedule`` is the list of topology specs backing the step's
    combine (one element for a static topology) — required for healing;
    without it a rollback restores state but the mixing weights stay as
    passed.  For a HIERARCHICAL step (``build_train_step(...,
    hierarchical=...)``) the schedule is MACHINE-level and the loop
    detects it via the step's ``hierarchical_local_size`` attribute:
    the detector keeps watching RANKS, and every heal delivery collapses
    the rank mask through ``healing.machine_dead_mask`` (a machine with
    any dead member is excised as a unit) before healing the machine
    schedule.  ``checkpointer`` needs ``save(step, state, force=,
    blocking=)``, ``wait()`` and ``restore_latest(like=)`` (the port's
    ``Checkpointer``, which restores into the live state in place); the
    loop saves with ``blocking=False`` (the state is copied to host memory
    before ``save`` returns, and a restore waits for the last write) and
    returns once every write is on disk; checkpoint steps store
    ``{"params", "opt_state", "step"}``.  ``sleep`` is injectable so
    tests run backoff under a virtual clock.

    ``straggler`` (an ``observe.fleet.StragglerDetector``) turns the
    loop's per-step wall time into a fleet health signal: each step the
    detector observes the per-rank step-time vector, newly-flagged
    ranks are emitted as ``straggler`` events and registered with
    ``FailureDetector.suspect`` (so a slow rank is *named* before the
    blunt ``BLUEFOG_OP_TIMEOUT`` fires), and the suspicion set tracks
    the detector's flags (a recovered rank is un-suspected).
    ``step_times_fn(step, wall_s) -> [n]`` supplies the per-rank
    vector; the default broadcasts the measured local wall time to all
    ranks.  Per-step wall time also lands in the
    ``bf_step_wall_seconds{loop="train"}`` histogram.

    ``elastic`` (a :class:`bluefog_tpu_torch.elastic.ElasticConfig`)
    turns on the full membership lifecycle: between steps the loop polls
    the admission signal (``elastic.admit``, defaulting to the fault
    plan's ``rejoinable_ranks``) and moves returning dead ranks to
    JOINING — quarantined bootstrap by pulled neighbor averaging
    (:mod:`bluefog_tpu_torch.elastic.bootstrap`), all of it weight DATA
    through the one step.  A joiner whose params' disagreement against
    the live mean drops under the quarantine threshold is PROMOTED
    (``rank_promoted``; the detector readmits it), one still over
    threshold after ``max_quarantine_steps`` is kicked back to DEAD
    (``rank_join_failed``), and a rollback kicks every in-flight joiner
    (the restored checkpoint predates its bootstrap).  Promotion forces
    a checkpoint on the next clean step; if a rollback nevertheless
    restores a step that predates a promotion, the promoted rank is
    demoted back to DEAD (``rank_join_failed`` with
    ``reason="promotion_rolled_back"``) so its rewound, uncertified rows
    never mix into the fleet as live weight.  Requires ``schedule=``;
    while elastic is on, the controller owns ``comm_weights``.

    ``control`` (a :class:`bluefog_tpu_torch.topology.
    TopologyControlPlane` built over this step's schedule as its
    carrier) closes the topology loop: at every step boundary the loop
    calls ``control.on_step(step, dead_mask=, params=)`` and, after a
    ``topology_swap`` or ``topology_rollback``, re-delivers the plane's
    ACTIVE schedule healed under the current dead mask (swap and heal
    compose in ``swap_comm_weights``) as the step's ``comm_weights``:
    new data, carrier-shaped, for the same step object.  When elastic is
    also on, a swap ``reschedule``-s the ``MembershipController`` onto
    the new specs and the controller keeps owning ``comm_weights``.
    Requires ``schedule=``; flat steps only (a hierarchical schedule is
    machine-level while the plane projects rank-level candidates), with
    every rank in this process.
    """
    if not hasattr(train_step, "default_comm_weights"):
        raise ValueError(
            "run_resilient needs a GUARDED train step — build it with "
            "build_train_step(..., guard=GuardConfig(...))")
    if getattr(train_step, "has_aux", False):
        raise ValueError(
            "run_resilient drives the no-aux step signature "
            "(params, opt_state, batch, step, comm_weights); a "
            "has_aux=True guarded step takes an extra aux tree — drive "
            "it with your own loop, or fold the aux state into params")
    # policy default: the GuardConfig the step was BUILT with (attached
    # by build_train_step) — passing guard= here only to repeat it
    # would be a silent-drift trap
    if guard is None:
        guard = getattr(train_step, "guard_config", None) or GuardConfig()
    if backend is None:
        backend = train_step.backend
    n = int(backend.size)
    lo, hi = backend.first_rank, backend.first_rank + backend.n_local
    ranks = list(range(lo, hi))
    gather = backend.gather_ranks if backend.n_local != n else None
    detector = detector or FailureDetector(n)
    if comm_weights is None:
        comm_weights = train_step.default_comm_weights
    # a hierarchical step's schedule specs are MACHINE-level; the
    # detector stays RANK-level, and every heal delivery collapses the
    # rank mask through the machine failure domain
    hier_l = getattr(train_step, "hierarchical_local_size", None)
    if control is not None:
        if not schedule:
            raise ValueError(
                "run_resilient(control=...) needs schedule= — the "
                "control plane is a weight re-plan over the step's "
                "carrier specs")
        if hier_l:
            raise ValueError(
                "run_resilient(control=...) does not drive a "
                "hierarchical step: the plane projects RANK-level "
                "candidates while a hierarchical schedule is "
                "MACHINE-level — synthesize hierarchically offline or "
                "train flat")
        if len(control.carrier) != len(schedule):
            raise ValueError(
                f"control plane carrier has {len(control.carrier)} "
                f"rounds but the step's schedule has {len(schedule)} — "
                "build the plane over the schedule the step compiled")
        if gather is not None:
            raise ValueError(
                "run_resilient(control=...) needs every rank's rows in "
                "this process (a StackedBackend): the plane's probation "
                "health reads every rank-major leaf, as the JAX "
                "package's reads fully addressable arrays")

    def heal(dead_mask):
        # with a control plane, healing applies to the ACTIVE (possibly
        # swapped) schedule, not the build-time one — a heal right
        # after a hot swap must not silently revert the swap
        if control is not None:
            return control.healed_weights(dead_mask)
        if hier_l:
            return healed_hierarchical_comm_weights(
                schedule, dead_mask, hier_l)
        return healed_comm_weights(schedule, dead_mask)

    dead = detector.dead_mask()
    if schedule and (dead.any() or control is not None):
        # the control plane's initial active plan may differ from the
        # carrier's own weights (``initial=``) — deliver it up front
        comm_weights = heal(dead)

    controller = None
    admit_fn = None
    _bootstrap = None
    if elastic is not None:
        if not schedule:
            raise ValueError(
                "run_resilient(elastic=...) needs schedule= — membership "
                "is a weight re-plan over the topology specs")
        if hier_l:
            raise ValueError(
                "run_resilient(elastic=...) does not drive a hierarchical "
                "step: the MembershipController anneals RANK-level "
                "weights while a hierarchical schedule is MACHINE-level. "
                "Drive membership yourself over the machine schedule "
                "(elastic.grown_comm_weights / MembershipController on "
                "the machine specs feed the step's comm_weights as data) "
                "or train flat.")
        # imported here, not at module top: bluefog_tpu_torch.elastic
        # imports resilience.healing, and this module loads as part of
        # the resilience package __init__
        from bluefog_tpu_torch.elastic import (MembershipController,
                                               bootstrap as _bootstrap)

        controller = MembershipController(
            schedule,
            bootstrap_rounds=elastic.bootstrap_rounds,
            quarantine_threshold=elastic.quarantine_threshold,
            detector=detector)
        controller.seed_dead(dead)
        if elastic.max_quarantine_steps < controller.bootstrap_rounds:
            raise ValueError(
                f"max_quarantine_steps ({elastic.max_quarantine_steps}) "
                "must cover the bootstrap anneal "
                f"({controller.bootstrap_rounds} rounds)")
        admit_fn = elastic.admit
        if admit_fn is None and fault_plan is not None:
            admit_fn = fault_plan.rejoinable_ranks
        if control is not None:
            # the controller renders weights over the plane's ACTIVE
            # plan (swap-aware) while keeping membership authority
            controller.reschedule(control.active_schedule())
        comm_weights = controller.comm_weights()

    events: List[ResilienceEvent] = []

    # the subset of loop events that are control DECISIONS (state
    # transitions with a cause), mirrored into the blackbox flight
    # recorder; high-rate telemetry kinds (skip, straggler, checkpoint)
    # stay out of the ring
    _decision_kinds = frozenset(
        ("rollback", "rank_dead", "rank_join_failed",
         "bad_window_unattributed"))

    def emit(kind: str, step: int, **detail):
        ev = ResilienceEvent(kind, step, detail)
        events.append(ev)
        if observe.enabled():
            observe.get_registry().counter(
                "bf_resilience_events_total",
                "resilience control-loop events", kind=kind).inc()
            observe.get_tracer().instant(f"resilience.{kind}",
                                         track="resilience")
        if kind in _decision_kinds:
            from bluefog_tpu_torch.observe import blackbox as _blackbox

            _blackbox.record_decision("resilience", kind, step=step,
                                      detail=detail or None)
        if on_event is not None:
            on_event(ev)

    def save(step: int):
        checkpointer.save(
            step, {"params": params, "opt_state": opt_state,
                   "step": step}, force=True, blocking=False)
        emit("checkpoint", step)

    like = {"params": params, "opt_state": opt_state, "step": 0}
    prev_flagged: set = set()
    total_skips = np.zeros(n, np.int64)
    last_loss: Optional[np.ndarray] = None
    consecutive_bad = 0
    n_rollbacks = 0
    # a pending promotion forces a checkpoint on the next clean step,
    # so restore_latest can normally never predate a promotion
    force_ckpt = False
    step = 0
    save(0)  # rollback anchor: the pristine initial state

    def own(mask):
        # the rows of a global [n] mask this process holds
        return np.asarray(mask, bool)[lo:hi]

    # rank -> step it was promoted at: a rollback demotes any rank
    # whose promotion the restored checkpoint does not contain
    promoted_at: dict = {}

    while step < steps:
        if controller is not None:
            # stamp the loop step so membership decisions (admit /
            # promote / kick / mark_dead) land at the right step in
            # the flight recorder's causal chains
            controller.current_step = step
        if controller is not None and admit_fn is not None:
            wanting = [int(r) for r in admit_fn(step)
                       if controller.is_dead(int(r))]
            if wanting:
                controller.admit(wanting)
                # mask only the NEWLY admitted ranks: an in-flight
                # joiner's rows are already mid-rebuild and must not be
                # touched again
                wm = np.zeros(n, bool)
                wm[wanting] = True
                if elastic.sanitize:
                    # admission hygiene, in place: a rank that died
                    # OUTSIDE the guard's frozen-finite invariant may
                    # carry garbage
                    _bootstrap.sanitize_rank_rows(params, own(wm))
                    _bootstrap.sanitize_rank_rows(opt_state, own(wm))
                if elastic.reset_opt_state:
                    # stale-but-finite optimizer moments pass the
                    # params-only promotion gate untouched; zeroing
                    # them makes quarantine rebuild the moments from
                    # fresh gradients instead
                    _bootstrap.zero_rank_rows(opt_state, own(wm))
                for r in wanting:
                    emit("rank_joining", step, rank=r)
        if controller is not None and controller.joining_ranks():
            # the anneal advances every quarantined round — fresh
            # weight DATA for the same step
            comm_weights = controller.comm_weights()
        batch = batch_fn(step)
        if fault_plan is not None:
            stall = fault_plan.stall_seconds(step)
            if stall > 0:
                sleep(stall)  # straggler injection: the stall watchdog /
                # BLUEFOG_OP_TIMEOUT layer owns this failure class
            batch = fault_plan.corrupt_batch(batch, step, ranks=ranks)
        t_step = time.monotonic()
        out = train_step(params, opt_state, batch, step, comm_weights)
        # a health-built step appends the HealthVector; the loop keys
        # on the guard outputs either way
        params, opt_state, loss, skipped = out[:4]
        # the one host transfer of the step (and its sync point): every
        # rank's skip flag and loss together
        flags = torch.stack([skipped.float(), loss.float()], dim=1)
        if gather is not None:
            flags = gather(flags)
        flags = flags.cpu().numpy()
        sk = flags[:, 0] != 0
        last_loss = flags[:, 1].copy()
        detector.observe(sk)
        total_skips += sk
        if sk.any() and observe.enabled():
            reg = observe.get_registry()
            for r in np.nonzero(sk)[0]:
                reg.counter("bf_resilience_skips_total",
                            "guarded-step skips (replays included)",
                            rank=int(r)).inc()
        wall = time.monotonic() - t_step
        if observe.enabled():
            observe.get_registry().histogram(
                "bf_step_wall_seconds", "train/engine step wall time",
                loop="train").observe(wall)
        if straggler is not None:
            times = (np.asarray(step_times_fn(step, wall), np.float64)
                     if step_times_fn is not None
                     else np.full(n, wall))
            newly = straggler.observe(times)
            # suspicion tracks the detector's CURRENT flags — a
            # recovered rank is withdrawn, but only OUR flags are
            # touched: suspicion other sources registered (heartbeats,
            # the operator) is not ours to clear
            flagged_now = set(straggler.flagged())
            withdrawn = prev_flagged - flagged_now
            if withdrawn:
                detector.clear_suspicion(sorted(withdrawn),
                                         source="straggler")
            detector.suspect(sorted(flagged_now), source="straggler")
            prev_flagged = flagged_now
            if newly:
                z = straggler.z_scores()
                emit("straggler", step, ranks=[int(r) for r in newly],
                     z=[float(z[r]) for r in newly])
        if controller is not None:
            joiners = controller.joining_ranks()
            if joiners:
                controller.tick()
                check_every = max(1, elastic.check_every)
                for r in joiners:
                    prog = controller.progress(r)
                    at_check = (prog >= controller.bootstrap_rounds
                                and (prog - controller.bootstrap_rounds)
                                % check_every == 0)
                    d = None
                    if at_check:
                        d = _bootstrap.disagreement(
                            params, r, controller.live_mask(),
                            backend=backend if gather is not None
                            else None)
                        if observe.enabled():
                            observe.get_registry().gauge(
                                "bf_elastic_disagreement",
                                "joiner bootstrap disagreement vs the "
                                "live mean", rank=r).set(float(d))
                        if d <= controller.quarantine_threshold:
                            controller.promote([r])
                            promoted_at[r] = step
                            force_ckpt = True
                            emit("rank_promoted", step, rank=r,
                                 disagreement=float(d), rounds=prog)
                            continue
                    # the deadline is enforced every tick, not only on
                    # check-cadence steps — with check_every > 1 a
                    # failed joiner must not linger past its quarantine
                    # budget waiting for the next measurement
                    if prog >= elastic.max_quarantine_steps:
                        detail = {"rank": r,
                                  "reason": "quarantine_expired"}
                        if d is not None:
                            detail["disagreement"] = float(d)
                        controller.kick([r])
                        emit("rank_join_failed", step, **detail)
                if controller.joining_ranks() != joiners:
                    comm_weights = controller.comm_weights()
        live_bad = detector.live_bad(sk)
        if live_bad:
            # only LIVE-rank skips are events: a declared-dead rank
            # skips every remaining step by design, and logging that
            # forever would grow the event list linearly in run length
            emit("skip", step, ranks=[int(r) for r in np.nonzero(sk)[0]])
        consecutive_bad = consecutive_bad + 1 if live_bad else 0
        step += 1

        if consecutive_bad >= guard.max_consecutive_bad:
            # Rollback is only useful when the badness is ATTRIBUTABLE:
            # a rank bad for the whole window is declared dead and
            # healed out, and restoring pre-poison state gives the
            # survivors a clean trajectory.  A window of overlapping
            # transients from DIFFERENT ranks has nothing to heal —
            # the skip guard already contained every one of them, and
            # a rollback would deterministically replay the identical
            # transients (batch_fn and the fault environment are
            # functions of the step index) in a futile loop.  Note the
            # window and keep training instead.
            # attribution is NUMERIC only (streak_suspects): an
            # externally-suspected straggler is slow, not poisonous —
            # killing it here would destroy healthy capacity and leave
            # the actual NaN source live
            newly = detector.streak_suspects(guard.max_consecutive_bad)
            if not newly:
                emit("bad_window_unattributed", step,
                     window=guard.max_consecutive_bad)
                consecutive_bad = 0
                continue
            if n_rollbacks >= guard.max_rollbacks:
                raise BluefogError(
                    f"run_resilient: giving up after {n_rollbacks} "
                    f"rollbacks (guard.max_rollbacks) with live ranks "
                    "still failing — the fault is not survivable by "
                    "skip/heal/rollback")
            detector.declare_dead(newly)
            dead = detector.dead_mask()
            for r in newly:
                emit("rank_dead", step, rank=r)
            if dead.all():
                raise BluefogError(
                    "run_resilient: every rank has been declared "
                    "dead — there is no surviving state to heal "
                    "around; the job must be restarted")
            # in place: the live tensors and optimizer take the saved
            # values, so the step keeps stepping the same objects
            state = checkpointer.restore_latest(like=like)
            restored_step = int(state["step"])
            if controller is not None:
                controller.current_step = step
                controller.mark_dead(newly)
                for r in newly:
                    promoted_at.pop(r, None)
                # in-flight joiners are invalidated too: the restored
                # checkpoint predates their bootstrap
                stranded = controller.joining_ranks()
                if stranded:
                    controller.kick(stranded)
                    for r in stranded:
                        emit("rank_join_failed", step, rank=r,
                             reason="rollback")
                # so is a rank PROMOTED after the restored checkpoint
                # (its promotion happened inside the bad window, where
                # checkpoints are refused): the restore rewinds its
                # rows to mid-bootstrap state the disagreement gate
                # never certified, so leaving it LIVE would mix
                # uncertified weight into the fleet.  Demote to DEAD —
                # the admission poll re-offers it for a fresh
                # quarantined bootstrap.  A checkpoint at step T holds
                # params after steps < T, so a promotion at step s is
                # contained only when s < restored_step.
                rewound = sorted(
                    r for r, s in promoted_at.items()
                    if s >= restored_step and controller.is_live(r))
                if rewound:
                    controller.mark_dead(rewound)
                    for r in rewound:
                        promoted_at.pop(r, None)
                        emit("rank_join_failed", step, rank=r,
                             reason="promotion_rolled_back")
                    dead = detector.dead_mask()
                    if dead.all():
                        raise BluefogError(
                            "run_resilient: every rank has been "
                            "declared dead — there is no surviving "
                            "state to heal around; the job must be "
                            "restarted")
                force_ckpt = False
                comm_weights = controller.comm_weights()
            elif schedule:
                comm_weights = heal(dead)
            backoff = min(
                guard.backoff_base * guard.backoff_factor ** n_rollbacks,
                guard.max_backoff)
            n_rollbacks += 1
            emit("rollback", step, restored_step=restored_step,
                 backoff=backoff, dead=[int(r) for r in np.nonzero(dead)[0]])
            step = restored_step
            consecutive_bad = 0
            detector.reset_streaks()
            if backoff > 0:
                sleep(backoff)
            continue

        if control is not None:
            # step boundary: the plane may hand back a swap (accepted
            # candidate), a probation verdict, or telemetry-window
            # transitions — re-deliver weights whenever the active
            # schedule changed hands
            acts = control.on_step(step, dead_mask=detector.dead_mask(),
                                   params=params)
            for kind, detail in acts:
                emit(kind, step, **detail)
            if any(k in ("topology_swap", "topology_rollback")
                   for k, _ in acts):
                if controller is not None:
                    controller.reschedule(control.active_schedule())
                    comm_weights = controller.comm_weights()
                else:
                    comm_weights = heal(detector.dead_mask())

        if (force_ckpt or (checkpoint_every > 0
                           and step % checkpoint_every == 0)) \
                and not live_bad:
            save(step)
            force_ckpt = False

    checkpointer.wait()
    return ResilientResult(
        params=params, opt_state=opt_state, step=step, last_loss=last_loss,
        total_skips=total_skips, n_rollbacks=n_rollbacks,
        dead_mask=detector.dead_mask(), events=events,
        membership=controller.states() if controller is not None else None)

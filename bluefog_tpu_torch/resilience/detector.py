"""Failure detection: numeric health + liveness heartbeats.

Port of ``bluefog_tpu/resilience/detector.py``: the detector is the JAX
package's host bookkeeping, copied; :func:`update_health` reads tensors,
and the heartbeats are the port's (``context._heartbeat``, beacons over
the ``torch.distributed`` job's key-value store).

Two independent failure signals, fused here:

* **Numeric health** — the guarded train step's isfinite reduce over
  (loss, update) surfaces as a rank-major ``skipped`` vector every step;
  :class:`FailureDetector` folds the per-step flags into per-rank
  *consecutive* and *total* skip counts.  A rank that skips ``k`` steps
  in a row is a death suspect — a transient NaN burst recovers its
  streak to zero, a dead rank never does.
* **Liveness heartbeats** — the beacons every process of a
  ``ProcessBackend`` job publishes (the stall watchdog reads them to
  *name* a hang).  ``heartbeat_dead_processes`` re-exposes that judgment
  for proactive health checks, and ``heartbeat_dead_ranks`` maps stale
  processes to the ranks they hold — the mask topology healing consumes.

The detector itself is pure host-side bookkeeping: it never touches the
device, so calling it every step costs nothing against the step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["FailureDetector", "update_health"]


def update_health(tree) -> np.ndarray:
    """Per-rank finiteness of a rank-major tree: entry ``r`` is True
    iff every inexact leaf's slice ``[r]`` is fully finite.  The eager
    counterpart of the guard's in-step health reduce — use it to audit
    params/updates outside a guarded step.  Leaves are tensors (on any
    device: one reduction each, one transfer at the end) or numpy
    arrays; an optimizer's state tensors count as leaves."""
    from bluefog_tpu_torch import _tree

    rows = []
    for _, leaf in _tree.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if not (leaf.is_floating_point() or leaf.is_complex()):
                continue
            if leaf.dim() < 1:
                raise ValueError(
                    "update_health needs rank-major leaves (leading rank "
                    f"axis); got a scalar leaf of dtype {leaf.dtype}")
            rows.append(torch.isfinite(
                leaf.reshape(leaf.shape[0], -1)).all(dim=1).cpu())
            continue
        if leaf is None:
            continue
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.inexact):
            continue
        if arr.ndim < 1:
            raise ValueError(
                "update_health needs rank-major leaves (leading rank "
                f"axis); got a scalar leaf of dtype {arr.dtype}")
        rows.append(torch.from_numpy(
            np.isfinite(arr.reshape(arr.shape[0], -1)).all(axis=1)))
    if not rows:
        raise ValueError("update_health: tree has no inexact leaves")
    ok = rows[0]
    for h in rows[1:]:
        ok = ok & h
    return ok.numpy()


class FailureDetector:
    """Per-rank failure bookkeeping over the guarded step's skip flags.

    ``observe`` one rank-major skip vector per step; ``suspects(k)``
    names ranks with >= k CONSECUTIVE skips that have not already been
    declared dead; ``declare_dead`` commits a verdict.  Death is not
    rescinded by recovery — a healed topology has no path back for a
    rank whose state silently diverged — but it IS reversible through
    the elastic membership lifecycle: ``readmit`` (called by
    ``MembershipController.promote`` once a rejoining rank's
    bootstrapped state has re-converged) clears the verdict along with
    the latched streak/suspicion that would instantly re-excise the
    rank.  ``dead_mask`` is the boolean mask topology healing takes."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.size = size
        self._consecutive = np.zeros(size, np.int64)
        self._total = np.zeros(size, np.int64)
        self._dead = np.zeros(size, bool)
        # rank -> the set of SOURCES currently suspecting it: several
        # independent monitors (straggler gossip, heartbeats, an
        # operator) may suspect the same rank, and one source clearing
        # its claim must not erase the others'
        self._external: Dict[int, set] = {}

    # ------------------------------------------------------------- #
    # numeric health
    # ------------------------------------------------------------- #
    def observe(self, skipped) -> None:
        """Fold one step's rank-major skip flags into the counters."""
        sk = np.asarray(skipped).reshape(-1).astype(bool)
        if sk.shape[0] != self.size:
            raise ValueError(
                f"skip vector of length {sk.shape[0]} does not match "
                f"world size {self.size}")
        self._total += sk
        self._consecutive = np.where(sk, self._consecutive + 1, 0)

    def consecutive_bad(self) -> np.ndarray:
        return self._consecutive.copy()

    def total_skips(self) -> np.ndarray:
        return self._total.copy()

    def streak_suspects(self, k: int) -> List[int]:
        """Live ranks with >= k consecutive skipped steps — the purely
        NUMERIC evidence.  This is what the rollback loop's death
        declaration keys on: a straggler flag (external suspicion) must
        never convert a NaN window into an execution of a
        healthy-but-slow rank."""
        return [int(r) for r in
                np.nonzero((self._consecutive >= k) & ~self._dead)[0]]

    def suspects(self, k: int) -> List[int]:
        """The fused suspicion view: live ranks with >= k consecutive
        skipped steps, plus any EXTERNALLY suspected live ranks
        (``suspect`` — the fleet telemetry layer's straggler flags land
        here).  For monitoring/policy; death attribution uses
        :meth:`streak_suspects`."""
        out = set(self.streak_suspects(k))
        out |= {r for r, srcs in self._external.items()
                if srcs and not self._dead[r]}
        return sorted(out)

    def suspect(self, ranks: Sequence[int],
                source: str = "external") -> None:
        """Register external suspicion from ``source`` (e.g.
        ``"straggler"`` for the gossiped flags of
        ``observe.fleet.StragglerDetector``); already-dead ranks are
        ignored.  A rank stays suspected while ANY source claims it."""
        for r in ranks:
            if not 0 <= r < self.size:
                raise ValueError(f"rank {r} outside world {self.size}")
            if not self._dead[r]:
                self._external.setdefault(int(r), set()).add(source)

    def clear_suspicion(self, ranks: Optional[Sequence[int]] = None,
                        source: Optional[str] = None) -> None:
        """Withdraw external suspicion: ``source``'s claims only (every
        source's with ``source=None``), on ``ranks`` (all ranks with
        ``ranks=None``).  A rank another source still suspects stays
        suspected — one monitor's recovery never erases another's
        standing claim."""
        targets = (list(self._external) if ranks is None
                   else [int(r) for r in ranks])
        for r in targets:
            srcs = self._external.get(r)
            if srcs is None:
                continue
            if source is None:
                srcs.clear()
            else:
                srcs.discard(source)
            if not srcs:
                self._external.pop(r, None)

    def external_suspects(self) -> List[int]:
        return sorted(r for r, srcs in self._external.items()
                      if srcs and not self._dead[r])

    def declare_dead(self, ranks: Sequence[int]) -> None:
        for r in ranks:
            if not 0 <= r < self.size:
                raise ValueError(f"rank {r} outside world {self.size}")
            self._dead[r] = True

    def readmit(self, ranks: Sequence[int]) -> None:
        """Reverse a death verdict for ranks the elastic membership
        lifecycle has re-bootstrapped (``MembershipController.promote``
        calls this once quarantine disagreement clears the threshold).

        Clearing the dead flag alone would NOT be enough: the
        consecutive-skip streak kept counting while the rank was dead
        (``observe`` has no dead special-case) and external suspicion
        latches until its source withdraws it — either one would make
        ``suspects()`` re-excise the rank on its first live step.  So
        readmission also zeroes the streak and drops every source's
        external claim.  ``total_skips`` is history, not suspicion, and
        is kept."""
        for r in ranks:
            if not 0 <= r < self.size:
                raise ValueError(f"rank {r} outside world {self.size}")
            if not self._dead[r]:
                raise ValueError(
                    f"rank {r} is not dead — nothing to readmit")
        for r in ranks:
            r = int(r)
            self._dead[r] = False
            self._consecutive[r] = 0
            self._external.pop(r, None)

    def dead_mask(self) -> np.ndarray:
        return self._dead.copy()

    def live_bad(self, skipped) -> bool:
        """Did any NOT-yet-declared-dead rank skip this step?  (Dead
        ranks skip forever by design — only live skips should count
        toward a rollback trigger.)"""
        sk = np.asarray(skipped).reshape(-1).astype(bool)
        return bool((sk & ~self._dead).any())

    def reset_streaks(self) -> None:
        """Clear the consecutive counters (after a rollback: the
        restored state re-earns its health)."""
        self._consecutive[:] = 0

    # ------------------------------------------------------------- #
    # liveness heartbeats
    # ------------------------------------------------------------- #
    @staticmethod
    def heartbeat_dead_processes(threshold: float) -> List[int]:
        """Processes whose liveness heartbeat has not advanced for
        ``threshold`` seconds (empty when liveness cannot be determined
        — one process / no key-value store).  Thin re-export of the
        beacon judgment the stall watchdog uses
        (``context._heartbeat``)."""
        from bluefog_tpu_torch.context import _heartbeat

        return _heartbeat.stale_processes(threshold)

    @staticmethod
    def heartbeat_dead_ranks(threshold: float) -> List[int]:
        """Ranks held by heartbeat-stale processes — the rank mask a
        healed topology excises (process ``p`` of a ``ProcessBackend``
        holds ranks ``p*k .. p*k + k - 1``).  Requires an initialized
        context; empty when liveness cannot be determined."""
        from bluefog_tpu_torch import context as ctx_mod

        stale = FailureDetector.heartbeat_dead_processes(threshold)
        if not stale or not ctx_mod.is_initialized():
            return []
        backend = ctx_mod.get_context().backend
        stale_set = set(stale)
        return [r for r in range(backend.size)
                if r // backend.n_local in stale_set]

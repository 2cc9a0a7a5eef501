"""Joiner bootstrap: state sync by pulled neighbor averaging only.

Port of ``bluefog_tpu/elastic/bootstrap.py``: the weight tables are the
JAX package's numpy, copied (byte-equal); the row helpers act on the
port's tensors IN PLACE, since its train step holds its state in place
(the optimizer keeps stepping the same tensors).

A rank rejoining the fleet must recover the live consensus without a
global broadcast — broadcast is exactly the centralized primitive the
paper's decentralized premise avoids, and it would need a program the
fleet never runs.  Instead the joiner syncs through the
SAME mixing rounds everyone runs, as pure weight data:

* the joiner's row pulls from its LIVE in-neighbors with its
  self-weight annealed ``0 -> w`` (its pristine self-weight) over
  ``rounds`` steps.  At anneal fraction 0 the first pull REPLACES the
  joiner's stale state with a weighted average of live neighbors (its
  own value enters with weight 0 — sound because the guard froze it
  finite, and ``0 * finite == 0``); by fraction 1 the row is the
  pristine row (rescaled over the live in-mass if some in-neighbors
  are still dead) and the joiner mixes like any live rank;
* live receivers keep their HEALED (zero) weights for the joiner for
  the whole quarantine — a half-bootstrapped value never leaks into
  the fleet.  Promotion flips those rows via
  :func:`~bluefog_tpu_torch.elastic.membership.grow_weights`.

Both comm modes are covered by the same schedule: an ATC step pulls
exactly (the joiner's combine output IS the neighbor average), a CTA
step pulls then applies one local finite-gradient update — either way
the disagreement gate below decides promotion, not the mode.

Every row emitted here sums to 1 exactly in the row-stochastic
tolerance sense: the anneal distributes ``1 - theta`` proportionally
over the live in-edges, so iterated averaging keeps contracting while
the joiner converges.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import numpy as np
import torch

from bluefog_tpu_torch import _tree
from bluefog_tpu_torch.resilience.healing import heal_weights
from bluefog_tpu_torch.topology.spec import (
    DynamicTopology, Topology, self_weights_of as _self_weights_of)

CommSpec = Union[Topology, DynamicTopology]

__all__ = [
    "anneal_fraction",
    "bootstrap_weights",
    "bootstrap_comm_weights",
    "disagreement",
    "sanitize_rank_rows",
    "zero_rank_rows",
]


def anneal_fraction(progress: int, rounds: int) -> float:
    """Anneal fraction after ``progress`` quarantined mixing rounds:
    0 at admission (first pull is a pure neighbor average), 1 from
    ``rounds`` on (the joiner's row is pristine, it just isn't read
    yet)."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if progress < 0:
        raise ValueError(f"progress must be >= 0, got {progress}")
    return min(float(progress) / float(rounds), 1.0)


def bootstrap_weights(spec: CommSpec, live_mask,
                      anneal: Mapping[int, float]) -> tuple:
    """One round's ``(class_weights [n_classes, n], self_weights [n])``
    float64 tables under quarantine: ranks in ``anneal`` (joining rank
    -> anneal fraction in [0, 1]) pull from their LIVE in-neighbors
    with self-weight ``theta = fraction * w_pristine``; everyone NOT
    live and not joining is dead; live rows are plain
    :func:`healing.heal_weights` rows around the whole non-live set
    (joiners included — quarantine means nobody reads them).

    With an empty ``anneal`` this IS ``heal_weights(spec, ~live)`` —
    the controller uses it as the single render path for both steady
    and bootstrapping states.

    A joiner with no live in-neighbor this round freezes (self-weight
    1.0): a one-peer schedule reaches it on another round."""
    n = spec.size
    live = np.asarray(live_mask, bool).reshape(-1)
    if live.shape[0] != n:
        raise ValueError(
            f"live mask of length {live.shape[0]} does not match "
            f"topology size {n}")
    joiners: Dict[int, float] = {}
    for r, f in anneal.items():
        r = int(r)
        if not 0 <= r < n:
            raise ValueError(f"rank {r} outside topology of size {n}")
        if live[r]:
            raise ValueError(
                f"rank {r} is live — a live rank cannot be bootstrapping")
        if not 0.0 <= float(f) <= 1.0:
            raise ValueError(
                f"anneal fraction for rank {r} must be in [0, 1], "
                f"got {f}")
        joiners[r] = float(f)
    # receivers' view: everything not LIVE is excised (quarantine)
    cw, sw = heal_weights(spec, ~live)
    if not joiners:
        return cw, sw
    classes = spec.shift_classes
    cw0 = (np.array([cls.recv_weights for cls in classes], np.float64)
           if classes else np.zeros((0, n), np.float64))
    sw0 = np.asarray(_self_weights_of(spec), np.float64)
    for j, frac in joiners.items():
        pulls = []
        mass = 0.0
        for c, cls in enumerate(classes):
            w = cw0[c, j]
            if w == 0.0:
                continue
            src = (j - cls.shift) % n
            if live[src]:
                pulls.append((c, w))
                mass += w
        if mass <= 0.0:
            sw[j] = 1.0  # no live in-neighbor this round: freeze
            continue
        theta = frac * sw0[j]
        scale = (1.0 - theta) / mass
        for c, w in pulls:
            cw[c, j] = w * scale
        sw[j] = theta
    return cw, sw


def bootstrap_comm_weights(specs: Sequence[CommSpec], live_mask,
                           anneal: Mapping[int, float]) -> tuple:
    """The quarantine round as runtime data — one float64 tensor
    ``(class_weights, self_weights)`` pair per round, same structure as
    ``optim.functional.comm_weight_inputs(specs)``, so the anneal is a
    per-step weight-data change through the one guarded step."""
    out = []
    for s in specs:
        cw, sw = bootstrap_weights(s, live_mask, anneal)
        out.append((torch.from_numpy(cw), torch.from_numpy(sw)))
    return tuple(out)


def _rank_rows(tree, n: int, what: str):
    """The inexact rank-major tensor leaves of ``tree`` (params dicts,
    optimizers and their tuples; numpy leaves become tensors), each
    checked to lead with ``n`` rows.  Integer leaves and counters (Adam's
    per-rank ``step``, what optax keeps as an int count) are left out."""
    out = []
    for path, leaf in _tree.leaves(tree):
        if path[-3:-2] == ("state",) and path[-1] == "step":
            continue  # an optimizer's count
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(leaf)
        if not isinstance(leaf, torch.Tensor) or not (
                leaf.is_floating_point() or leaf.is_complex()):
            continue
        if leaf.dim() < 1 or leaf.shape[0] != n:
            raise ValueError(
                f"{what} needs rank-major leaves with leading dim {n}, "
                f"got shape {tuple(leaf.shape)}")
        out.append(leaf)
    return out


def disagreement(tree, rank: int, live_mask, backend=None) -> float:
    """Normalized disagreement of ``rank``'s state rows against the
    LIVE ranks — the promotion gate.  The L2 distance of the rank's
    rows from the live mean, in units of the live ranks' own maximum
    deviation from that mean: decentralized training never drives the
    replicas to exact agreement mid-run (they intentionally differ by
    the consensus distance), so an absolute threshold would either
    never fire or fire vacuously.  A value <= 1 means the joiner sits
    INSIDE the live consensus cloud — indistinguishable from a replica
    that never left — which is what ``quarantine_threshold`` (default
    1.0) gates on.  A tiny relative floor keeps the ratio meaningful
    when the live ranks are at exact consensus (pure-mixing
    simulations: both numerator and denominator at the ~1e-16 floor).

    Computed in float64 on the leaves' device with one transfer at the
    end; called once per check cadence, never inside the step.
    ``backend``: a ``ProcessBackend`` whose processes each hold some
    rows — every process calls this at the same step, and the rows are
    gathered first.  Non-finite joiner entries count as infinite
    disagreement (never promote garbage)."""
    live = np.asarray(live_mask, bool).reshape(-1)
    if not live.any():
        raise ValueError("no live ranks to compare against")
    n = live.shape[0]
    local = n if backend is None else backend.n_local
    leaves = _rank_rows(tree, local, "disagreement")
    if not leaves:
        raise ValueError("disagreement: tree has no inexact leaves")
    dev = leaves[0].device
    idx = torch.as_tensor(np.flatnonzero(live), device=dev)
    num = torch.zeros((), dtype=torch.float64, device=dev)
    scale2 = torch.zeros((), dtype=torch.float64, device=dev)
    live_dev2 = torch.zeros(len(idx), dtype=torch.float64, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    for leaf in leaves:
        if backend is not None:
            leaf = backend.gather_ranks(leaf)
        mine = leaf[rank].reshape(-1).to(torch.float64)
        bad = bad | ~torch.isfinite(mine).all()
        rows = leaf.index_select(0, idx.to(leaf.device)).reshape(
            len(idx), -1).to(torch.float64)
        ref = rows.mean(dim=0)
        num = num + (mine - ref).square().sum()
        live_dev2 = live_dev2 + (rows - ref).square().sum(dim=1)
        scale2 = scale2 + ref.square().sum()
    num, scale2, live_dev2, bad = (
        t.cpu() for t in (num, scale2, live_dev2, bad))
    if bool(bad):
        return float("inf")
    denom = float(np.sqrt(float(live_dev2.max()))) + 1e-9 * float(
        np.sqrt(float(scale2))) + 1e-300
    return float(np.sqrt(float(num)) / denom)


def sanitize_rank_rows(tree, rank_mask):
    """Zero every non-finite entry on the masked ranks' rows of a
    rank-major tree, IN PLACE (params dicts, optimizers' state tensors,
    the tuples that carry them), and return the tree — admission
    hygiene for state that died OUTSIDE the guard's frozen-finite
    invariant (a re-attached host's memory is not certified by
    anything).  Finite values are left as they are; with anneal fraction
    0 the first pull overwrites the row anyway, this just keeps ``0 *
    x`` well-defined on the way.  ``rank_mask`` has one entry per row the
    tree holds (a process's own rows under ``ProcessBackend``)."""
    mask = np.asarray(rank_mask, bool).reshape(-1)
    if not mask.any():
        return tree
    with torch.no_grad():
        for leaf in _rank_rows(tree, mask.shape[0], "sanitize_rank_rows"):
            idx = torch.as_tensor(np.flatnonzero(mask), device=leaf.device)
            rows = leaf.index_select(0, idx)
            leaf.index_copy_(0, idx, torch.where(
                torch.isfinite(rows), rows, torch.zeros_like(rows)))
    return tree


def zero_rank_rows(tree, rank_mask):
    """Zero the masked ranks' rows of every inexact rank-major leaf, IN
    PLACE, and return the tree — admission hygiene for OPTIMIZER state.
    A rejoining rank's moments are finite (the guard froze them) but
    STALE: they describe the gradient field as of the preemption, and
    the promotion gate measures params only, so
    :func:`sanitize_rank_rows` would wave them through untouched.
    Zeroing the rows at admission makes quarantine rebuild the moments
    from fresh gradients, so a promoted rank's first live updates are
    steered by current curvature, not pre-preemption history.  Integer
    leaves and step counters (Adam's per-rank ``step``, an int count in
    optax) are left alone."""
    mask = np.asarray(rank_mask, bool).reshape(-1)
    if not mask.any():
        return tree
    with torch.no_grad():
        for leaf in _rank_rows(tree, mask.shape[0], "zero_rank_rows"):
            idx = torch.as_tensor(np.flatnonzero(mask), device=leaf.device)
            leaf.index_fill_(0, idx, 0)
    return tree

"""Topology healing: re-plan the mixing weights around dead ranks.

Port of ``bluefog_tpu/resilience/healing.py``: the heal arithmetic is
the JAX package's numpy, copied, so its tables are byte-equal to JAX's;
:func:`healed_comm_weights` hands them over as float64 torch tensors
shaped like ``optim.functional.comm_weight_inputs`` (JAX returns jnp
arrays).

A dead rank silently breaks the row-stochasticity of the mixing matrix:
its in-edges deliver stale (or garbage) payloads that still carry
weight, so every neighbor's combine drifts off the consensus manifold.
Healing treats rank loss as a RE-PLANNING problem: the edge STRUCTURE
(which permutes run) never changes; the weights are runtime data.

The heal rule, per receiving rank ``dst``:

* every in-edge from a dead ``src`` is zeroed and its weight mass is
  transferred to ``dst``'s self-weight — row sums are preserved
  EXACTLY (no renormalization error), so the healed matrix stays
  row-stochastic and iterated averaging over the surviving ranks still
  contracts to their consensus;
* a dead ``dst`` keeps self-weight 1.0 and no in-weights: its state is
  frozen in place and, with its out-edges zeroed everywhere, it is
  unreachable — excised without touching the step.

The zero-weight edges still transfer (the reference also ships
scaled-by-zero payloads rather than skipping sends), which is sound
because the skip guard keeps every rank's params finite — 0 * finite ==
0.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from bluefog_tpu_torch.topology.spec import (
    DynamicTopology, Topology, self_weights_of as _self_weights_of)

CommSpec = Union[Topology, DynamicTopology]

# This module legitimately constructs weight tables from scratch: the
# analysis lint's weight-matrix-bypass rule treats it as an authority
# (everywhere else, tables must come from the shared helpers here).
_WEIGHT_AUTHORITY = True

__all__ = [
    "mixing_matrix",
    "mixing_matrix_from_weights",
    "row_sums",
    "is_row_stochastic",
    "heal_weights",
    "heal_spec",
    "healed_comm_weights",
    "machine_dead_mask",
    "healed_hierarchical_comm_weights",
    "consensus_simulation",
]


def mixing_matrix(spec: CommSpec) -> np.ndarray:
    """The round's mixing matrix M, RECEIVER-major: one round of
    neighbor averaging is ``x_new = M @ x`` with
    ``M[dst, src]`` the weight dst applies to src's value and
    ``M[dst, dst]`` the self weight.  (Note this is the transpose of
    ``Topology.weights``' sender-major convention.)"""
    n = spec.size
    M = np.zeros((n, n), np.float64)
    M[np.arange(n), np.arange(n)] = np.asarray(_self_weights_of(spec),
                                               np.float64)
    for cls in spec.shift_classes:
        for (src, dst) in cls.perm:
            if cls.recv_weights[dst] != 0.0:
                M[dst, src] += cls.recv_weights[dst]
    return M


def mixing_matrix_from_weights(spec: CommSpec, class_weights,
                               self_weights) -> np.ndarray:
    """The receiver-major mixing matrix a ``(class_weights [n_classes,
    n], self_weights [n])`` table pair induces over ``spec``'s edge
    structure — the numpy view of exactly what a guarded step does
    with re-planned weight DATA (healed, grown, or bootstrap-annealed),
    for simulation and row-sum audits."""
    n = spec.size
    cw = np.asarray(class_weights, np.float64)
    sw = np.asarray(self_weights, np.float64).reshape(-1)
    classes = spec.shift_classes
    if cw.shape != (len(classes), n) or sw.shape[0] != n:
        raise ValueError(
            f"weight tables of shapes {cw.shape}/{sw.shape} do not "
            f"match {len(classes)} classes over size {n}")
    M = np.zeros((n, n), np.float64)
    M[np.arange(n), np.arange(n)] = sw
    for c, cls in enumerate(classes):
        for (src, dst) in cls.perm:
            if cw[c, dst] != 0.0:
                M[dst, src] += cw[c, dst]
    return M


def row_sums(spec: CommSpec) -> np.ndarray:
    return mixing_matrix(spec).sum(axis=1)


def is_row_stochastic(spec: CommSpec, tol: float = 1e-9) -> bool:
    """Every rank's combine weights (self + in-edges) sum to 1 — the
    invariant that makes iterated neighbor averaging consensus-
    preserving, and the one a dead rank breaks until healed."""
    return bool(np.all(np.abs(row_sums(spec) - 1.0) <= tol))


def heal_weights(spec: CommSpec, dead_mask) -> tuple:
    """Healed ``(class_weights [n_classes, n], self_weights [n])``
    float64 arrays over ``spec``'s OWN shift classes (same shapes as the
    unhealed ``collectives.class_recv_weights`` / ``self_weight_vector``
    tables — shape-stability is the contract).

    Dead srcs' weight mass moves to the receiver's self weight (exact
    row-sum preservation); dead receivers get self weight 1.0 and no
    in-weights."""
    n = spec.size
    dead = np.asarray(dead_mask, bool).reshape(-1)
    if dead.shape[0] != n:
        raise ValueError(
            f"dead mask of length {dead.shape[0]} does not match "
            f"topology size {n}")
    classes = spec.shift_classes
    cw = (np.array([cls.recv_weights for cls in classes], np.float64)
          if classes else np.zeros((0, n), np.float64))
    sw = np.asarray(_self_weights_of(spec), np.float64).copy()
    for c, cls in enumerate(classes):
        for dst in range(n):
            w = cw[c, dst]
            if w == 0.0:
                continue
            src = (dst - cls.shift) % n
            if dead[dst]:
                cw[c, dst] = 0.0
            elif dead[src]:
                sw[dst] += w
                cw[c, dst] = 0.0
    sw[dead] = 1.0
    return cw, sw


def heal_spec(spec: CommSpec, dead_mask) -> CommSpec:
    """A standalone healed spec of the same type (for eager ops and
    simulation).  A DynamicTopology keeps its edge tuple — dead edges
    stay DECLARED at weight 0.0, preserving the shift-class structure
    (and thus the step's exchanges) exactly; a Topology is rebuilt from
    the healed weight matrix (zero edges drop — fine for an eager spec,
    but data delivery into a guarded step must go through
    :func:`healed_comm_weights` instead)."""
    cw, sw = heal_weights(spec, dead_mask)
    n = spec.size
    if isinstance(spec, DynamicTopology):
        healed = {}
        classes = spec.shift_classes
        by_edge = {}
        for c, cls in enumerate(classes):
            for (src, dst) in cls.perm:
                by_edge[(src, dst)] = cw[c, dst]
        vals = tuple(float(by_edge.get(e, 0.0)) for e in spec.edges)
        return DynamicTopology(n, spec.edges, vals,
                               tuple(float(w) for w in sw))
    W = np.zeros((n, n), np.float64)
    for c, cls in enumerate(spec.shift_classes):
        for (src, dst) in cls.perm:
            W[src, dst] += cw[c, dst]
    W[np.arange(n), np.arange(n)] = sw
    return Topology.from_weight_matrix(W)


# the last (n_specs, dead-index tuple) recorded into the flight
# recorder: healed_comm_weights runs on EVERY weight render, so the
# healing plane records a decision only when the excised set actually
# changes — a re-render of the same heal is data delivery, not a new
# decision
_last_healed_recorded = None


def healed_comm_weights(specs: Sequence[CommSpec], dead_mask) -> tuple:
    """The healed schedule as runtime DATA: one ``(class_weights,
    self_weights)`` float64 tensor pair per round, structurally identical
    to ``optim.functional.comm_weight_inputs(specs)`` — pass it as a
    guarded train step's ``comm_weights`` and the dead ranks are excised
    with the same step."""
    global _last_healed_recorded
    dead = np.asarray(dead_mask, bool).reshape(-1)
    key = (len(specs), tuple(int(i) for i in np.flatnonzero(dead)))
    if key != _last_healed_recorded and (
            dead.any() or _last_healed_recorded is not None):
        _last_healed_recorded = key
        from bluefog_tpu_torch.observe import blackbox as _blackbox

        _blackbox.record_decision(
            "healing", "replan", step=-1,
            telemetry={"dead": list(key[1]), "rounds": len(specs),
                       "size": int(dead.shape[0])})
    out = []
    for s in specs:
        cw, sw = heal_weights(s, dead_mask)
        out.append((torch.from_numpy(cw), torch.from_numpy(sw)))
    return tuple(out)


def machine_dead_mask(dead_mask, local_size: int) -> np.ndarray:
    """Collapse a RANK-level dead mask to the MACHINE level: a machine is
    dead when ANY of its ``local_size`` ranks is dead.

    Under the hierarchical exchange the machine is the failure domain:
    the intra-machine reduce is an exact grouped psum whose program
    cannot skip a member, so a machine containing a dead rank has a
    polluted mean and is excised from the inter-machine mixing as a
    unit (conservative — its surviving ranks keep their machine-local
    consensus and rejoin with the machine)."""
    from bluefog_tpu_torch.parallel.collectives import (
        validate_machine_decomposition)

    dead = np.asarray(dead_mask, bool).reshape(-1)
    validate_machine_decomposition(dead.shape[0], local_size)
    return dead.reshape(-1, int(local_size)).any(axis=1)


def healed_hierarchical_comm_weights(machine_specs: Sequence[CommSpec],
                                     dead_mask, local_size: int) -> tuple:
    """Healed MACHINE-level weight tables from a RANK-level dead mask —
    the hierarchical train step's ``comm_weights`` delivery.  The rank
    mask collapses through :func:`machine_dead_mask` and the machine
    schedule heals exactly like a flat one; the tables are machine-sized
    (``[n_classes, n_machines]`` / ``[n_machines]``) so dead ranks and
    joiners swap in as pure data, same contract as
    :func:`healed_comm_weights`."""
    return healed_comm_weights(machine_specs,
                               machine_dead_mask(dead_mask, local_size))


def consensus_simulation(specs: Sequence[CommSpec], rounds: int,
                         dim: int = 32, seed: int = 0,
                         dead_mask=None, weights=None) -> np.ndarray:
    """Seeded consensus-distance trace of iterated mixing (the
    wire_quant_consensus harness's pure-numpy machinery, pointed at
    healing): iterate ``x <- M_t @ x`` over the schedule and report,
    per round, the max deviation of the LIVE ranks from their own
    running mean.

    Dead ranks model a real failure: their rows are FROZEN (a dead
    device computes nothing) while neighbors keep reading whatever the
    schedule's weights say.  Under a healed schedule those weights are
    zero and the survivors contract to their own consensus; under an
    UNHEALED schedule the frozen rows act as disagreeing anchors that
    hold the live ranks apart — the stalled floor this function makes
    measurable.

    ``weights`` overrides the specs' own tables with re-planned
    per-round ``(class_weights, self_weights)`` pairs (one per spec,
    cycled) — the same data a guarded step would be fed, so healed,
    grown, and bootstrap-annealed schedules simulate through the one
    code path (:func:`mixing_matrix_from_weights`)."""
    n = specs[0].size
    dead = (np.zeros(n, bool) if dead_mask is None
            else np.asarray(dead_mask, bool).reshape(-1))
    live = ~dead
    if not live.any():
        raise ValueError("no live ranks to simulate")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim))
    if weights is None:
        mats = [mixing_matrix(s) for s in specs]
    else:
        if len(weights) != len(specs):
            raise ValueError(
                f"{len(weights)} weight pairs against {len(specs)} specs")
        mats = [mixing_matrix_from_weights(s, cw, sw)
                for s, (cw, sw) in zip(specs, weights)]
    trace = np.zeros(rounds)
    for t in range(rounds):
        new = mats[t % len(mats)] @ x
        new[dead] = x[dead]
        x = new
        xbar = x[live].mean(axis=0)
        trace[t] = np.abs(x[live] - xbar).max()
    return trace

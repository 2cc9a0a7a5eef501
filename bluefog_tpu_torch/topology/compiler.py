"""Topology compiler: telemetry-fed synthesis of mixing schedules scored
against a pod cost model.

Port of ``bluefog_tpu/topology/compiler.py``, its code copied whole: only
its imports name the port's modules (``topology.spec``, ``topology.torus``,
``topology.dynamic``, ``topology.graphs``, ``observe.fleet``), so its
outputs are the JAX package's byte for byte.

The mixing topology was hand-picked from a fixed menu (ring / exp2 /
torus-exp2, machine-scored once by ``default_pod_schedule``) even though
the repo measures everything needed to do better: ``topology/torus.py``
machine-scores schedules (congestion x rounds-to-consensus) and
``observe/fleet.py`` records real per-edge traffic as
``bf_edge_bytes_total``.  This module closes the loop:

* :class:`PodSpec` generalizes ``TorusSpec``'s congestion model to a
  **heterogeneous** pod: ``machines x chips_per_machine``, where the
  machine axis rides expensive DCN links and the chip axis cheap ICI
  links, plus optional per-link cost multipliers **calibrated from a
  fleet-telemetry traffic snapshot** (``PodSpec.calibrated`` /
  ``PodSpec.from_telemetry`` route measured ``bf_edge_bytes_total``
  bytes onto the physical links and charge busy links more).  One
  round's cost is ``max over links of load(link) * cost(link)`` — the
  wall-time multiplier of the link-limited model; homogeneous costs
  recover ``round_congestion`` exactly.

* :func:`compile_topology` **searches** the space of weighted
  one-peer/multi-shift schedules, TACCL-style (sketch-guided: the
  :class:`Sketch` names candidate shift families, a period bound and a
  degree bound) with Swing-style short-cutting (arXiv:2401.09356 —
  bidirectional ``+-s`` rounds and direction-flip / shift+-1
  mutations).  Search = seeded candidate enumeration over
  circulant/torus shift families + hill-climbing mutations + **weight
  optimization per candidate** (per-round self-weight on a grid,
  row-stochastic by construction, spectral-gap objective), scored by
  ``cost_to_consensus`` extended with the heterogeneous link costs and
  pruned with the ``consensus_contraction`` bound
  ``cost >= sum(round costs)`` (rounds-to-consensus is never below one
  period), so n=128 synthesis finishes in seconds.

  Every candidate family is circulant — per torus axis or in rank
  space — so one period's contraction is evaluated in closed form over
  the frequency grid (the mixing matrices commute and are jointly
  diagonalized by the DFT; the generic ``consensus_contraction`` on
  the materialized matrices agrees to machine precision, which the
  tests assert).  The bidirectional family is why the compiler beats
  the menu: a ``+-s`` round with self-weight theta has the REAL
  frequency response ``theta + (1-theta) cos(2 pi s j / L)``, so a
  **zero-self-weight** round kills whole conjugate frequency pairs at
  congestion 1 where one-directional exp2 pays congestion ``s`` — e.g.
  on an (8, 16) pod the synthesized schedule reaches the exact average
  at total link cost 24 vs torus-exp2's 31 (DCN 4x ICI), and 12 vs 16
  even on a homogeneous torus.

* The winner is emitted as ordinary :class:`DynamicTopology` rounds
  (:class:`CompiledTopology`), which plug into
  ``optim.functional.build_train_step(schedule=...)`` unchanged, plus
  a wire-cost prediction (``predicted_collectives``) the HLO tests
  hold the real lowering to: one ``lax.ppermute`` per materialized
  shift class per round, carrying exactly the payload bytes.

Offline CLI::

    python -m bluefog_tpu_torch.topology.compiler --machines 4 --chips 8 --emit json

No jax imports: pure host-side synthesis (trace-time / CPU-only safe).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.topology.spec import DynamicTopology
from bluefog_tpu_torch.topology.torus import (
    TorusSpec,
    consensus_contraction,
    link_loads,
    rounds_from_contraction,
    schedule_congestion,
    torus_one_peer_schedule,
)

__all__ = [
    "PodSpec",
    "Sketch",
    "Candidate",
    "CandidateRound",
    "CompiledTopology",
    "CompiledHierarchicalTopology",
    "CompiledAllToAll",
    "candidate_contraction",
    "expand_machine_pairs",
    "materialize",
    "menu_schedules",
    "compile_topology",
    "compile_all_to_all",
    "main",
]

LinkKey = Tuple[Tuple[int, ...], int, int]


def _score_fields(congestions: Sequence[float], costs: Sequence[float],
                  sigma: float, eps: float) -> Dict[str, float]:
    """The ONE score-dict schema: built here whether the inputs come
    from the search's cached per-round metrics (``evaluate``) or the
    generic matrix machinery (:meth:`PodSpec.score`), so every
    ``CompiledTopology.report`` entry reads uniformly."""
    period = len(costs)
    r2c = rounds_from_contraction(sigma, period, eps)
    mean_cost = float(np.mean(costs)) if costs else 0.0
    return {
        "rounds_per_period": float(period),
        "mean_congestion": (float(np.mean(congestions))
                            if congestions else 0.0),
        "max_congestion": (float(np.max(congestions))
                           if congestions else 0.0),
        "mean_round_cost": mean_cost,
        "max_round_cost": float(np.max(costs)) if costs else 0.0,
        "rounds_to_consensus": r2c,
        "cost_to_consensus": mean_cost * r2c,
        "exact_average_per_period": float(sigma < 1e-12),
    }


# ------------------------------------------------------------------ #
# the pod cost model
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class PodSpec:
    """Physical interconnect of a pod: ``machines`` hosts in a ring of
    DCN links (torus axis 0), each holding ``chips_per_machine`` chips
    in a ring of ICI links (torus axis 1).  Rank r sits at the
    row-major coordinate, the ``create_device_mesh`` order —
    ``TorusSpec((machines, chips))`` with per-axis link costs.

    ``ici_cost`` / ``dcn_cost`` are relative time units per unit
    payload per link (the reciprocal-bandwidth ratio; the defaults say
    a DCN hop is 4x an ICI hop).  ``link_cost_overrides`` multiply
    individual links — the CALIBRATION hook: :meth:`calibrated` fills
    them from a measured per-edge traffic snapshot, so the cost model
    reflects measured, not assumed, link contention.

    A round's cost is ``max over links of load * cost`` — the
    link-limited wall-time multiplier (``round_congestion`` weighted
    by link cost; with ``ici_cost == dcn_cost == 1`` and no overrides
    the two are identical).
    """

    machines: int
    chips_per_machine: int
    ici_cost: float = 1.0
    dcn_cost: float = 4.0
    link_cost_overrides: Tuple[Tuple[LinkKey, float], ...] = ()

    def __post_init__(self):
        if self.machines < 1 or self.chips_per_machine < 1:
            raise ValueError(
                f"pod needs machines >= 1 and chips >= 1, got "
                f"{self.machines} x {self.chips_per_machine}")
        if self.ici_cost <= 0 or self.dcn_cost <= 0:
            raise ValueError("link costs must be positive")

    @property
    def axes(self) -> Tuple[int, int]:
        return (self.machines, self.chips_per_machine)

    @property
    def size(self) -> int:
        return self.machines * self.chips_per_machine

    @functools.cached_property
    def torus(self) -> TorusSpec:
        return TorusSpec(self.axes)

    @functools.cached_property
    def _overrides(self) -> Dict[LinkKey, float]:
        return dict(self.link_cost_overrides)

    def link_cost(self, key: LinkKey) -> float:
        """Cost of one unit payload crossing the directed link ``key``
        (``(node_coord, axis, sign)``, the ``link_loads`` keying)."""
        base = self.dcn_cost if key[1] == 0 else self.ici_cost
        return base * self._overrides.get(key, 1.0)

    def round_cost(self, round_or_pairs) -> float:
        """Wall-time multiplier of one exchange round: route every
        edge along dimension-ordered minimal paths, then take the most
        expensive link's ``load * cost``."""
        if isinstance(round_or_pairs, DynamicTopology):
            pairs = list(round_or_pairs.edges)
        elif isinstance(round_or_pairs, dict):
            pairs = list(round_or_pairs.items())
        else:
            pairs = list(round_or_pairs)
        loads = link_loads(pairs, self.torus)
        if not loads:
            return 0.0
        return max(load * self.link_cost(k) for k, load in loads.items())

    def schedule_cost(self, schedule: Sequence) -> Dict[str, object]:
        per_round = [self.round_cost(r) for r in schedule]
        return {
            "per_round": per_round,
            "mean": float(np.mean(per_round)) if per_round else 0.0,
            "max": float(np.max(per_round)) if per_round else 0.0,
        }

    def score(self, schedule: Sequence[DynamicTopology],
              eps: float = 1e-3,
              sigma: Optional[float] = None) -> Dict[str, float]:
        """``score_schedule`` extended with heterogeneous link costs:
        ``cost_to_consensus`` charges each round its pod cost instead
        of its bare congestion.  ``sigma`` (one period's contraction)
        may be supplied by a caller that already knows it (the
        compiler's Fourier scoring); otherwise it is measured from the
        materialized mixing matrices."""
        cong = schedule_congestion(schedule, self.torus)
        cost = self.schedule_cost(schedule)
        if sigma is None:
            sigma = consensus_contraction(schedule)
        return _score_fields(cong["per_round"], cost["per_round"],
                             sigma, eps)

    # ---------------------------------------------------------- #
    # telemetry calibration
    # ---------------------------------------------------------- #
    def traffic_link_loads(
            self, traffic: Mapping[Tuple[int, int], float],
    ) -> Dict[LinkKey, float]:
        """Route a measured per-edge traffic snapshot (``{(src, dst):
        bytes}``, the ``bf_edge_bytes_total`` shape) onto the physical
        links: per-link background bytes under the same
        dimension-ordered minimal routing the schedule cost uses.
        Edges naming ranks outside this pod mean the snapshot came
        from a differently-shaped fleet — a configuration error worth
        a loud message, not an IndexError from the router."""
        n = self.size
        bad = sorted(r for (s, d) in traffic for r in (s, d)
                     if not 0 <= r < n)
        if bad:
            raise ValueError(
                f"traffic snapshot names rank(s) {bad[:4]} outside "
                f"this {self.machines}x{self.chips_per_machine} pod "
                f"(size {n}) — was it recorded by a different fleet "
                f"shape?")
        pairs = [(s, d) for (s, d) in traffic]
        payloads = {(s, d): float(b) for (s, d), b in traffic.items()}
        return link_loads(pairs, self.torus, payloads=payloads)

    def calibrated(self, traffic: Mapping[Tuple[int, int], float],
                   contention: float = 1.0) -> "PodSpec":
        """A new ``PodSpec`` whose link costs reflect measured
        contention: link l's cost is multiplied by ``1 + contention *
        bytes_l / max_bytes`` (bytes_l = the snapshot's background
        traffic routed onto l).  A new payload on the busiest link
        queues behind the most background traffic, so the compiler is
        steered toward the links telemetry shows are quiet — the
        schedule adapts to measured, not assumed, link costs."""
        loads = self.traffic_link_loads(traffic)
        top = max(loads.values(), default=0.0)
        if top <= 0.0:
            return self
        overrides = dict(self.link_cost_overrides)
        for key, b in loads.items():
            overrides[key] = (overrides.get(key, 1.0)
                              * (1.0 + contention * b / top))
        return dataclasses.replace(
            self, link_cost_overrides=tuple(sorted(overrides.items())))

    @classmethod
    def from_telemetry(cls, machines: int, chips_per_machine: int,
                       registry=None, contention: float = 1.0,
                       link: Optional[str] = None,
                       **kwargs) -> "PodSpec":
        """Build a pod spec calibrated from the LIVE fleet-telemetry
        traffic counters: reads the ``bf_edge_bytes_total{src,dst}``
        family out of the metrics registry
        (:func:`bluefog_tpu_torch.observe.fleet.traffic_snapshot`) and
        routes it into per-link cost multipliers.  With no recorded
        traffic this is the plain (uncalibrated) spec.

        ``link`` filters the snapshot to one billed leg ("dcn"/"ici" —
        the per-leg labels a hierarchical step records): calibrating a
        HIERARCHICAL synthesis from ``link="dcn"`` routes only the
        inter-machine bytes onto the cost model, so cheap intra-machine
        chatter never masquerades as DCN load."""
        from bluefog_tpu_torch.observe.fleet import traffic_snapshot

        base = cls(machines, chips_per_machine, **kwargs)
        return base.calibrated(traffic_snapshot(registry, link=link),
                               contention=contention)


# ------------------------------------------------------------------ #
# the sketch: candidate space bounds + search budget
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class Sketch:
    """TACCL-style communication sketch: the human-supplied outline
    that bounds the synthesis space instead of hand-picking the
    schedule.  ``families`` seed the enumeration (torus-axis and
    rank-space circulant shift families); ``max_period`` bounds the
    schedule length, ``max_degree`` the per-round in-degree (1 =
    strictly one-peer, 2 admits the Swing-style bidirectional ``+-s``
    rounds); ``mutation_rounds`` bounds the hill-climbing generations
    and ``weight_grid``/``weight_sweeps`` the per-round self-weight
    optimization."""

    families: Tuple[str, ...] = ("torus_exp2", "torus_exp2_rev",
                                 "torus_sym", "single_hop",
                                 "logical_exp2", "ring")
    max_period: int = 12
    max_degree: int = 2
    mutation_rounds: int = 3
    weight_sweeps: int = 2
    weight_grid: Tuple[float, ...] = tuple(k / 16.0 for k in range(16))

    def __post_init__(self):
        if self.max_period < 1 or self.max_degree < 1:
            raise ValueError("sketch bounds must be >= 1")
        if not self.weight_grid or not all(
                0.0 <= t < 1.0 for t in self.weight_grid):
            raise ValueError("weight grid must lie in [0, 1)")


@dataclasses.dataclass(frozen=True)
class CandidateRound:
    """One round of a candidate: a set of circulant shifts applied
    simultaneously, plus the per-rank self-weight ``theta``.  The
    remaining mass ``1 - theta`` splits equally across the shifts —
    row-stochastic by construction.  ``shifts`` entries are ``(axis,
    shift)`` with ``axis`` a torus axis (torus-space candidates) or
    ``None`` (rank-space circulant over Z_n)."""

    shifts: Tuple[Tuple[Optional[int], int], ...]
    theta: float = 0.5


@dataclasses.dataclass(frozen=True)
class Candidate:
    """A full candidate schedule in one shift space ("torus" or
    "rank"); both spaces are commutative circulant families, so the
    period contraction has the closed Fourier form
    :func:`candidate_contraction` evaluates."""

    name: str
    space: str  # "torus" | "rank"
    rounds: Tuple[CandidateRound, ...]


def _round_factor_base(rnd: CandidateRound, axes: Sequence[int],
                       space: str) -> np.ndarray:
    """The round's shift response G with F(theta) = theta +
    (1 - theta) * G, over the full frequency grid (rank space: Z_n;
    torus space: Z_L0 x Z_L1 ...).  Independent of theta, so weight
    optimization re-evaluates F from a cached G."""
    n = int(np.prod(axes))
    if space == "rank":
        js = np.arange(n)
        terms = [np.exp(2j * np.pi * (s % n) * js / n)
                 for (_, s) in rnd.shifts]
    else:
        grids = np.meshgrid(*[np.arange(L) for L in axes], indexing="ij")
        terms = [np.exp(2j * np.pi * (s % axes[a]) * grids[a] / axes[a])
                 for (a, s) in rnd.shifts]
    return np.mean(terms, axis=0)


def _sigma_from_factors(factors: Sequence[np.ndarray],
                        thetas: Sequence[float]) -> float:
    """max over non-DC frequencies of |prod_t (theta_t +
    (1-theta_t) G_t)| — one period's contraction, exactly (the rounds
    commute and are diagonalized by the same DFT)."""
    prod = np.ones_like(factors[0])
    for G, th in zip(factors, thetas):
        prod = prod * (th + (1.0 - th) * G)
    mags = np.abs(prod).reshape(-1)
    mags[0] = 0.0  # DC: row sums are 1 by construction
    return float(mags.max())


def candidate_contraction(cand: Candidate,
                          axes: Sequence[int]) -> float:
    """One period's spectral contraction of a candidate, in closed
    form over the frequency grid — equal to
    ``consensus_contraction(materialize(cand, axes))`` to machine
    precision (tested), at O(period * n) instead of O(period * n^3)."""
    factors = [_round_factor_base(r, axes, cand.space)
               for r in cand.rounds]
    return _sigma_from_factors(factors, [r.theta for r in cand.rounds])


def _shift_dst(src: int, axis: Optional[int], s: int,
               axes: Sequence[int], spec: TorusSpec, n: int) -> int:
    """Destination of one shift from ``src`` — the ONE place the
    rank-space vs torus-space mapping lives, so the search's routing
    cost and the materialized schedule can never disagree."""
    if axis is None:
        return (src + s) % n
    c = list(spec.coord(src))
    c[axis] = (c[axis] + s) % axes[axis]
    return spec.rank(c)


def _round_pairs(rnd: CandidateRound, axes: Sequence[int],
                 space: str) -> List[Tuple[int, int]]:
    """The (src, dst) edges one candidate round exchanges — exactly
    the materialized round's edge set (self-maps dropped; duplicate
    shifts landing on the same dst merge); theta only moves weights,
    never edges."""
    return list(materialize_round(rnd, axes, space).edges)


def materialize_round(rnd: CandidateRound, axes: Sequence[int],
                      space: str) -> DynamicTopology:
    """Emit one candidate round as an ordinary ``DynamicTopology``:
    each shift contributes weight ``(1 - theta)/k`` on its edge;
    shifts that collapse to the same (src, dst) (e.g. +-1 on a
    length-2 axis) accumulate, and shifts that collapse to self fold
    into the self-weight — exactly matching the Fourier response."""
    n = int(np.prod(axes))
    spec = TorusSpec(tuple(axes))
    w = (1.0 - rnd.theta) / len(rnd.shifts)
    edges: Dict[Tuple[int, int], float] = {}
    selfs = [rnd.theta] * n
    for (axis, s) in rnd.shifts:
        for src in range(n):
            dst = _shift_dst(src, axis if space != "rank" else None,
                             s, axes, spec, n)
            if dst == src:
                selfs[src] += w
            else:
                edges[(src, dst)] = edges.get((src, dst), 0.0) + w
    return DynamicTopology.from_edges(n, edges, selfs)


def materialize(cand: Candidate,
                axes: Sequence[int]) -> List[DynamicTopology]:
    """The candidate as a ready-to-train dynamic schedule."""
    return [materialize_round(r, axes, cand.space) for r in cand.rounds]


# ------------------------------------------------------------------ #
# seeds: the sketch's shift families
# ------------------------------------------------------------------ #
def _norm_shift(s: int, L: int) -> Optional[int]:
    s = s % L
    return None if s == 0 else s


def _seed_candidates(pod: PodSpec, sketch: Sketch) -> List[Candidate]:
    axes = pod.axes
    n = pod.size
    out: List[Candidate] = []

    def add(name: str, space: str, rounds: List[CandidateRound]):
        rounds = [r for r in rounds if r.shifts]
        if not rounds or len(rounds) > sketch.max_period:
            return
        if any(len(r.shifts) > sketch.max_degree for r in rounds):
            return
        out.append(Candidate(name, space, tuple(rounds)))

    def axis_rounds(direction: int) -> List[CandidateRound]:
        rounds = []
        for a, L in enumerate(axes):
            for k in range(max(0, int(math.log2(L)) if L > 1 else 0)):
                s = _norm_shift(direction * (2 ** k), L)
                if s is not None:
                    rounds.append(CandidateRound(((a, s),), 0.5))
        return rounds

    fams = set(sketch.families)
    if "torus_exp2" in fams:
        add("torus_exp2", "torus", axis_rounds(+1))
    if "torus_exp2_rev" in fams:
        add("torus_exp2_rev", "torus", axis_rounds(-1))
    if "torus_sym" in fams and sketch.max_degree >= 2:
        # Swing-style bidirectional halving: per axis, one +-1 round at
        # theta=1/2 kills the top frequency, then zero-self-weight
        # +-2^k rounds kill the remaining conjugate pairs — exact
        # average per period at lower congestion than exp2.
        rounds = []
        for a, L in enumerate(axes):
            if L < 2:
                continue
            one = _norm_shift(1, L)
            back = _norm_shift(-1, L)
            first = ((a, one),) if back in (None, one) else (
                (a, one), (a, back))
            rounds.append(CandidateRound(first, 0.5))
            for k in range(int(math.log2(L)) - 1):
                s, b = _norm_shift(2 ** k, L), _norm_shift(-(2 ** k), L)
                shifts = ((a, s),) if b in (None, s) else ((a, s), (a, b))
                rounds.append(CandidateRound(shifts, 0.0))
        add("torus_sym", "torus", rounds)
    if "single_hop" in fams:
        rounds = []
        for a, L in enumerate(axes):
            if L < 2:
                continue
            rounds.append(CandidateRound(((a, 1),), 0.5))
            if L > 2:
                rounds.append(CandidateRound(((a, L - 1),), 0.5))
        add("single_hop", "torus", rounds)
    if "logical_exp2" in fams:
        rounds = [CandidateRound(((None, 2 ** k),), 0.5)
                  for k in range(max(1, int(math.ceil(math.log2(n)))))
                  if 2 ** k < n]
        add("logical_exp2", "rank", rounds)
    if "ring" in fams:
        add("ring", "rank", [CandidateRound(((None, 1),), 0.5)])
    return out


# ------------------------------------------------------------------ #
# mutations: Swing short-cutting on the candidate structure
# ------------------------------------------------------------------ #
def _mutants(cand: Candidate, axes: Sequence[int],
             sketch: Sketch) -> List[Candidate]:
    """Single-point structural mutations: direction flips, shift +-1
    short-cuts, symmetrize (add the opposite shift), desymmetrize
    (drop one shift of a multi-shift round), and round removal — the
    neighborhood the hill-climber explores each generation."""
    n = int(np.prod(axes))

    def mod_of(axis: Optional[int]) -> int:
        return n if axis is None else axes[axis]

    out: List[Candidate] = []

    def emit(tag: str, rounds: List[CandidateRound]):
        rounds = [r for r in rounds if r.shifts]
        if not rounds or len(rounds) > sketch.max_period:
            return
        for r in rounds:
            if len(r.shifts) > sketch.max_degree:
                return
            if len(set(r.shifts)) != len(r.shifts):
                return
        out.append(Candidate(f"{cand.name}~{tag}", cand.space,
                             tuple(rounds)))

    rounds = list(cand.rounds)
    for t, rnd in enumerate(rounds):
        for k, (axis, s) in enumerate(rnd.shifts):
            L = mod_of(axis)
            variants = []
            flip = _norm_shift(-s, L)
            if flip is not None and flip != s:
                variants.append(("flip", flip))
            for d in (-1, +1):
                sc = _norm_shift(s + d, L)
                if sc is not None and sc != s:
                    variants.append((f"sc{d:+d}", sc))
            for tag, ns in variants:
                shifts = list(rnd.shifts)
                shifts[k] = (axis, ns)
                emit(f"r{t}{tag}", rounds[:t]
                     + [CandidateRound(tuple(shifts), rnd.theta)]
                     + rounds[t + 1:])
            if len(rnd.shifts) > 1:
                shifts = rnd.shifts[:k] + rnd.shifts[k + 1:]
                emit(f"r{t}drop{k}", rounds[:t]
                     + [CandidateRound(shifts, rnd.theta)]
                     + rounds[t + 1:])
        if (len(rnd.shifts) < sketch.max_degree
                and len(rnd.shifts) == 1):
            (axis, s) = rnd.shifts[0]
            opp = _norm_shift(-s, mod_of(axis))
            if opp is not None and opp != s:
                emit(f"r{t}sym", rounds[:t]
                     + [CandidateRound(((axis, s), (axis, opp)),
                                       rnd.theta)]
                     + rounds[t + 1:])
        if len(rounds) > 1:
            emit(f"r{t}rm", rounds[:t] + rounds[t + 1:])
    return out


# ------------------------------------------------------------------ #
# per-candidate weight optimization (spectral-gap objective)
# ------------------------------------------------------------------ #
def _optimize_weights(cand: Candidate, axes: Sequence[int],
                      sketch: Sketch) -> Tuple[Candidate, float]:
    """Coordinate descent on the per-round self-weights over the
    sketch's grid, minimizing one period's contraction (the
    spectral-gap objective).  Row-stochasticity is structural (theta
    in [0, 1), equal split of the rest).  Cheap: each evaluation is a
    cached-factor product over the frequency grid, so the grid search
    finds the exact killers (theta = 0 and 1/2) the closed-form
    constructions use."""
    factors = [_round_factor_base(r, axes, cand.space)
               for r in cand.rounds]
    thetas = [r.theta for r in cand.rounds]
    sigma = _sigma_from_factors(factors, thetas)
    for _ in range(sketch.weight_sweeps):
        improved = False
        for t in range(len(thetas)):
            best_th, best_sigma = thetas[t], sigma
            for th in sketch.weight_grid:
                if th == thetas[t]:
                    continue
                trial = list(thetas)
                trial[t] = th
                s = _sigma_from_factors(factors, trial)
                if s < best_sigma - 1e-15:
                    best_th, best_sigma = th, s
            if best_th != thetas[t]:
                thetas[t], sigma = best_th, best_sigma
                improved = True
        if not improved:
            break
    rounds = tuple(CandidateRound(r.shifts, th)
                   for r, th in zip(cand.rounds, thetas))
    return Candidate(cand.name, cand.space, rounds), sigma


# ------------------------------------------------------------------ #
# the compiled artifact
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class CompiledTopology:
    """A synthesized mixing schedule plus everything needed to audit
    it: the winning ``DynamicTopology`` rounds (feed ``schedule`` to
    ``build_train_step(schedule=...)`` unchanged), the pod-cost score,
    the per-candidate report the choice was made from, and search
    statistics.  ``predicted_collectives`` states the wire cost the
    cost model charged — the claim the HLO tests hold the real
    lowering to."""

    schedule: List[DynamicTopology]
    score: Dict[str, float]
    name: str
    pod: PodSpec
    report: Dict[str, Dict[str, float]]
    search: Dict[str, float]

    def predicted_collectives(self, payload_bytes: float) -> Dict:
        """The exact collective lowering the schedule implies, each
        permute carrying the full per-rank payload (weights are traced
        operands — a declared edge always moves bytes).  Mirrors
        ``collectives.neighbor_allreduce``'s class-fusion rule: an
        in-degree-1 round (every src and dst unique across ALL shift
        classes — e.g. a wrapping one-peer rotation that decomposes
        into two partial permutations) fuses into ONE
        ``lax.ppermute``; multi-shift rounds issue one per class."""
        per_round = []
        for r in self.schedule:
            pairs = [p for cls in r.shift_classes for p in cls.perm]
            srcs = [s for s, _ in pairs]
            dsts = [d for _, d in pairs]
            fused = (len(set(srcs)) == len(srcs)
                     and len(set(dsts)) == len(dsts))
            per_round.append({
                "permutes": 1 if fused else len(r.shift_classes),
                "bytes_per_permute": float(payload_bytes),
            })
        return {
            "permutes_per_period": sum(r["permutes"] for r in per_round),
            "bytes_per_period": float(sum(
                r["permutes"] * r["bytes_per_permute"]
                for r in per_round)),
            "per_round": per_round,
        }

    def as_json(self) -> Dict:
        """JSON-ready emission (the CLI's ``--emit json`` payload)."""
        return {
            "pod": {
                "machines": self.pod.machines,
                "chips_per_machine": self.pod.chips_per_machine,
                "ici_cost": self.pod.ici_cost,
                "dcn_cost": self.pod.dcn_cost,
                "calibrated_links": len(self.pod.link_cost_overrides),
            },
            "winner": self.name,
            "score": self.score,
            "report": self.report,
            "search": self.search,
            "schedule": [
                {
                    "edges": [[int(s), int(d), float(w)] for (s, d), w in
                              zip(r.edges, r.edge_weight_values)],
                    "self_weights": [float(w)
                                     for w in r.self_weight_values],
                }
                for r in self.schedule
            ],
        }


# ------------------------------------------------------------------ #
# hierarchical synthesis: exact ICI reduce inside the machine,
# decentralized mixing only across DCN
# ------------------------------------------------------------------ #
def expand_machine_pairs(pairs: Sequence[Tuple[int, int]],
                         local_size: int) -> List[Tuple[int, int]]:
    """Expand MACHINE-level edges to the RANK-level counterpart pairs
    the hierarchical exchange actually wires (``collectives.
    hierarchical_neighbor_allreduce``): local rank ``j`` of machine
    ``ms`` sends to local rank ``j`` of machine ``md``.  Pure host-side
    mirror of the jax implementation's expansion, so the cost model and
    the HLO predictions can never disagree with the lowering."""
    L = int(local_size)
    return [(ms * L + j, md * L + j)
            for (ms, md) in pairs for j in range(L)]


def _ici_reduce_cost(pod: PodSpec) -> Tuple[float, float]:
    """(congestion, cost) of the intra-machine exact-mean leg: a ring
    allreduce of the full payload over each machine's ``L`` chips puts
    ``2 (L - 1) / L`` payload units on every ICI link (reduce-scatter +
    all-gather), priced at the most expensive ICI link's calibrated
    cost.  ``L == 1`` machines have no ICI leg."""
    L = pod.chips_per_machine
    if L < 2:
        return 0.0, 0.0
    load = 2.0 * (L - 1) / L
    worst = max(pod.link_cost((pod.torus.coord(r), 1, sign))
                for r in range(pod.size) for sign in (+1, -1))
    return load, load * worst


def _machine_pod(pod: PodSpec) -> PodSpec:
    """The inter-machine graph as a smaller pod for the existing sketch
    search: ``machines x 1``, DCN-priced axis 0 only.  Calibrated
    DCN-link overrides carry over machine-wise (the max over the
    machine's chip lanes — a congested lane throttles the whole
    machine exchange, since the counterpart expansion pins every lane
    into the same round)."""
    agg: Dict[LinkKey, float] = {}
    for (coord, axis, sign), mult in pod.link_cost_overrides:
        if axis != 0:
            continue  # ICI overrides are priced by _ici_reduce_cost
        key = ((coord[0], 0), 0, sign)
        agg[key] = max(agg.get(key, 1.0), mult)
    return PodSpec(pod.machines, 1, ici_cost=pod.ici_cost,
                   dcn_cost=pod.dcn_cost,
                   link_cost_overrides=tuple(sorted(agg.items())))


def _hierarchical_score(pod: PodSpec,
                        machine_schedule: Sequence[DynamicTopology],
                        eps: float = 1e-3) -> Dict[str, float]:
    """Full-pod score of a two-level schedule, same ``cost_to_consensus``
    schema as the flat scorer: each round pays the ICI reduce leg PLUS
    the DCN leg of its counterpart-expanded machine edges (max link
    load x calibrated cost, dimension-ordered routing — identical
    machinery to the flat rounds it competes against).

    Contraction is the MACHINE schedule's: the expanded round mixes by
    ``kron(W_machine, J_L / L)``, whose non-DC spectrum is the machine
    matrix's non-DC spectrum plus exact zeros (the intra-machine modes
    die in the first exact mean), so rounds-to-consensus is governed by
    the inter-machine mixing alone."""
    L = pod.chips_per_machine
    ici_cong, ici_cost = _ici_reduce_cost(pod)
    congs, costs = [], []
    for r in machine_schedule:
        pairs = expand_machine_pairs(list(r.edges), L)
        loads = link_loads(pairs, pod.torus)
        dcn_cong = max(loads.values(), default=0.0)
        dcn_cost = max((load * pod.link_cost(k)
                        for k, load in loads.items()), default=0.0)
        congs.append(max(ici_cong, dcn_cong))
        costs.append(ici_cost + dcn_cost)
    sigma = consensus_contraction(machine_schedule)
    return _score_fields(congs, costs, sigma, eps)


@dataclasses.dataclass
class CompiledHierarchicalTopology:
    """A synthesized TWO-LEVEL schedule: ``local_size`` names the exact
    intra-machine reduce (the ``axis_index_groups`` width) and
    ``machine_schedule`` the decentralized inter-machine rounds — feed
    ``build_train_step(schedule=machine_schedule,
    hierarchical=local_size)`` unchanged.  ``score`` is the full-pod
    ``cost_to_consensus`` (:func:`_hierarchical_score`);
    ``predicted_collectives`` states the per-round lowering the HLO
    tests hold the real program to: exactly ONE grouped all-reduce
    (the ICI leg) plus the machine permutes, each permute carrying the
    full payload across DCN."""

    local_size: int
    machine_schedule: List[DynamicTopology]
    score: Dict[str, float]
    name: str
    pod: PodSpec
    report: Dict[str, Dict[str, float]]
    search: Dict[str, float]

    @property
    def schedule(self) -> List[DynamicTopology]:
        """Alias: the specs a train step consumes (machine-level)."""
        return self.machine_schedule

    def predicted_collectives(self, payload_bytes: float) -> Dict:
        """Per round: 1 grouped all-reduce over every machine's chips
        plus the machine-class permutes (the flat class-fusion rule
        applied at machine level — the counterpart expansion preserves
        in-degree-1-ness, so a fused machine round is one
        ``lax.ppermute`` on the wire)."""
        per_round = []
        for r in self.machine_schedule:
            pairs = [p for cls in r.shift_classes for p in cls.perm]
            srcs = [s for s, _ in pairs]
            dsts = [d for _, d in pairs]
            fused = (len(set(srcs)) == len(srcs)
                     and len(set(dsts)) == len(dsts))
            per_round.append({
                "all_reduces": 1,
                "permutes": 1 if fused else len(r.shift_classes),
                "bytes_per_permute": float(payload_bytes),
            })
        return {
            "permutes_per_period": sum(r["permutes"] for r in per_round),
            "bytes_per_period": float(sum(
                r["permutes"] * r["bytes_per_permute"]
                for r in per_round)),
            "all_reduces_per_period": len(per_round),
            "all_reduce_groups": self.pod.machines,
            "all_reduce_group_size": self.local_size,
            "bytes_per_all_reduce": float(payload_bytes),
            "per_round": per_round,
        }

    def as_json(self) -> Dict:
        return {
            "pod": {
                "machines": self.pod.machines,
                "chips_per_machine": self.pod.chips_per_machine,
                "ici_cost": self.pod.ici_cost,
                "dcn_cost": self.pod.dcn_cost,
                "calibrated_links": len(self.pod.link_cost_overrides),
            },
            "winner": self.name,
            "local_size": self.local_size,
            "score": self.score,
            "report": self.report,
            "search": self.search,
            "machine_schedule": [
                {
                    "edges": [[int(s), int(d), float(w)] for (s, d), w in
                              zip(r.edges, r.edge_weight_values)],
                    "self_weights": [float(w)
                                     for w in r.self_weight_values],
                }
                for r in self.machine_schedule
            ],
        }


# ------------------------------------------------------------------ #
# all-to-all schedule synthesis (MoE expert dispatch)
# ------------------------------------------------------------------ #
# An all-to-all moves a DISTINCT shard along every (src, dst) pair —
# n * (n - 1) directed transfers — so the schedule is not a mixing
# matrix but a PARTITION of the n - 1 nonzero torus shifts into
# rounds: round t applies its shifts simultaneously, each rank sending
# the shard addressed to its shift image (arxiv 2309.13541's
# shift-class decomposition, searched under the same heterogeneous
# PodSpec cost model as the mixing candidates).  Every shift appears
# exactly once across the period, so one period completes the
# dispatch; the objective is the SUM of per-round max-link-load costs
# ("cost to dispatch"), not a contraction rate.


def _a2a_shifts(pod: PodSpec) -> List[Tuple[int, int]]:
    """Every nonzero torus shift ``(dm, dc)`` — one per (src, dst)
    offset class; the unit of scheduling."""
    M, L = pod.axes
    return [(dm, dc) for dm in range(M) for dc in range(L)
            if (dm, dc) != (0, 0)]


def _a2a_shift_pairs(shift: Tuple[int, int],
                     pod: PodSpec) -> List[Tuple[int, int]]:
    """The n (src, dst) pairs one torus shift moves.  Distinct shifts
    send a given src to distinct dsts, so a multi-shift round's pair
    list has duplicate SRCS but never duplicate (src, dst) entries —
    the pair-list ``link_loads`` form bills every one."""
    M, L = pod.axes
    spec = pod.torus
    dm, dc = shift
    out = []
    for src in range(pod.size):
        m, c = spec.coord(src)
        out.append((src, spec.rank(((m + dm) % M, (c + dc) % L))))
    return out


def _a2a_round_topology(shifts: Sequence[Tuple[int, int]],
                        pod: PodSpec) -> DynamicTopology:
    """One a2a round as an ordinary ``DynamicTopology`` (unit edge
    weights, zero self-weights — a2a rounds move shards, they don't
    average).  Safe by construction: within a rank-space shift class,
    srcs are unique (two torus shifts sharing a class delta cannot
    share a src — same src + same delta would be the same dst, and
    distinct shifts have distinct dsts), so ``shift_classes`` always
    decomposes into partial permutations."""
    edges = {p: 1.0 for sh in shifts for p in _a2a_shift_pairs(sh, pod)}
    return DynamicTopology.from_edges(pod.size, edges,
                                      [0.0] * pod.size)


@dataclasses.dataclass
class CompiledAllToAll:
    """A synthesized all-to-all dispatch schedule plus its audit
    surface: ``schedule`` holds one ``DynamicTopology`` per round
    (feed to ``moe.dispatch.dispatch_plan`` unchanged),
    ``shifts_per_round`` the torus shifts each round carries, and
    ``score`` the cost-to-dispatch against the naive baselines.
    ``predicted_collectives`` states the exact wire lowering — the
    claim the HLO tests hold ``moe.dispatch.all_to_all_dispatch`` to,
    permute-for-permute and byte-for-byte."""

    schedule: List[DynamicTopology]
    shifts_per_round: List[Tuple[Tuple[int, int], ...]]
    score: Dict[str, float]
    name: str
    pod: PodSpec
    report: Dict[str, Dict[str, float]]
    search: Dict[str, float]

    def predicted_collectives(self, payload_bytes: float) -> Dict:
        """Same fusion rule as the mixing schedules (and as the
        dispatch implementation): a round whose union pair list has
        all-unique srcs AND dsts lowers to ONE ``lax.ppermute``;
        otherwise one per rank-space shift class, each carrying the
        full per-destination shard payload."""
        per_round = []
        for r in self.schedule:
            pairs = [p for cls in r.shift_classes for p in cls.perm]
            srcs = [s for s, _ in pairs]
            dsts = [d for _, d in pairs]
            fused = (len(set(srcs)) == len(srcs)
                     and len(set(dsts)) == len(dsts))
            per_round.append({
                "permutes": 1 if fused else len(r.shift_classes),
                "bytes_per_permute": float(payload_bytes),
            })
        return {
            "permutes_per_period": sum(r["permutes"] for r in per_round),
            "bytes_per_period": float(sum(
                r["permutes"] * r["bytes_per_permute"]
                for r in per_round)),
            "per_round": per_round,
        }

    def as_json(self) -> Dict:
        return {
            "pod": {
                "machines": self.pod.machines,
                "chips_per_machine": self.pod.chips_per_machine,
                "ici_cost": self.pod.ici_cost,
                "dcn_cost": self.pod.dcn_cost,
                "calibrated_links": len(self.pod.link_cost_overrides),
            },
            "winner": self.name,
            "score": self.score,
            "report": self.report,
            "search": self.search,
            "shifts_per_round": [
                [[int(dm), int(dc)] for (dm, dc) in shifts]
                for shifts in self.shifts_per_round
            ],
            "schedule": [
                {
                    "edges": [[int(s), int(d), float(w)] for (s, d), w in
                              zip(r.edges, r.edge_weight_values)],
                    "self_weights": [float(w)
                                     for w in r.self_weight_values],
                }
                for r in self.schedule
            ],
        }


def naive_all_to_all_cost(pod: PodSpec) -> float:
    """The topology-UNAWARE baseline: ``lax.all_to_all``'s linear
    rank-ring decomposition — n - 1 sequential rank-space shift
    rounds, each priced by the same routing machinery.  Rank shifts
    straddle the machine boundary (a +1 rank shift is mostly ICI plus
    a DCN wrap), so every round pays the DCN lane even when most of
    its traffic is intra-machine — the waste the compiled schedule
    exists to remove."""
    n = pod.size
    return float(sum(
        pod.round_cost([(r, (r + s) % n) for r in range(n)])
        for s in range(1, n)))


def one_shot_all_to_all_cost(pod: PodSpec) -> float:
    """Cost of issuing EVERY pair in one round — the congestion
    reference: no schedule can beat the busiest link's total demand,
    so this bounds cost_to_dispatch from below."""
    n = pod.size
    pairs = [(s, d) for s in range(n) for d in range(n) if s != d]
    return float(pod.round_cost(pairs))


def compile_all_to_all(pod: PodSpec, sketch: Optional[Sketch] = None,
                       verbose: bool = False) -> CompiledAllToAll:
    """Synthesize the all-to-all dispatch schedule for ``pod``: pack
    the n - 1 nonzero torus shifts into rounds of at most
    ``sketch.max_degree`` shifts, minimizing the summed per-round
    max-link cost.  Two seeds — a greedy bin-pack (expensive shifts
    anchor their own rounds, each remaining shift joins the round it
    inflates least) and the inverse pairing ``(dm, dc)`` with
    ``(-dm, -dc)`` (bidirectional rounds fill both DCN directions at
    once) — then hill-climbing by single-shift moves and pair swaps,
    every evaluation served by a frozenset-keyed round-cost cache.
    The winner emits as ``DynamicTopology`` rounds the MoE dispatch
    consumes directly."""
    sketch = sketch or Sketch()
    if pod.size < 2:
        raise ValueError("all-to-all needs a pod of size >= 2")
    t0 = time.perf_counter()
    shifts = _a2a_shifts(pod)
    pair_cache = {sh: _a2a_shift_pairs(sh, pod) for sh in shifts}
    cost_cache: Dict[frozenset, float] = {}
    stats = {"evaluations": 0}

    def round_cost(group) -> float:
        key = frozenset(group)
        if not key:
            return 0.0
        c = cost_cache.get(key)
        if c is None:
            stats["evaluations"] += 1
            pairs = [p for sh in key for p in pair_cache[sh]]
            c = cost_cache[key] = pod.round_cost(pairs)
        return c

    def total(rounds) -> float:
        return sum(round_cost(r) for r in rounds)

    def greedy_seed() -> List[set]:
        order = sorted(shifts, key=lambda sh: -round_cost({sh}))
        rounds: List[set] = []
        for sh in order:
            best_i, best_delta = None, round_cost({sh})
            for i, r in enumerate(rounds):
                if len(r) >= sketch.max_degree:
                    continue
                delta = round_cost(r | {sh}) - round_cost(r)
                if delta < best_delta - 1e-12:
                    best_i, best_delta = i, delta
            if best_i is None:
                rounds.append({sh})
            else:
                rounds[best_i].add(sh)
        return rounds

    def inverse_seed() -> List[set]:
        M, L = pod.axes
        rounds, used = [], set()
        for sh in shifts:
            if sh in used:
                continue
            inv = ((M - sh[0]) % M, (L - sh[1]) % L)
            if (sketch.max_degree >= 2 and inv != sh
                    and inv not in used):
                rounds.append({sh, inv})
                used |= {sh, inv}
            else:
                rounds.append({sh})
                used.add(sh)
        return rounds

    def climb(rounds: List[set]) -> List[set]:
        for _ in range(max(1, sketch.mutation_rounds) * 4):
            improved = False
            # single-shift moves
            for i in range(len(rounds)):
                for sh in sorted(rounds[i]):
                    base = round_cost(rounds[i])
                    rest = round_cost(rounds[i] - {sh})
                    for j in range(len(rounds)):
                        if (j == i
                                or len(rounds[j]) >= sketch.max_degree):
                            continue
                        delta = (rest + round_cost(rounds[j] | {sh})
                                 - base - round_cost(rounds[j]))
                        if delta < -1e-12:
                            rounds[i].discard(sh)
                            rounds[j].add(sh)
                            improved = True
                            break
            rounds = [r for r in rounds if r]
            # pair swaps
            for i in range(len(rounds)):
                for j in range(i + 1, len(rounds)):
                    base = round_cost(rounds[i]) + round_cost(rounds[j])
                    done = False
                    for a in sorted(rounds[i]):
                        for b in sorted(rounds[j]):
                            ni = (rounds[i] - {a}) | {b}
                            nj = (rounds[j] - {b}) | {a}
                            if (round_cost(ni) + round_cost(nj)
                                    < base - 1e-12):
                                rounds[i], rounds[j] = ni, nj
                                improved = done = True
                                break
                        if done:
                            break
            if not improved:
                break
        return [r for r in rounds if r]

    seeds = {"greedy": greedy_seed(), "inverse": inverse_seed()}
    report: Dict[str, Dict[str, float]] = {}
    best_name, best_rounds, best_cost = None, None, float("inf")
    for name, rounds in seeds.items():
        report[f"seed:{name}"] = {
            "cost_to_dispatch": total(rounds),
            "rounds_per_period": float(len(rounds)),
        }
        climbed = climb([set(r) for r in rounds])
        c = total(climbed)
        report[f"climbed:{name}"] = {
            "cost_to_dispatch": c,
            "rounds_per_period": float(len(climbed)),
        }
        if c < best_cost - 1e-12:
            best_name, best_rounds, best_cost = name, climbed, c

    assert best_rounds is not None
    # deterministic emission order: cheap rounds first, ties by shifts
    ordered = sorted((tuple(sorted(r)) for r in best_rounds),
                     key=lambda r: (round_cost(set(r)), r))
    schedule = [_a2a_round_topology(r, pod) for r in ordered]
    costs = [round_cost(set(r)) for r in ordered]
    naive = naive_all_to_all_cost(pod)
    one_shot = one_shot_all_to_all_cost(pod)
    score = {
        "rounds_per_period": float(len(ordered)),
        "mean_round_cost": float(np.mean(costs)) if costs else 0.0,
        "max_round_cost": float(np.max(costs)) if costs else 0.0,
        "cost_to_dispatch": float(best_cost),
        "naive_linear_cost": naive,
        "one_shot_cost": one_shot,
        "compiled_advantage": (naive / best_cost
                               if best_cost > 0 else float("inf")),
    }
    report["compiled"] = {
        "cost_to_dispatch": float(best_cost),
        "rounds_per_period": float(len(ordered)),
    }
    report["naive:linear"] = {
        "cost_to_dispatch": naive,
        "rounds_per_period": float(pod.size - 1),
    }
    report["naive:one_shot"] = {
        "cost_to_dispatch": one_shot,
        "rounds_per_period": 1.0,
    }
    stats["seconds"] = time.perf_counter() - t0
    if verbose:
        for name, sc in sorted(report.items()):
            print(f"[compile_all_to_all] {name}: cost_to_dispatch="
                  f"{sc['cost_to_dispatch']:.3f} "
                  f"({sc['rounds_per_period']:.0f} rounds)")
    return CompiledAllToAll(
        schedule=schedule, shifts_per_round=list(ordered), score=score,
        name=f"a2a:{best_name}", pod=pod, report=report,
        search={k: float(v) for k, v in stats.items()})


def menu_schedules(pod: PodSpec) -> Dict[str, List[DynamicTopology]]:
    """The FIXED menu the compiler competes against — the schedules an
    operator could hand-pick (``default_pod_schedule``'s
    candidates plus the rank-space classics)."""
    from bluefog_tpu_torch.topology.dynamic import one_peer_dynamic_schedule
    from bluefog_tpu_torch.topology.graphs import RingGraph

    menu = {
        "torus_exp2": torus_one_peer_schedule(pod.axes, "exp2"),
        "torus_single_hop": torus_one_peer_schedule(pod.axes,
                                                    "single_hop"),
    }
    if pod.size > 1:
        menu["logical_exp2"] = one_peer_dynamic_schedule(pod.size)
        menu["ring"] = one_peer_dynamic_schedule(
            RingGraph(pod.size, connect_style=1))
    return {k: v for k, v in menu.items() if v}


def compile_topology(pod: PodSpec, sketch: Optional[Sketch] = None,
                     eps: float = 1e-3,
                     verbose: bool = False,
                     hierarchical: bool = False):
    """Synthesize the mixing schedule for ``pod``: seed the sketch's
    shift families, weight-optimize each candidate (spectral-gap
    objective), hill-climb with Swing-style mutations, prune with the
    contraction bound (``cost_to_consensus >= sum of round costs`` —
    rounds-to-consensus is never below one period), and emit the
    winner as ``DynamicTopology`` rounds scored by the generic matrix
    machinery (the Fourier search score and the materialized-matrix
    score must agree; the tests assert it).

    ``hierarchical=True`` synthesizes the TWO-LEVEL decomposition
    instead: the inter-machine graph becomes a smaller
    ``machines x 1`` pod (calibrated DCN overrides carried over
    machine-wise) driven through the SAME sketch search, and the winner
    is rescored on the full pod by :func:`_hierarchical_score` — ICI
    reduce leg plus counterpart-expanded DCN leg per round, contraction
    from the machine matrix.  Returns a
    :class:`CompiledHierarchicalTopology` whose ``report`` keeps the
    machine-level search entries under ``machine:*`` and full-pod flat
    menu scores under ``menu:*`` for the apples-to-apples audit."""
    if hierarchical:
        if pod.machines < 2:
            raise ValueError(
                "hierarchical synthesis needs machines >= 2 — a "
                "single-machine pod has no DCN leg to decentralize")
        inner = compile_topology(_machine_pod(pod), sketch, eps=eps,
                                 verbose=verbose)
        score = _hierarchical_score(pod, inner.schedule, eps=eps)
        report = {f"machine:{k}": v for k, v in inner.report.items()}
        report["hierarchical"] = score
        for name, sched in menu_schedules(pod).items():
            report[f"menu:{name}"] = pod.score(sched, eps=eps)
        if verbose:
            print(f"[compile_topology] hierarchical "
                  f"(L={pod.chips_per_machine}, {inner.name}): "
                  f"cost_to_consensus={score['cost_to_consensus']:.3f}")
        return CompiledHierarchicalTopology(
            local_size=pod.chips_per_machine,
            machine_schedule=inner.schedule, score=score,
            name=f"hier:{inner.name}", pod=pod, report=report,
            search=inner.search)
    sketch = sketch or Sketch()
    t0 = time.perf_counter()
    axes = pod.axes
    # per-round metric cache, keyed by structure: (congestion, cost) —
    # one routing pass serves both the homogeneous and weighted figure
    metric_cache: Dict[Tuple, Tuple[float, float]] = {}
    stats = {"candidates": 0, "pruned": 0}

    def round_metrics(cand: Candidate) -> Tuple[List[float], List[float]]:
        congs, costs = [], []
        for rnd in cand.rounds:
            key = (cand.space, rnd.shifts)
            m = metric_cache.get(key)
            if m is None:
                pairs = _round_pairs(rnd, axes, cand.space)
                loads = link_loads(pairs, pod.torus)
                cong = max(loads.values(), default=0.0)
                cost = max((load * pod.link_cost(k)
                            for k, load in loads.items()), default=0.0)
                m = metric_cache[key] = (cong, cost)
            congs.append(m[0])
            costs.append(m[1])
        return congs, costs

    def evaluate(cand: Candidate, best_cost: float):
        """(candidate, score) after weight optimization, or None when
        the contraction bound prunes it.  Scores come from the shared
        ``_score_fields`` schema, same as PodSpec.score."""
        stats["candidates"] += 1
        congs, costs = round_metrics(cand)
        if best_cost < float("inf") and sum(costs) >= best_cost:
            stats["pruned"] += 1
            return None
        cand, sigma = _optimize_weights(cand, axes, sketch)
        return cand, _score_fields(congs, costs, sigma, eps)

    best: Optional[Tuple[Candidate, Dict[str, float]]] = None
    report: Dict[str, Dict[str, float]] = {}

    def consider(entry) -> bool:
        nonlocal best
        if entry is None:
            return False
        cand, score = entry
        if (best is None or score["cost_to_consensus"]
                < best[1]["cost_to_consensus"] - 1e-12):
            best = (cand, score)
            return True
        return False

    seeds = _seed_candidates(pod, sketch)
    if not seeds:
        raise ValueError(
            f"sketch {sketch.families!r} yields no candidate within "
            f"period {sketch.max_period} for pod {axes}")
    evaluated = []
    for seed in seeds:
        entry = evaluate(seed, float("inf"))
        if entry is None:
            continue
        evaluated.append(entry)
        report[f"seed:{seed.name}"] = entry[1]
        consider(entry)

    # hill-climb from every surviving seed (the search is cheap; the
    # per-candidate bound prunes hopeless mutants before weight opt)
    for cand, score in evaluated:
        current, current_score = cand, score
        for _ in range(sketch.mutation_rounds):
            best_mut = None
            for mut in _mutants(current, axes, sketch):
                entry = evaluate(
                    mut, current_score["cost_to_consensus"])
                if entry is None:
                    continue
                if (best_mut is None or entry[1]["cost_to_consensus"]
                        < best_mut[1]["cost_to_consensus"]):
                    best_mut = entry
            if best_mut is None or (best_mut[1]["cost_to_consensus"]
                                    >= current_score["cost_to_consensus"]
                                    - 1e-12):
                break
            current, current_score = best_mut
            consider(best_mut)
        if current is not cand:
            report[f"climbed:{cand.name}"] = current_score

    assert best is not None
    winner, _search_score = best
    schedule = materialize(winner, axes)
    # final score through the GENERIC machinery: materialized matrices,
    # measured contraction — the search's Fourier shortcut gets no say
    # in the published number (and must agree with it; tested).
    final = pod.score(schedule, eps=eps)
    report["compiled"] = final
    for name, sched in menu_schedules(pod).items():
        report[f"menu:{name}"] = pod.score(sched, eps=eps)
    stats["seconds"] = time.perf_counter() - t0
    if verbose:
        for name, sc in sorted(report.items()):
            print(f"[compile_topology] {name}: "
                  f"cost_to_consensus={sc['cost_to_consensus']:.3f} "
                  f"({sc['rounds_per_period']:.0f} rounds/period)")
    return CompiledTopology(schedule=schedule, score=final,
                            name=winner.name, pod=pod, report=report,
                            search={k: float(v)
                                    for k, v in stats.items()})


# ------------------------------------------------------------------ #
# CLI: compile offline, emit the schedule + score
# ------------------------------------------------------------------ #
def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m bluefog_tpu_torch.topology.compiler --machines 4 --chips 8
    --emit json`` — offline synthesis for operators: prints the
    synthesized schedule plus its score dict (and the full
    per-candidate report), so a pod's schedule can be compiled and
    reviewed before a job ever runs."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.topology.compiler",
        description="Synthesize a mixing schedule for a pod and emit "
                    "it as JSON or a summary table.")
    ap.add_argument("--machines", type=int, required=True)
    ap.add_argument("--chips", type=int, required=True,
                    help="chips per machine")
    ap.add_argument("--ici-cost", type=float, default=1.0)
    ap.add_argument("--dcn-cost", type=float, default=4.0)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--max-period", type=int, default=12)
    ap.add_argument("--max-degree", type=int, default=2)
    ap.add_argument("--traffic", default=None, metavar="SNAPSHOT.json",
                    help="per-edge traffic snapshot to calibrate link "
                         "costs from: JSON [[src, dst, bytes], ...] "
                         "(the bf_edge_bytes_total shape)")
    ap.add_argument("--contention", type=float, default=1.0,
                    help="calibration strength (see PodSpec.calibrated)")
    ap.add_argument("--hierarchical", action="store_true",
                    help="synthesize the two-level schedule: exact ICI "
                         "reduce per machine, compiled mixing across "
                         "DCN only")
    ap.add_argument("--emit", choices=("json", "summary"),
                    default="summary")
    args = ap.parse_args(argv)

    pod = PodSpec(args.machines, args.chips, ici_cost=args.ici_cost,
                  dcn_cost=args.dcn_cost)
    if args.traffic:
        with open(args.traffic) as fh:
            rows = json.load(fh)
        pod = pod.calibrated(
            {(int(s), int(d)): float(b) for s, d, b in rows},
            contention=args.contention)
    sketch = Sketch(max_period=args.max_period,
                    max_degree=args.max_degree)
    compiled = compile_topology(pod, sketch, eps=args.eps,
                                hierarchical=args.hierarchical)
    if args.emit == "json":
        print(json.dumps(compiled.as_json(), indent=1, sort_keys=True))
    else:
        print(f"winner: {compiled.name}  "
              f"(searched {compiled.search['candidates']:.0f} "
              f"candidates, pruned {compiled.search['pruned']:.0f}, "
              f"{compiled.search['seconds']:.2f}s)")
        for k, v in compiled.score.items():
            print(f"  {k}: {v:.6g}")
        for name, sc in sorted(compiled.report.items()):
            print(f"{name:>28}: cost_to_consensus="
                  f"{sc['cost_to_consensus']:.3f}  rounds/period="
                  f"{sc['rounds_per_period']:.0f}")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

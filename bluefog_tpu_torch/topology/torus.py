"""Torus-aware dynamic schedules + machine-checked ICI congestion accounting.

Port of ``bluefog_tpu/topology/torus.py``, its code copied whole: only
its imports name the port's modules (``topology.spec``), so its outputs
are the JAX package's byte for byte.

A pessimistic scaling projection charges a one-peer ``2^k`` rank shift
``min(2^k, n - 2^k)`` nearest-neighbor hops — a 1-D worst case that ignores
the physical interconnect.  A TPU v5e pod is a 2-D torus of ICI links (a
v5e-128 slice is an (8, 16) torus; ``jax.experimental.mesh_utils.
create_device_mesh`` hands out ranks in torus order), so the honest cost of
a permutation round is its **link congestion**: route every (src, dst) pair
along dimension-ordered minimal torus paths and take the maximum number of
payloads any single directed link carries.  Round wall-time =
``congestion x payload / link_bandwidth``.

This module provides
* the congestion counter (``link_loads`` / ``round_congestion``) — the
  machine-checked replacement for the closed-form hop guess, and
* ``torus_one_peer_schedule`` — one-peer dynamic rounds defined directly in
  torus coordinates, so the question "does the schedule map onto physical
  neighbors?" is answered by construction:

  - ``mode="single_hop"``: every round rotates the whole torus by one hop
    along one axis (2 rounds per axis, +/-).  Congestion is exactly 1 —
    the pessimistic routing model and the full-link-rate model coincide.
  - ``mode="exp2"``: per-axis exponential-2 shifts (the reference's
    one-peer Exponential-2 schedule, reference common/topology_util.py:
    315-357, re-indexed per torus axis).  With power-of-two axes and
    1/2-1/2 weights this reaches the EXACT average after
    ``sum(log2(axis))`` rounds — the hypercube dissemination argument,
    axis by axis — at a machine-counted mean congestion far below the
    1-D ``min(2^k, n-2^k)`` bound.

No jax imports: pure host-side schedule/analysis code (usable at
trace time and in CPU-only projection harnesses).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.topology.spec import DynamicTopology

__all__ = [
    "TorusSpec",
    "link_loads",
    "round_congestion",
    "schedule_congestion",
    "torus_one_peer_schedule",
    "torus_shift_round",
    "mixing_matrix",
    "consensus_contraction",
    "rounds_from_contraction",
    "rounds_to_consensus",
    "score_schedule",
    "default_pod_schedule",
]


@dataclasses.dataclass(frozen=True)
class TorusSpec:
    """Physical torus shape.  Rank r sits at the row-major coordinate
    ``unravel(r, axes)`` — the order ``mesh_utils.create_device_mesh``
    produces on a real slice, so logical rank i IS torus position i."""

    axes: Tuple[int, ...]

    @property
    def size(self) -> int:
        return int(np.prod(self.axes))

    def coord(self, rank: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(rank, self.axes))

    def rank(self, coord: Sequence[int]) -> int:
        wrapped = [c % L for c, L in zip(coord, self.axes)]
        return int(np.ravel_multi_index(wrapped, self.axes))

    def is_neighbor(self, a: int, b: int) -> bool:
        """True iff a and b are one ICI hop apart (differ by +-1 mod L on
        exactly one axis)."""
        ca, cb = self.coord(a), self.coord(b)
        diff_axes = [i for i, (x, y) in enumerate(zip(ca, cb)) if x != y]
        if len(diff_axes) != 1:
            return False
        i = diff_axes[0]
        d = (cb[i] - ca[i]) % self.axes[i]
        return d == 1 or d == self.axes[i] - 1


def _axis_route(delta: int, length: int) -> List[Tuple[int, int, float]]:
    """Minimal-direction route groups for a displacement on one ring.

    Returns [(sign, hops, load_fraction)]: the payload goes ``hops`` hops
    in direction ``sign`` starting FROM THE SOURCE; when both directions
    are equally short (d == L/2) the payload is split half/half over the
    two opposite semicircles — the torus has both, and any reasonable
    router load-balances the tie."""
    d = delta % length
    if d == 0:
        return []
    back = length - d
    if d < back:
        return [(+1, d, 1.0)]
    if back < d:
        return [(-1, back, 1.0)]
    return [(+1, d, 0.5), (-1, back, 0.5)]


def link_loads(
    send_map,
    spec: TorusSpec,
    embedding: Optional[Sequence[int]] = None,
    payloads: Optional[Dict[Tuple[int, int], float]] = None,
) -> Dict[Tuple[Tuple[int, ...], int, int], float]:
    """Per-directed-link payload load of one exchange round under
    dimension-ordered minimal routing.

    ``send_map``: {src_rank: dst_rank} (one-peer rounds), or an iterable
    of ``(src, dst)`` pairs — the multi-shift form, where one src may
    send to several dsts in the same round (in-degree > 1 schedules;
    duplicate pairs accumulate).  Each pair routes one payload unless
    ``payloads[(src, dst)]`` scales it (the traffic-calibration path
    routes measured per-edge BYTES instead of unit payloads).
    ``embedding``: optional permutation; ``embedding[r]`` is the torus
    position of logical rank r (identity = row-major, the
    ``create_device_mesh`` order).  A link is keyed
    ``(node_coord, axis, sign)``: the link leaving ``node_coord`` along
    ``axis`` in direction ``sign``.
    """
    loads: Dict[Tuple[Tuple[int, ...], int, int], float] = {}
    emb = list(range(spec.size)) if embedding is None else list(embedding)
    pairs = (send_map.items() if isinstance(send_map, dict)
             else list(send_map))
    for src, dst in pairs:
        if src == dst:
            continue
        size = 1.0 if payloads is None else float(
            payloads.get((src, dst), 1.0))
        if size == 0.0:
            continue
        cur = list(spec.coord(emb[src]))
        tgt = spec.coord(emb[dst])
        for ax, L in enumerate(spec.axes):
            # each direction group walks from the SOURCE position of
            # this axis (a tie-split's two halves take opposite
            # semicircles; the -1 half must not retrace the +1 path)
            start = cur[ax]
            for sign, hops, frac in _axis_route(tgt[ax] - start, L):
                pos = start
                for _ in range(hops):
                    cur[ax] = pos
                    key = (tuple(cur), ax, sign)
                    loads[key] = loads.get(key, 0.0) + frac * size
                    pos = (pos + sign) % L
            cur[ax] = tgt[ax]
    return loads


def round_congestion(
    round_or_map,
    spec: TorusSpec,
    embedding: Optional[Sequence[int]] = None,
) -> float:
    """Maximum per-link load of one round (1.0 == a single payload at full
    link rate; the round's wall-time multiplier under the pessimistic,
    link-limited model).  Multi-shift ``DynamicTopology`` rounds
    (in-degree > 1) route EVERY declared edge — the loads add."""
    if isinstance(round_or_map, DynamicTopology):
        send_map = list(round_or_map.edges)
    elif isinstance(round_or_map, dict):
        send_map = dict(round_or_map)
    else:
        send_map = list(round_or_map)
    loads = link_loads(send_map, spec, embedding)
    return max(loads.values()) if loads else 0.0


def schedule_congestion(
    schedule: Iterable, spec: TorusSpec,
    embedding: Optional[Sequence[int]] = None,
) -> Dict[str, object]:
    """Machine-checked congestion profile of a dynamic schedule."""
    per_round = [round_congestion(r, spec, embedding) for r in schedule]
    return {
        "per_round": per_round,
        "mean": float(np.mean(per_round)) if per_round else 0.0,
        "max": float(np.max(per_round)) if per_round else 0.0,
    }


def torus_shift_round(
    spec: TorusSpec, axis: int, shift: int,
    self_weight: float = 0.5,
) -> DynamicTopology:
    """One round where every rank sends to the rank ``shift`` positions away
    along ``axis`` (a pure torus rotation: in-degree 1 everywhere)."""
    n = spec.size
    edge_weights: Dict[Tuple[int, int], float] = {}
    w = 1.0 - self_weight
    for src in range(n):
        c = list(spec.coord(src))
        c[axis] = (c[axis] + shift) % spec.axes[axis]
        dst = spec.rank(c)
        if dst != src:
            edge_weights[(src, dst)] = w
    return DynamicTopology.from_edges(n, edge_weights, [self_weight] * n)


def torus_one_peer_schedule(
    axes: Sequence[int], mode: str = "single_hop",
) -> List[DynamicTopology]:
    """One-peer dynamic schedule defined in physical torus coordinates.

    ``mode="single_hop"``: rounds cycle through the torus generators
    (+1 and -1 along each axis): every round is a one-ICI-hop rotation,
    congestion exactly 1.  Union over a period = the torus graph
    (strongly connected), weights 1/2-1/2 as in the reference's dynamic
    one-peer mode (reference torch/mpi_ops.py:504-510).

    ``mode="exp2"``: per-axis shifts of +2^k, k = 0..log2(L)-1 — the
    reference's Exponential-2 one-peer schedule applied along each torus
    axis.  For power-of-two axes, one period reaches the exact average
    (recursive pairwise halving per axis).
    """
    spec = TorusSpec(tuple(int(a) for a in axes))
    rounds: List[DynamicTopology] = []
    if mode == "single_hop":
        for axis in range(len(spec.axes)):
            if spec.axes[axis] < 2:
                continue
            rounds.append(torus_shift_round(spec, axis, +1))
            if spec.axes[axis] > 2:
                rounds.append(torus_shift_round(spec, axis, -1))
    elif mode == "exp2":
        for axis, L in enumerate(spec.axes):
            if L < 2:
                continue
            for k in range(max(1, int(math.log2(L)))):
                rounds.append(torus_shift_round(spec, axis, 2 ** k))
    else:
        raise ValueError(f"unknown torus schedule mode {mode!r}")
    return rounds


def mixing_matrix(rnd: DynamicTopology) -> np.ndarray:
    """Row-stochastic update matrix M with x_new = M @ x:
    ``M[dst, src]`` is the weight dst applies to src's value."""
    n = rnd.size
    M = np.zeros((n, n))
    for (src, dst), w in zip(rnd.edges, rnd.edge_weight_values):
        M[dst, src] = w
    M[np.arange(n), np.arange(n)] += np.asarray(rnd.self_weight_values)
    return M


def consensus_contraction(schedule: Sequence[DynamicTopology]) -> float:
    """Spectral contraction of one period: max |eigenvalue| of
    (P - 1 1^T / n) where P is the product of the per-round matrices.
    0.0 means the period reaches the exact average."""
    n = schedule[0].size
    P = np.eye(n)
    for rnd in schedule:
        P = mixing_matrix(rnd) @ P
    dev = P - np.full((n, n), 1.0 / n)
    return float(np.max(np.abs(np.linalg.eigvals(dev))))


def rounds_from_contraction(sigma: float, period: int,
                            eps: float = 1e-3) -> float:
    """Rounds to eps-consensus given one period's contraction sigma —
    the closed-form core of :func:`rounds_to_consensus`, public so the
    topology compiler's Fourier-scored candidates (which know sigma
    without building matrices) share the exact same figure of merit."""
    if sigma <= eps:  # exact (or better than eps) within one period
        return float(period)
    if sigma >= 1.0:
        return float("inf")
    return float(period * math.log(eps) / math.log(sigma))


_r2c_from_sigma = rounds_from_contraction  # internal alias (pre-PR name)


def rounds_to_consensus(
    schedule: Sequence[DynamicTopology], eps: float = 1e-3,
) -> float:
    """Rounds (not periods) for the disagreement to contract below eps.
    Exact-average periods report one period's length."""
    return _r2c_from_sigma(consensus_contraction(schedule), len(schedule),
                           eps)


def score_schedule(
    schedule: Sequence[DynamicTopology], spec: TorusSpec,
    eps: float = 1e-3,
) -> Dict[str, float]:
    """Machine-counted figures of merit for a one-peer schedule on a
    physical torus: per-STEP wire cost (mean link congestion — one round
    fires per training step, so this is the steady-state comm-time
    multiplier) and cost-to-consensus (summed congestion of the rounds a
    fresh disagreement needs to contract below ``eps`` — the statistical-
    efficiency axis the per-step number hides)."""
    cong = schedule_congestion(schedule, spec)
    sigma = consensus_contraction(schedule)  # once: O(period * n^3)
    period = len(schedule)
    r2c = _r2c_from_sigma(sigma, period, eps)
    return {
        "rounds_per_period": float(period),
        "mean_congestion": cong["mean"],
        "max_congestion": cong["max"],
        "rounds_to_consensus": r2c,
        "cost_to_consensus": cong["mean"] * r2c,
        "exact_average_per_period": float(sigma < 1e-12),
    }


def default_pod_schedule(
    axes: Sequence[int], eps: float = 1e-3, verbose: bool = False,
):
    """The documented default one-peer schedule for a pod's physical torus
    ``axes`` — picked by MACHINE-COUNTED score, not by rule of thumb.

    This two-entry menu is the floor, not the ceiling: for a real pod
    (heterogeneous DCN/ICI links, measured traffic) use
    ``topology.compiler.compile_topology``, which SEARCHES the weighted
    multi-shift schedule space and beats both menu entries at pod
    shapes (docs/topology.md).

    Candidates (all defined in torus coordinates, so every round's link
    congestion is exact, not a 1-D hop guess):

    * ``exp2``       — per-axis exponential-2 shifts: exact average each
      ``sum(log2(axis))``-round period, mean congestion ~2.3 on a
      near-square torus (the best-of-both-worlds schedule).
    * ``single_hop`` — one-ICI-hop rotations: congestion exactly 1 (the
      cheapest possible per-step wire time) but hundreds of rounds to
      consensus at pod scale.

    Selection: lowest ``cost_to_consensus`` (congestion-weighted rounds
    until a fresh disagreement contracts below ``eps``), tie-broken by
    per-step ``mean_congestion``.  On power-of-two tori this picks
    ``exp2``: ~16 congestion-units to the EXACT average vs single-hop's
    ~700 to 1e-3 — while its per-step cost (~2.3x single-hop) still
    projects >=95% scaling efficiency at v5e-128 with the int8 wire
    compressor (benchmarks/scaling_projection_r05.json).

    Returns ``(schedule, report)``: the winning round list (feed it to
    ``optim.functional.build_train_step(schedule=...)``, or iterate it
    as the per-step weight schedule for the eager
    ``api.neighbor_allreduce`` dynamic mode) and the per-candidate score
    table the choice was made from.
    """
    spec = TorusSpec(tuple(int(a) for a in axes))
    report = {}
    best_name, best_sched, best_key = None, None, None
    for mode in ("exp2", "single_hop"):
        sched = torus_one_peer_schedule(spec.axes, mode)
        if not sched:  # degenerate (all axes length 1)
            continue
        score = score_schedule(sched, spec, eps=eps)
        report[mode] = score
        key = (score["cost_to_consensus"], score["mean_congestion"])
        if best_key is None or key < best_key:
            best_name, best_sched, best_key = mode, sched, key
    if best_sched is None:
        raise ValueError(f"no non-trivial schedule for torus axes {axes!r}")
    for mode in report:
        report[mode]["selected"] = float(mode == best_name)
    if verbose:
        for mode, score in report.items():
            print(f"[default_pod_schedule] {mode}: {score}")
    return best_sched, report

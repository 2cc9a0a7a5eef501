"""Device-ready topology specification.

Port of ``bluefog_tpu/topology/spec.py``.  The edge set {(src, dst)} of a
digraph over n ranks is partitioned by ``s = (dst - src) mod n``; each
class is a partial permutation of the rank axis, i.e. exactly one gather
along the rank axis of a stacked ``[n, ...]`` tensor (or one point-to-point
exchange per process in a distributed backend).  Circulant graphs
(exponential-2, ring, fully-connected) decompose into a handful of
classes; the weighted combine then reads per-rank weight vectors.

Graphs are the port's own :class:`~bluefog_tpu_torch.topology.graphs.DiGraph`
(a weight matrix); this module imports numpy only.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.topology.graphs import DiGraph

# This module legitimately constructs weight tables from scratch: the
# analysis lint's weight-matrix-bypass rule treats it as an authority
# (everywhere else, tables must come from the shared helpers here).
_WEIGHT_AUTHORITY = True

__all__ = ["ShiftClass", "Topology", "DynamicTopology",
           "self_weights_of", "uniform_topology_spec"]


def self_weights_of(spec) -> Tuple[float, ...]:
    """Per-rank self weights of either spec flavor (Topology keeps them
    as ``self_weights``, DynamicTopology as ``self_weight_values``)."""
    if isinstance(spec, Topology):
        return spec.self_weights
    return spec.self_weight_values


def uniform_topology_spec(graph: DiGraph) -> "Topology":
    """Resolve a graph to the reference's *unweighted* combine: every rank
    uses 1/(in_degree+1) for itself and each in-neighbor
    (reference torch/mpi_ops.py:504-510)."""
    n = graph.number_of_nodes()
    adj = graph.weights != 0.0
    np.fill_diagonal(adj, False)
    weights = np.zeros((n, n))
    for dst in range(n):
        srcs = np.nonzero(adj[:, dst])[0]
        w = 1.0 / (len(srcs) + 1)
        weights[srcs, dst] = w
        weights[dst, dst] = w
    return Topology.from_weight_matrix(weights)


@dataclasses.dataclass(frozen=True)
class ShiftClass:
    """One permutation slice of an edge set.

    ``perm``: tuple of (src, dst) pairs, each src/dst appearing at most once.
    ``recv_weights``: length-n vector; entry d is the weight rank d applies to
    the value it receives through this class (0.0 if d receives nothing).
    """

    shift: int
    perm: Tuple[Tuple[int, int], ...]
    recv_weights: Tuple[float, ...]


def _decompose(
    size: int,
    edges: Sequence[Tuple[int, int]],
    edge_weights: Dict[Tuple[int, int], float],
) -> Tuple[ShiftClass, ...]:
    by_shift: Dict[int, List[Tuple[int, int]]] = {}
    for (src, dst) in edges:
        if src == dst:
            continue
        by_shift.setdefault((dst - src) % size, []).append((src, dst))
    classes = []
    for shift in sorted(by_shift):
        pairs = sorted(by_shift[shift])
        recv = [0.0] * size
        seen_src, seen_dst = set(), set()
        for src, dst in pairs:
            if src in seen_src or dst in seen_dst:
                raise ValueError(
                    f"shift class {shift} is not a partial permutation: {pairs}"
                )
            seen_src.add(src)
            seen_dst.add(dst)
            recv[dst] = float(edge_weights[(src, dst)])
        classes.append(ShiftClass(shift, tuple(pairs), tuple(recv)))
    return tuple(classes)


@dataclasses.dataclass(frozen=True)
class Topology:
    """A static weighted digraph, flattened to arrays + shift classes.

    ``weights[src, dst]`` is the combine weight dst applies to src's value
    (reference convention, bluefog/common/topology_util.py:40-51).
    """

    size: int
    weights_bytes: bytes  # float64 [n, n] raw buffer (hashable)
    shift_classes: Tuple[ShiftClass, ...]
    self_weights: Tuple[float, ...]

    @staticmethod
    def from_graph(graph: DiGraph) -> "Topology":
        return Topology.from_weight_matrix(graph.to_numpy())

    @staticmethod
    def from_weight_matrix(weights: np.ndarray) -> "Topology":
        weights = np.asarray(weights, dtype=np.float64)
        n = weights.shape[0]
        assert weights.shape == (n, n)
        edges = [(int(s), int(d)) for s, d in zip(*np.nonzero(weights))]
        ew = {(s, d): float(weights[s, d]) for (s, d) in edges}
        classes = _decompose(n, edges, ew)
        self_w = tuple(float(weights[i, i]) for i in range(n))
        return Topology(
            size=n,
            weights_bytes=weights.tobytes(),
            shift_classes=classes,
            self_weights=self_w,
        )

    @property
    def weights(self) -> np.ndarray:
        return np.frombuffer(self.weights_bytes, dtype=np.float64).reshape(
            self.size, self.size
        )

    def digest(self) -> str:
        return hashlib.sha1(self.weights_bytes).hexdigest()[:16]

    def to_graph(self) -> DiGraph:
        return DiGraph(self.weights)

    def in_neighbors(self, rank: int) -> List[int]:
        w = self.weights
        return [s for s in range(self.size) if s != rank and w[s, rank] != 0.0]

    def out_neighbors(self, rank: int) -> List[int]:
        w = self.weights
        return [d for d in range(self.size) if d != rank and w[rank, d] != 0.0]

    def in_degrees(self) -> np.ndarray:
        w = self.weights
        off = (w != 0.0) & ~np.eye(self.size, dtype=bool)
        return off.sum(axis=0)

    def out_degrees(self) -> np.ndarray:
        w = self.weights
        off = (w != 0.0) & ~np.eye(self.size, dtype=bool)
        return off.sum(axis=1)

    def max_in_degree(self) -> int:
        return int(self.in_degrees().max()) if self.size else 0

    def is_uniform_in_degree(self) -> bool:
        deg = self.in_degrees()
        return bool((deg == deg[0]).all())


@dataclasses.dataclass(frozen=True)
class DynamicTopology:
    """One round of a dynamic topology: explicit per-edge send/recv sets.

    ``edge_weights[(src, dst)]`` is the total scale applied to src's value as
    seen by dst (sender-side dst_weight x receiver-side src_weight, one
    multiply at the receiver).  A declared edge with weight 0.0 is still an
    edge: it transfers, scaled by zero (reference mpi_controller.cc:594-600).
    """

    size: int
    edges: Tuple[Tuple[int, int], ...]
    edge_weight_values: Tuple[float, ...]
    self_weight_values: Tuple[float, ...]  # length n

    @staticmethod
    def from_edges(
        size: int,
        edge_weights: Dict[Tuple[int, int], float],
        self_weights: Optional[Sequence[float]] = None,
    ) -> "DynamicTopology":
        edges = tuple(sorted(edge_weights))
        vals = tuple(float(edge_weights[e]) for e in edges)
        if self_weights is None:
            self_weights = [0.0] * size
        return DynamicTopology(size, edges, vals,
                               tuple(float(w) for w in self_weights))

    @functools.cached_property
    def shift_classes(self) -> Tuple[ShiftClass, ...]:
        # the decomposition of an immutable edge set never changes, so
        # it is computed once (cached_property writes through __dict__,
        # which frozen dataclasses allow)
        ew = dict(zip(self.edges, self.edge_weight_values))
        return _decompose(self.size, self.edges, ew)

    def in_degrees(self) -> np.ndarray:
        """Per-rank in-degree (received edges) of this round."""
        deg = np.zeros(self.size, np.int64)
        for (_, dst) in self.edges:
            deg[dst] += 1
        return deg

    def max_in_degree(self) -> int:
        return int(self.in_degrees().max()) if self.edges else 0

    def digest(self) -> str:
        h = hashlib.sha1(repr((self.size, self.edges, self.edge_weight_values,
                               self.self_weight_values)).encode())
        return h.hexdigest()[:16]

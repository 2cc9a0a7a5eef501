"""Static virtual-topology generators.

Port of ``bluefog_tpu/topology/graphs.py``.  The JAX package returns
``networkx.DiGraph`` objects; networkx is not a dependency of the port,
so every generator here returns a :class:`DiGraph` of the port's own:
the ``[n, n]`` float64 weight matrix plus the few graph queries the
framework uses.  Its semantics are those of a networkx DiGraph built by
``nx.from_numpy_array``: an edge ``(i, j)`` exists where
``weights[i, j] != 0``, a non-zero diagonal entry is a self-loop, and
``weights`` is exactly what ``nx.to_numpy_array`` of that graph gives.

The averaging convention is the framework's:

    new_x[rank] = W[rank, rank] * x[rank] + sum_{src} W[src, rank] * x[src]

i.e. **W[i, j] is the weight node j applies to the value it receives from
node i** (reference GetRecvWeights, topology_util.py:40-51).

This module imports numpy only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "DiGraph",
    "ExponentialTwoGraph",
    "ExponentialGraph",
    "SymmetricExponentialGraph",
    "MeshGrid2DGraph",
    "StarGraph",
    "RingGraph",
    "FullyConnectedGraph",
    "IsTopologyEquivalent",
    "IsRegularGraph",
    "GetRecvWeights",
    "GetSendWeights",
    "circulant_graph",
]


class DiGraph:
    """A weighted digraph over ranks ``0..n-1``, held as its weight
    matrix (``weights[src, dst]``, float64, zero where there is no
    edge)."""

    __slots__ = ("_w",)

    def __init__(self, weights):
        w = np.array(weights, dtype=np.float64)
        if w.ndim != 2 or w.shape[0] != w.shape[1]:
            raise ValueError(f"weight matrix must be square, got {w.shape}")
        w.setflags(write=False)
        self._w = w

    @property
    def weights(self) -> np.ndarray:
        """The read-only ``[n, n]`` float64 weight matrix."""
        return self._w

    def to_numpy(self) -> np.ndarray:
        """A writable copy of the weight matrix (``nx.to_numpy_array``)."""
        return self._w.copy()

    def number_of_nodes(self) -> int:
        return self._w.shape[0]

    def number_of_edges(self) -> int:
        return int(np.count_nonzero(self._w))

    def successors(self, rank: int) -> List[int]:
        """Out-neighbors in ascending order (the self-loop included)."""
        return [int(d) for d in np.nonzero(self._w[rank])[0]]

    def predecessors(self, rank: int) -> List[int]:
        """In-neighbors in ascending order (the self-loop included)."""
        return [int(s) for s in np.nonzero(self._w[:, rank])[0]]

    def degree(self, rank: int) -> int:
        """In- plus out-degree; a self-loop counts once in each."""
        return int(np.count_nonzero(self._w[rank])
                   + np.count_nonzero(self._w[:, rank]))

    def __repr__(self) -> str:
        return (f"DiGraph(n={self.number_of_nodes()}, "
                f"edges={self.number_of_edges()})")


def _is_power_of(x: int, base: int) -> bool:
    if x <= 0:
        return False
    p = 1
    while p < x:
        p *= base
    return p == x


def circulant_graph(size: int, shift_weights: Dict[int, float]) -> DiGraph:
    """Build a circulant digraph from a ``{shift: weight}`` profile.

    Edge (i, (i+s) % size) gets weight ``shift_weights[s]`` for every node i.
    Shift 0 is the self-loop weight.
    """
    row = np.zeros(size)
    for shift, w in shift_weights.items():
        row[shift % size] += w
    return DiGraph(np.stack([np.roll(row, i) for i in range(size)]))


def _uniform_circulant(size: int, shifts) -> DiGraph:
    """Circulant graph with uniform weight 1/(len(shifts)) over given shifts
    (which include the self shift 0)."""
    shifts = sorted(set(int(s) % size for s in shifts))
    w = 1.0 / len(shifts)
    return circulant_graph(size, {s: w for s in shifts})


def ExponentialTwoGraph(size: int) -> DiGraph:
    """Each node i connects to i + 2**k for all 2**k < size
    (reference topology_util.py:66-89)."""
    assert size > 0
    shifts = [0] + [s for s in range(1, size) if s & (s - 1) == 0]
    return _uniform_circulant(size, shifts)


def ExponentialGraph(size: int, base: int = 2) -> DiGraph:
    """Each node i connects to i + base**k (all powers of ``base`` < size)
    (reference topology_util.py:99-125)."""
    assert size > 0
    shifts = [0] + [s for s in range(1, size) if _is_power_of(s, base)]
    return _uniform_circulant(size, shifts)


def SymmetricExponentialGraph(size: int, base: int = 4) -> DiGraph:
    """Exponential graph whose second half of shifts mirrors the first
    half: shift s counts if ``s if s <= size//2 else size - s`` is a power
    of ``base`` (reference topology_util.py:128-157)."""
    assert size > 0
    shifts = [0]
    for s in range(1, size):
        index = s if s <= size // 2 else size - s
        if _is_power_of(index, base):
            shifts.append(s)
    return _uniform_circulant(size, shifts)


def MeshGrid2DGraph(size: int,
                    shape: Optional[Tuple[int, int]] = None) -> DiGraph:
    """2-D grid graph with Metropolis-Hastings weights: 4-neighborhood,
    w_ij = 1/max(deg_i, deg_j) (degree counts self), self weight =
    1 - row sum (reference topology_util.py:160-211)."""
    assert size > 0
    if shape is None:
        nrow = int(np.sqrt(size))
        while size % nrow != 0:
            nrow -= 1
        shape = (nrow, size // nrow)
    nrow, ncol = shape
    assert nrow * ncol == size, "The shape doesn't match the size provided."

    connect = np.zeros((size, size))
    for i in range(size):
        connect[i, i] = 1.0
        if (i + 1) % ncol != 0:  # right neighbor in the same row
            connect[i, i + 1] = connect[i + 1, i] = 1.0
        if i + ncol < size:  # neighbor in the next row
            connect[i, i + ncol] = connect[i + ncol, i] = 1.0

    degree = [np.count_nonzero(connect[i]) for i in range(size)]  # incl. self
    weights = np.zeros((size, size))
    for i in range(size):
        for j in np.nonzero(connect[i])[0]:
            if i != j:
                weights[i, j] = 1.0 / max(degree[i], degree[j])
        weights[i, i] = 1.0 - weights[i].sum()
    return DiGraph(weights)


def StarGraph(size: int, center_rank: int = 0) -> DiGraph:
    """Bidirectional star (reference topology_util.py:214-237)."""
    assert size > 0
    weights = np.zeros((size, size))
    for i in range(size):
        weights[i, i] = 1.0 - 1.0 / size
        weights[center_rank, i] = 1.0 / size
        weights[i, center_rank] = 1.0 / size
    return DiGraph(weights)


def RingGraph(size: int, connect_style: int = 0) -> DiGraph:
    """Ring graph. connect_style: 0 = bidirectional, 1 = left only,
    2 = right only (reference topology_util.py:240-281)."""
    assert size > 0
    assert 0 <= connect_style <= 2, (
        "connect_style has to be int between 0 and 2, where 0 for "
        "bi-connection, 1 for left connection, 2 for right connection."
    )
    if size == 1:
        return circulant_graph(1, {0: 1.0})
    if size == 2:
        return circulant_graph(2, {0: 0.5, 1: 0.5})
    if connect_style == 0:
        return circulant_graph(size, {0: 1 / 3, 1: 1 / 3, size - 1: 1 / 3})
    if connect_style == 1:
        return circulant_graph(size, {0: 0.5, size - 1: 0.5})
    return circulant_graph(size, {0: 0.5, 1: 0.5})


def FullyConnectedGraph(size: int) -> DiGraph:
    """All-to-all with uniform 1/size weights
    (reference topology_util.py:284-303)."""
    assert size > 0
    return circulant_graph(size, {s: 1.0 / size for s in range(size)})


def IsTopologyEquivalent(topo1: Optional[DiGraph],
                         topo2: Optional[DiGraph]) -> bool:
    """Weighted-adjacency equality (not isomorphism)
    (reference topology_util.py:23-37)."""
    if topo1 is None or topo2 is None:
        return False
    if topo1.number_of_nodes() != topo2.number_of_nodes():
        return False
    if topo1.number_of_edges() != topo2.number_of_edges():
        return False
    return bool((topo1.weights == topo2.weights).all())


def IsRegularGraph(topo: DiGraph) -> bool:
    """All nodes have the same (total) degree
    (reference topology_util.py:306-312)."""
    degree = topo.degree(0)
    return all(topo.degree(r) == degree
               for r in range(1, topo.number_of_nodes()))


def GetRecvWeights(topo: DiGraph, rank: int) -> Tuple[float, Dict[int, float]]:
    """(self_weight, {src_rank: weight}) that ``rank`` applies when
    combining (reference topology_util.py:40-51)."""
    weights = topo.weights
    self_weight = 0.0
    neighbor_weights = {}
    for src in topo.predecessors(rank):
        if src == rank:
            self_weight = float(weights[rank, rank])
        else:
            neighbor_weights[src] = float(weights[src, rank])
    return self_weight, neighbor_weights


def GetSendWeights(topo: DiGraph, rank: int) -> Tuple[float, Dict[int, float]]:
    """(self_weight, {dst_rank: weight}) read along ``rank``'s out-edges
    (reference topology_util.py:54-64)."""
    weights = topo.weights
    self_weight = 0.0
    neighbor_weights = {}
    for dst in topo.successors(rank):
        if dst == rank:
            self_weight = float(weights[rank, rank])
        else:
            neighbor_weights[dst] = float(weights[rank, dst])
    return self_weight, neighbor_weights

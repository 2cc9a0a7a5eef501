"""The port's topology package (bluefog_tpu_torch/topology) against the
JAX package's, byte for byte.  The port builds on numpy only (no
networkx), so every generator's weight matrix is held byte-equal to
``nx.to_numpy_array`` of the JAX generator's graph, and the derived
specs (shift classes, receive weights, self weights, digests) and the
one-peer dynamic schedule are held equal round by round.  No tolerance:
the port does the same float64 arithmetic in the same order."""

import itertools

import networkx as nx
import numpy as np
import pytest

from bluefog_tpu import topology as J
from bluefog_tpu_torch import topology as T

SIZES = [1, 2, 3, 4, 5, 8, 12, 16]

GENERATORS = {
    "exp2": lambda m, n: m.ExponentialTwoGraph(n),
    "exp3": lambda m, n: m.ExponentialGraph(n, base=3),
    "exp2b": lambda m, n: m.ExponentialGraph(n),
    "symexp4": lambda m, n: m.SymmetricExponentialGraph(n),
    "symexp2": lambda m, n: m.SymmetricExponentialGraph(n, base=2),
    "mesh2d": lambda m, n: m.MeshGrid2DGraph(n),
    "star": lambda m, n: m.StarGraph(n),
    "star_last": lambda m, n: m.StarGraph(n, center_rank=n - 1),
    "ring": lambda m, n: m.RingGraph(n),
    "ring_left": lambda m, n: m.RingGraph(n, connect_style=1),
    "ring_right": lambda m, n: m.RingGraph(n, connect_style=2),
    "full": lambda m, n: m.FullyConnectedGraph(n),
    "circulant": lambda m, n: m.circulant_graph(
        n, {0: 0.25, 1: 0.5, n - 1: 0.125, 3: 0.125}),
}


def _classes(spec):
    return [(c.shift, c.perm, c.recv_weights) for c in spec.shift_classes]


def _same_spec(a, b):
    assert a.size == b.size
    assert _classes(a) == _classes(b)
    if isinstance(b, J.Topology):
        assert isinstance(a, T.Topology)
        assert a.weights_bytes == b.weights_bytes
        assert a.self_weights == b.self_weights
        assert a.digest() == b.digest()
        for r in range(a.size):
            assert a.in_neighbors(r) == b.in_neighbors(r)
            assert a.out_neighbors(r) == b.out_neighbors(r)
        assert np.array_equal(a.in_degrees(), b.in_degrees())
        assert np.array_equal(a.out_degrees(), b.out_degrees())
        assert a.is_uniform_in_degree() == b.is_uniform_in_degree()
    else:
        assert a.edges == b.edges
        assert a.edge_weight_values == b.edge_weight_values
        assert a.self_weight_values == b.self_weight_values
        assert a.digest() == b.digest()
        assert np.array_equal(a.in_degrees(), b.in_degrees())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_generator_byte_equal(gen, n):
    jg = GENERATORS[gen](J, n)
    tg = GENERATORS[gen](T, n)
    jw = nx.to_numpy_array(jg)
    assert tg.weights.dtype == np.float64
    assert tg.weights.tobytes() == jw.tobytes()
    assert tg.number_of_nodes() == jg.number_of_nodes()
    assert tg.number_of_edges() == jg.number_of_edges()
    for r in range(n):
        assert tg.successors(r) == list(jg.successors(r))
        assert tg.predecessors(r) == list(jg.predecessors(r))
        assert tg.degree(r) == jg.degree(r)
        assert T.GetRecvWeights(tg, r) == J.GetRecvWeights(jg, r)
        assert T.GetSendWeights(tg, r) == J.GetSendWeights(jg, r)
    assert T.IsRegularGraph(tg) == J.IsRegularGraph(jg)
    _same_spec(T.Topology.from_graph(tg), J.Topology.from_graph(jg))
    _same_spec(T.uniform_topology_spec(tg), J.uniform_topology_spec(jg))
    back = T.Topology.from_graph(tg).to_graph()
    assert back.weights.tobytes() == jw.tobytes()


@pytest.mark.parametrize("n", SIZES)
def test_one_peer_schedule_round_by_round(n):
    for gen in ("exp2", "ring", "star", "full"):
        js = J.one_peer_dynamic_schedule(GENERATORS[gen](J, n))
        ts = T.one_peer_dynamic_schedule(GENERATORS[gen](T, n))
        assert len(js) == len(ts)
        for a, b in zip(ts, js):
            _same_spec(a, b)
        for i in range(len(js) + 2):
            assert (T.one_peer_round(GENERATORS[gen](T, n), i)
                    == J.one_peer_round(GENERATORS[gen](J, n), i))
    for a, b in zip(T.one_peer_dynamic_schedule(n),
                    J.one_peer_dynamic_schedule(n)):
        _same_spec(a, b)
    for a, b in zip(T.one_peer_dynamic_schedule(n, rounds=5),
                    J.one_peer_dynamic_schedule(n, rounds=5)):
        _same_spec(a, b)


@pytest.mark.parametrize("n", [2, 4, 5, 8])
def test_dynamic_send_recv_iterators(n):
    for r in range(n):
        jt = J.GetDynamicOnePeerSendRecvRanks(J.ExponentialTwoGraph(n), r)
        tt = T.GetDynamicOnePeerSendRecvRanks(T.ExponentialTwoGraph(n), r)
        assert (list(itertools.islice(tt, 6))
                == list(itertools.islice(jt, 6)))


@pytest.mark.parametrize("world,local", [(8, 4), (12, 3), (16, 4)])
def test_machine_schedules(world, local):
    for r in range(world):
        for it_name in ("GetInnerOuterRingDynamicSendRecvRanks",
                        "GetInnerOuterExpo2DynamicSendRecvRanks"):
            jt = getattr(J, it_name)(world, local, r)
            tt = getattr(T, it_name)(world, local, r)
            assert (list(itertools.islice(tt, 7))
                    == list(itertools.islice(jt, 7)))
        jt = J.GetExp2DynamicSendRecvMachineRanks(world, local, r, r % local)
        tt = T.GetExp2DynamicSendRecvMachineRanks(world, local, r, r % local)
        assert list(itertools.islice(tt, 5)) == list(itertools.islice(jt, 5))
        for i in range(5):
            assert (T.exp2_machine_round(world // local, r // local, i)
                    == J.exp2_machine_round(world // local, r // local, i))


def test_dynamic_topology_from_edges_with_zero_weight_edge():
    edges = {(0, 1): 0.5, (1, 2): 0.0, (3, 0): 0.25, (2, 3): 1.0}
    selfs = [0.5, 0.5, 1.0, 0.0]
    a = T.DynamicTopology.from_edges(4, edges, selfs)
    b = J.DynamicTopology.from_edges(4, edges, selfs)
    _same_spec(a, b)
    assert T.self_weights_of(a) == tuple(selfs)
    c = T.DynamicTopology.from_edges(4, edges)
    assert c.self_weight_values == (0.0,) * 4


def test_topology_equivalence_and_errors():
    a, b = T.ExponentialTwoGraph(8), T.ExponentialTwoGraph(8)
    assert T.IsTopologyEquivalent(a, b)
    assert not T.IsTopologyEquivalent(a, T.RingGraph(8))
    assert not T.IsTopologyEquivalent(a, None)
    assert (T.IsTopologyEquivalent(a, T.RingGraph(8))
            == J.IsTopologyEquivalent(J.ExponentialTwoGraph(8),
                                      J.RingGraph(8)))
    with pytest.raises(AssertionError):
        T.MeshGrid2DGraph(6, shape=(4, 2))
    with pytest.raises(ValueError, match="square"):
        T.DiGraph(np.zeros((2, 3)))

"""The port's eager collective ops (``bluefog_tpu_torch.api`` over the
stacked backend) against the JAX package's (``bluefog_tpu.api`` over 8
virtual CPU devices), test for test as ``tests/test_ops.py``: the same
seeded numpy inputs go through ``bluefog_tpu`` (``bf.init()``) and the
port (``bf.init(size=8, device="cpu")``), and the outputs are compared.

Tolerance: 1e-6 of the largest entry in float32, 1e-12 in float64 (both
sides combine in the payload's accumulation dtype, with the same
weights); bfloat16 within test_ops.py's rtol of 1e-2 of the exact mean.
Error cases raise an exception of the same type name on both sides.
"""

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as JT
from bluefog_tpu_torch import topology as TT

SIZE = 8
DTYPES = [np.float32, np.float64, np.int32]
SIDES = ((jbf, JT), (tbf, TT))


@pytest.fixture
def both():
    jbf.init()
    tbf.init(size=SIZE, device="cpu")
    yield
    jbf.shutdown()
    tbf.shutdown()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def _tol(dtype):
    return 1e-12 if np.dtype(dtype) == np.float64 else 1e-6


def _close(got, want, dtype=np.float64):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
                ) if want.size else 0.0
    assert err <= _tol(dtype) * scale, (err, scale)


def _run(fn):
    """``fn(bf, topology_module)`` on the JAX package, then the port."""
    return [fn(bf, T) for bf, T in SIDES]


def _same_error(fn, match=None):
    names = []
    for bf, T in SIDES:
        with pytest.raises(Exception, match=match) as ei:
            fn(bf, T)
        names.append(type(ei.value).__name__)
    assert names[0] == names[1], names


def rank_tensor(bf, shape, dtype=np.float32, seed=None):
    """Per-rank tensor filled with the rank id (the reference pattern), or
    seeded normal values."""
    if seed is None:
        return bf.from_rank_values(lambda r: np.full(shape, r, dtype=dtype))
    vals = np.random.default_rng(seed).normal(size=(SIZE,) + shape)
    return bf.from_rank_values(list(vals.astype(dtype)))


# ------------------------------------------------------------------ #
# allreduce / broadcast / allgather
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", DTYPES)
def test_allreduce_average(both, dtype):
    want, got = _run(lambda bf, T: bf.allreduce(
        rank_tensor(bf, (4, 3), dtype), average=True))
    assert _np(got).dtype == np.dtype(dtype)
    _close(got, want, dtype)
    if dtype != np.int32:
        w2, g2 = _run(lambda bf, T: bf.allreduce(
            rank_tensor(bf, (4, 3), dtype, seed=1), average=True))
        _close(g2, w2, dtype)


def test_allreduce_sum(both):
    want, got = _run(lambda bf, T: bf.allreduce(
        rank_tensor(bf, (5,), np.float32, seed=2), average=False))
    _close(got, want, np.float32)


def test_allreduce_nonblocking_poll(both):
    outs = []
    for bf, T in SIDES:
        handle = bf.allreduce_nonblocking(rank_tensor(bf, (4,)))
        assert bf.poll(handle) in (True, False)
        outs.append(bf.synchronize(handle))
    _close(outs[1], outs[0], np.float32)


def test_duplicate_inflight_names_rejected(both):
    for bf, T in SIDES:
        x = rank_tensor(bf, (2,))
        h1 = bf.allreduce_nonblocking(x, name="dup")
        with pytest.raises(Exception) as ei:
            bf.allreduce_nonblocking(x, name="dup")
        assert type(ei.value).__name__ == "BluefogError"
        bf.synchronize(h1)
        bf.synchronize(bf.allreduce_nonblocking(x, name="dup"))


@pytest.mark.parametrize("root", [0, 3, 7])
def test_broadcast(both, root):
    want, got = _run(lambda bf, T: bf.broadcast(
        rank_tensor(bf, (4, 2), np.float64, seed=3), root_rank=root))
    _close(got, want)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_allgather(both):
    want, got = _run(lambda bf, T: bf.allgather(
        rank_tensor(bf, (2, 3), np.float32, seed=4)))
    assert tuple(got.shape) == (SIZE, SIZE * 2, 3)
    np.testing.assert_array_equal(_np(got), _np(want))


# ------------------------------------------------------------------ #
# neighbor_allreduce: static topologies
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("maker", ["ExponentialTwoGraph", "RingGraph",
                                   "MeshGrid2DGraph", "StarGraph",
                                   "FullyConnectedGraph"])
def test_neighbor_allreduce_static_uniform(both, maker):
    def fn(bf, T):
        assert bf.set_topology(getattr(T, maker)(SIZE))
        return bf.neighbor_allreduce(rank_tensor(bf, (3, 2), np.float64,
                                                 seed=5))
    want, got = _run(fn)
    _close(got, want)


@pytest.mark.parametrize("maker", ["ExponentialTwoGraph", "MeshGrid2DGraph",
                                   "RingGraph"])
def test_neighbor_allreduce_static_weighted(both, maker):
    def fn(bf, T):
        assert bf.set_topology(getattr(T, maker)(SIZE), is_weighted=True)
        return bf.neighbor_allreduce(rank_tensor(bf, (4,), np.float32,
                                                 seed=6))
    want, got = _run(fn)
    _close(got, want, np.float32)


def test_neighbor_allreduce_explicit_weights(both):
    def fn(bf, T):
        bf.set_topology(T.RingGraph(SIZE))
        src_weights = [{(r - 1) % SIZE: 0.25, (r + 1) % SIZE: 0.25}
                       for r in range(SIZE)]
        return bf.neighbor_allreduce(rank_tensor(bf, (2,), np.float64,
                                                 seed=7),
                                     self_weight=0.5, src_weights=src_weights)
    want, got = _run(fn)
    _close(got, want)


def test_neighbor_allreduce_bf16_precision(both):
    """bf16 payloads combine in f32."""
    expected = np.mean([1.0 + r * 1e-2 for r in range(SIZE)])
    outs = []
    for bf, T in SIDES:
        bf.set_topology(T.FullyConnectedGraph(SIZE))
        x = bf.from_rank_values(
            lambda r: np.full((16,), 1.0 + r * 1e-2, dtype=np.float32))
        if bf is jbf:
            import jax.numpy as jnp
            x16 = bf.rank_sharded(jnp.asarray(x, dtype=jnp.bfloat16))
        else:
            x16 = x.to(torch.bfloat16)
        out = bf.neighbor_allreduce(x16)
        assert str(out.dtype).endswith("bfloat16")
        outs.append(np.asarray(_np(out), np.float32))
        np.testing.assert_allclose(outs[-1], expected, rtol=1e-2)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-2)


# ------------------------------------------------------------------ #
# neighbor_allreduce: dynamic topology
# ------------------------------------------------------------------ #
def test_neighbor_allreduce_dynamic_one_peer(both):
    for shift in [1, 2, 4]:
        want, got = _run(lambda bf, T: bf.neighbor_allreduce(
            rank_tensor(bf, (3,), np.float64, seed=8 + shift),
            self_weight=0.5,
            src_weights=[{(r - shift) % SIZE: 0.5} for r in range(SIZE)],
            dst_weights=[[(r + shift) % SIZE] for r in range(SIZE)]))
        _close(got, want)


def test_neighbor_allreduce_dynamic_dst_weighting(both):
    shift = 2
    want, got = _run(lambda bf, T: bf.neighbor_allreduce(
        rank_tensor(bf, (2,), np.float32, seed=12), self_weight=0.5,
        src_weights=[{(r - shift) % SIZE: 0.25} for r in range(SIZE)],
        dst_weights=[{(r + shift) % SIZE: 2.0} for r in range(SIZE)]))
    _close(got, want, np.float32)


def test_neighbor_allreduce_dynamic_empty_send(both):
    dst_weights = [[1]] + [[] for _ in range(SIZE - 1)]
    src_weights = [{} for _ in range(SIZE)]
    src_weights[1] = {0: 0.5}
    self_weight = [1.0] * SIZE
    self_weight[1] = 0.5
    want, got = _run(lambda bf, T: bf.neighbor_allreduce(
        rank_tensor(bf, (2,), np.float64), self_weight=self_weight,
        src_weights=src_weights, dst_weights=dst_weights))
    _close(got, want)
    np.testing.assert_allclose(_np(got)[1], 0.5, atol=1e-12)


def test_varying_dynamic_weights_do_not_recompile(both):
    """50 rounds of new weight values over one edge structure: one cached
    entry on both sides (the port's device index tables too), and every
    round combines with its own weights."""
    from bluefog_tpu.context import get_context as jctx
    from bluefog_tpu_torch.context import get_context as tctx
    from bluefog_tpu_torch.parallel import collectives as TC

    shift = 1
    sizes = {"jax": [], "port": [], "tables": []}
    for step in range(50):
        w = 1.0 / (2.0 + 0.37 * step)
        want, got = _run(lambda bf, T: bf.neighbor_allreduce(
            rank_tensor(bf, (3,), np.float64), self_weight=1.0 - w,
            src_weights=[{(r - shift) % SIZE: w} for r in range(SIZE)],
            dst_weights=[[(r + shift) % SIZE] for r in range(SIZE)]))
        _close(got, want)
        sizes["jax"].append(len(jctx()._op_cache))
        sizes["port"].append(len(tctx()._op_cache))
        sizes["tables"].append(len(TC._index_cache))
    for k, v in sizes.items():
        assert v[-1] == v[0], (k, v[:5])


def test_neighbor_allreduce_topo_check(both):
    src_weights = [{} for _ in range(SIZE)]
    src_weights[1] = {0: 0.5}
    dst_weights = [[] for _ in range(SIZE)]
    _same_error(lambda bf, T: bf.neighbor_allreduce(
        rank_tensor(bf, (2,), np.float64), self_weight=1.0,
        src_weights=src_weights, dst_weights=dst_weights,
        enable_topo_check=True), match="mismatch")
    dst_weights2 = [[1]] + [[] for _ in range(SIZE - 1)]
    src_weights2 = [{} for _ in range(SIZE)]
    _same_error(lambda bf, T: bf.neighbor_allreduce(
        rank_tensor(bf, (2,), np.float64), self_weight=1.0,
        src_weights=src_weights2, dst_weights=dst_weights2,
        enable_topo_check=True), match="mismatch")
    want, got = _run(lambda bf, T: bf.neighbor_allreduce(
        rank_tensor(bf, (2,), np.float64), self_weight=1.0,
        src_weights=src_weights, dst_weights=dst_weights,
        enable_topo_check=False))
    _close(got, want)


def test_neighbor_allreduce_requires_weights_with_dst(both):
    _same_error(lambda bf, T: bf.neighbor_allreduce(
        rank_tensor(bf, (2,), np.float64), dst_weights=[[1]] * SIZE))


def test_neighbor_allreduce_self_src_must_pair(both):
    _same_error(lambda bf, T: bf.neighbor_allreduce(
        rank_tensor(bf, (2,), np.float64), self_weight=0.5))


def test_allgather_variable_size(both):
    parts = [np.random.default_rng(r).normal(size=(r + 1, 3)).astype(
        np.float32) for r in range(SIZE)]
    want, got = _run(lambda bf, T: bf.allgather(parts))
    assert tuple(got.shape) == (SIZE, sum(r + 1 for r in range(SIZE)), 3)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_allgather_variable_size_rejects_mismatched_trailing(both):
    parts = [np.zeros((2, 3)) for _ in range(SIZE - 1)] + [np.zeros((2, 4))]
    _same_error(lambda bf, T: bf.allgather(parts), match="trailing")


# ------------------------------------------------------------------ #
# neighbor_allgather
# ------------------------------------------------------------------ #
def test_neighbor_allgather_regular(both):
    def fn(bf, T):
        bf.set_topology(T.ExponentialTwoGraph(SIZE))
        return bf.neighbor_allgather(rank_tensor(bf, (2, 3), np.float32,
                                                 seed=13))
    want, got = _run(fn)
    assert tuple(got.shape) == (SIZE, 3 * 2, 3)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_neighbor_allgather_irregular(both):
    def fn(bf, T):
        bf.set_topology(T.StarGraph(SIZE))
        return bf.neighbor_allgather(rank_tensor(bf, (1, 2), np.float32,
                                                 seed=14))
    want, got = _run(fn)
    assert isinstance(got, list) and len(got) == SIZE
    assert tuple(got[0].shape) == (SIZE - 1, 2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_neighbor_allgather_dynamic(both):
    src_ranks = [[(r - 3) % SIZE] for r in range(SIZE)]
    dst_ranks = [[(r + 3) % SIZE] for r in range(SIZE)]
    want, got = _run(lambda bf, T: bf.neighbor_allgather(
        rank_tensor(bf, (2,), np.float32, seed=15), src_ranks=src_ranks,
        dst_ranks=dst_ranks))
    np.testing.assert_array_equal(_np(got), _np(want))


# ------------------------------------------------------------------ #
# pair gossip
# ------------------------------------------------------------------ #
def test_pair_gossip_average(both):
    targets = [r ^ 1 for r in range(SIZE)]
    want, got = _run(lambda bf, T: bf.pair_gossip(
        rank_tensor(bf, (3,), np.float64, seed=16), targets))
    _close(got, want)


def test_pair_gossip_weighted(both):
    targets = [r ^ 1 for r in range(SIZE)]
    want, got = _run(lambda bf, T: bf.pair_gossip(
        rank_tensor(bf, (2,), np.float32, seed=17), targets,
        self_weight=0.75, pair_weight=0.25))
    _close(got, want, np.float32)


def test_barrier(both):
    for bf, T in SIDES:
        bf.barrier()


# ------------------------------------------------------------------ #
# beyond test_ops.py: the hierarchical exchange
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dynamic", [False, True])
def test_hierarchical_neighbor_allreduce(dynamic):
    """local_size 2: 4 machines of 2 ranks over a machine ring (static), or
    one-peer machine weights (dynamic)."""
    jbf.init(local_size=2)
    tbf.init(size=SIZE, device="cpu", local_size=2)
    try:
        def fn(bf, T):
            assert bf.set_machine_topology(T.RingGraph(4))
            x = rank_tensor(bf, (3,), np.float32, seed=18)
            if not dynamic:
                return bf.hierarchical_neighbor_allreduce(x)
            return bf.hierarchical_neighbor_allreduce(
                x, self_weight=0.5,
                src_machine_weights=[{(m - 1) % 4: 0.5} for m in range(4)],
                dst_machine_weights=[[(m + 1) % 4] for m in range(4)])
        want, got = _run(fn)
        _close(got, want, np.float32)
    finally:
        jbf.shutdown()
        tbf.shutdown()

"""The port's distributed optimizer wrappers (``bluefog_tpu_torch.optim.
wrappers`` over ``torch.optim``) against the JAX package's (optax), test
for test as ``tests/test_optimizers.py``: the synthetic per-rank least
squares problem (reference LinearProblemBuilder, torch_optimizer_test.py
:100-180) trained for the JAX test's number of steps by every wrapper,
from the same seeded numpy start, on both sides; then the gradient
compressors.

The JAX side runs over 8 virtual CPU devices, the port over
``bf.init(size=8, device="cpu")``.  Every array is float64 on both sides
(the window payloads scale and combine in float32 on both, as the JAX
kernels do).  Tolerance: 1e-5 of the leaf's largest entry after the
steps; the JAX test's own convergence bounds hold on the port.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import compressor as JC
from bluefog_tpu import optim as JO
from bluefog_tpu.topology import ExponentialTwoGraph as JExp2
from bluefog_tpu_torch import compressor as TC
from bluefog_tpu_torch import optim as TO
from bluefog_tpu_torch.topology import ExponentialTwoGraph as TExp2

SIZE = 8
DIM = 4
SAMPLES = 32


@pytest.fixture
def both():
    jbf.init()
    tbf.init(size=SIZE, device="cpu")
    yield
    jbf.win_free()
    tbf.win_free()
    jbf.shutdown()
    tbf.shutdown()


def make_problem(seed=0):
    """Per-rank least squares: y_r = A_r w* + noise, every rank starting
    at its own random point."""
    rng = np.random.default_rng(seed)
    w_star = rng.normal(size=(DIM, 1))
    A = rng.normal(size=(SIZE, SAMPLES, DIM))
    y = A @ w_star + 0.01 * rng.normal(size=(SIZE, SAMPLES, 1))
    w0 = np.random.default_rng(seed + 1).normal(size=(SIZE, DIM, 1))
    return A, y, w_star, w0


def _grad_np(A, y, w, xp):
    err = xp.einsum("rsd,rdo->rso", A, w) - y
    return 2.0 * xp.einsum("rsd,rso->rdo", A, err) / SAMPLES


def global_mse(A, y, w):
    err = np.einsum("rsd,rdo->rso", A, w) - y
    return float(np.mean(err ** 2))


def _run_jax(make_opt, steps, dynamic_update=None, broadcast_init=False,
             grad_transform=None):
    A, y, _, w0 = make_problem()
    Aj, yj = jbf.rank_sharded(A), jbf.rank_sharded(y)
    params = {"w": jbf.rank_sharded(w0)}
    if broadcast_init:
        params = jbf.broadcast_parameters(params, root_rank=0)
    opt = make_opt()
    state = opt.init(params)
    for i in range(steps):
        if dynamic_update is not None:
            dynamic_update(opt, i)
        grad = _grad_np(Aj, yj, params["w"], jnp)
        if grad_transform is not None:
            grad = grad_transform(grad, i)
        params, state = opt.step(params, {"w": grad}, state)
    return np.asarray(params["w"])


def _run_port(make_opt, steps, dynamic_update=None, broadcast_init=False):
    A, y, _, w0 = make_problem()
    At, yt = torch.from_numpy(A), torch.from_numpy(y)
    w = torch.from_numpy(w0.copy())
    if broadcast_init:
        tbf.broadcast_parameters({"w": w}, root_rank=0)
    opt = make_opt([w], {"w": w})
    for i in range(steps):
        if dynamic_update is not None:
            dynamic_update(opt, i)
        w.grad = _grad_np(At, yt, w, torch)
        opt.step()
    return w.numpy()


def _check(got, want, bound):
    A, y, _, _ = make_problem()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    assert global_mse(A, y, got) < bound


def test_gradient_allreduce_optimizer(both):
    want = _run_jax(lambda: JO.DistributedGradientAllreduceOptimizer(
        optax.sgd(0.05)), 100, broadcast_init=True)
    got = _run_port(lambda p, named: TO.DistributedGradientAllreduceOptimizer(
        torch.optim.SGD(p, lr=0.05), named), 100, broadcast_init=True)
    _check(got, want, 0.01)
    for r in range(1, SIZE):
        np.testing.assert_allclose(got[r], got[0], atol=1e-9)


@pytest.mark.parametrize("comm", ["neighbor_allreduce", "allreduce"])
def test_adapt_with_combine_optimizer(both, comm):
    jbf.set_topology(JExp2(SIZE))
    tbf.set_topology(TExp2(SIZE))
    want = _run_jax(lambda: JO.DistributedAdaptWithCombineOptimizer(
        optax.sgd(0.05), communication_type=getattr(
            JO.CommunicationType, comm)), 100)
    got = _run_port(lambda p, named: TO.DistributedAdaptWithCombineOptimizer(
        torch.optim.SGD(p, lr=0.05), named,
        communication_type=getattr(TO.CommunicationType, comm)), 100)
    _check(got, want, 0.02)
    assert np.max(np.std(got, axis=0)) < 0.05


def test_adapt_then_combine_optimizer(both):
    jbf.set_topology(JExp2(SIZE))
    tbf.set_topology(TExp2(SIZE))
    want = _run_jax(lambda: JO.DistributedAdaptThenCombineOptimizer(
        optax.sgd(0.05)), 100)
    got = _run_port(lambda p, named: TO.DistributedAdaptThenCombineOptimizer(
        torch.optim.SGD(p, lr=0.05), named), 100)
    _check(got, want, 0.02)


def test_adapt_with_combine_adam(both):
    jbf.set_topology(JExp2(SIZE))
    tbf.set_topology(TExp2(SIZE))
    want = _run_jax(lambda: JO.DistributedAdaptWithCombineOptimizer(
        optax.adam(0.05)), 150)
    got = _run_port(lambda p, named: TO.DistributedAdaptWithCombineOptimizer(
        torch.optim.Adam(p, lr=0.05), named), 150)
    _check(got, want, 0.02)


def test_dynamic_topology_optimizer(both):
    jbf.set_topology(JExp2(SIZE))
    tbf.set_topology(TExp2(SIZE))

    def dynamic_update(opt, i):
        shift = 2 ** (i % 3)
        opt.dst_weights = [[(r + shift) % SIZE] for r in range(SIZE)]
        opt.src_weights = [{(r - shift) % SIZE: 0.5} for r in range(SIZE)]
        opt.self_weight = 0.5

    want = _run_jax(lambda: JO.DistributedAdaptWithCombineOptimizer(
        optax.sgd(0.05)), 120, dynamic_update)
    got = _run_port(lambda p, named: TO.DistributedAdaptWithCombineOptimizer(
        torch.optim.SGD(p, lr=0.05), named), 120, dynamic_update)
    _check(got, want, 0.02)
    assert np.max(np.std(got, axis=0)) < 0.05


def test_local_aggregation(both):
    jbf.set_topology(JExp2(SIZE))
    tbf.set_topology(TExp2(SIZE))
    want = _run_jax(lambda: JO.DistributedAdaptWithCombineOptimizer(
        optax.sgd(0.05), num_steps_per_communication=4), 160)
    got = _run_port(lambda p, named: TO.DistributedAdaptWithCombineOptimizer(
        torch.optim.SGD(p, lr=0.05), named,
        num_steps_per_communication=4), 160)
    _check(got, want, 0.05)


@pytest.mark.parametrize("name", ["DistributedWinPutOptimizer",
                                  "DistributedPullGetOptimizer",
                                  "DistributedPushSumOptimizer"])
def test_window_optimizers(both, name):
    jbf.set_topology(JExp2(SIZE))
    tbf.set_topology(TExp2(SIZE))
    want = _run_jax(lambda: getattr(JO, name)(optax.sgd(0.05)), 100)
    opts = []

    def make(p, named):
        opts.append(getattr(TO, name)(torch.optim.SGD(p, lr=0.05), named))
        return opts[-1]

    got = _run_port(make, 100)
    _check(got, want, 0.05)
    assert tbf.get_current_created_window_names() == ["param.w"]
    if name == "DistributedPushSumOptimizer":
        np.testing.assert_allclose(float(opts[0].ps_weights().sum()), SIZE,
                                   rtol=1e-12)


def test_hierarchical_neighbor_allreduce_optimizer():
    jbf.init(local_size=2)
    tbf.init(size=SIZE, device="cpu", local_size=2)
    try:
        jbf.set_machine_topology(JExp2(4))
        tbf.set_machine_topology(TExp2(4))
        want = _run_jax(lambda: JO.DistributedHierarchicalNeighborAllreduceOptimizer(
            optax.sgd(0.05)), 60)
        got = _run_port(
            lambda p, named: TO.DistributedHierarchicalNeighborAllreduceOptimizer(
                torch.optim.SGD(p, lr=0.05), named), 60)
        _check(got, want, 0.05)
    finally:
        jbf.shutdown()
        tbf.shutdown()


def test_wrapper_refuses_non_elementwise_optimizer(both):
    w = torch.zeros(SIZE, 3)
    with pytest.raises(TypeError, match="element-wise"):
        TO.DistributedAdaptThenCombineOptimizer(torch.optim.LBFGS([w]))


# ------------------------------------------------------------------ #
# gradient compressors (per rank slice)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kw", [dict(k=3), dict(percentage=0.25)])
def test_topk_compressor_matches_jax_per_rank(kw):
    x = np.random.default_rng(2).normal(size=(SIZE, 4, 5)).astype(np.float32)
    want = np.stack([np.asarray(JC.TopKCompressor(**kw)(jnp.asarray(x[r])))
                     for r in range(SIZE)])
    got = TC.TopKCompressor(**kw)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_random_k_and_quantized_compressors():
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(SIZE, 100)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    out = TC.RandomKCompressor(k=10)(x, generator=g)
    kept = out != 0
    assert (kept.sum(1) == 10).all()
    assert torch.equal(out[kept], x[kept])
    with pytest.raises(ValueError, match="Generator"):
        TC.RandomKCompressor(k=10)(x)
    q = TC.QuantizedCompressor(4)
    draws = torch.stack([q(x, generator=g) for _ in range(400)])
    norm = x.abs().amax(1, keepdim=True)
    levels = draws / norm * 4
    assert torch.allclose(levels, levels.round(), atol=1e-4)
    assert (draws.mean(0) - x).abs().max() < 0.15 * norm.max()


def test_compressed_optimizer_matches_jax(both):
    """CompressedOptimizer(TopK) over the ATC wrapper: each rank's
    gradient keeps its 2 largest entries, then the ATC step; the JAX side
    applies its TopKCompressor to each rank's slice before its wrapper."""
    jbf.set_topology(JExp2(SIZE))
    tbf.set_topology(TExp2(SIZE))
    comp = JC.TopKCompressor(k=2)

    def per_rank(grad, i):
        return jnp.stack([comp(grad[r]) for r in range(SIZE)])

    want = _run_jax(lambda: JO.DistributedAdaptThenCombineOptimizer(
        optax.sgd(0.05)), 60, grad_transform=per_rank)
    got = _run_port(lambda p, named: TC.CompressedOptimizer(
        TO.DistributedAdaptThenCombineOptimizer(
            torch.optim.SGD(p, lr=0.05), named), TC.TopKCompressor(k=2)), 60)
    _check(got, want, 0.1)

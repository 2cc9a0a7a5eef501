"""The port's stacked collectives (bluefog_tpu_torch/parallel/
collectives.py) against the JAX package's ``neighbor_allreduce`` /
``allreduce`` / ``broadcast`` under ``shard_map`` on the 8-device CPU
mesh.  The same rank-major numpy input goes through both.

Tolerances: f32 payloads agree within 1e-6 (rtol and atol): both run the
same f32 multiply-add chain in the same order, and XLA may contract one
multiply-add into an FMA (1 ulp).  bf16 payloads agree within one bf16
ulp of the output (rtol 2**-7).  The int8 wire rounds x / scale to
nearest on both sides, so the codes agree except where an FMA-level
difference in x / scale straddles a .5 boundary; the tolerance is one
int8 step (max |x| / 127 of the sender) times the receive weight."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu import topology as JT
from bluefog_tpu.parallel import collectives as JC
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.parallel import collectives as TC

N = 8


def _mesh(n=N):
    return Mesh(np.array(jax.devices()[:n]), ("bf",))


def _jax_per_rank(fn, x: np.ndarray) -> np.ndarray:
    """Run ``fn(shard)`` per rank under shard_map; returns rank-major."""
    f = jax.shard_map(lambda v: fn(v[0])[None], mesh=_mesh(x.shape[0]),
                      in_specs=P("bf"), out_specs=P("bf"), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x)).astype(jnp.float32))


def _spec(name, mod):
    if name == "exp2":
        return mod.uniform_topology_spec(mod.ExponentialTwoGraph(N))
    if name == "ring":
        return mod.Topology.from_graph(mod.RingGraph(N))
    if name == "star":        # in-degree 7 at the center, 1 elsewhere
        return mod.Topology.from_graph(mod.StarGraph(N))
    if name == "one_peer":    # round 1 of the exp2 one-peer schedule
        return mod.one_peer_dynamic_schedule(N)[1]
    if name == "one_peer_pairs":  # a one-peer round of mixed shifts,
        # whose disjoint classes fuse into one gather
        edges = {(0, 1): 0.5, (1, 0): 0.5, (2, 5): 0.5, (5, 2): 0.5,
                 (3, 4): 0.25, (4, 3): 0.75}   # ranks 6, 7 receive nothing
        selfs = [0.5, 0.5, 0.5, 0.75, 0.25, 0.5, 1.0, 1.0]
        return mod.DynamicTopology.from_edges(N, edges, selfs)
    if name == "zero_edge":   # a declared edge of weight 0.0
        edges = {(0, 1): 0.0, (2, 1): 0.5, (5, 6): 0.25, (7, 0): 1.0}
        selfs = [0.0, 0.5, 1.0, 1.0, 1.0, 1.0, 0.75, 1.0]
        return mod.DynamicTopology.from_edges(N, edges, selfs)
    raise KeyError(name)


SPECS = ["exp2", "ring", "star", "one_peer", "one_peer_pairs", "zero_edge"]


def _x(dtype=np.float32, shape=(N, 6, 5), seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 3).astype(dtype)


def _int8_tol(x, spec):
    step = np.abs(x.reshape(N, -1)).max(axis=1) / 127.0
    return float(step.max()) * 1.0001


@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
@pytest.mark.parametrize("name", SPECS)
def test_neighbor_allreduce_matches_jax(name, compress):
    x = _x()
    js, ts = _spec(name, JT), _spec(name, TT)
    want = _jax_per_rank(
        lambda v: JC.neighbor_allreduce(v, js, "bf", compress=compress), x)
    got = TC.neighbor_allreduce(torch.from_numpy(x), ts, compress=compress)
    assert got.dtype == torch.float32 and got.shape == x.shape
    atol = _int8_tol(x, ts) if compress == "int8" else 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=atol)


@pytest.mark.parametrize("name", SPECS)
def test_traced_weights_match_jax(name):
    """Weights as runtime tensors over the spec's edge structure (the
    train step's path): perturbed tables, same on both sides."""
    x = _x(seed=1)
    js, ts = _spec(name, JT), _spec(name, TT)
    rng = np.random.RandomState(2)
    cw = np.asarray(JC.class_recv_weights(js))
    assert np.array_equal(cw, TC.class_recv_weights(ts).numpy())
    assert np.array_equal(np.asarray(JC.self_weight_vector(js)),
                          TC.self_weight_vector(ts).numpy())
    cw = cw * (1.0 + 0.5 * rng.rand(*cw.shape))
    sw = np.asarray(JC.self_weight_vector(js)) + 0.1 * rng.rand(N)
    want = _jax_per_rank(
        lambda v: JC.neighbor_allreduce(v, js, "bf",
                                        class_weights=jnp.asarray(cw),
                                        self_weights=jnp.asarray(sw)), x)
    got = TC.neighbor_allreduce(torch.from_numpy(x), ts,
                                class_weights=torch.from_numpy(cw),
                                self_weights=torch.from_numpy(sw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("compress", [None, "int8"])
def test_bf16_payload_accumulates_in_f32(compress):
    x = _x().astype(jnp.bfloat16)
    js, ts = _spec("exp2", JT), _spec("exp2", TT)
    want = _jax_per_rank(
        lambda v: JC.neighbor_allreduce(v, js, "bf", compress=compress), x)
    got = TC.neighbor_allreduce(
        torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16), ts,
        compress=compress)
    assert got.dtype == torch.bfloat16
    atol = _int8_tol(x.astype(np.float32), ts) if compress else 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=atol)


def test_non_receivers_get_zeros_not_weighted_garbage():
    """Ranks 6 and 7 receive nothing in ``one_peer_pairs``; an inf held
    by a rank that sends to nobody in a class must not turn into
    0 * inf = NaN at a rank outside that class (ppermute delivers zeros
    there)."""
    x = _x()
    x[6] = np.inf
    x[7] = -np.inf
    js, ts = _spec("one_peer_pairs", JT), _spec("one_peer_pairs", TT)
    want = _jax_per_rank(lambda v: JC.neighbor_allreduce(v, js, "bf"), x)
    got = TC.neighbor_allreduce(torch.from_numpy(x), ts).numpy()
    assert np.isfinite(got[:6]).all() and np.isfinite(want[:6]).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_zero_weight_declared_edge_still_transfers():
    """A declared 0.0 edge carries the sender's value scaled by zero,
    as in the reference: an inf at the sender reaches the receiver as
    NaN in both packages; other receivers stay finite."""
    x = _x()
    x[0] = np.inf
    js, ts = _spec("zero_edge", JT), _spec("zero_edge", TT)
    want = _jax_per_rank(lambda v: JC.neighbor_allreduce(v, js, "bf"), x)
    got = TC.neighbor_allreduce(torch.from_numpy(x), ts).numpy()
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got[2:]).all()


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_allreduce_matches_jax(average, dtype):
    x = _x().astype(dtype)
    want = _jax_per_rank(lambda v: JC.allreduce(v, "bf", average=average), x)
    t = torch.from_numpy(x.astype(np.float32))
    if dtype != np.float32:
        t = t.to(torch.bfloat16)
    got = TC.allreduce(t, average=average)
    assert got.dtype == t.dtype and got.shape == t.shape
    tol = 1e-6 if dtype == np.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=1e-5)


@pytest.mark.parametrize("root", [0, 3, 7])
def test_broadcast_matches_jax(root):
    x = _x()
    want = _jax_per_rank(lambda v: JC.broadcast(v, root, "bf"), x)
    got = TC.broadcast(torch.from_numpy(x), root).numpy()
    assert np.array_equal(got, want)


def test_stacked_backend_methods_and_checks():
    be = TC.StackedBackend(N, device="cpu")
    x = torch.from_numpy(_x())
    spec = _spec("exp2", TT)
    assert torch.equal(be.neighbor_allreduce(x, spec),
                       TC.neighbor_allreduce(x, spec))
    assert torch.equal(be.allreduce(x), TC.allreduce(x))
    assert torch.equal(be.broadcast(x, 2), TC.broadcast(x, 2))
    stacked = be.rank_major({"w": torch.arange(6.0).reshape(2, 3)})
    assert stacked["w"].shape == (N, 2, 3)
    assert all(torch.equal(stacked["w"][r], stacked["w"][0])
               for r in range(N))
    with pytest.raises(ValueError, match="ranks"):
        TC.neighbor_allreduce(x[:4], spec)
    with pytest.raises(ValueError, match="compress"):
        TC.neighbor_allreduce(x, spec, compress="fp8")
    with pytest.raises(ValueError, match="root"):
        TC.broadcast(x, N)
    with pytest.raises(ValueError):
        TC.StackedBackend(0, device="cpu")


# ------------------------------------------------------------------ #
# the gathers and pair gossip the eager API calls
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name", SPECS)
def test_neighbor_allgather_dense_and_padded_match_jax(name):
    x = _x()
    js, ts = _spec(name, JT), _spec(name, TT)
    backend = TC.StackedBackend(N, device="cpu")
    assert TC.in_neighbor_lists(ts) == JC.in_neighbor_lists(js)
    dense = _jax_per_rank(lambda v: JC.neighbor_allgather(v, js, "bf"), x)
    got = backend.neighbor_allgather(torch.from_numpy(x), ts)
    np.testing.assert_array_equal(got.numpy(), dense)
    padded = _jax_per_rank(
        lambda v: JC.neighbor_allgather_padded(v, js, "bf"), x)
    got = backend.neighbor_allgather_padded(torch.from_numpy(x), ts)
    np.testing.assert_array_equal(got.numpy(), padded)


def test_allgather_allgatherv_and_pair_gossip_match_jax():
    x = _x()
    backend = TC.StackedBackend(N, device="cpu")
    xt = torch.from_numpy(x)
    want = _jax_per_rank(lambda v: JC.allgather(v, "bf"), x)
    np.testing.assert_array_equal(backend.allgather(xt).numpy(), want)
    sizes = [(r * 3) % 7 for r in range(N)]          # includes 0 rows
    want = _jax_per_rank(lambda v: JC.allgatherv(v, sizes, "bf"), x)
    np.testing.assert_array_equal(backend.allgatherv(xt, sizes).numpy(),
                                  want)
    targets = [1, 0, 3, 2, 4, 6, 5, 7]               # 4 and 7 keep theirs
    want = _jax_per_rank(
        lambda v: JC.pair_gossip(v, targets, "bf", 0.75, 0.25), x)
    np.testing.assert_allclose(backend.pair_gossip(xt, targets, 0.75,
                                                   0.25).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="two ranks"):
        backend.pair_gossip(xt, [1, 0, 1, 2, 4, 6, 5, 7])


@pytest.mark.parametrize("average", [True, False])
def test_machine_allreduce_matches_jax(average):
    x = _x()
    groups = TC.machine_groups(N, 2)

    def grouped(v):
        acc = jax.lax.psum(v, "bf", axis_index_groups=groups)
        return acc / 2 if average else acc

    want = _jax_per_rank(grouped, x)
    got = TC.allreduce(torch.from_numpy(x), average, local_size=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

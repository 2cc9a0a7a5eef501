"""The port's context and introspection (``bluefog_tpu_torch.context`` /
``api``) against the JAX package's, test for test as
``tests/test_basics.py``: init, sizes, ranks, (machine) topology, neighbor
ranks; then ``topology.infer``, ``utility`` and the parts of
``tests/test_watchdog.py`` that need no ``jax.distributed`` (the stall
watchdog and the op timeout on one process).  The JAX side runs over 8
virtual CPU devices, the port over ``bf.init(size=8, device="cpu")``.
"""

import logging
import time

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as JT
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.context import BluefogError, StallWatchdog, timed_wait
from bluefog_tpu_torch.logging_util import get_logger

SIZE = 8
SIDES = ((jbf, JT), (tbf, TT))


@pytest.fixture
def both():
    jbf.init()
    tbf.init(size=SIZE, device="cpu")
    yield
    jbf.shutdown()
    tbf.shutdown()


def _run(fn):
    return [fn(bf, T) for bf, T in SIDES]


def test_init_size_rank(both):
    want, got = _run(lambda bf, T: (
        bf.size(), bf.rank(), bf.local_size(), bf.local_rank(),
        bf.machine_size(), bf.is_homogeneous(), bf.is_initialized()))
    assert got == want == (8, 0, 8, 0, 1, True, True)


def test_default_topology_is_exponential(both):
    want, got = _run(lambda bf, T: (
        T.IsTopologyEquivalent(bf.load_topology(), T.ExponentialGraph(8)),
        bf.is_topo_weighted()))
    assert got == want == (True, False)
    np.testing.assert_array_equal(
        tbf.load_topology().to_numpy(),
        __import__("networkx").to_numpy_array(jbf.load_topology()))


def test_set_topology(both):
    def fn(bf, T):
        out = [bf.set_topology(T.RingGraph(8)),
               T.IsTopologyEquivalent(bf.load_topology(), T.RingGraph(8)),
               bf.set_topology(T.StarGraph(8), is_weighted=True),
               bf.is_topo_weighted()]
        return out
    want, got = _run(fn)
    assert got == want == [True, True, True, True]


def test_set_topology_wrong_size(both):
    want, got = _run(lambda bf, T: bf.set_topology(T.RingGraph(4)))
    assert got is want is False


def test_set_topology_not_digraph(both):
    want, got = _run(lambda bf, T: bf.set_topology("not a graph"))
    assert got is want is False


def test_set_topology_fails_with_live_window(both):
    def fn(bf, T):
        x = np.ones((8, 4))
        return [bf.win_create(x, "topo_pin_test"),
                bf.set_topology(T.RingGraph(8)),
                bf.win_free("topo_pin_test"),
                bf.set_topology(T.RingGraph(8))]
    want, got = _run(fn)
    assert got == want == [True, False, True, True]


@pytest.mark.parametrize("maker", ["ExponentialTwoGraph", "RingGraph",
                                   "StarGraph", "MeshGrid2DGraph"])
def test_neighbor_ranks(both, maker):
    def fn(bf, T):
        bf.set_topology(getattr(T, maker)(8))
        return ([bf.in_neighbor_ranks(r) for r in range(8)],
                [bf.out_neighbor_ranks(r) for r in range(8)],
                bf.in_neighbor_ranks())
    want, got = _run(fn)
    assert got == want
    if maker == "ExponentialTwoGraph":
        assert got[0][0] == [4, 6, 7] and got[1][0] == [1, 2, 4]
        assert got[0][3] == [1, 2, 7] and got[2] == [4, 6, 7]


def test_machine_topology():
    jbf.init(local_size=4)
    tbf.init(size=8, device="cpu", local_size=4)
    try:
        def fn(bf, T):
            ring2 = T.RingGraph(2)
            return (bf.machine_size(), bf.local_size(),
                    bf.set_machine_topology(ring2),
                    T.IsTopologyEquivalent(bf.load_machine_topology(), ring2),
                    bf.in_neighbor_machine_ranks(0),
                    bf.out_neighbor_machine_ranks(0),
                    bf.set_machine_topology(T.RingGraph(8)))
        want, got = _run(fn)
        assert got == want == (2, 4, True, True, [1], [1], False)
    finally:
        jbf.shutdown()
        tbf.shutdown()


def test_parity_shims(both):
    def fn(bf, T):
        out = [bf.mpi_threads_supported(),
               bf.unified_mpi_window_model_supported(), bf.nccl_built()]
        bf.suspend()
        bf.resume()
        bf.set_skip_negotiate_stage(True)
        out.append(bf.get_skip_negotiate_stage())
        bf.set_skip_negotiate_stage(False)
        out.append(bf.get_skip_negotiate_stage())
        return out
    want, got = _run(fn)
    assert got == want == [True, True, False, True, False]


def test_rank_value_helpers(both):
    def fn(bf, T):
        x = bf.from_rank_values(lambda r: np.full((3,), float(r)))
        return tuple(x.shape), bf.to_rank_values(x)
    (ws, wv), (gs, gv) = _run(fn)
    assert gs == ws == (8, 3)
    for a, b in zip(gv, wv):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(BluefogError, match="leading dim 8"):
        tbf.rank_sharded(np.zeros((4, 3)))


def test_init_refuses_without_cuda_and_under_bfrun(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbf.init(size=2)
    monkeypatch.setenv("BLUEFOG_TPU_COORDINATOR", "127.0.0.1:1234")
    monkeypatch.setenv("BLUEFOG_TPU_NUM_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="item 6"):
        tbf.init(size=2, device="cpu")
    assert not tbf.is_initialized()


def test_ops_on_cpu_is_an_explicit_request(monkeypatch):
    monkeypatch.setenv("BLUEFOG_OPS_ON_CPU", "1")
    tbf.init(size=4)
    try:
        from bluefog_tpu_torch.context import get_context
        assert get_context().device.type == "cpu"
    finally:
        tbf.shutdown()


# ------------------------------------------------------------------ #
# topology.infer
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("which", ["InferSourceFromDestinationRanks",
                                   "InferDestinationFromSourceRanks"])
def test_infer(which):
    lists = [[(r + 1) % SIZE, (r + 3) % SIZE] for r in range(SIZE)]
    want = getattr(JT, which)(lists, construct_adjacency_matrix=True)
    got = getattr(tbf, which)(lists, construct_adjacency_matrix=True)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert getattr(TT, which)(lists, rank=2) == getattr(JT, which)(lists,
                                                                   rank=2)
    for bad in ([[0]] + [[]] * (SIZE - 1), [[1, 1]] + [[]] * (SIZE - 1),
                [[SIZE]] + [[]] * (SIZE - 1)):
        with pytest.raises(AssertionError):
            getattr(TT, which)(bad)


# ------------------------------------------------------------------ #
# utility
# ------------------------------------------------------------------ #
def test_broadcast_and_allreduce_parameters(both):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(SIZE, 3, 2))
    b = rng.normal(size=(2,))          # replicated: tiled to rank-major
    jp = jbf.broadcast_parameters({"w": jbf.rank_sharded(w), "b": b}, 3)
    tp = {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b)}
    out = tbf.broadcast_parameters(tp, 3)
    assert out["w"] is tp["w"]         # rank-major: in place
    for k in ("w", "b"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jp[k]))
    ja = jbf.allreduce_parameters({"w": jbf.rank_sharded(w)})
    ta = tbf.allreduce_parameters({"w": torch.from_numpy(w.copy())})
    np.testing.assert_allclose(ta["w"].numpy(), np.asarray(ja["w"]),
                               rtol=0, atol=1e-12)


def test_broadcast_optimizer_state(both):
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.normal(size=(SIZE, 4)))
    opt = torch.optim.Adam([p], lr=0.1)
    from bluefog_tpu_torch.optim.functional import _rank_adam
    _rank_adam(opt, [p], [torch.from_numpy(rng.normal(size=(SIZE, 4)))],
               SIZE)
    opt.state[p]["step"][2] = 7.0     # rank 2's count differs
    before = {k: v.clone() for k, v in opt.state[p].items()}
    assert tbf.broadcast_optimizer_state(opt, root_rank=2) is opt
    for k, v in opt.state[p].items():
        np.testing.assert_array_equal(
            v.numpy(), np.broadcast_to(before[k][2].numpy(), v.shape))


# ------------------------------------------------------------------ #
# the stall watchdog and the op timeout (tests/test_watchdog.py)
# ------------------------------------------------------------------ #
class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def capture():
    handler = _Capture()
    logger = get_logger()
    logger.addHandler(handler)
    yield handler
    logger.removeHandler(handler)


@pytest.fixture
def watchdog():
    wd = StallWatchdog()
    yield wd
    wd.stop()


@pytest.mark.parametrize("wait_s,threshold,warns", [
    (0.8, "0.2", True), (0.01, "5", False), (0.1, "0", False)])
def test_watchdog(monkeypatch, capture, watchdog, wait_s, threshold, warns):
    monkeypatch.setenv("BLUEFOG_STALL_WARNING_TIME", threshold)
    with watchdog.watch("allreduce.noname.0"):
        time.sleep(wait_s)
    assert any("Stall detected" in m and "allreduce.noname.0" in m
               for m in capture.messages) == warns


def test_op_timeout_disabled_by_default():
    assert timed_wait("slow_but_fine",
                      lambda: (time.sleep(0.05), 41)[1]) == 41


def test_op_timeout_raises_naming_the_op(monkeypatch):
    monkeypatch.setenv("BLUEFOG_OP_TIMEOUT", "0.2")
    t0 = time.monotonic()
    with pytest.raises(BluefogError) as ei:
        timed_wait("allreduce.stuck_op", lambda: time.sleep(30))
    assert time.monotonic() - t0 < 5
    assert "allreduce.stuck_op" in str(ei.value)
    assert "BLUEFOG_OP_TIMEOUT" in str(ei.value)


def test_op_timeout_names_stale_ranks(monkeypatch):
    from bluefog_tpu_torch import context as ctx_mod

    monkeypatch.setenv("BLUEFOG_OP_TIMEOUT", "0.2")
    monkeypatch.setattr(ctx_mod._heartbeat, "stale_processes",
                        lambda threshold: [1, 3])
    with pytest.raises(BluefogError, match=r"\[1, 3\]"):
        timed_wait("neighbor_allreduce.orphaned", lambda: time.sleep(30))


def test_op_timeout_fast_wait_and_errors(monkeypatch):
    monkeypatch.setenv("BLUEFOG_OP_TIMEOUT", "5")
    assert timed_wait("fast", lambda: 7) == 7

    def boom():
        raise RuntimeError("peer closed")

    with pytest.raises(RuntimeError, match="peer closed"):
        timed_wait("doomed", boom)


def test_op_timeout_applies_to_eager_ops(monkeypatch):
    """The escalation is wired into synchronize: a handle whose wait never
    completes raises (simulated by stubbing the handle's wait)."""
    from bluefog_tpu_torch import context as ctx_mod

    tbf.init(size=SIZE, device="cpu")
    try:
        x = tbf.from_rank_values(lambda r: np.full((4,), float(r)))
        assert tuple(tbf.neighbor_allreduce(x).shape) == (8, 4)
        monkeypatch.setenv("BLUEFOG_OP_TIMEOUT", "0.2")
        monkeypatch.setattr(ctx_mod._Handle, "wait",
                            lambda self: time.sleep(30))
        handle = tbf.neighbor_allreduce_nonblocking(x, name="wedged_op")
        with pytest.raises(BluefogError, match="wedged_op"):
            tbf.synchronize(handle)
    finally:
        tbf.shutdown()


def test_heartbeat_waits_for_the_process_backend():
    from bluefog_tpu_torch import context as ctx_mod

    assert ctx_mod._heartbeat.stale_processes(1.0) == []
    with pytest.raises(NotImplementedError, match="item 6"):
        ctx_mod._heartbeat.start(1.0)


@pytest.mark.parametrize("name,item", [
    ("DataLoader", "item 7"), ("DistributedSampler", "item 7"),
    ("device_prefetch", "item 7"), ("load_mnist", "item 7"),
    ("load_cifar10", "item 7"), ("default_pod_schedule", "item 12")])
def test_names_left_out_name_their_roadmap_item(name, item):
    assert hasattr(jbf, name)
    with pytest.raises(NotImplementedError, match=item):
        getattr(tbf, name)()


# ------------------------------------------------------------------ #
# the eager layer's spans and counter (tests/test_timeline.py)
# ------------------------------------------------------------------ #
def test_ops_emit_timeline(tmp_path, monkeypatch):
    """Ops run with BLUEFOG_TIMELINE set write ENQUEUE_<OP>, COMMUNICATE
    and the data-plane span (CUDA_<OP> here, XLA_<OP> in JAX) under the
    op's name, balanced; bf_ops_total counts the dispatches."""
    import json
    import os

    from bluefog_tpu_torch.observe import get_registry

    monkeypatch.setenv("BLUEFOG_TIMELINE", str(tmp_path / "ops"))
    counter = get_registry().counter("bf_ops_total", "eager collective "
                                     "dispatches", op="neighbor_allreduce")
    before = counter.value
    tbf.init(size=SIZE, device="cpu")
    try:
        x = tbf.from_rank_values(lambda r: np.full((4,), float(r)))
        x = tbf.neighbor_allreduce(x, name="test_neighbor_allreduce")
        tbf.allreduce(x, name="test_allreduce")
        tbf.neighbor_allgather(x, name="test_neighbor_allgather")
        tbf.timeline_start_activity("test_python_interface_x",
                                    "FAKE_ACTIVITY")
        tbf.timeline_end_activity("test_python_interface_x")
    finally:
        tbf.shutdown()
    assert counter.value == before + 1
    files = [f for f in os.listdir(tmp_path) if f.startswith("ops")]
    text = (tmp_path / files[0]).read_text()
    events = json.loads(text)
    for span in ("ENQUEUE_NEIGHBOR_ALLREDUCE", "CUDA_NEIGHBOR_ALLREDUCE",
                 "ENQUEUE_ALLREDUCE", "CUDA_ALLREDUCE",
                 "ENQUEUE_NEIGHBOR_ALLGATHER", "COMMUNICATE",
                 "FAKE_ACTIVITY"):
        assert span in text, span
    tids = {e.get("tid") for e in events}
    assert {"test_neighbor_allreduce", "test_allreduce"} <= tids
    phases = [e["ph"] for e in events]
    assert phases.count("B") == phases.count("E")

"""The port's Checkpointer (bluefog_tpu_torch/checkpoint.py, torch.save in
the place of orbax) on the CPU.

* A round trip is bit-equal for every leaf of a guarded Adam step's state
  (the per-rank ``state["step"]`` count one behind on a skipped rank),
  push-sum's ``(optimizer, ps_weight)`` and a ``MixState``; a restore
  with ``like=`` writes into the live tensors and optimizer in place.
* Steps after a restore equal the uninterrupted run's bit for bit: the
  optimizer still steps the live tensors.  The resumed Adam run is also
  held to the JAX package's uninterrupted optax run of the same plan
  (4-device mesh, guard, the same NaN) within the train-mode tests'
  bound for Adam (``tests/test_torch_train_modes.py``: 1e-5 of each
  leaf's largest entry plus 1e-6; the port's per-rank count is float32,
  optax's an int), and the restored count is optax's count.
* ``max_to_keep``, ``all_steps``, ``latest_step``; a truncated newest step
  falls back with a warning; a rank-count mismatch raises at once.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from bluefog_tpu import topology as JT
from bluefog_tpu.optim import functional as JF

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.checkpoint import Checkpointer

N = 4


def _data(steps=6):
    rng = np.random.RandomState(3)
    x = rng.randn(steps, N, 3, 5).astype(np.float32)
    y = rng.randn(steps, N, 3, 2).astype(np.float32)
    x[1, 1, 0, 0] = np.nan  # rank 1 skips step 1 under the guard
    return x, y


def _tloss(p, b):
    return ((torch.tanh(b[0] @ p["w"]) + p["b"] - b[1]) ** 2).mean()


def _base():
    rng = np.random.RandomState(0)
    return {"b": (rng.randn(2) * 0.1).astype(np.float32),
            "w": (rng.randn(5, 2) * 0.5).astype(np.float32)}


def _adam_run():
    """(step, params, optimizer) of a guarded atc Adam step, 4 ranks."""
    backend = bt.StackedBackend(N, device="cpu")
    params = bt.rank_major({k: torch.from_numpy(v)
                            for k, v in _base().items()}, backend)
    opt = torch.optim.Adam(params.values(), lr=0.05)
    step = bt.build_train_step(
        _tloss, opt, backend, comm_mode="atc",
        topology=TT.uniform_topology_spec(TT.ExponentialTwoGraph(N)),
        guard=bt.GuardConfig())
    return step, params, opt


def _steps(step, params, opt_state, lo, hi):
    x, y = _data()
    for s in range(lo, hi):
        out = step(params, opt_state, (torch.from_numpy(x[s]),
                                       torch.from_numpy(y[s])), s,
                   step.default_comm_weights)
    return out


def _leaves(state):
    from bluefog_tpu_torch import _tree

    return [(p, v.clone() if isinstance(v, torch.Tensor) else v)
            for p, v in _tree.leaves(state)]


def _assert_same(a, b):
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), p
        else:
            assert x == y, p


def test_adam_round_trip_and_resume_bit_exact(tmp_path):
    step, params, opt = _adam_run()
    _steps(step, params, opt, 0, 3)
    counts = opt.state[params["w"]]["step"]
    assert counts.tolist() == [3.0, 2.0, 3.0, 3.0]
    assert counts.dtype == torch.float32  # rank 1 skipped once
    ck = Checkpointer(str(tmp_path / "ck"))
    state = {"params": params, "opt_state": opt, "step": 3}
    saved = _leaves(state)
    ck.save(3, state)
    _steps(step, params, opt, 3, 6)
    uninterrupted = _leaves(state)
    live_w, live_m = params["w"], opt.state[params["w"]]["exp_avg"]
    got = ck.restore(3, like={"params": params, "opt_state": opt,
                              "step": 0})
    # in place: the same objects, the saved bits
    assert got["params"] is params and got["opt_state"] is opt
    assert got["step"] == 3
    assert params["w"] is live_w
    assert opt.state[params["w"]]["exp_avg"] is live_m
    _assert_same(_leaves(got), saved)
    _steps(step, params, opt, 3, 6)
    _assert_same(_leaves(state), uninterrupted)
    # ... and the resumed run is JAX's uninterrupted optax run
    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))
    jopt = optax.adam(0.05)

    def jloss(p, b):
        return jnp.mean((jnp.tanh(b[0] @ p["w"]) + p["b"] - b[1]) ** 2)

    jstep = JF.build_train_step(
        jloss, jopt, mesh, comm_mode="atc",
        topology=JT.uniform_topology_spec(JT.ExponentialTwoGraph(N)),
        guard=JF.GuardConfig())
    jp = JF.rank_major({k: jnp.asarray(v) for k, v in _base().items()},
                       mesh)
    jo = JF.rank_major(jopt.init({k: jnp.asarray(v)
                                  for k, v in _base().items()}), mesh)
    x, y = _data()
    for s in range(6):
        jp, jo, _, _ = jstep(jp, jo, (x[s], y[s]), jnp.int32(s),
                             jstep.default_comm_weights)
    for k in ("b", "w"):
        want = np.asarray(jp[k])
        err = np.abs(params[k].numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max() + 1e-6, k
    np.testing.assert_array_equal(
        opt.state[params["w"]]["step"].numpy(),
        np.asarray(jo[0].count, np.float32))
    ck.close()


def test_push_sum_and_mix_state_round_trip(tmp_path):
    backend = bt.StackedBackend(N, device="cpu")
    topo = TT.uniform_topology_spec(TT.ExponentialTwoGraph(N))
    x, y = _data()
    batch = (torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    for mode in ("push_sum", "topk"):
        params = bt.rank_major({k: torch.from_numpy(v)
                                for k, v in _base().items()}, backend)
        opt = torch.optim.SGD(params.values(), lr=0.05, momentum=0.9)
        kw = (dict(comm_mode="push_sum") if mode == "push_sum" else
              dict(comm_mode="atc", compress=bt.MixCompressConfig(
                  ratio=0.5, values="none")))
        step = bt.build_train_step(_tloss, opt, backend, topology=topo,
                                   **kw)
        extra = (bt.push_sum_weights(backend) if mode == "push_sum"
                 else step.init_mix_state(params))
        state = (opt, extra)
        for s in range(2):
            step(params, state, batch, s)
        ck = Checkpointer(str(tmp_path / mode))
        ck.save(2, {"params": params, "opt_state": state})
        saved = _leaves({"params": params, "opt_state": state})
        for s in range(2, 4):
            step(params, state, batch, s)
        after = _leaves({"params": params, "opt_state": state})
        ck.restore(2, like={"params": params, "opt_state": state})
        _assert_same(_leaves({"params": params, "opt_state": state}), saved)
        for s in range(2, 4):
            step(params, state, batch, s)
        _assert_same(_leaves({"params": params, "opt_state": state}), after)


def test_keep_steps_fallback_and_world_mismatch(tmp_path, monkeypatch):
    from bluefog_tpu_torch import checkpoint

    warned = []
    monkeypatch.setattr(checkpoint.logger, "warning",
                        lambda msg, *a: warned.append(msg % a))
    ck = Checkpointer(str(tmp_path / "c"), max_to_keep=2)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ck.restore_latest()
    for s in (1, 2, 3):
        ck.save(s, {"x": torch.full((8, 2), float(s)), "step": s})
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    with pytest.raises(ValueError, match="exists"):
        ck.save(3, {"x": torch.zeros(8, 2), "step": 3})
    assert ck.restore_latest()["x"][0, 0].item() == 3.0
    # a truncated newest step falls back to the next-newest, warning
    path = os.path.join(str(tmp_path / "c"), "3", "p0", "state.pt")
    with open(path, "r+b") as fh:
        fh.truncate(40)
    like = {"x": torch.zeros(8, 2), "step": 0}
    got = ck.restore_latest(like=like)
    assert got["x"] is like["x"] and like["x"][0, 0].item() == 2.0
    assert got["step"] == 2
    assert len(warned) == 1 and "step 3" in warned[0] \
        and "not restorable" in warned[0]
    # a rank-count mismatch is the caller's error: it raises at once
    with pytest.raises(ValueError, match="rank axis"):
        ck.restore_latest(like={"x": torch.zeros(4, 2), "step": 0})
    other = Checkpointer(str(tmp_path / "c"),
                         backend=bt.StackedBackend(4, device="cpu"))
    with pytest.raises(ValueError, match="rank axis"):
        other.restore_latest()
    # the other leaves' dtypes and shapes are checked before any write
    x = torch.zeros(8, 3)
    with pytest.raises(ValueError):
        ck.restore(2, like={"x": x, "step": 0})
    assert (x == 0).all()
    # nothing restorable left: the newest step's error propagates
    with open(os.path.join(str(tmp_path / "c"), "2", "p0", "state.pt"),
              "r+b") as fh:
        fh.truncate(40)
    with pytest.raises(Exception):
        ck.restore_latest(like=like)
    # an asynchronous save is on disk after wait(); the state was copied
    # before save returned
    ck2 = Checkpointer(str(tmp_path / "a"))
    live = torch.ones(8, 2)
    ck2.save(5, {"x": live}, blocking=False)
    live.add_(1)
    ck2.wait()
    assert ck2.restore(5)["x"].eq(1).all()
    assert ck2.last_save["bytes"] == 64.0
    ck2.close()

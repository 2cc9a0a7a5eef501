"""The expert-sharded MoE under the process backend: one bfrun job of 2
processes x 4 ranks (gloo on the CPU) runs the compiled all-to-all over
``compile_all_to_all(PodSpec(4, 2))`` (f32 and int8 wires, and the
transpose back) and the kill -> heal -> return cycle of
tests/test_torch_moe_dispatch.py through ``build_train_step(moe=...)``
(cta); every process's rows must be ``StackedBackend(8)``'s bit for
bit, the dispatch moving its shards only through the backend's
permutes."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8

pytestmark = pytest.mark.moe

# Run by each process of the job and, in the test process, over
# StackedBackend(8): ``run(backend)`` -> {what: this process's rows}.
RUN = r'''
import numpy as np
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import moe
from bluefog_tpu_torch.topology.compiler import PodSpec, compile_all_to_all
from bluefog_tpu_torch.topology.torus import torus_one_peer_schedule

N = 8


def run(backend):
    lo, hi = backend.first_rank, backend.first_rank + backend.n_local
    plan = moe.dispatch_plan(compile_all_to_all(
        PodSpec(4, 2, dcn_cost=4.0)).schedule)
    x = np.random.default_rng(0).normal(size=(N, N, 3, 4)).astype(
        np.float32)
    xs = torch.from_numpy(x[lo:hi].copy())
    out = {}
    out["f32"] = moe.all_to_all_dispatch(xs, plan, backend)
    out["back"] = moe.all_to_all_dispatch(out["f32"], plan.transpose(),
                                          backend)
    out["int8"] = moe.all_to_all_dispatch(xs, plan, backend,
                                          wire_dtype="int8")
    out["naive"] = moe.naive_all_to_all(xs, backend)
    g = torch.Generator().manual_seed(0)
    full = moe.init_moe_params(g, 4, 4, 4, n_ranks=N, device="cpu")
    full["router.w"] = full["router.w"][:1].expand(N, 4, 4).clone()
    params = {k: v[lo:hi].clone() for k, v in full.items()}
    opt = torch.optim.SGD(params.values(), lr=1e-2)
    step = bt.build_train_step(
        moe.make_moe_loss(plan, backend, 3), opt, backend,
        comm_mode="cta", schedule=torus_one_peer_schedule((4, 2), "exp2"),
        moe=bt.MoEConfig(n_experts=4, capacity=3))
    route = moe.default_route_table(N, 4)
    dead = np.zeros(N, bool)
    dead[5] = True
    rng = np.random.default_rng(1)
    losses = []
    for s, (rt, cm) in enumerate((
            (route, moe.capacity_mask_of(np.zeros(N))),
            (moe.heal_route_table(route, dead, 4),
             moe.capacity_mask_of(dead)),
            (route, moe.capacity_mask_of(np.zeros(N))))):
        tokens = rng.normal(size=(N, 6, 4)).astype(np.float32)
        tiled = np.broadcast_to(cm[None], (N, N)).copy()
        batch = tuple(torch.from_numpy(np.ascontiguousarray(v[lo:hi]))
                      for v in (tokens, rt, tiled))
        params, opt, loss = step(params, opt, batch, s)
        losses.append(loss.clone())
    out["loss"] = torch.stack(losses)
    out.update({k: v.clone() for k, v in params.items()})
    return {k: v.numpy() for k, v in out.items()}
'''

WORKER = RUN + r'''

if __name__ == "__main__":
    import pickle
    import sys

    from bluefog_tpu_torch.context import get_context

    bt.init()
    backend = get_context().backend
    assert type(backend).__name__ == "ProcessBackend"
    assert backend.n_local == 4 and backend.size == N
    got = run(backend)
    with open(f"{sys.argv[1]}/p{backend.process_index}.pkl", "wb") as f:
        pickle.dump(got, f)
    bt.shutdown()
    print("moe OK")
'''


def test_moe_job_bit_equals_stacked(tmp_path):
    from bluefog_tpu_torch.parallel.collectives import StackedBackend

    (tmp_path / "worker.py").write_text(WORKER)
    (tmp_path / "job").mkdir()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BLUEFOG_", "XLA_", "JAX_"))}
    env.update(PYTHONPATH=ROOT, BLUEFOG_TPU_PROCESS_GROUP_TIMEOUT="60")
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", "2",
         "--force-cpu-devices", "4", "--coordinator",
         f"file://{tmp_path / 'store'}", sys.executable,
         str(tmp_path / "worker.py"), str(tmp_path / "job")],
        capture_output=True, text=True, timeout=150, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("moe OK") == 2, out.stdout
    ns: dict = {}
    exec(RUN, ns)
    want = ns["run"](StackedBackend(N, device="cpu"))
    np.testing.assert_array_equal(want["f32"], want["naive"])
    np.testing.assert_array_equal(
        want["back"], np.random.default_rng(0).normal(
            size=(N, N, 3, 4)).astype(np.float32))
    for p in range(2):
        with open(tmp_path / "job" / f"p{p}.pkl", "rb") as f:
            got = pickle.load(f)
        assert set(got) == set(want)
        for k, w in want.items():
            rows = w[:, 4 * p:4 * p + 4] if k == "loss" else \
                w[4 * p:4 * p + 4]
            np.testing.assert_array_equal(got[k], rows,
                                          err_msg=f"process {p} {k}")

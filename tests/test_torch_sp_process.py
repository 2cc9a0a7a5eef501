"""Sequence parallelism under the process backend: a bfrun job of 2
processes x 1 rank (gloo on the CPU), each rank's sequence split into 2
shards that its process holds, trains the tiny f32 ring + flash Llama 3
atc steps over ``ExponentialTwoGraph(2)`` (Adam(1e-3), batch 2 x 32 per
rank, ``batch_specs=("bf", None, "sp")``), and a Ulysses + xla one with
the guard.  Params and losses must equal ``StackedBackend(2)``'s bit for
bit: the shards of a rank never leave its process, and the exchange
between the ranks is the stacked backend's arithmetic."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, T, STEPS = 2, 2, 32, 3
MODES = {"ring_flash": ("ring", "flash", False),
         "ulysses_xla_guard": ("ulysses", "xla", True)}

# Run by each process of the job and, in the test process, over
# StackedBackend(2): ``run(backend, raw)`` -> {mode: results of this
# process's ranks}.
RUN = r'''
import numpy as np
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch.models.llama import llama_loss_fn


def run(backend, raw, modes):
    lo, hi = backend.first_rank, backend.first_rank + backend.n_local
    batch = (torch.from_numpy(raw[lo:hi, :, :-1]),
             torch.from_numpy(raw[lo:hi, :, 1:]))
    out = {}
    for name, (mode, impl, guarded) in modes.items():
        cfg = bt.LlamaConfig.tiny(dtype=torch.float32, attn_mode=mode,
                                  sp_axis="sp", attn_impl=impl)
        model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32,
                         generator=torch.Generator().manual_seed(4))
        params = bt.rank_major(model.state(release=True), backend)
        opt = torch.optim.Adam(params.values(), lr=1e-3)
        step = bt.build_train_step(
            llama_loss_fn(model), opt, backend, comm_mode="atc",
            topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(2)),
            sp_axis=bt.SeqAxis("sp", 2), batch_specs=("bf", None, "sp"),
            guard=bt.GuardConfig() if guarded else None)
        losses = []
        for s in range(3):
            args = (params, opt, batch, s)
            if guarded:
                args = args + (step.default_comm_weights,)
            params, opt, loss = step(*args)[:3]
            losses.append(loss.numpy().copy())
        res = {k: v.detach().numpy().copy() for k, v in params.items()}
        res["loss"] = np.stack(losses, axis=1)
        out[name] = res
    return out
'''

WORKER = RUN + r'''

if __name__ == "__main__":
    import pickle
    import sys

    from bluefog_tpu_torch.context import get_context

    bt.init()
    backend = get_context().backend
    assert type(backend).__name__ == "ProcessBackend"
    assert backend.n_local == 1 and backend.size == 2
    with open(sys.argv[1], "rb") as f:
        raw, modes = pickle.load(f)
    got = run(backend, raw, modes)
    with open(f"{sys.argv[2]}/p{backend.process_index}.pkl", "wb") as f:
        pickle.dump(got, f)
    bt.shutdown()
    print("sp OK")
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from bluefog_tpu_torch.parallel.collectives import StackedBackend

    raw = np.random.RandomState(0).randint(0, 256, (N, B, T + 1)).astype(
        np.int32)
    d = tmp_path_factory.mktemp("sp_process")
    with open(d / "setup.pkl", "wb") as f:
        pickle.dump((raw, MODES), f)
    (d / "worker.py").write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BLUEFOG_", "XLA_", "JAX_"))}
    env.update(PYTHONPATH=ROOT, BLUEFOG_TPU_PROCESS_GROUP_TIMEOUT="60")
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", "2",
         "--force-cpu-devices", "1", "--coordinator",
         f"file://{d / 'store'}", sys.executable, str(d / "worker.py"),
         str(d / "setup.pkl"), str(d)],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("sp OK") == 2, out.stdout
    parts = []
    for p in range(2):
        with open(d / f"p{p}.pkl", "rb") as f:
            parts.append(pickle.load(f))
    process = {m: {k: np.concatenate([p[m][k] for p in parts])
                   for k in parts[0][m]} for m in MODES}
    ns: dict = {}
    exec(RUN, ns)
    stacked = ns["run"](StackedBackend(N, device="cpu"), raw, MODES)
    return process, stacked


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sp_process_job_bit_equals_stacked(runs, mode):
    process, stacked = runs
    got, want = process[mode], stacked[mode]
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), (
            f"{mode} {k}: max |diff| {np.abs(got[k] - want[k]).max()}")
    assert np.isfinite(got["loss"]).all() and got["loss"].shape == (N, 3)
    # training moves: the last step's loss is below the first's
    assert (got["loss"][:, -1] < got["loss"][:, 0]).all()

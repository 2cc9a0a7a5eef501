"""Per-device wire buckets across processes: the tiny f32 Llama at dp 4 x
tp 2 (every tp shard of a rank in its process) trained 3 atc steps under
the int8 wire, the int8_sr wire and ``MixCompressConfig(0.5, "int8")`` by
a bfrun job of 2 processes x 2 ranks (gloo on the CPU).  Params, losses
and every ``MixState`` buffer must equal ``StackedBackend(4)``'s bit for
bit: a (rank, device) row quantizes, selects and draws the same wherever
its rank lives."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, T, STEPS = 4, 2, 16, 3
MODES = ("int8", "int8_sr", "mix_int8")

# Run by each process of the job and, in the test process, over
# StackedBackend(4): ``run(backend)`` -> {mode: this process's rows}.
RUN = r'''
import numpy as np
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.models.llama import llama_loss_fn, llama_param_specs
from bluefog_tpu_torch.optim import functional as TF

N, B, T, STEPS = 4, 2, 16, 3


def run(backend, modes):
    lo, hi = backend.first_rank, backend.first_rank + backend.n_local
    tp = bt.MeshAxis("tp", 2)
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, tp_axis="tp",
                              tp_size=2)
    raw = np.random.RandomState(0).randint(0, 256, (N, B, T + 1))
    batch = (torch.from_numpy(raw[lo:hi, :, :-1].astype(np.int32)),
             torch.from_numpy(raw[lo:hi, :, 1:].astype(np.int32)))
    out = {}
    for mode in modes:
        model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0))
        state = model.state(release=True)
        specs = llama_param_specs(state)
        params = bt.rank_major(state, backend, specs=specs)
        opt = torch.optim.SGD(params.values(), lr=0.3)
        compress = (bt.MixCompressConfig(0.5, "int8") if mode == "mix_int8"
                    else mode)
        step = bt.build_train_step(
            llama_loss_fn(model), opt, backend, comm_mode="atc",
            topology=TT.uniform_topology_spec(TT.ExponentialTwoGraph(N)),
            mesh_axes=(tp,), param_specs=specs,
            opt_state_specs=TF.optax_state_specs(opt, state, specs),
            compress=compress)
        opt_state = ((opt, step.init_mix_state(params))
                     if step.mix_config is not None else opt)
        losses = []
        for s in range(STEPS):
            params, opt_state, loss = step(params, opt_state, batch, s)
            losses.append(loss.numpy().copy())
        got = {k: v.numpy().copy() for k, v in params.items()}
        got["loss"] = np.stack(losses)
        if step.mix_config is not None:
            ms = opt_state[1]
            for field in ("err", "ref", "mirror"):
                for i, t in enumerate(getattr(ms, field)):
                    got[f"{field}[{i}]"] = t.numpy().copy()
        out[mode] = got
    return out
'''

WORKER = RUN + r'''

if __name__ == "__main__":
    import pickle
    import sys

    from bluefog_tpu_torch.context import get_context

    # one intra-op thread: two processes of tiny ops on a shared host
    # otherwise wait on each other's spinning thread pools
    torch.set_num_threads(1)
    bt.init()
    backend = get_context().backend
    assert type(backend).__name__ == "ProcessBackend"
    assert backend.n_local == 2 and backend.size == 4
    got = run(backend, sys.argv[2].split(","))
    with open(f"{sys.argv[1]}/p{backend.process_index}.pkl", "wb") as f:
        pickle.dump(got, f)
    bt.shutdown()
    print("train OK")
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The bfrun job (every mode) and StackedBackend(4)'s run."""
    from bluefog_tpu_torch.parallel.collectives import StackedBackend

    d = tmp_path_factory.mktemp("wire_shard_process")
    (d / "worker.py").write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BLUEFOG_", "XLA_", "JAX_"))}
    env.update(PYTHONPATH=ROOT, BLUEFOG_TPU_PROCESS_GROUP_TIMEOUT="60")
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", "2",
         "--force-cpu-devices", "2", "--coordinator",
         f"file://{d / 'store'}", sys.executable, str(d / "worker.py"),
         str(d), ",".join(MODES)],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("train OK") == 2, out.stdout
    parts = []
    for p in range(2):
        with open(d / f"p{p}.pkl", "rb") as f:
            parts.append(pickle.load(f))
    process = {mode: {k: np.concatenate([p[mode][k] for p in parts],
                                        axis=1 if k == "loss" else 0)
                      for k in parts[0][mode]} for mode in MODES}
    ns: dict = {}
    exec(RUN, ns)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the processes' own setting
    try:
        stacked = ns["run"](StackedBackend(N, device="cpu"), MODES)
    finally:
        torch.set_num_threads(threads)
    return process, stacked


@pytest.mark.parametrize("mode", MODES)
def test_process_tp_wire_bit_equals_stacked(runs, mode):
    """Each process's rows of params, losses and MixState equal the
    stacked backend's bit for bit."""
    process, stacked = runs
    got, want = process[mode], stacked[mode]
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), (
            f"{mode} {k}: max |diff| {np.abs(got[k] - want[k]).max()}")
    assert np.isfinite(want["loss"]).all()

"""run_resilient under the process backend: one bfrun job of 2 processes x
2 ranks (gloo on the CPU) trains the 6 x 2 float64 linear map of
``tests/test_torch_resilience.py`` (SGD 0.05, momentum 0.9, guarded atc
over the one-peer schedule of 4 ranks) through

* (a) a NaN burst on rank 1 and the death of rank 3: skips, a death,
  the heal and a rollback from per-process checkpoint files (each
  process writes its own rows, and the two agree on the step to restore
  through the job's key-value store);
* (b) the same burst and a preemption of rank 3 under
  ``elastic=ElasticConfig(...)``: dead, rollback, rejoin, promotion (the
  disagreement gate gathers the rows of both processes).

Every process must log the events ``StackedBackend(4)`` logs, and the
params rows of the two processes must be the stacked run's bit for
bit."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4

# Run by each process of the job and, in the test process, over
# StackedBackend(4): ``run(backend, ckdir)`` -> {case: (events, params
# rows of this process's ranks)}.
RUN = r'''
import numpy as np
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import resilience as R
from bluefog_tpu_torch.checkpoint import Checkpointer
from bluefog_tpu_torch.elastic import ElasticConfig

N = 4
CASES = {
    "death": (lambda: R.FaultPlan.nan_burst(N, 1, 2, 2).merged(
        R.FaultPlan.rank_death(N, 3, 7)), None),
    "preempt": (lambda: R.FaultPlan.nan_burst(N, 1, 2, 2).merged(
        R.FaultPlan.preempt(N, 3, 7, 6)),
        dict(bootstrap_rounds=3, max_quarantine_steps=12)),
}


def run(backend, ckdir):
    rng = np.random.RandomState(7)
    x, y = rng.randn(32, N, 4, 6), rng.randn(32, N, 4, 2)
    lo, hi = backend.first_rank, backend.first_rank + backend.n_local
    sched = bt.one_peer_dynamic_schedule(N)
    out = {}
    for name, (plan, elastic) in CASES.items():
        params = {"w": torch.zeros(backend.n_local, 6, 2,
                                   dtype=torch.float64)}
        opt = torch.optim.SGD(params.values(), lr=0.05, momentum=0.9)
        step = bt.build_train_step(
            lambda p, b: ((b[0] @ p["w"] - b[1]) ** 2).mean(), opt,
            backend, comm_mode="atc", schedule=sched,
            guard=bt.GuardConfig(max_consecutive_bad=3, backoff_base=0.0))
        res = R.run_resilient(
            step, params, opt,
            lambda s: (torch.from_numpy(x[s % 32, lo:hi]),
                       torch.from_numpy(y[s % 32, lo:hi])),
            steps=20, checkpointer=Checkpointer(f"{ckdir}/{name}",
                                                backend=backend),
            schedule=sched, fault_plan=plan(), checkpoint_every=4,
            sleep=lambda s: None,
            elastic=None if elastic is None else ElasticConfig(**elastic))
        events = [(e.kind, e.step, e.detail) for e in res.events]
        out[name] = (events, res.params["w"].numpy().copy(),
                     res.membership)
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
    assert backend.n_local == 2 and backend.size == 4
    got = run(backend, sys.argv[1])
    with open(f"{sys.argv[1]}/p{backend.process_index}.pkl", "wb") as f:
        pickle.dump(got, f)
    bt.shutdown()
    print("resilient OK")
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from bluefog_tpu_torch.parallel.collectives import StackedBackend

    d = tmp_path_factory.mktemp("resilience_process")
    (d / "worker.py").write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BLUEFOG_", "XLA_", "JAX_"))}
    env.update(PYTHONPATH=ROOT, BLUEFOG_TPU_PROCESS_GROUP_TIMEOUT="60")
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", "2",
         "--force-cpu-devices", "2", "--coordinator",
         f"file://{d / 'store'}", sys.executable, str(d / "worker.py"),
         str(d / "job")],
        capture_output=True, text=True, timeout=150, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("resilient OK") == 2, out.stdout
    parts = []
    for p in range(2):
        with open(d / "job" / f"p{p}.pkl", "rb") as f:
            parts.append(pickle.load(f))
    ns: dict = {}
    exec(RUN, ns)
    stacked = ns["run"](StackedBackend(N, device="cpu"), str(d / "stacked"))
    return parts, stacked, d


@pytest.mark.parametrize("case", ["death", "preempt"])
def test_resilient_job_bit_equals_stacked(runs, case):
    parts, stacked, d = runs
    events, want, membership = stacked[case]
    kinds = [k for k, _, _ in events]
    assert "skip" in kinds and kinds.count("rollback") == 1
    if case == "preempt":
        assert "rank_promoted" in kinds and membership == ["live"] * N
    else:
        assert ("rank_dead", 10, {"rank": 3}) in events
    for p, part in enumerate(parts):
        got_events, got, got_membership = part[case]
        assert got_events == events, f"process {p}"
        assert got_membership == membership
        assert np.array_equal(got, want[2 * p:2 * p + 2]), f"process {p}"
    # each process wrote its own rows of every checkpoint step
    shards = sorted(os.listdir(d / "job" / case / "0"))
    assert shards == ["p0", "p1"]

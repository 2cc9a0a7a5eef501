"""The process backend on the card: a bfrun job of one process holding 2
ranks on ``cuda:0`` over NCCL (world size 1: one card cannot hold two
NCCL ranks) trains a small f32 ResNet 3 atc steps and must give
``StackedBackend(2)``'s bits on the same data, with no host sync in a
steady step; the eager allreduce, broadcast and allgather go through
NCCL exactly.  Marked ``cuda``: without an NVIDIA card every test here
skips.  The file imports torch and the port only:

    python -m pytest --noconftest -q tests/test_torch_process_cuda.py
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r'''
import torch
import torch.nn.functional as F

import bluefog_tpu_torch as bt
from bluefog_tpu_torch.models import resnet as TR


def run(backend, steps=3):
    """(params after ``steps`` atc steps, a steady step's host syncs)."""
    import warnings

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    model = bt.ResNet(stage_sizes=(1,), block_cls=TR.BottleneckBlock,
                      num_classes=10, num_filters=8, dtype=torch.float32,
                      pallas_conv1x1=True, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
    p0, s0 = model.state()
    params, stats = bt.rank_major(p0, backend), bt.rank_major(s0, backend)
    opt = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)

    def loss_fn(p, s, batch):
        images, labels = batch
        logits, new = model.apply(p, s, images, train=True)
        return F.cross_entropy(logits, labels), new

    step = bt.build_train_step(
        loss_fn, opt, backend, comm_mode="atc", has_aux=True,
        topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(2)))
    g = torch.Generator("cuda").manual_seed(1)
    images = torch.randn(2, 4, 32, 32, 3, generator=g, device="cuda")
    labels = torch.randint(0, 10, (2, 4), generator=g, device="cuda")
    batch = (backend.own(images), backend.own(labels))
    for i in range(steps):
        params, stats, opt, loss = step(params, stats, opt, batch, i)
    torch.cuda.synchronize()
    out = {k: v.detach().cpu() for k, v in params.items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(params, stats, opt, batch, steps)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum("synchronizing CUDA operation" in str(w.message)
                for w in caught)
    return out, syncs
'''

CHILD = RUN + r'''

if __name__ == "__main__":
    import sys

    from bluefog_tpu_torch.context import get_context

    bt.init()
    b = get_context().backend
    assert (type(b).__name__, b.wire, b.size, b.n_local) == (
        "ProcessBackend", "nccl", 2, 2), b
    params, syncs = run(b)
    torch.save(params, sys.argv[1])
    x = bt.from_rank_values(lambda r: torch.full((33,), float(r + 1),
                                                 device="cuda"))
    assert torch.equal(bt.allreduce(x), torch.full_like(x, 1.5))
    assert torch.equal(bt.broadcast(x, 1), torch.full_like(x, 2.0))
    assert torch.equal(bt.allgather(x)[0], torch.cat([x[0], x[1]]))
    print(f"SYNCS {syncs}")
    bt.shutdown()
'''


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA path has no CPU mode)")


@pytest.mark.cuda
def test_nccl_process_job_bit_equals_stacked_without_host_syncs(tmp_path):
    _card()
    (tmp_path / "child.py").write_text(textwrap.dedent(CHILD))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BLUEFOG_", "XLA_", "JAX_"))}
    env.update(PYTHONPATH=ROOT, BLUEFOG_TPU_PROCESS_GROUP_TIMEOUT="60")
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", "1",
         "--extra-env", "BLUEFOG_TPU_RANKS_PER_PROCESS=2",
         "--coordinator", f"file://{tmp_path / 'store'}", sys.executable,
         str(tmp_path / "child.py"), str(tmp_path / "params.pt")],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SYNCS 0" in out.stdout, out.stdout
    got = torch.load(tmp_path / "params.pt")
    ns: dict = {}
    exec(RUN, ns)
    want, syncs = ns["run"](ns["bt"].StackedBackend(2, device="cuda"))
    assert syncs == 0
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), (
            k, float((got[k] - want[k]).abs().max()))

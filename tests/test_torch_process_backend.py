"""``ProcessBackend`` against ``StackedBackend(4)``: every method of the
port's backend, run in a bfrun job of 2 processes x 2 ranks and of 4
processes x 1 rank (gloo on the CPU, the processes meeting in a file
store under ``tmp_path``), must give the stacked backend's bits on the
same inputs.  The stacked backend is held to the JAX package by
``tests/test_torch_collectives.py``, ``test_torch_mix_compress.py`` and
``test_torch_hierarchical.py``; here the two backends share one copy of
the math and differ only in where the rows live, so the check is exact.
The stochastic-rounding wires (int8_sr, top-k with int8_sr values) draw
per global rank (``collectives.WireGenerator``) and are bit-equal too.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4

# The cases, run by the bfrun job's processes and, in the test process,
# on StackedBackend(4): ``cases(backend)`` returns {name: this process's
# rows of the result}.  Inputs come from one numpy seed, full [4, ...]
# arrays of which each process takes its own rows.
CASES = r'''
import numpy as np
import torch

from bluefog_tpu_torch.parallel import collectives as C
from bluefog_tpu_torch.topology import (ExponentialTwoGraph, RingGraph,
                                        StarGraph,
                                        one_peer_dynamic_schedule,
                                        uniform_topology_spec)

N = 4


def cases(b):
    rng = np.random.RandomState(0)
    lo, hi = b.first_rank, b.first_rank + b.n_local

    def full(*shape):
        return rng.randn(N, *shape).astype(np.float32)

    def mine(a):
        return torch.from_numpy(np.ascontiguousarray(a[lo:hi]))

    spec = uniform_topology_spec(ExponentialTwoGraph(N))
    star = uniform_topology_spec(StarGraph(N))
    fused = one_peer_dynamic_schedule(N)[1]
    machines = uniform_topology_spec(RingGraph(2))
    x = mine(full(5, 7))
    y = mine(full(9))
    cw = C.class_recv_weights(spec) * 0.5
    sw = C.self_weight_vector(spec) * 1.5
    gen = lambda step, bucket=0: C.wire_generator("cpu", step, bucket)
    out = {}
    out["neighbor_allreduce"] = b.neighbor_allreduce(x, spec)
    out["neighbor_allreduce_int8"] = b.neighbor_allreduce(
        x, spec, compress="int8")
    out["neighbor_allreduce_bf16_wire"] = b.neighbor_allreduce(
        x, spec, compress="bf16")
    out["neighbor_allreduce_int8_sr"] = b.neighbor_allreduce(
        x, spec, compress="int8", generator=gen(3, 1))
    out["neighbor_allreduce_weights"] = b.neighbor_allreduce(
        x, spec, class_weights=cw, self_weights=sw)
    out["neighbor_allreduce_fused_round"] = b.neighbor_allreduce(x, fused)
    out["neighbor_allreduce_star"] = b.neighbor_allreduce(x, star)
    out["neighbor_allreduce_bf16_payload"] = b.neighbor_allreduce(
        x.to(torch.bfloat16), spec).float()
    for i, o in enumerate(b.neighbor_allreduce_buckets(
            [x, y], spec, compress="int8", wire_step=2)):
        out[f"buckets_int8_sr_{i}"] = o
    out["hierarchical"] = b.hierarchical_neighbor_allreduce(x, machines, 2)
    out["hierarchical_int8_sr"] = b.hierarchical_neighbor_allreduce(
        x, machines, 2, compress="int8", generator=gen(5))
    mixed, ps = b.push_sum_mix({"x": x, "y": y},
                               mine(np.full(N, 1.0, np.float32)), star)
    out["push_sum_x"], out["push_sum_y"], out["push_sum_ps"] = (
        mixed["x"], mixed["y"], ps)
    numel, k = 35, 9
    for name, values, topo, hls in (
            ("int8", "int8", spec, None), ("int8_sr", "int8_sr", spec, None),
            ("none", "none", fused, None), ("hier", "int8", machines, 2)):
        slots = C.mix_mirror_slots(topo)
        res = b.mix_compress_exchange(
            x, topo, ref_row=mine(full(numel) * 0.1),
            mirrors=mine(full(slots, numel) * 0.1),
            err=mine(full(numel) * 0.01),
            ratio=mine(np.array([0.1, 0.25, 0.2, 0.3], np.float32)), k=k,
            values=values,
            generator=gen(7, 2) if values == "int8_sr" else None,
            hierarchical_local_size=hls)
        for part, t in zip(("out", "ref", "mirrors", "err"), res):
            out[f"mix_{name}_{part}"] = t
    out["allreduce"] = b.allreduce(x)
    out["allreduce_sum_bf16"] = b.allreduce(x.to(torch.bfloat16),
                                            average=False).float()
    out["allreduce_local"] = b.allreduce(x, local_size=2)
    out["broadcast"] = b.broadcast(x, 3)
    out["allgather"] = b.allgather(x)
    out["allgatherv"] = b.allgatherv(mine(full(3, 2)), [1, 3, 2, 3])
    out["neighbor_allgather"] = b.neighbor_allgather(x, spec)
    out["neighbor_allgather_padded"] = b.neighbor_allgather_padded(x, star)
    out["pair_gossip_across"] = b.pair_gossip(x, [2, 3, 0, 1])
    out["pair_gossip_self"] = b.pair_gossip(x, [0, 2, 1, 3], 0.25, 0.75)
    return {k: v.contiguous() for k, v in out.items()}
'''

WORKER = CASES + r'''

if __name__ == "__main__":
    import sys

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.context import get_context

    bf.init()
    backend = get_context().backend
    assert type(backend).__name__ == "ProcessBackend", backend
    got = cases(backend)
    np.savez(f"{sys.argv[1]}/p{backend.process_index}.npz",
             **{k: v.numpy() for k, v in got.items()})
    bf.shutdown()
    print("cases OK")
'''

LAYOUTS = {"2x2": (2, 2), "4x1": (4, 1)}


def _stacked():
    ns: dict = {}
    exec(CASES, ns)
    from bluefog_tpu_torch.parallel.collectives import StackedBackend
    return {k: v.numpy() for k, v in ns["cases"](
        StackedBackend(N, device="cpu")).items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Each layout's job once: {layout: {case: [4, ...] rows}}."""
    got = {}
    for layout, (procs, k) in LAYOUTS.items():
        d = tmp_path_factory.mktemp(f"job{layout}")
        (d / "worker.py").write_text(WORKER)
        env = {key: v for key, v in os.environ.items()
               if not key.startswith(("BLUEFOG_", "XLA_", "JAX_"))}
        env.update(PYTHONPATH=ROOT, BLUEFOG_TPU_PROCESS_GROUP_TIMEOUT="60")
        out = subprocess.run(
            [sys.executable, "-m", "bluefog_tpu_torch.run", "-np",
             str(procs), "--force-cpu-devices", str(k), "--coordinator",
             f"file://{d / 'store'}", sys.executable, str(d / "worker.py"),
             str(d)], capture_output=True, text=True, timeout=120,
            env=env, cwd=ROOT)
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stdout.count("cases OK") == procs, out.stdout
        parts = [np.load(d / f"p{p}.npz") for p in range(procs)]
        got[layout] = {name: np.concatenate([p[name] for p in parts])
                       for name in parts[0].files}
    got["stacked"] = _stacked()
    return got


CASE_NAMES = [
    "neighbor_allreduce", "neighbor_allreduce_int8",
    "neighbor_allreduce_bf16_wire", "neighbor_allreduce_int8_sr",
    "neighbor_allreduce_weights", "neighbor_allreduce_fused_round",
    "neighbor_allreduce_star", "neighbor_allreduce_bf16_payload",
    "buckets_int8_sr_0", "buckets_int8_sr_1", "hierarchical",
    "hierarchical_int8_sr", "push_sum_x", "push_sum_y", "push_sum_ps",
    "mix_int8_out", "mix_int8_ref", "mix_int8_mirrors", "mix_int8_err",
    "mix_int8_sr_out", "mix_int8_sr_ref", "mix_int8_sr_err",
    "mix_none_out", "mix_none_mirrors", "mix_hier_out", "mix_hier_ref",
    "allreduce", "allreduce_sum_bf16", "allreduce_local", "broadcast",
    "allgather", "allgatherv", "neighbor_allgather",
    "neighbor_allgather_padded", "pair_gossip_across", "pair_gossip_self"]


@pytest.mark.parametrize("case", CASE_NAMES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_process_backend_bit_equals_stacked(results, layout, case):
    want = results["stacked"][case]
    got = results[layout][case]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want), (
        f"{layout} {case}: max |diff| "
        f"{np.abs(got.astype(np.float64) - want).max()}")


def test_every_case_is_checked(results):
    assert sorted(results["stacked"]) == sorted(
        set(CASE_NAMES) | {"mix_int8_sr_mirrors", "mix_none_ref",
                           "mix_none_err", "mix_hier_mirrors",
                           "mix_hier_err"})
    for layout in LAYOUTS:
        assert sorted(results[layout]) == sorted(results["stacked"])
        for case in ("mix_int8_sr_mirrors", "mix_none_ref", "mix_none_err",
                     "mix_hier_mirrors", "mix_hier_err"):
            assert np.array_equal(results[layout][case],
                                  results["stacked"][case]), case


def test_stochastic_rounding_draws_per_global_rank():
    """A rank's draws come from its own stream: the same rank gives the
    same bits whichever rows hold it, and two ranks differ."""
    from bluefog_tpu_torch.parallel import collectives as C

    g = C.wire_generator("cpu", 4, 1)
    like = torch.zeros(4, 6)
    all4 = g.uniform(like)
    assert torch.equal(g.uniform(like[:2], first_rank=2), all4[2:])
    assert not torch.equal(all4[0], all4[1])
    assert float(all4.min()) >= 0.0 and float(all4.max()) < 1.0

"""The topology control plane on the card.  Marked ``cuda``: without an
NVIDIA card every test here skips (the plane's probation health reads
the params on their device, and the step runs there).  The file imports
torch and the port only:

    python -m pytest --noconftest -q tests/test_torch_control_cuda.py

* The on-device consensus distance (float64 on the card, one transfer)
  equals the host float64 reduction of the same rows within 1e-12
  relative, dead rows excluded.
* ``run_resilient(control=)`` at the tiny end-to-end size of
  ``tests/test_torch_topology_control.py`` (8 stacked ranks, a 6 x 2
  float64 linear map, two ranks dying at step 4) logs on the card the
  event list it logs on the CPU, with the same plane decisions, and
  every call gets carrier-shaped weights.
"""

import tempfile

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import resilience as R
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.checkpoint import Checkpointer
from bluefog_tpu_torch.topology import control as TC

pytestmark = pytest.mark.cuda

N = 8
SHIFTS = (1, 2, 4, 6, 7)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _carrier():
    w = 1.0 / (len(SHIFTS) + 1)
    ew = {(i, (i + s) % N): w for s in SHIFTS for i in range(N)}
    return [TT.DynamicTopology.from_edges(N, ew, [w] * N)] * 4


@pytest.mark.parametrize("seed", [0, 1])
def test_consensus_distance_on_the_card_equals_host_float64(seed):
    _card()
    rng = np.random.RandomState(seed)
    live = rng.rand(N) < 0.7
    live[0] = True
    host = {"a": rng.randn(N, 64, 33).astype(np.float32),
            "b": rng.randn(N, 1000),
            "no_rank_axis": rng.randn(5)}
    want = 0.0
    for k in ("a", "b"):
        rows = host[k][live].astype(np.float64)
        want = max(want, float(np.abs(rows - rows.mean(axis=0)).max()))
    card = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    card["b"][torch.from_numpy(~live).cuda()] = 1e9   # dead rows ignored
    got = TC._consensus_distance(card, live)
    assert got == pytest.approx(want, rel=1e-12)


def _run(dev):
    rng = np.random.RandomState(11)
    xs, ys = rng.randn(16, N, 4, 6), rng.randn(16, N, 4, 2)

    def loss_fn(params, batch):
        x, y = batch
        return ((x @ params["w"] - y) ** 2).mean()

    backend = bt.StackedBackend(N, device=dev)
    params = {"w": torch.zeros(N, 6, 2, dtype=torch.float64, device=dev)}
    opt = torch.optim.SGD(params.values(), lr=0.05, momentum=0.9)
    step = bt.build_train_step(loss_fn, opt, backend, comm_mode="atc",
                               schedule=_carrier(), guard=bt.GuardConfig())
    shapes = []

    def recorded(p, o, batch, i, weights):
        shapes.append([(tuple(cw.shape), tuple(sw.shape))
                       for cw, sw in weights])
        return step(p, o, batch, i, weights)

    for attr in ("default_comm_weights", "backend", "guard_config"):
        setattr(recorded, attr, getattr(step, attr))
    plane = TT.TopologyControlPlane(
        TT.PodSpec(4, 2, ici_cost=1.0, dcn_cost=4.0), _carrier(), window=0,
        margin=0.05, cooldown=4, probation=3, rollback_tolerance=4.0,
        synchronous=True)
    plan = R.FaultPlan(N, [R.Fault(4, 6, "dead"), R.Fault(4, 7, "dead")])
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        res = R.run_resilient(
            recorded, params, opt,
            lambda s: (torch.from_numpy(xs[s % 16]).to(dev),
                       torch.from_numpy(ys[s % 16]).to(dev)),
            steps=20, checkpointer=ck, schedule=_carrier(),
            guard=bt.GuardConfig(max_consecutive_bad=3, backoff_base=0.0),
            fault_plan=plan, checkpoint_every=0, sleep=lambda s: None,
            control=plane)
        ck.close()
    ref = [(tuple(cw.shape), tuple(sw.shape))
           for cw, sw in step.default_comm_weights]
    assert all(s == ref for s in shapes)
    return res, plane


def test_run_resilient_control_on_the_card_logs_the_host_events():
    _card()
    card, cplane = _run("cuda")
    host, hplane = _run("cpu")
    events = [(e.kind, e.step) for e in card.events]
    assert events == [(e.kind, e.step) for e in host.events]
    kinds = [k for k, _ in events]
    for kind in ("topology_trigger", "topology_swap", "topology_commit"):
        assert kind in kinds
    assert cplane.active_name() == hplane.active_name()
    for ce, he in zip(card.events, host.events):
        if ce.kind.startswith("topology_"):
            assert ce.detail == he.detail
    w, hw = card.params["w"].cpu(), host.params["w"]
    assert (w - hw).abs().max() <= 1e-4 * hw.abs().max() + 1e-7

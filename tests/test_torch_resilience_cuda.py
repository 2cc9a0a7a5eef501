"""Data, checkpoints and the resilient loop on the card.  Marked ``cuda``:
without an NVIDIA card every test here skips (the flash kernels have no
CPU mode, and the pinned-buffer and stream paths exist only there).  The
file imports torch and the port only:

    python -m pytest --noconftest -q tests/test_torch_resilience_cuda.py

* ``device_prefetch`` to the card: every batch equal to the loader's, on
  the card, in order, with ``depth + 1`` pinned slots reused.
* A checkpoint of card state round-trips bit for bit into the live
  tensors, and the steps after it equal the uninterrupted run's.
* ``run_resilient`` of a tiny f32 ViT (flash: K2, K3a, K3b) on the card
  through a NaN burst and a rank death logs the host run's events, with
  params within 1e-4 of each leaf's largest entry plus 1e-7 (phase 14's
  card-against-host bound).
"""

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import data as D
from bluefog_tpu_torch import resilience as R
from bluefog_tpu_torch.checkpoint import Checkpointer
from bluefog_tpu_torch.parallel import flash_attention as fa

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")


def test_device_prefetch_to_the_card():
    _card()
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (96, 8, 8, 3)).astype(np.uint8)
    y = rng.randint(0, 10, (96,)).astype(np.int32)
    loader = D.DataLoader((x, y), batch_size=16, world=4, rank_major=True,
                          seed=2, use_native=True)
    want = list(D.DataLoader((x, y), batch_size=16, world=4,
                             rank_major=True, seed=2, use_native=False))
    got = []
    for gx, gy in D.device_prefetch(loader, depth=2):
        assert gx.is_cuda and gy.is_cuda and gx.dtype == torch.uint8
        # consumed on the current stream at once: the copy has landed
        got.append((gx.float().sum().item(), gx.cpu().numpy(),
                    gy.cpu().numpy()))
    assert len(got) == len(want) == 6
    for (s, gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert s == float(wx.astype(np.float64).sum())


def _toy(dev):
    backend = bt.StackedBackend(4, device=dev)
    g = torch.Generator().manual_seed(0)
    params = bt.rank_major({"w": torch.randn(6, 2, generator=g)}, backend)
    opt = torch.optim.SGD(params.values(), lr=0.05, momentum=0.9)
    step = bt.build_train_step(
        lambda p, b: ((b[0] @ p["w"] - b[1]) ** 2).mean(), opt, backend,
        comm_mode="atc", schedule=bt.one_peer_dynamic_schedule(4),
        guard=bt.GuardConfig(max_consecutive_bad=3, backoff_base=0.0))
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(16, 4, 4, 6).astype(np.float32))
    y = torch.from_numpy(rng.randn(16, 4, 4, 2).astype(np.float32))
    return step, params, opt, (lambda s: (x[s % 16].to(dev),
                                          y[s % 16].to(dev)))


def test_card_checkpoint_round_trip_and_resume(tmp_path):
    _card()
    step, params, opt, batch = _toy("cuda")
    w = step.default_comm_weights
    for s in range(3):
        step(params, opt, batch(s), s, w)
    state = {"params": params, "opt_state": opt, "step": 3}
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(3, state, blocking=False)
    saved = params["w"].clone(), opt.state[params["w"]][
        "momentum_buffer"].clone()
    for s in range(3, 6):
        step(params, opt, batch(s), s, w)
    after = params["w"].clone()
    live = params["w"]
    got = ck.restore_latest(like={"params": params, "opt_state": opt,
                                  "step": 0})
    assert got["step"] == 3 and params["w"] is live
    assert torch.equal(params["w"], saved[0])
    assert torch.equal(opt.state[params["w"]]["momentum_buffer"], saved[1])
    for s in range(3, 6):
        step(params, opt, batch(s), s, w)
    assert torch.equal(params["w"], after)
    assert ck.last_save["bytes"] == 2 * 4 * 6 * 2 * 4
    ck.close()


def _tiny_vit(dev, seed=0):
    import torch.nn.functional as F

    cfg = bt.ViTConfig.tiny(dtype=torch.float32, attn_impl="flash")
    init = bt.ViT(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(seed)).state_dict()
    model = bt.ViT(cfg, device=dev,
                   generator=torch.Generator(dev).manual_seed(seed))
    model.load_state_dict(init)
    backend = bt.StackedBackend(4, device=dev)
    params = bt.rank_major(model.state(), backend)
    opt = torch.optim.SGD(params.values(), lr=1e-3, momentum=0.9)
    step = bt.build_train_step(
        lambda p, b: F.cross_entropy(model.apply(p, b[0]), b[1]), opt,
        backend, comm_mode="atc",
        topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(4)),
        guard=bt.GuardConfig(max_consecutive_bad=2, backoff_base=0.0))
    g = torch.Generator().manual_seed(seed + 1)
    images = torch.randn(4, 2, cfg.image_size, cfg.image_size, 3,
                         generator=g)
    labels = torch.randint(0, cfg.num_classes, (4, 2), generator=g)
    return cfg, step, params, opt, (lambda s: (images.to(dev),
                                               labels.to(dev)))


def test_resilient_tiny_vit_card_against_host(tmp_path):
    _card()
    spec = bt.uniform_topology_spec(bt.ExponentialTwoGraph(4))
    plan = R.FaultPlan.nan_burst(4, rank=1, step=1).merged(
        R.FaultPlan.rank_death(4, rank=2, step=4))
    out = {}
    for dev in ("cuda", "cpu"):
        cfg, step, params, opt, batch = _tiny_vit(dev)
        fa.reset_launch_counts()
        res = R.run_resilient(
            step, params, opt, batch, steps=8,
            checkpointer=Checkpointer(str(tmp_path / dev)),
            schedule=[spec], fault_plan=plan, checkpoint_every=2,
            sleep=lambda s: None)
        launches = fa.flash_forward.launches
        out[dev] = ([(e.kind, e.step, e.detail) for e in res.events],
                    {k: v.cpu() for k, v in res.params.items()}, launches)
    assert out["cuda"][0] == out["cpu"][0]
    kinds = [k for k, _, _ in out["cuda"][0]]
    assert "skip" in kinds and "rollback" in kinds
    assert out["cuda"][2] > 0 and out["cpu"][2] == 0
    for k, want in out["cpu"][1].items():
        err = (out["cuda"][1][k] - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-7, k

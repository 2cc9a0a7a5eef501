"""The train-step modes of bluefog_tpu_torch on the card: each mode of a
small MLP trained on CUDA tensors against the same run on the host,
bucketed overlap (the side stream) bit-equal to the plain exchange, the
guard's skip, the stochastic-rounding wire's repeatability, and steady
steps free of host syncs.  Marked ``cuda``: without an NVIDIA card every
test here skips.  The file imports torch and the port only:

    python -m pytest --noconftest -q tests/test_torch_train_modes_cuda.py

Tolerance of card against host: 1e-5 relative plus 1e-6 absolute
(f32 GEMMs sum in another order; TF32 is off for matmuls by default).
"""

import warnings

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bt

N = 4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA path has no CPU mode)")


def _loss(p, batch):
    x, y = batch
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return ((h @ p["w2"] + p["b2"] - y) ** 2).mean()


def _config(mode):
    exp2 = bt.uniform_topology_spec(bt.ExponentialTwoGraph(N))
    return {
        "guard_health": ("atc", dict(topology=exp2, guard=bt.GuardConfig(),
                                     health=bt.HealthConfig())),
        "cta_bucketed": ("cta", dict(topology=exp2, overlap="bucketed",
                                     overlap_buckets=2)),
        "atc_bucketed": ("atc", dict(topology=exp2, overlap="bucketed",
                                     overlap_buckets=2)),
        "topk": ("atc", dict(topology=exp2,
                             compress=bt.MixCompressConfig(0.5, "none"))),
        "hierarchical": ("atc", dict(
            topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(2)),
            hierarchical_local_size=2)),
        "push_sum": ("push_sum", dict(topology=exp2)),
        "int8_sr": ("atc", dict(topology=exp2, compress="int8_sr")),
        "atc": ("atc", dict(topology=exp2)),
        "cta": ("cta", dict(topology=exp2)),
    }[mode]


def _run(mode, dev, steps=3, nan=None, count_syncs=False):
    comm_mode, kw = _config(mode)
    rng = np.random.RandomState(0)
    base = {"b1": rng.randn(64) * 0.1, "b2": rng.randn(8) * 0.1,
            "w1": rng.randn(32, 64) * 0.3, "w2": rng.randn(64, 8) * 0.3}
    backend = bt.StackedBackend(N, device=dev)
    params = bt.rank_major({k: torch.tensor(v, dtype=torch.float32)
                            for k, v in base.items()}, backend)
    opt = torch.optim.SGD(params.values(), lr=0.1, momentum=0.9)
    step = bt.build_train_step(_loss, opt, backend, comm_mode=comm_mode, **kw)
    state = opt
    if step.mix_config is not None:
        state = (opt, step.init_mix_state(params))
    elif comm_mode == "push_sum":
        state = (opt, bt.push_sum_weights(backend))
    x = torch.tensor(np.random.RandomState(1).randn(steps, N, 16, 32),
                     dtype=torch.float32)
    y = torch.tensor(np.random.RandomState(2).randn(steps, N, 16, 8),
                     dtype=torch.float32)
    if nan is not None:
        x[nan[0], nan[1], 0, 0] = float("nan")
    outs, syncs = [], 0
    for s in range(steps):
        args = (params, state, (x[s].to(dev), y[s].to(dev)), s)
        if hasattr(step, "guard_config"):
            args += (step.default_comm_weights,)
        if count_syncs and s == steps - 1:
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = step(*args)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            # not the one-time notice that the mode is a prototype
            syncs = sum("synchronizing CUDA operation" in str(w.message)
                        for w in caught)
        else:
            out = step(*args)
        params, state = out[0], out[1]
        outs.append([o.cpu() if isinstance(o, torch.Tensor) else o
                     for o in out[2:]])
    return ({k: v.cpu() for k, v in params.items()}, state, outs, syncs,
            opt)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["guard_health", "cta_bucketed",
                                  "atc_bucketed", "topk", "hierarchical",
                                  "push_sum"])
def test_mode_on_card_matches_host(mode):
    _card()
    nan = (1, 2) if mode == "guard_health" else None
    cp, _, co, _, _ = _run(mode, "cuda", nan=nan)
    hp, _, ho, _, _ = _run(mode, "cpu", nan=nan)
    for k in hp:
        torch.testing.assert_close(cp[k], hp[k], rtol=1e-5, atol=1e-6)
    for a, b in zip(co, ho):
        torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=1e-6,
                                   equal_nan=True)
        if mode == "guard_health":
            assert torch.equal(a[1], b[1])
            for f in ("grad_norm", "update_norm", "consensus", "skipped"):
                torch.testing.assert_close(getattr(a[2], f).cpu(),
                                           getattr(b[2], f), rtol=1e-5,
                                           atol=1e-6, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("comm_mode", ["cta", "atc"])
def test_bucketed_side_stream_is_bit_equal_to_plain(comm_mode):
    _card()
    plain, _, _, _, _ = _run(comm_mode, "cuda")
    bucketed, _, _, _, _ = _run(f"{comm_mode}_bucketed", "cuda")
    for k in plain:
        assert torch.equal(plain[k], bucketed[k]), k


@pytest.mark.cuda
def test_guard_on_card_keeps_the_skipped_rank():
    _card()
    params, _, outs, _, opt = _run("guard_health", "cuda", steps=2,
                                   nan=(1, 2))
    assert outs[1][1].tolist() == [0, 0, 1, 0]
    assert all(torch.isfinite(v).all() for v in params.values())
    for p in opt.param_groups[0]["params"]:
        assert torch.isfinite(opt.state[p]["momentum_buffer"]).all()


@pytest.mark.cuda
def test_int8_sr_on_card_repeats_bit_for_bit():
    _card()
    a, _, _, _, _ = _run("int8_sr", "cuda")
    b, _, _, _, _ = _run("int8_sr", "cuda")
    for k in a:
        assert torch.isfinite(a[k]).all() and torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["atc", "guard_health", "cta_bucketed",
                                  "atc_bucketed", "int8_sr", "topk",
                                  "hierarchical", "push_sum"])
def test_steady_step_makes_no_host_sync(mode):
    """A step after the first (which copies the weight tables to the card
    once) makes no host sync under torch.cuda.set_sync_debug_mode."""
    _card()
    _, _, _, syncs, _ = _run(mode, "cuda", count_syncs=True)
    assert syncs == 0

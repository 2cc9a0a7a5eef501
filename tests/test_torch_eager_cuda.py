"""The eager ``bf.*`` API, windows and optimizer wrappers on the card:
phase 15 and 17 of ``chip_smoke.py`` at test size.  Every eager op on 8
ranks stacked on CUDA against the same ops on the host (f32 and bf16);
``poll`` never blocks; a nonblocking dynamic ``neighbor_allreduce`` with
new weight values makes no host sync before its ``synchronize``; a tiny
f32 ResNet trained 2 steps through each wrapper on the card (K1) against
the host (its plain version), TF32 off as in ``chip_smoke.py``.  Marked
``cuda``: without an NVIDIA card every test here skips.  The file
imports torch, the port and ``chip_smoke`` only:

    python -m pytest --noconftest -q tests/test_torch_eager_cuda.py

Tolerances are ``chip_smoke``'s: f32 within 1e-6 of the largest entry,
bf16 within one bf16 step of it, versions exact, p within 1e-12; the
tiny ResNet within 5e-4 of each leaf's largest entry plus 5e-7 (losses
1e-5), phase 7's.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA path has no CPU mode)")


@pytest.fixture(autouse=True)
def _f32_convolutions():
    """f32 convolutions and matmuls in f32 on the card, as chip_smoke.py
    runs them (cuDNN's default TF32 rounds f32 inputs to 10 bits)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eager_ops_card_against_host(dtype):
    _card()
    card = chip_smoke.eager_ops("cuda", dtype, 3, shape=(5, 7))
    host = chip_smoke.eager_ops("cpu", dtype, 3, shape=(5, 7))
    worst = chip_smoke.eager_ops_worst(card, host, dtype)
    assert set(worst) == set(host)
    assert max(worst.values()) <= 1, worst


@pytest.mark.cuda
def test_nonblocking_dynamic_neighbor_allreduce_makes_no_host_sync():
    _card()
    syncs, polls, longest = chip_smoke._eager_syncs_and_poll()
    assert syncs == 0
    assert polls in ([False, True], [True]) and longest < 50


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper,compress",
                         [(w, False) for w in chip_smoke.EAGER_WRAPPERS]
                         + [(chip_smoke.EAGER_WRAPPERS[0], True)])
def test_tiny_resnet_wrappers_card_against_host(wrapper, compress):
    _card()
    card = chip_smoke.eager_tiny_run("cuda", 1, wrapper, compress, steps=2)
    host = chip_smoke.eager_tiny_run("cpu", 1, wrapper, compress, steps=2)
    assert card[3] == 4 * 4 * 2 and host[3] == 0
    for which in (0, 1):
        for k, want in host[which].items():
            scale = want.abs().max().item()
            err = (card[which][k] - want).abs().max().item()
            assert err <= 5e-4 * scale + 5e-7, (k, err, scale)
    assert (card[2] - host[2]).abs().max().item() <= 1e-5

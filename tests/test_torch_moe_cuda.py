"""MoE on the card.  Marked ``cuda``: without an NVIDIA card every test
here skips (the flash kernels the MoE Llama trains through have no CPU
mode).  The file imports torch and the port only:

    python -m pytest --noconftest -q tests/test_torch_moe_cuda.py

* The compiled all-to-all over ``StackedBackend(8)`` on the card is
  bit-equal to the naive all-to-all (the swap of the rank axes) and to
  the host's, the transpose returns the input, the int8 wire is
  repeatable and equals the host's.
* A tiny f32 MoE Llama (flash, D = 16: K2, K3a, K3b) gives the host's
  logits, aux loss and gradients within 1e-4 of each leaf's largest
  entry plus 1e-7 (phase 10's card-against-host bound), both routers,
  capacity drops present.
"""

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import moe
from bluefog_tpu_torch.models.llama import llama_loss_fn
from bluefog_tpu_torch.parallel import flash_attention as fa
from bluefog_tpu_torch.topology.compiler import PodSpec, compile_all_to_all

pytestmark = pytest.mark.cuda

N = 8


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")


def test_dispatch_on_the_card_equals_naive_and_host():
    _card()
    plan = moe.dispatch_plan(compile_all_to_all(PodSpec(4, 2)).schedule)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(N, N, 5, 64)).astype(np.float32))
    host = bt.StackedBackend(N, device="cpu")
    card = bt.StackedBackend(N, device="cuda")
    xc = x.cuda()
    got = moe.all_to_all_dispatch(xc, plan, card)
    assert torch.equal(got, moe.naive_all_to_all(xc, card))
    assert torch.equal(got.cpu(), moe.all_to_all_dispatch(x, plan, host))
    assert torch.equal(moe.all_to_all_dispatch(got, plan.transpose(), card),
                       xc)
    a = moe.all_to_all_dispatch(xc, plan, card, wire_dtype="int8")
    b = moe.all_to_all_dispatch(xc, plan, card, wire_dtype="int8")
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), moe.all_to_all_dispatch(
        x, plan, host, wire_dtype="int8"))


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_tiny_moe_llama_card_equals_host(router):
    _card()
    over = dict(n_experts=4, moe_top_k=2, capacity_factor=0.5,
                moe_aux_weight=0.01, moe_router=router)
    if router == "expert_choice":
        over["allow_noncausal_router"] = True
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash",
                              **over)
    init = bt.Llama(cfg, device="cpu", param_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0)).state_dict()
    raw = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 33)))
    out = {}
    for dev in ("cuda", "cpu"):
        model = bt.Llama(cfg, device=dev, param_dtype=torch.float32)
        model.load_state_dict(init)
        params = {k: v.requires_grad_(True)
                  for k, v in model.state().items()}
        batch = (raw[:, :-1].to(dev), raw[:, 1:].to(dev))
        fa.reset_launch_counts()
        loss = llama_loss_fn(model)(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        if dev == "cuda":
            assert fa.flash_forward.launches == cfg.n_layers
            assert fa.flash_backward_dq.launches == cfg.n_layers
        out[dev] = (float(loss.detach()),
                    {k: g.cpu() for k, g in zip(params, grads)})
    assert abs(out["cuda"][0] - out["cpu"][0]) < 1e-5
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-4 * scale + 1e-7, k

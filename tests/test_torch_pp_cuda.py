"""Pipeline parallelism on the card.  Marked ``cuda``: without an NVIDIA
card every test here skips (the flash kernels the stages run through have
no CPU mode).  The file imports torch and the port only:

    python -m pytest --noconftest -q tests/test_torch_pp_cuda.py

* A tiny Llama (flash; f32 at head dim 16, bf16 at head dim 128, the
  ``wgmma`` kernels) under ``llama_pp_loss_fn``, GPipe at 2 stages and the
  circular schedule at 2 stages x 2 loops: its summed stage losses and
  every gradient on the card equal the plain model's on the card within
  1e-4 of each leaf's largest entry plus 1e-7 (f32; bf16: 2e-2), every
  layer slot's attention one K2, K3a and K3b launch a tick for both
  stages (the stages folded into the batch).
* ``build_train_step(pp_axis=)`` on the card: one SGD step of dp 2 x pp 2
  equals the same step on the CPU (the kernels' plain versions) within
  1e-4 of each leaf's largest entry.
"""

import dataclasses

import pytest
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch.models.llama import (llama_circular_layout,
                                            llama_loss_fn,
                                            llama_param_specs,
                                            llama_pp_loss_fn)
from bluefog_tpu_torch.optim import functional as TF
from bluefog_tpu_torch.parallel import flash_attention as fa

pytestmark = pytest.mark.cuda

PP = bt.MeshAxis("pp", 2)
FLASH = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")


@pytest.mark.parametrize("n_loops", [1, 2])
@pytest.mark.parametrize("dtype,over", [
    (torch.float32, dict()),
    (torch.bfloat16, dict(dim=512, n_heads=4, n_kv_heads=2,
                          hidden_dim=256)),
])
def test_pp_llama_on_the_card_equals_the_plain_model(dtype, over, n_loops):
    _card()
    cfg = bt.LlamaConfig.tiny(dtype=dtype, attn_impl="flash", n_layers=4,
                              scan_layers=True, **over)
    g = torch.Generator("cuda").manual_seed(0)
    model = bt.Llama(cfg, device="cuda", param_dtype=torch.float32,
                     generator=g)
    params = model.state()
    batch = tuple(torch.randint(0, 256, (4, 64), generator=g,
                                device="cuda") for _ in range(2))
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss1 = llama_loss_fn(model)(p, batch)
    g1 = dict(zip(p, torch.autograd.grad(loss1, list(p.values()))))
    n_micro = 2
    pp = {k: v.clone().requires_grad_(True) for k, v in (
        llama_circular_layout(params, 2, n_loops) if n_loops > 1
        else params).items()}
    for f in FLASH:
        f.launches = 0
    with bt.bind_axis(PP):
        loss2 = llama_pp_loss_fn(cfg, pp_axis="pp", n_stages=2,
                                 n_micro=n_micro, n_loops=n_loops)(pp, batch)
        g2 = torch.autograd.grad(loss2.sum(), list(pp.values()))
    g2 = dict(zip(pp, g2))
    if n_loops > 1:
        g2 = llama_circular_layout(g2, 2, n_loops, inverse=True)
    # one launch a layer slot a tick: (n_loops * M + S - 1) ticks of
    # L / (S * n_loops) slots
    ticks = n_loops * n_micro + 1
    assert [f.launches for f in FLASH] == \
        [ticks * cfg.n_layers // (2 * n_loops)] * 3
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert abs(loss2.sum().item() - loss1.item()) <= tol * abs(loss1.item())
    for k, want in g1.items():
        scale = float(want.abs().max())
        err = float((g2[k] - want).abs().max())
        assert err <= tol * scale + 1e-7, (k, err, scale)


def test_pp_step_on_the_card_equals_the_cpu():
    _card()
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash",
                              n_layers=4, scan_layers=True)
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32,
                     generator=torch.Generator().manual_seed(1))
    state = model.state(release=True)
    raw = torch.randint(0, 256, (2, 4, 33),
                        generator=torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", "cuda"):
        backend = bt.StackedBackend(2, device=dev)
        leaves = {k: v.to(dev) for k, v in state.items()}
        specs = llama_param_specs(leaves, tp_axis=None, ep_axis=None,
                                  pp_axis="pp")
        params = bt.rank_major(leaves, backend, specs=specs)
        opt = torch.optim.SGD(params.values(), lr=0.1)
        step = bt.build_train_step(
            llama_pp_loss_fn(dataclasses.replace(cfg), pp_axis="pp",
                             n_stages=2, n_micro=2),
            opt, backend, comm_mode="atc",
            topology=bt.uniform_topology_spec(bt.ExponentialTwoGraph(2)),
            pp_axis=PP, param_specs=specs,
            opt_state_specs=TF.optax_state_specs(opt, leaves, specs))
        batch = (raw[..., :-1].to(dev), raw[..., 1:].to(dev))
        params, opt, loss = step(params, opt, batch, 0)
        out[dev] = ({k: v.cpu() for k, v in params.items()}, loss.cpu())
    assert torch.allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    for k, want in out["cpu"][0].items():
        scale = float(want.abs().max())
        err = float((out["cuda"][0][k] - want).abs().max())
        assert err <= 1e-4 * scale + 1e-7, (k, err, scale)

"""Tensor parallelism on the card.  Marked ``cuda``: without an NVIDIA
card every test here skips (the flash and decode kernels the tp shards
run through have no CPU mode).  The file imports torch and the port
only:

    python -m pytest --noconftest -q tests/test_torch_tp_cuda.py

* A tiny Llama (flash; f32 at head dim 16, bf16 at head dim 128, the
  ``wgmma`` kernels) at tp 2, plain and with ``vocab_parallel`` and
  ``tp_seq_shard``: its loss and gradients on the card equal the same
  model's at tp 1 on the card within 1e-4 of each leaf's largest entry
  plus 1e-7 (f32; bf16: 2e-2), every shard's attention through K2, K3a
  and K3b at the per-shard shape (``n_heads / tp`` heads, the shards in
  the batch).
* The tp 2 decode on the card gives the tp 1 decode's greedy tokens,
  every single-token step through K4 at the per-shard shape.
* A tp attention at a head dim the kernels refuse raises on the card
  (no plain fallback).
"""

import dataclasses

import pytest
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch.models.llama import llama_loss_fn
from bluefog_tpu_torch.parallel import decode_attention as da
from bluefog_tpu_torch.parallel import flash_attention as fa

pytestmark = pytest.mark.cuda

TP = bt.MeshAxis("tp", 2)
FLASH = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")


def _grads(model, params, batch, axis):
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    with bt.bind_axis(axis) if axis else torch.enable_grad():
        loss = llama_loss_fn(model)(p, batch)
        g = torch.autograd.grad(loss, list(p.values()))
    return loss.item(), dict(zip(p, g))


@pytest.mark.parametrize("dtype,over", [
    (torch.float32, dict()),
    (torch.float32, dict(vocab_parallel=True, tp_seq_shard=True)),
    (torch.bfloat16, dict(dim=512, n_heads=4, n_kv_heads=2,
                          hidden_dim=256)),
])
def test_tp_llama_on_the_card_equals_tp1(dtype, over):
    _card()
    cfg1 = bt.LlamaConfig.tiny(dtype=dtype, attn_impl="flash",
                               **{k: v for k, v in over.items()
                                  if k not in ("vocab_parallel",
                                               "tp_seq_shard")})
    cfg2 = dataclasses.replace(cfg1, tp_axis="tp", tp_size=2,
                               **{k: v for k, v in over.items()
                                  if k in ("vocab_parallel",
                                           "tp_seq_shard")})
    g = torch.Generator("cuda").manual_seed(0)
    m1 = bt.Llama(cfg1, device="cuda", param_dtype=torch.float32,
                  generator=g)
    m2 = bt.Llama(cfg2, device="cuda", param_dtype=torch.float32)
    params = m1.state()
    batch = tuple(torch.randint(0, 256, (2, 64), generator=g,
                                device="cuda") for _ in range(2))
    loss1, g1 = _grads(m1, params, batch, None)
    for f in FLASH:
        f.launches = 0
    loss2, g2 = _grads(m2, params, batch, TP)
    assert [f.launches for f in FLASH] == [cfg2.n_layers] * 3
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert abs(loss2 - loss1) <= tol * abs(loss1)
    for k, want in g1.items():
        scale = float(want.abs().max())
        err = float((g2[k] - want).abs().max())
        assert err <= tol * scale + 1e-7, (k, err, scale)


def test_tp_decode_on_the_card_equals_tp1():
    _card()
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    model = bt.Llama(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(3))
    state = model.state()
    prompt = torch.randint(0, 256, (3, 9), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))
    want = bt.llama_generate(state, cfg, prompt, 6)
    da.decode_attention.launches = 0
    got = bt.llama_generate(state, dataclasses.replace(
        cfg, tp_axis="tp", tp_size=2), prompt, 6, mesh=TP)
    assert torch.equal(got, want)
    # every step after the prefill, every layer, one launch for all shards
    assert da.decode_attention.launches == 5 * cfg.n_layers


def test_tp_attention_at_a_refused_shape_raises_on_the_card():
    _card()
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash",
                              dim=96, n_heads=2, n_kv_heads=2,
                              tp_axis="tp", tp_size=2)   # head dim 48
    model = bt.Llama(cfg, device="cuda")
    tokens = torch.zeros(1, 8, dtype=torch.long, device="cuda")
    with bt.bind_axis(TP), pytest.raises(ValueError, match="head dim"):
        model(tokens)

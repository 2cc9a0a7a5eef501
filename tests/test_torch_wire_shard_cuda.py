"""Per-device wire buckets on the card.  Marked ``cuda``: without an
NVIDIA card every test here skips (the step's exchanges run on the
card's tensors there, and the host copy is the plain per-device path
they are held to).  The file imports torch and the port only:

    python -m pytest --noconftest -q tests/test_torch_wire_shard_cuda.py

* The int8 wire's per-(rank, device) absmax scales and codes of a
  ``[n, D, numel]`` bucket on the card equal each device's row
  quantized alone on the host, for round to nearest and for stochastic
  rounding (each (rank, device) stream drawn on the card).
* The top-k mixing exchange of a per-device bucket on the card equals
  one exchange per device on the host: the kept masks, the wire, the
  output and every state row.
* A dp 4 x tp 2 tiny Llama under ``MixCompressConfig(0.5, "int8")``:
  the step's combine on the card, from the host's params and MixState,
  equals the host's (params and every MixState row, one per device),
  and a steady step on the card makes no host sync.
"""

import warnings

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import compressor as TCmp
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.models.llama import llama_loss_fn, llama_param_specs
from bluefog_tpu_torch.optim import functional as TF
from bluefog_tpu_torch.parallel import collectives as TC

pytestmark = pytest.mark.cuda

N, D = 4, 2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _x(numel, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        N, D, numel).astype(np.float32))


@pytest.mark.parametrize("sr", [False, True])
def test_per_device_scales_on_card_equal_each_device_alone(sr):
    _card()
    x = _x(1000)
    gen = TC.wire_generator("cuda", 3, 1) if sr else None
    q, scale = TC._wire_quantize_int8(x.cuda(), gen, per_device=True)
    assert scale.shape == (N, D)
    for r in range(N):
        for d in range(D):
            want_s = x[r, d].abs().max() / 127.0
            assert scale[r, d].item() == want_s.item(), (r, d)
            y = x[r, d].cuda() / want_s.cuda()
            if sr:
                u = torch.rand(1000, generator=gen.generator(r, d),
                               device="cuda")
                want = torch.floor(y + u)
            else:
                want = torch.round(y)
            want = torch.clamp(want, -127, 127).to(torch.int8)
            assert torch.equal(q[r, d], want), (r, d)


@pytest.mark.parametrize("values", ["int8", "none"])
def test_per_device_topk_exchange_on_card_equals_each_device_on_host(
        values):
    _card()
    nb, k = 600, 300
    spec = TT.uniform_topology_spec(TT.ExponentialTwoGraph(N))
    x = _x(nb, 1)
    rng = np.random.RandomState(2)
    ref = torch.from_numpy(rng.randn(N, D * nb).astype(np.float32))
    mir = torch.from_numpy(rng.randn(N, 2, D * nb).astype(np.float32))
    err = torch.from_numpy(0.1 * rng.randn(N, D * nb).astype(np.float32))
    ratio = torch.full((N,), 0.4)
    got = TC.mix_compress_exchange(
        x.cuda(), spec, ref_row=ref.cuda(), mirrors=mir.cuda(),
        err=err.cuda(), ratio=ratio.cuda(), k=k, values=values,
        per_device=True)
    for d in range(D):
        sl = slice(d * nb, (d + 1) * nb)
        want = TC.mix_compress_exchange(
            x[:, d], spec, ref_row=ref[:, sl], mirrors=mir[:, :, sl],
            err=err[:, sl], ratio=ratio, k=k, values=values)
        pieces = (got[0][:, d], got[1][:, sl], got[2][:, :, sl],
                  got[3][:, sl])
        for what, a, b in zip(("out", "ref", "mirror", "err"), pieces,
                              want):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"device {d} {what}")
        target = (x[:, d] - ref[:, sl] + err[:, sl])
        m_host, _ = TCmp.topk_mask_encode(target, k,
                                          torch.full((N,), 240))
        m_card, _ = TCmp.topk_mask_encode(target.cuda(), k,
                                          torch.full((N,), 240).cuda())
        assert torch.equal(m_card.cpu(), m_host), d


def _step(device):
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, tp_axis="tp",
                              tp_size=2, attn_impl="xla")
    model = bt.Llama(cfg, device=device, param_dtype=torch.float32,
                     generator=torch.Generator(device).manual_seed(0))
    state = {k: v.to(device) for k, v in model.state(release=True).items()}
    backend = bt.StackedBackend(N, device=device)
    specs = llama_param_specs(state)
    params = bt.rank_major(state, backend, specs=specs)
    opt = torch.optim.SGD(params.values(), lr=0.3)
    step = bt.build_train_step(
        llama_loss_fn(model), opt, backend, comm_mode="cta",
        topology=TT.uniform_topology_spec(TT.ExponentialTwoGraph(N)),
        mesh_axes=(bt.MeshAxis("tp", 2),), param_specs=specs,
        opt_state_specs=TF.optax_state_specs(opt, state, specs),
        compress=bt.MixCompressConfig(0.5, "int8"))
    raw = np.random.RandomState(0).randint(0, 256, (N, 2, 17))
    batch = (torch.from_numpy(raw[..., :-1]).to(device),
             torch.from_numpy(raw[..., 1:]).to(device))
    return step, params, (opt, step.init_mix_state(params)), batch


def test_tp_mix_combine_on_card_equals_host_and_step_has_no_syncs():
    """The step's top-k combine (int8 values, per-device buckets) on the
    card, from the host's params and MixState, equals the host's: the
    combined params and every MixState row (the selection, the scales
    and the decode are exact on both; a whole step is not compared, as
    its f32 products round in another order and a rounding boundary or
    a top-k place can move with them).  A steady step on the card makes
    no host sync."""
    _card()
    host = _step("cpu")
    card = _step("cuda")
    for p_h, p_c in zip(host[1].values(), card[1].values()):
        p_h.add_(0.01 * torch.randn_like(p_h))   # ranks apart
        p_c.copy_(p_h)
    for field in ("err", "ref", "mirror"):
        for a, b in zip(getattr(host[2][1], field),
                        getattr(card[2][1], field)):
            b.copy_(a)
    cons_h = host[0].combine(host[1], 0, host[2][1])
    cons_c = card[0].combine(card[1], 0, card[2][1])
    for (k, a), b in zip(host[1].items(), card[1].values()):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for field in ("err", "ref", "mirror"):
        for i, (a, b) in enumerate(zip(getattr(host[2][1], field),
                                       getattr(card[2][1], field))):
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{field}[{i}]")
    np.testing.assert_allclose(cons_c.cpu().numpy(), cons_h.numpy(),
                               rtol=1e-5)
    numel = sum(r["numel"] for r in card[0].mix_wire_layout(card[1]))
    assert sum(e.shape[1] for e in card[2][1].err) == 2 * numel
    state = card[2]
    out = card[0](card[1], state, card[3], 0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            card[0](card[1], out[1], card[3], 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    assert not syncs, [str(w.message) for w in syncs]

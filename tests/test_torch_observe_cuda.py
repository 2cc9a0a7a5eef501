"""The step profiler on the card: ``ServingEngine.profile()``'s
``decode_step`` names the decode-attention kernel K4 among its device
kernels, launches it once a layer in each of its two runs, and counts
K4's work in its FLOPs.  Marked ``cuda``: without an NVIDIA card the test
skips.  The file imports torch, numpy and the port only, so it also runs
where jax is not installed:

    python -m pytest --noconftest -q tests/test_torch_observe_cuda.py
"""

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as bt
from bluefog_tpu_torch.observe.registry import MetricsRegistry
from bluefog_tpu_torch.parallel import decode_attention as da
from bluefog_tpu_torch.serving import Request, ServingEngine


@pytest.mark.cuda
def test_decode_step_profile_names_k4_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    cfg = bt.LlamaConfig.tiny(dtype=torch.bfloat16, n_heads=4, n_kv_heads=2,
                              dim=128)
    model = bt.Llama(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    eng = ServingEngine(model, cfg, capacity=4, max_len=64, prefill_chunk=8,
                        registry=MetricsRegistry())
    for i in range(3):
        eng.submit(Request(np.arange(5 + 4 * i, dtype=np.int32) % 251, 6))
    for _ in range(3):
        eng.step()
    da.reset_launch_counts()
    profs = eng.profile(publish=False)
    assert da.decode_attention.launches == 2 * cfg.n_layers
    dec = profs["decode_step"]
    names = " ".join(dec.op_breakdown)
    assert "decode_split_kernel" in names and "decode_merge_kernel" in names
    assert dec.kernel_ms("decode_split_kernel", "decode_merge_kernel") > 0
    assert dec.kernel_flops["decode_attention"] > 0
    assert dec.flops > dec.kernel_flops["decode_attention"]
    assert dec.device_seconds > 0 and dec.peak_flops > 0
    assert "decode_split_kernel" not in " ".join(
        profs["prefill_chunk"].op_breakdown)
    eng.run()

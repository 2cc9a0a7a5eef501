"""Weight-only int8 quantization of a Llama state dict.

Port of ``bluefog_tpu/models/quant.py``: each projection kernel ``W [in,
out]`` of :data:`QUANT_KERNELS` becomes ``clip(round(W / s), -127, 127)``
in int8 with one f32 scale per OUTPUT channel, ``s = max(|W|, axis=in) /
127``, as in the JAX package (bit for bit: an f32 division and round half
to even).  The port's state dict keeps flax's ``[in, out]`` kernel shape
(``models/llama.py``'s ``Dense``), so the reduction is over axis -2 in
both packages.  The quantized layout is the one ``QuantDense`` loads:
``<module>.kernel`` int8 ``[in, out]`` beside ``<module>.scale`` f32
``[out]``.

Usage::

    qstate = quantize_llama_params(model.state_dict())   # once, offline
    out = llama_generate(qstate, cfg, prompt, n, weight_quant="int8")
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import torch

__all__ = ["quantize_llama_params", "is_quantized_params",
           "QUANT_KERNELS"]

# Modules whose kernel quantizes: all seven projections plus the logits
# head.  Embeddings stay full precision (decode gathers one row a token)
# and norm scales are vectors.
QUANT_KERNELS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "output")


def _quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 kernel + per-output-channel f32 scale for ``w [.., in, out]``
    (the reduction is over the input axis only)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127)
    return q.to(torch.int8), scale


def _module(key: str) -> str:
    parts = key.split(".")
    return parts[-2] if len(parts) >= 2 else ""


def quantize_llama_params(state: Union[Mapping[str, torch.Tensor],
                                       torch.nn.Module]
                          ) -> Dict[str, torch.Tensor]:
    """Convert a full-precision Llama state dict (or a
    :class:`~bluefog_tpu_torch.models.Llama`) to the ``param_quant`` int8
    layout: every ``<m>.kernel`` of a :data:`QUANT_KERNELS` module ``m``
    becomes an int8 kernel plus ``<m>.scale``; every other entry is kept
    as it is.  The tensors stay on their device."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, w in state.items():
        if key.endswith(".kernel") and _module(key) in QUANT_KERNELS:
            q, scale = _quantize_kernel(w)
            out[key] = q
            out[key[:-len("kernel")] + "scale"] = scale
        else:
            out[key] = w
    return out


def is_quantized_params(state) -> bool:
    """True if the state dict already carries the int8 layout (any
    :data:`QUANT_KERNELS` module with both ``kernel`` and ``scale``).  A
    :class:`~bluefog_tpu_torch.models.Llama` answers by its config."""
    if isinstance(state, torch.nn.Module):
        return getattr(state, "cfg", None) is not None \
            and state.cfg.param_quant != "none"
    return any(key.endswith(".scale") and _module(key) in QUANT_KERNELS
               and key[:-len("scale")] + "kernel" in state
               for key in state)

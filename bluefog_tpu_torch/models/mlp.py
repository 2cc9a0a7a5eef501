"""Small dense and conv models for MNIST-scale experiments.

Port of ``bluefog_tpu/models/mlp.py`` (flax.linen): :class:`MLP` and
:class:`MnistNet` with the same architecture and parameter names
(flax's auto-names ``Dense_0``, ``Conv_0``, ...), so a flax tree maps
onto the state dict by joining paths
(``interop.mlp_params_from_flax``).

* Parameters are float32 (flax's default ``param_dtype``); every layer
  casts its input, kernel and bias to ``dtype`` and computes ``x @ kernel``
  and then ``+ bias`` in it, as flax's ``nn.Dense``/``nn.Conv`` do.
* Images are NHWC, as the JAX models take them; :class:`MnistNet`
  flattens its last feature map in NHWC order, so its ``Dense_0`` kernel
  is flax's row for row.  Conv kernels are stored OIHW (flax: HWIO),
  Dense kernels keep flax's ``[in, out]``.
* flax infers the input width at ``init``; :class:`MLP` takes it as
  ``in_features``.
* Dropout (``MnistNet(..., deterministic=False)``) draws its mask from
  torch's generator, not ``jax.random``: the same rate, other bits.

Parameters are drawn from ``generator`` (default: seed 0 on ``device``)
at flax's initializer scales: LeCun-normal (truncated at 2 std) kernels,
zero biases.  ``device`` defaults to ``"cuda"`` and raises without CUDA
unless ``"cpu"`` is passed.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch._device import resolve_device

__all__ = ["MLP", "MnistNet", "Dense"]


class Dense(nn.Module):
    """flax ``nn.Dense`` with a bias: float32 kernel ``[in, out]`` and
    bias, ``x @ kernel + bias`` computed in ``dtype``."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(n_in, n_out, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(n_out, device=device),
                                 requires_grad=False)

    def forward(self, x):
        return (x.to(self.dtype) @ self.kernel.to(self.dtype)
                + self.bias.to(self.dtype))


class _Conv(nn.Module):
    """flax ``nn.Conv(padding="VALID")`` with a bias: float32 kernel
    (stored OIHW) and bias, computed in ``dtype`` on NCHW tensors."""

    def __init__(self, ci: int, co: int, k: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(co, ci, k, k, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(co, device=device),
                                 requires_grad=False)

    def forward(self, x):
        y = F.conv2d(x.to(self.dtype), self.kernel.to(self.dtype))
        return y + self.bias.to(self.dtype)[:, None, None]


@torch.no_grad()
def init_lecun_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers on every ``kernel`` parameter of
    ``module`` (LeCun-normal, truncated at 2 std, over the kernel's fan
    in: ``[in, out]`` Dense, OIHW conv, or the module's own ``fan_in``)
    and zeros on every ``bias``; other parameters are left alone."""
    for mod in module.modules():
        kernel = mod._parameters.get("kernel")
        if kernel is not None:
            fan_in = getattr(mod, "fan_in", None) or (
                kernel.shape[0] if kernel.dim() == 2
                else math.prod(kernel.shape[1:]))
            std = fan_in ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(kernel, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        bias = mod._parameters.get("bias")
        if bias is not None:
            bias.zero_()


class _Model(nn.Module):
    """What the port's small models share: ``state()`` and ``apply``."""

    def state(self) -> Dict[str, torch.Tensor]:
        """Detached copies of the parameters, by state-dict name."""
        return {k: v.detach().clone() for k, v in self.named_parameters()}

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
              **kwargs) -> torch.Tensor:
        """The forward over the given parameters (``torch.func.
        functional_call``): the functional form ``build_train_step``
        uses."""
        return torch.func.functional_call(self, params, (x,), kwargs)


class MLP(_Model):
    """Plain MLP: ``features[i]`` hidden widths with ReLU, the last one
    the logits.  Input ``[N, ...]`` is flattened to ``[N,
    in_features]``."""

    def __init__(self, in_features: int,
                 features: Sequence[int] = (128, 64, 10),
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.features = tuple(features)
        widths = (in_features,) + self.features
        for i in range(len(self.features)):
            setattr(self, f"Dense_{i}", Dense(widths[i], widths[i + 1],
                                              dtype, dev))
        init_lecun_(self, generator or torch.Generator(dev).manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        n = len(self.features)
        for i in range(n - 1):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{n - 1}")(x)


class MnistNet(_Model):
    """The reference's MNIST CNN in NHWC: conv(10, 5x5) -> max-pool ->
    conv(20, 5x5) -> max-pool -> dense(50) -> dense(10), ReLU after each
    but the last; dropout 0.5 before the last layer only with
    ``deterministic=False``.  Images ``[N, 28, 28, 1]``."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.Conv_0 = _Conv(1, 10, 5, dtype, dev)
        self.Conv_1 = _Conv(10, 20, 5, dtype, dev)
        self.Dense_0 = Dense(4 * 4 * 20, 50, dtype, dev)
        self.Dense_1 = Dense(50, 10, dtype, dev)
        init_lecun_(self, generator or torch.Generator(dev).manual_seed(0))

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)    # NHWC -> NCHW view
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's order
        x = F.relu(self.Dense_0(x))
        if not deterministic:
            x = F.dropout(x, 0.5, training=True)
        return self.Dense_1(x)

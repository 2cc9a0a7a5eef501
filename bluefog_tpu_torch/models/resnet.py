"""ResNet family of the port.

Port of ``bluefog_tpu/models/resnet.py`` (flax.linen): the same
architecture, numerics recipe and parameter names.

* **Layout.** ``forward`` takes NHWC images, as the JAX model does;
  inside, activations are NCHW tensors in channels_last memory
  (``x.permute(0, 3, 1, 2)`` of an NHWC tensor is one, with no copy).
  The 3x3 convolutions, the stem and max-pool go to cuDNN through
  ``F.conv2d`` / ``F.max_pool2d``, as the JAX package leaves them to XLA.
* **Precision.** bf16 compute (``dtype``) with float32 parameters and
  float32 batch-norm statistics.
* **Padding.** flax's ``"SAME"`` is reproduced exactly: for an even input
  at stride 2 a 3x3 convolution pads (0, 1), not torch's (1, 1).  The
  space-to-depth stem pads [(2, 1), (2, 1)]; an odd H or W falls back to
  the plain 7x7/s2 stem with (3, 3) padding.
* **Batch norm** has flax's semantics (:class:`BatchNorm`): it normalises
  with the biased batch variance, computes its statistics in float32, and
  in train mode returns the new running statistics
  (``momentum * old + (1 - momentum) * batch``, ``momentum`` = 0.9 the
  weight of the OLD value) instead of updating buffers in place, as
  ``mutable=["batch_stats"]`` does.  Each rank keeps its own statistics.
* **Names.** Submodules carry flax's names (``conv_init``, ``bn_init``,
  ``BottleneckBlock_3/Conv_1``, ``BatchNorm_2``, ``conv_proj``,
  ``norm_proj``, ``Dense_0``), so a flax tree maps onto the state dict by
  joining paths (``interop.resnet_params_from_flax``).  Conv kernels are
  stored OIHW (flax: HWIO); Dense kernels keep flax's ``[in, out]``.
* **K1.** ``pallas_conv1x1=True`` routes each bottleneck's expansion and
  projection 1x1 convolutions through :func:`~bluefog_tpu_torch.parallel.
  conv1x1.conv1x1`, whose backward is the fused kernel; the expansion is
  then named ``_PallasConv1x1_0`` instead of ``Conv_2``, as in flax.

``model.apply(params, batch_stats, x, train=True)`` is the functional
form ``build_train_step`` uses: it runs ``torch.func.functional_call``
on the given tensors and returns ``(logits, new_batch_stats)``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.parallel.conv1x1 import conv1x1

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "BatchNorm", "Conv",
           "PallasConv1x1", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152"]

_CL = torch.channels_last


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding (low, high) of one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int,
          pads: Tuple[Tuple[int, int], Tuple[int, int]]) -> torch.Tensor:
    """NCHW (channels_last) convolution with explicit per-side padding."""
    (hl, hh), (wl, wh) = pads
    if hl == hh and wl == wh:
        return F.conv2d(x, w, stride=stride, padding=(hl, wl))
    x = F.pad(x, (wl, wh, hl, hh)).contiguous(memory_format=_CL)
    return F.conv2d(x, w, stride=stride)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME")``: kernel OIHW,
    float32, computed in ``dtype``."""

    def __init__(self, ci: int, co: int, k: int, stride: int = 1,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(co, ci, k, k, device=device))
        self.k, self.stride, self.dtype = k, stride, dtype

    def forward(self, x):
        pads = tuple(_same_pads(x.shape[d], self.k, self.stride)
                     for d in (2, 3))
        return _conv(x, self.kernel.to(self.dtype), self.stride, pads)


class PallasConv1x1(nn.Module):
    """flax ``_PallasConv1x1``: a 1x1 convolution whose backward is the
    fused K1 kernel.  Kernel ``[co, ci, 1, 1]`` (OIHW), float32."""

    def __init__(self, ci: int, co: int, stride: int = 1,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(co, ci, 1, 1, device=device))
        self.stride, self.dtype = stride, dtype

    def forward(self, x):
        co, ci = self.kernel.shape[:2]
        w = self.kernel.reshape(co, ci).t().to(self.dtype)   # [ci, co]
        y = conv1x1(x.to(self.dtype).permute(0, 2, 3, 1), w, self.stride)
        return y.permute(0, 3, 1, 2)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW.

    ``forward(x, stats=None)`` normalises with the running statistics
    (eval); ``forward(x, stats={})`` normalises with the batch's (train)
    and writes this layer's new running ``mean``/``var`` into ``stats``
    under its qualified name.  Batch statistics are float32 and biased.
    One ``F.batch_norm`` pass both normalises and leaves the batch mean
    and the unbiased variance in zeroed float32 scratch buffers (momentum
    1); ``(count - 1) / count`` turns the latter into flax's biased
    variance.  The output is in ``dtype``."""

    def __init__(self, features: int, zero_scale: bool = False,
                 dtype=torch.bfloat16, momentum: float = 0.9,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.scale = nn.Parameter(
            (torch.zeros if zero_scale else torch.ones)(features,
                                                        device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.zero_scale = zero_scale
        self.qualname = ""   # set by ResNet after construction

    def forward(self, x, stats: Optional[Dict[str, torch.Tensor]] = None):
        if stats is None:
            y = F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                             False, 0.0, self.eps)
            return y.to(self.dtype)
        batch = torch.zeros(2, x.shape[1], dtype=torch.float32,
                            device=x.device)
        y = F.batch_norm(x, batch[0], batch[1], self.scale, self.bias, True,
                         1.0, self.eps)
        count = x.numel() // x.shape[1]
        with torch.no_grad():
            m = self.momentum
            var = batch[1] * ((count - 1) / count)
            stats[self.qualname + "mean"] = m * self.mean + (1 - m) * batch[0]
            stats[self.qualname + "var"] = m * self.var + (1 - m) * var
        return y.to(self.dtype)


class _Stem(nn.Module):
    """``conv_init``: the 7x7/s2 stem, computed space-to-depth when H and W
    are even (flax ``_SpaceToDepthInit``: a 4x4/s1 conv over the 2x2
    space-to-depth layout, padding [(2, 1), (2, 1)]; the parameter stays
    the 7x7 kernel), else as the plain conv with (3, 3) padding."""

    def __init__(self, ci: int, co: int, space_to_depth: bool, dtype,
                 device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(co, ci, 7, 7, device=device))
        self.space_to_depth, self.dtype = space_to_depth, dtype

    def forward(self, x_nhwc):
        b, h, w, c = x_nhwc.shape
        f = self.kernel.shape[0]
        kernel = self.kernel.to(self.dtype)
        if not (self.space_to_depth and h % 2 == 0 and w % 2 == 0):
            return F.conv2d(x_nhwc.permute(0, 3, 1, 2), kernel, stride=2,
                            padding=3)
        # x[2P+a, 2Q+b, c] -> X[P, Q, (a, b, c)]
        xs = x_nhwc.reshape(b, h // 2, 2, w // 2, 2, c)
        xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        # w4[m, n, (a, b, c), o] = w7[2m + a - 1, 2n + b - 1, c, o]
        w7 = kernel.permute(2, 3, 1, 0)                      # HWIO
        w8 = F.pad(w7, (0, 0, 0, 0, 1, 0, 1, 0))             # [8, 8, c, f]
        w4 = w8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
        w4 = w4.reshape(4, 4, 4 * c, f).permute(3, 2, 0, 1)  # OIHW
        return _conv(xs.permute(0, 3, 1, 2), w4, 1, ((2, 1), (2, 1)))


class BasicBlock(nn.Module):
    """flax ``BasicBlock``: two 3x3 convs, zero-initialised last BN scale,
    a 1x1 projection when the shape changes."""

    expansion = 1

    def __init__(self, ci: int, filters: int, stride: int, dtype,
                 pallas_conv1x1: bool = False, device=None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, device=device)
        norm = partial(BatchNorm, dtype=dtype, device=device)
        self.Conv_0 = conv(ci, filters, 3, stride)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3)
        self.BatchNorm_1 = norm(filters, zero_scale=True)
        if ci != filters or stride != 1:
            self.conv_proj = conv(ci, filters, 1, stride)
            self.norm_proj = norm(filters)

    def forward(self, x, stats=None):
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = self.BatchNorm_1(self.Conv_1(y), stats)
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(residual), stats)
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """flax ``BottleneckBlock``: 1x1 -> 3x3 (stride) -> 1x1 expansion,
    zero-initialised last BN scale, a 1x1 projection when the shape
    changes; with ``pallas_conv1x1`` the expansion and projection are
    :class:`PallasConv1x1` (the K1 backward)."""

    expansion = 4

    def __init__(self, ci: int, filters: int, stride: int, dtype,
                 pallas_conv1x1: bool = False, device=None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, device=device)
        norm = partial(BatchNorm, dtype=dtype, device=device)
        co = filters * 4
        self.Conv_0 = conv(ci, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, stride)
        self.BatchNorm_1 = norm(filters)
        if pallas_conv1x1:
            self._PallasConv1x1_0 = PallasConv1x1(filters, co, 1, dtype,
                                                  device)
            self._expand = "_PallasConv1x1_0"
        else:
            self.Conv_2 = conv(filters, co, 1)
            self._expand = "Conv_2"
        self.BatchNorm_2 = norm(co, zero_scale=True)
        if ci != co or stride != 1:
            self.conv_proj = (PallasConv1x1(ci, co, stride, dtype, device)
                              if pallas_conv1x1 else conv(ci, co, 1, stride))
            self.norm_proj = norm(co)

    def forward(self, x, stats=None):
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), stats))
        y = self.BatchNorm_2(getattr(self, self._expand)(y), stats)
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(residual), stats)
        return F.relu(residual + y)


class Dense(nn.Module):
    """flax ``nn.Dense`` in float32: ``x @ kernel + bias``, kernel
    ``[in, out]``."""

    def __init__(self, n_in: int, n_out: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(n_in, n_out, device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x):
        return x.float() @ self.kernel + self.bias


class ResNet(nn.Module):
    """ResNet over NHWC images (flax ``ResNet``).

    ``forward(x, train=False)`` returns logits (float32); with
    ``train=True`` it normalises with batch statistics and returns
    ``(logits, new_batch_stats)``.  Parameters are drawn from
    ``generator`` (default: seed 0 on ``device``) at flax's initializer
    scales: LeCun-normal (truncated at 2 std) for conv and Dense kernels,
    zeros for biases, ones for BN scales except the zero-initialised
    last BN of each block.  ``device`` defaults to ``"cuda"`` and raises
    without CUDA unless ``"cpu"`` is passed."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 space_to_depth: bool = True, pallas_conv1x1: bool = False,
                 in_channels: int = 3,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.dtype = dtype
        self.pallas_conv1x1 = (pallas_conv1x1
                               and block_cls is BottleneckBlock)
        self.conv_init = _Stem(in_channels, num_filters, space_to_depth,
                               dtype, dev)
        self.bn_init = BatchNorm(num_filters, dtype=dtype, device=dev)
        ci, k = num_filters, 0
        self._blocks = []
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                name = f"{block_cls.__name__}_{k}"
                setattr(self, name, block_cls(ci, filters, stride, dtype,
                                              self.pallas_conv1x1, dev))
                self._blocks.append(name)
                ci, k = filters * block_cls.expansion, k + 1
        self.Dense_0 = Dense(ci, num_classes, dev)
        for name, mod in self.named_modules():
            if isinstance(mod, BatchNorm):
                mod.qualname = f"{name}." if name else ""
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        self.init_weights_(generator)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """Redraw every parameter from ``generator`` (see the class
        docstring) and reset the batch statistics."""
        for mod in self.modules():
            kernel = getattr(mod, "kernel", None)
            if isinstance(kernel, nn.Parameter):
                fan_in = (kernel.shape[0] if isinstance(mod, Dense)
                          else math.prod(kernel.shape[1:]))
                std = fan_in ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(kernel, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            if isinstance(mod, Dense):
                mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.scale.fill_(0.0 if mod.zero_scale else 1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)

    def state(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(params, batch_stats): detached copies of the parameters and the
        running statistics, keyed by their state-dict names."""
        params = {k: v.detach().clone() for k, v in self.named_parameters()}
        stats = {k: v.detach().clone() for k, v in self.named_buffers()}
        return params, stats

    def forward(self, x: torch.Tensor, train: bool = False):
        stats = {} if train else None
        y = self.conv_init(x.to(self.dtype))
        y = F.relu(self.bn_init(y, stats))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for name in self._blocks:
            y = getattr(self, name)(y, stats)
        y = y.mean(dim=(2, 3))
        logits = self.Dense_0(y)
        return (logits, stats) if train else logits

    def apply(self, params: Dict[str, torch.Tensor],
              batch_stats: Dict[str, torch.Tensor], x: torch.Tensor,
              train: bool = False):
        """The forward over the given tensors (``torch.func.
        functional_call``): ``params`` by parameter name, ``batch_stats``
        by buffer name.  Returns logits, or ``(logits, new_batch_stats)``
        with ``train=True``."""
        return torch.func.functional_call(self, {**params, **batch_stats},
                                          (x,), {"train": train})


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3),
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3),
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3),
                    block_cls=BottleneckBlock)

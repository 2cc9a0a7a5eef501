"""Vision Transformer of the port.

Port of ``bluefog_tpu/models/vit.py`` (flax.linen): :class:`ViTConfig`
with every field and its factories, the same architecture (patchify,
cls token, learned position embeddings, register tokens, pre-LN blocks)
and parameter names (``patch_embed``, ``cls_token``, ``pos_embed``,
``reg_tokens``, ``block_{i}/{norm1, attn/{wq, wk, wv, wo}, norm2,
mlp_in, mlp_out}``, ``norm``, ``head``), so a flax tree maps onto the
state dict by joining paths (``interop.vit_params_from_flax``).

Token attention is ``full_attention`` (``attn_impl="xla"``), the flash
kernels K2/K3a/K3b non-causal (``attn_impl="flash"``,
``parallel/flash_attention.py``) or ``blockwise_attention``
(``attn_mode="blockwise"``).

What flax computes, and the port with it:

* ``nn.LayerNorm(dtype=bf16, param_dtype=f32)``: epsilon 1e-6 (torch's
  default is 1e-5); the statistics in f32 whatever the input (flax
  promotes to at least f32), the variance as E[x²] - E[x]² clipped at 0,
  ``(x - mean) · (rsqrt(var + eps) · scale) + bias`` in f32, then cast to
  ``dtype``.
* ``nn.gelu`` is the tanh approximation.
* ``nn.Dense``: input, f32 kernel and bias cast to ``dtype``, the product
  and then the bias add in ``dtype``; the head is an f32 Dense.
* The patch embedding is ``nn.Conv`` with an HWIO kernel ``[p, p, C,
  dim]``, stride p and "SAME" padding; the port pads the same way,
  patchifies (a reshape to ``[B, patches, p·p·C]`` in (row, col,
  channel) order) and multiplies by the kernel reshaped to ``[p·p·C,
  dim]``: the same sum.  The kernel is stored HWIO, as flax's.
* ``n_register_tokens="auto"`` adds ``(-t) % 8`` registers, from the
  token geometry only; ``pos_embed`` covers the t tokens before them,
  and they are dropped before pooling.

Images are NHWC, as the JAX model takes them.  Parameters are f32
(flax's ``param_dtype``), drawn from ``generator`` (default: seed 0 on
``device``) at flax's initializer scales: LeCun-normal kernels, zero
biases, ones for the norms' scales, zero cls token, normal(0.02)
position embeddings and registers.  ``device`` defaults to ``"cuda"``
and raises without CUDA unless ``"cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.models.mlp import Dense, _Model, init_lecun_
from bluefog_tpu_torch.models.resnet import _same_pads
from bluefog_tpu_torch.parallel.flash_attention import flash_attention
from bluefog_tpu_torch.parallel.ring_attention import (blockwise_attention,
                                                       full_attention)

__all__ = ["ViTConfig", "ViT", "ViT_S16", "ViT_B16"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Same fields and defaults as the JAX ``ViTConfig``; ``dtype`` is a
    torch dtype (or its name)."""
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    dim: int = 768
    depth: int = 12
    n_heads: int = 12
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16
    attn_mode: str = "full"  # full | blockwise
    attn_impl: str = "xla"  # xla | flash
    attn_block_size: int = 256
    pool: str = "cls"  # cls | gap
    n_register_tokens: object = "auto"  # int | "auto"

    def __post_init__(self):
        if isinstance(self.dtype, str):
            object.__setattr__(self, "dtype", _DTYPES[self.dtype])

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def small(**overrides) -> "ViTConfig":
        return ViTConfig(dim=384, depth=12, n_heads=6, **overrides)

    @staticmethod
    def base(**overrides) -> "ViTConfig":
        return ViTConfig(dim=768, depth=12, n_heads=12, **overrides)

    @staticmethod
    def tiny(**overrides) -> "ViTConfig":
        """Test-scale config."""
        return ViTConfig(image_size=32, patch_size=8, num_classes=10,
                         dim=64, depth=2, n_heads=4, **overrides)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (see the module docstring)."""

    def __init__(self, dim: int, dtype: torch.dtype, device,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(dim, device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, device=device),
                                 requires_grad=False)

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp_min((x32 * x32).mean(-1, keepdim=True)
                              - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x32 - mean) * mul + self.bias).to(self.dtype)


class PatchEmbed(nn.Module):
    """flax ``nn.Conv(dim, (p, p), strides=(p, p))`` with "SAME" padding
    on NHWC images, as a patchify and one product (see the module
    docstring): ``[B, H, W, C]`` -> ``[B, patches, dim]``."""

    def __init__(self, p: int, ci: int, dim: int, dtype, device):
        super().__init__()
        self.p, self.dtype = p, dtype
        self.fan_in = p * p * ci   # the kernel is HWIO
        self.kernel = nn.Parameter(torch.empty(p, p, ci, dim, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, device=device),
                                 requires_grad=False)

    def forward(self, x):
        p = self.p
        b, h, w, c = x.shape
        (hl, hh), (wl, wh) = _same_pads(h, p, p), _same_pads(w, p, p)
        if hl or hh or wl or wh:
            x = F.pad(x, (0, 0, wl, wh, hl, hh))
        gh, gw = (h + hl + hh) // p, (w + wl + wh) // p
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c).to(self.dtype)
        kernel = self.kernel.to(self.dtype).reshape(p * p * c, -1)
        return x @ kernel + self.bias.to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, device):
        super().__init__()
        self.cfg = cfg
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, Dense(cfg.dim, cfg.dim, cfg.dtype, device))

    def forward(self, x):
        cfg = self.cfg
        b, t, _ = x.shape
        shape = (b, t, cfg.n_heads, cfg.head_dim)
        q = self.wq(x).reshape(shape)
        k = self.wk(x).reshape(shape)
        v = self.wv(x).reshape(shape)
        if cfg.attn_impl == "flash":
            out = flash_attention(q, k, v, causal=False,
                                  block_q=min(cfg.attn_block_size, t),
                                  block_k=min(cfg.attn_block_size, t))
        elif cfg.attn_mode == "blockwise":
            out = blockwise_attention(q, k, v, cfg.attn_block_size,
                                      causal=False)
        else:
            out = full_attention(q, k, v, causal=False)
        return self.wo(out.reshape(b, t, cfg.dim))


class Block(nn.Module):
    """Pre-LN block: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``
    with a tanh-approximated GELU."""

    def __init__(self, cfg: ViTConfig, device):
        super().__init__()
        self.norm1 = LayerNorm(cfg.dim, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.norm2 = LayerNorm(cfg.dim, cfg.dtype, device)
        hidden = cfg.dim * cfg.mlp_ratio
        self.mlp_in = Dense(cfg.dim, hidden, cfg.dtype, device)
        self.mlp_out = Dense(hidden, cfg.dim, cfg.dtype, device)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        h = F.gelu(self.mlp_in(self.norm2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class ViT(_Model):
    """images ``[B, H, W, 3]`` -> logits ``[B, num_classes]`` (f32)."""

    def __init__(self, cfg: ViTConfig,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.attn_impl not in ("xla", "flash"):
            raise ValueError(f"attn_impl {cfg.attn_impl!r} not in "
                             "('xla', 'flash')")
        dev = resolve_device(device)
        self.cfg = cfg
        p, d = cfg.patch_size, cfg.dim
        # RGB images: flax infers the channels from the init batch
        self.patch_embed = PatchEmbed(p, 3, d, cfg.dtype, dev)
        # the conv's "SAME" output: ceil(image / patch) per side
        side = -(-cfg.image_size // p)
        t = side * side
        if cfg.pool == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=dev),
                                          requires_grad=False)
            t += 1
        self.n_tokens = t
        self.pos_embed = nn.Parameter(torch.empty(1, t, d, device=dev),
                                      requires_grad=False)
        self.n_reg = ((-t) % 8 if cfg.n_register_tokens == "auto"
                      else int(cfg.n_register_tokens))
        if self.n_reg:
            self.reg_tokens = nn.Parameter(
                torch.empty(1, self.n_reg, d, device=dev),
                requires_grad=False)
        for i in range(cfg.depth):
            setattr(self, f"block_{i}", Block(cfg, dev))
        self.norm = LayerNorm(d, cfg.dtype, dev)
        self.head = Dense(d, cfg.num_classes, torch.float32, dev)
        self.init_weights_(generator or torch.Generator(dev).manual_seed(0))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """Redraw every parameter from ``generator`` (see the module
        docstring for the scales)."""
        init_lecun_(self, generator)
        for mod in self.modules():
            if isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        if self.n_reg:
            self.reg_tokens.normal_(0.0, 0.02, generator=generator)
        if self.cfg.pool == "cls":
            self.cls_token.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        b = images.shape[0]
        x = self.patch_embed(images.to(dt))
        if cfg.pool == "cls":
            x = torch.cat([self.cls_token.to(dt).expand(b, 1, cfg.dim), x],
                          dim=1)
        x = x + self.pos_embed.to(dt)
        if self.n_reg:
            x = torch.cat(
                [x, self.reg_tokens.to(dt).expand(b, self.n_reg, cfg.dim)],
                dim=1)
        for i in range(cfg.depth):
            x = getattr(self, f"block_{i}")(x)
        x = self.norm(x)
        x = x[:, :self.n_tokens]   # registers are working memory only
        x = x[:, 0] if cfg.pool == "cls" else x.mean(dim=1)
        return self.head(x)


def ViT_S16(device: Union[str, torch.device] = "cuda",
            generator: Optional[torch.Generator] = None, **overrides) -> ViT:
    return ViT(ViTConfig.small(**overrides), device=device,
               generator=generator)


def ViT_B16(device: Union[str, torch.device] = "cuda",
            generator: Optional[torch.Generator] = None, **overrides) -> ViT:
    return ViT(ViTConfig.base(**overrides), device=device,
               generator=generator)

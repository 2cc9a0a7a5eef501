"""Llama decoder: the full-sequence training forward and the decode
layout (K/V-cached, last-position logits).

Port of ``bluefog_tpu/models/llama.py``: :class:`LlamaConfig` (every
field kept, so configs map one to one), ``RMSNorm``,
``_llama3_scaled_freqs``/``rotary_embed``, ``_amax_quantize``,
``Attention`` (the full-sequence path and the ``_decode_attend`` cache
path), ``_cached_attention``, the int8 layers of ``param_quant``
(``QuantDense``, the quantized logits head and the w8a8 integer
attention ``_cached_attention_int8``), ``FeedForward``, ``Block``,
``Llama`` and the losses ``chunked_xent``/``llama_chunked_xent_loss_fn``.
Deviations from the JAX package:

* :meth:`Llama.forward` runs the decode layout when it is given a
  :class:`KVCache` (it writes the cache and returns the last position's
  logits, every position with ``all_logits=True``), else the training
  forward of JAX's ``__call__(tokens, pos_offset, return_hidden)``:
  full sequence, causal, autograd on, f32 logits ``[B, T, vocab]``.
  The training forward's attention is the flash kernels
  (``attn_impl="flash"``, ``parallel/flash_attention.py``), splash (K2
  forward, the fused one-pass backward K5, ``attn_impl="splash"``,
  ``parallel/splash.py``),
  :func:`~bluefog_tpu_torch.parallel.ring_attention.blockwise_attention`
  (``attn_mode="blockwise"``) or ``full_attention``.
* Sequence parallelism (``attn_mode="ring"`` or ``"ulysses"`` with
  ``sp_axis``): the JAX model runs per sequence shard under
  ``shard_map``; here the forward takes EVERY shard of the bound
  :class:`~bluefog_tpu_torch.parallel.collectives.SeqAxis` named
  ``cfg.sp_axis``, stacked shard-major: tokens ``[S, B, T_local]`` ->
  logits ``[S, B, T_local, vocab]``, ``pos_offset`` an int or a per-shard
  ``[S]`` tensor (JAX's ``axis_index * T_local``).  The per-token layers
  run on the shards folded into the batch (``[S * B, T_local]``), and
  attention goes through ``parallel/ring_attention.py``'s
  ``ring_attention`` or ``parallel/ulysses.py``.  A call with the axis
  unbound raises ``NameError``, as ``axis_index`` outside ``shard_map``.
* Mixture of experts (``n_experts > 0``) at ``ep_size = 1``: every
  expert lives on the device (:class:`MoEFeedForward`, with
  :func:`moe_combine_weights`'s top-k and expert-choice routers, grouped
  routing and per-group capacity).  Its Switch load-balancing aux loss,
  which JAX sows into ``"intermediates"``, is read explicitly:
  ``forward(..., return_aux=True)`` (``Llama.apply`` passes it through)
  returns ``(out, aux)``, ``aux`` the sum over layers of each layer's
  term (f32 scalar; ``[S]``, one per shard, under sequence parallelism,
  where each shard routes its own tokens as each JAX device does; 0 for
  a dense model).  :func:`llama_loss_fn` adds ``moe_aux_weight * aux``.
* The model axes (``tp_axis``/``tp_size`` with ``vocab_parallel`` and
  ``tp_seq_shard``; ``ep_axis``/``ep_size``): the JAX model runs per
  device under ``shard_map``; here every shard of the bound
  :class:`~bluefog_tpu_torch.parallel.collectives.MeshAxis` runs at
  once on one device.  A per-shard value is stacked shard-major
  ``[tp, ...]``; a value JAX replicates over the axis is held ONCE.  So
  a replicated input that every shard reads collects the sum of their
  cotangents, and the psum that merges the shards' partials hands each
  the one cotangent: Megatron's conjugate pair (JAX's ``_tp_region_in``
  / ``_tp_region_out``, and all-gather / reduce-scatter under
  ``tp_seq_shard``) is plain autograd over the axis's collectives, with
  no custom backward.  The param tree is the tp=1 tree (global shapes):
  a shard computes from its slice (``llama_param_specs``): column-
  parallel ``wq/wk/wv/w1/w3`` as one product whose columns are the
  shards' (shard-major views), row-parallel ``wo/w2`` per shard (a
  batched product) before the psum; each shard's heads folded into the
  attention's batch (K2/K3a/K3b and K4 at the per-shard shape).
  Outputs: logits ``[B, T, vocab]`` held once, or under
  ``vocab_parallel`` each shard's columns ``[tp, B, T, vocab / tp]``
  (train with :func:`vocab_parallel_xent`); under ``tp_seq_shard`` the
  residual stream (``return_hidden``) is ``[tp, B, T / tp, dim]``.
  Experts over an ep axis: shard ``s`` holds experts ``s * E / ep ..``
  and its partial combine meets the others' in one psum.
* Pipeline parallelism (:func:`llama_pp_loss_fn` over a pp axis,
  :func:`llama_circular_layout`, ``llama_param_specs(pp_axis=)``): the
  JAX package shards dim 0 of the SCANNED block stack over the pp axis;
  the port keeps its per-layer leaves ``layers.{i}.…`` (the tree
  ``interop/from_jax.py`` maps JAX's scanned rows to, so checkpoints and
  ``llama_params_from_flax`` carry over unchanged), and layer ``i`` in
  storage order belongs to stage ``i // (n_layers / S)``, the stage
  JAX's contiguous sharding gives its row.  Every stage of a rank runs
  on one device (``parallel/pipeline.py``): the loss stacks the stages'
  weights per layer slot, in the dtype each product computes in (one
  copy of the layer weights, bf16 when the model computes in bf16),
  and runs each slot as ONE pass over all stages: a kernel with a
  leading stage axis multiplies each stage's rows by its own slice
  (:class:`Dense`, :class:`RMSNorm`, the row-parallel products), and
  the stages fold into the attention's batch, stage-major (under ring
  or Ulysses attention the sequence shards fold inside each stage).  A
  MoE FFN routes each stage's tokens on their own, so routing groups
  and capacities stay inside one stage's microbatch.  Values JAX
  replicates over pp run once: the embedding (stage 0's input) and the
  final norm and head (on the last stage's outputs).
* The integer products of ``param_quant="w8a8"`` (s8 x s8 -> s32, which
  JAX leaves to XLA) go to ``torch._int_mm``: cuBLASLt on the card, an
  exact integer product on the CPU (:func:`int8_matmul`).  The w8a8
  attention's two contractions of int8 codes run as float products that
  hold every partial sum exactly (f32 under its gate, ``max_len <=
  1024``; see :func:`_exact_float`), which gives the int32 result bit for
  bit.
* ``remat=True`` checkpoints each block with ``torch.utils.checkpoint``:
  the whole block is recomputed for ``remat_policy`` "none" and
  "everything" (flax's ``policy=None`` and ``nothing_saveable`` save the
  same), and "dots" keeps the projections' outputs through a selective
  checkpoint policy (JAX's ``checkpoint_dots_with_no_batch_dims``).
  ``scan_layers=True`` changes only flax's parameter layout, which
  ``interop/from_jax.py`` reads; the port always loops over its layers.
* The cache is a :class:`KVCache` of stacked per-layer tensors written
  IN PLACE (JAX rebuilt it with ``dynamic_update_slice``), with ONE
  ``[B]`` index for all layers (JAX kept an equal ``cache_index`` per
  layer).  Its layout, not ``cfg.kv_quant``, decides whether a step
  quantizes: :func:`~bluefog_tpu_torch.models.generate.init_cache`
  builds it from the config.
* Each row of the batch has its own position (``cache.index [B]``), so
  one batched step serves slots at different positions (JAX vmapped
  one-slot steps).
* Every single-token step calls the decode-attention wrapper
  (``parallel/decode_attention.py``), JAX's ``decode_attn="pallas"``
  path; prefill (T > 1) runs :func:`_cached_attention`.
* Projections keep flax's ``[in, out]`` kernel layout and compute
  ``x @ kernel`` in ``cfg.dtype``.  ``Llama(param_dtype=torch.float32)``
  keeps f32 master parameters, cast to ``cfg.dtype`` on every call, as
  flax's ``param_dtype=float32`` does (the training layout).  By default
  the parameters are stored in the dtype flax casts them to
  (``cfg.dtype`` for the projections and the embedding, f32 for the
  norms and for the logits head under ``logits_dot_in_fp32``): the
  forward is the same, and the card holds half the bytes (the serving
  layout).  The embedding gathers its rows and then casts them (flax
  casts the table, then gathers: the same values).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import itertools
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.parallel.collectives import bound_axis
from bluefog_tpu_torch.parallel.decode_attention import (
    decode_attention, decode_attention_int8)
from bluefog_tpu_torch.parallel.flash_attention import flash_attention
from bluefog_tpu_torch.parallel.ring_attention import (blockwise_attention,
                                                       full_attention,
                                                       ring_attention)
from bluefog_tpu_torch.parallel.splash import splash_attention
from bluefog_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["LlamaConfig", "Llama", "KVCache", "RMSNorm", "QuantDense",
           "MoEFeedForward", "vocab_parallel_embed", "moe_combine_weights",
           "moe_group_shape", "int8_matmul", "rotary_embed",
           "chunked_xent", "llama_chunked_xent_loss_fn", "llama_loss_fn",
           "vocab_parallel_xent", "llama_param_specs", "llama_pp_loss_fn",
           "llama_circular_layout"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Same fields, defaults and validation as the JAX ``LlamaConfig``
    (see its comments for each knob); ``dtype`` is a torch dtype (or
    its name)."""
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: Optional[int] = None  # default 8/3 * dim rounded to 256
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attn_mode: str = "full"  # full | blockwise | ring | ulysses
    attn_impl: str = "xla"  # xla | flash | splash
    attn_block_size: int = 512
    rope_scaling_kind: str = "none"  # none | llama3
    rope_scaling_factor: float = 8.0
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_len: int = 8192
    attn_flash_block_size: int = 1024
    attn_flash_block_k: int = 1024
    sp_axis: Optional[str] = None
    tp_axis: Optional[str] = None
    tp_size: int = 1
    n_experts: int = 0
    moe_top_k: int = 2
    ep_axis: Optional[str] = None
    ep_size: int = 1
    capacity_factor: float = 1.25
    moe_group_size: int = 4096
    moe_router: str = "topk"
    allow_noncausal_router: bool = False
    moe_aux_weight: float = 0.0
    remat: bool = False
    scan_layers: bool = False
    remat_policy: str = "none"
    decode: bool = False
    logits_dot_in_fp32: bool = True
    kv_quant: str = "none"  # none | int8
    param_quant: str = "none"  # none | int8 | w8a8
    decode_attn: str = "xla"  # xla | pallas
    vocab_parallel: bool = False
    tp_seq_shard: bool = False

    def __post_init__(self):
        if isinstance(self.dtype, str):
            object.__setattr__(self, "dtype", _DTYPES[self.dtype])
        if self.decode and self.attn_mode != "full":
            raise ValueError(
                f"decode=True requires attn_mode='full' (got "
                f"{self.attn_mode!r}); incremental K/V caching and "
                "ring/blockwise attention do not compose")
        if self.decode and self.n_experts:
            if self.moe_router != "topk":
                raise ValueError(
                    "decode=True supports only moe_router='topk' "
                    "(expert_choice is non-causal)")
            if self.capacity_factor < self.n_experts:
                raise ValueError(
                    "decode=True with MoE requires DROPLESS routing: "
                    "capacity_factor >= n_experts")
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(
                f"kv_quant {self.kv_quant!r} not in ('none', 'int8')")
        if self.param_quant not in ("none", "int8", "w8a8"):
            raise ValueError(
                f"param_quant {self.param_quant!r} not in "
                "('none', 'int8', 'w8a8')")
        if self.kv_quant != "none" and not self.decode:
            raise ValueError(
                "kv_quant is a decode-time knob (it shapes the K/V cache "
                "layout); set it through llama_generate")
        if self.param_quant != "none" and not self.decode:
            raise ValueError(
                "param_quant is inference-only; set it through "
                "llama_generate")
        if self.attn_impl not in ("xla", "flash", "splash"):
            raise ValueError(
                f"attn_impl {self.attn_impl!r} not in "
                "('xla', 'flash', 'splash')")
        if self.attn_impl == "splash":
            if self.attn_mode != "full":
                raise ValueError(
                    "attn_impl='splash' serves the plain full-sequence "
                    "causal path only")
            if self.decode:
                raise ValueError(
                    "attn_impl='splash' is a train-time knob; decode "
                    "uses decode_attn ('xla' | 'pallas')")
        if self.decode_attn not in ("xla", "pallas"):
            raise ValueError(
                f"decode_attn {self.decode_attn!r} not in "
                "('xla', 'pallas')")
        if self.decode_attn == "pallas" and not self.decode:
            raise ValueError(
                "decode_attn='pallas' is a decode-time knob; set it "
                "through llama_generate")
        if self.vocab_parallel:
            if self.tp_size <= 1 or self.tp_axis is None:
                raise ValueError("vocab_parallel requires tensor "
                                 "parallelism (tp_axis + tp_size > 1)")
            if self.vocab_size % self.tp_size:
                raise ValueError(
                    f"vocab_size ({self.vocab_size}) must divide by "
                    f"tp_size ({self.tp_size}) for vocab_parallel")
            if self.decode:
                raise ValueError(
                    "vocab_parallel is a training-time memory layout; "
                    "drop it from the decode config")
        if self.tp_seq_shard:
            if self.tp_size <= 1 or self.tp_axis is None:
                raise ValueError("tp_seq_shard requires tensor "
                                 "parallelism (tp_axis + tp_size > 1)")
            if self.decode:
                raise ValueError(
                    "tp_seq_shard is a training-time activation layout; "
                    "drop it from the decode config")
            if self.n_experts:
                raise ValueError("tp_seq_shard + MoE is not supported")
            if self.attn_mode in ("ring", "ulysses"):
                raise ValueError(
                    "tp_seq_shard already shards the sequence over tp; "
                    "composing it with ring/ulysses attention is "
                    "redundant — pick one")
            if not self.vocab_parallel:
                raise ValueError("tp_seq_shard requires vocab_parallel=True")
        if self.rope_scaling_kind not in ("none", "llama3"):
            raise ValueError(
                f"rope_scaling_kind {self.rope_scaling_kind!r} not in "
                "('none', 'llama3')")
        valid = ("none", "dots", "everything")
        if self.remat_policy not in valid:
            raise ValueError(
                f"remat_policy {self.remat_policy!r} not in {valid}")
        if self.remat_policy != "none" and not self.remat:
            raise ValueError("remat_policy requires remat=True")
        if self.tp_size > 1:
            if self.tp_axis is None:
                raise ValueError("tp_size > 1 requires tp_axis")
            for name, val in (("n_heads", self.n_heads),
                              ("n_kv_heads", self.n_kv_heads),
                              ("ffn_dim", self.ffn_dim)):
                if val % self.tp_size:
                    raise ValueError(
                        f"{name} ({val}) must divide by tp_size "
                        f"({self.tp_size})")
        if self.ep_size > 1:
            if self.ep_axis is None:
                raise ValueError("ep_size > 1 requires ep_axis")
            if not self.n_experts:
                raise ValueError("ep_size > 1 requires n_experts > 0")
        if self.moe_router not in ("topk", "expert_choice"):
            raise ValueError(f"moe_router {self.moe_router!r} not in "
                             "('topk', 'expert_choice')")
        if self.moe_router == "expert_choice" \
                and not self.allow_noncausal_router:
            raise ValueError(
                "moe_router='expert_choice' is non-causal; pass "
                "allow_noncausal_router=True to acknowledge it, or use "
                "moe_router='topk'")
        if self.n_experts:
            if self.n_experts % self.ep_size:
                raise ValueError(
                    f"n_experts ({self.n_experts}) must divide by ep_size "
                    f"({self.ep_size})")
            if self.moe_top_k > self.n_experts:
                raise ValueError("moe_top_k exceeds n_experts")
            if self.tp_size > 1:
                raise ValueError(
                    "MoE + tensor parallelism in one config is not "
                    "supported yet (experts are not tp-sharded)")

    @property
    def rope_scaling(self):
        """The ``rotary_embed`` scaling tuple, or None when disabled."""
        if self.rope_scaling_kind == "none":
            return None
        return (self.rope_scaling_factor,
                self.rope_scaling_low_freq_factor,
                self.rope_scaling_high_freq_factor,
                self.rope_scaling_original_max_len)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_dim(self) -> int:
        if self.hidden_dim is not None:
            return self.hidden_dim
        h = int(8 * self.dim / 3)
        return ((h + 255) // 256) * 256

    @staticmethod
    def llama3_8b(**overrides) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, hidden_dim=14336, rope_theta=500000.0, **overrides)

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        """Test-scale config."""
        base = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, hidden_dim=128, max_seq_len=256)
        base.update(overrides)
        return LlamaConfig(**base)


def _model_axis(name: Optional[str], size: int, what: str):
    """The bound axis of a ``tp_axis``/``ep_axis`` over ``size > 1``
    shards, or None (``NameError`` when the name is unbound, as
    ``lax.axis_index`` outside ``shard_map``)."""
    if name is None or size <= 1:
        return None
    axis = bound_axis(name)
    if axis.size != size:
        raise ValueError(f"{what}={size} but the bound axis {axis!r} has "
                         f"{axis.size} shards")
    return axis


def _tp_axis(cfg: LlamaConfig):
    return _model_axis(cfg.tp_axis, cfg.tp_size, "tp_size")


def _ep_axis(cfg: LlamaConfig):
    return _model_axis(cfg.ep_axis, cfg.ep_size, "ep_size")


def _enter_tp_region(x: torch.Tensor, cfg: LlamaConfig, axis):
    """The residual stream as a tp region reads it: full rows.  Held
    once, a replicated stream needs no operator (every shard's product
    reads the one copy, and autograd sums their cotangents: Megatron's
    ``f``); under ``tp_seq_shard`` the shard-major rows ``[tp, B, T/tp,
    D]`` are all-gathered along the sequence (the backward
    reduce-scatters)."""
    if cfg.tp_seq_shard:
        return axis.all_gather(x, axis=1)
    return x


def _leave_tp_region(y: torch.Tensor, cfg: LlamaConfig, axis):
    """The shards' partial outputs ``y [tp, B, T, D]`` merged onto the
    stream's layout: one psum (Megatron's ``g``), or under
    ``tp_seq_shard`` a reduce-scatter to ``[tp, B, T/tp, D]``."""
    if cfg.tp_seq_shard:
        return axis.psum_scatter(y, scatter_dimension=1)
    return axis.psum(y)


def _shard_cols(y: torch.Tensor, n: int) -> torch.Tensor:
    """A column-parallel product's output ``[..., out]`` as its ``n``
    shards' columns, shard-major ``[n, ..., out / n]`` (a view): shard
    ``s`` owns columns ``s * out / n ..``, the slice
    ``llama_param_specs`` gives it, so one product over the whole kernel
    computes every shard's own product."""
    return y.unflatten(-1, (n, y.shape[-1] // n)).movedim(-2, 0)


def _shard_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """``[B, T, H, D]`` heads as ``n`` shards of ``H / n`` heads folded
    into the batch, shard-major: ``[n * B, T, H / n, D]`` (contiguous, the
    attention kernels' layout).  Shard ``s``'s query heads map to its own
    kv heads under GQA, as on a device of the JAX mesh."""
    b, t, h, d = x.shape
    return x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4).reshape(
        n * b, t, h // n, d)


def _row_parallel(layer: nn.Module, x: torch.Tensor, n: int
                  ) -> torch.Tensor:
    """A row-parallel projection of shard-major ``x [n, ..., in / n]``:
    each shard's partial ``x_s @ kernel_s`` over its rows ``s * in / n
    ..`` of the kernel (``[n, ..., out]``), what each device computes
    before the region's psum."""
    lead = x.shape[1:-1]
    x2 = x.reshape(n, -1, x.shape[-1])
    if isinstance(layer, QuantDense):
        y = layer.forward_shards(x2, n)
    elif layer.kernel.dim() == 3:
        # stage-stacked [S, in, out] over stage-major rows: shard t of
        # stage s multiplies its rows t * in / n .. of stage s's kernel
        w = layer.kernel.to(layer.dtype)
        s = w.shape[0]
        y = torch.einsum("tsri,stio->tsro",
                         x2.to(layer.dtype).reshape(n, s, -1, x.shape[-1]),
                         w.view(s, n, w.shape[1] // n, -1))
    else:
        w = layer.kernel.to(layer.dtype)
        y = torch.bmm(x2.to(layer.dtype), w.view(n, w.shape[0] // n, -1))
    return y.reshape(n, *lead, y.shape[-1])


def _sp_axis(cfg: LlamaConfig):
    """The bound sequence axis of a ring or Ulysses config (``NameError``
    when ``cfg.sp_axis`` is unbound)."""
    if cfg.sp_axis is None:
        raise ValueError(f"{cfg.attn_mode} attention needs sp_axis")
    return bound_axis(cfg.sp_axis)


def _amax_quantize(x: torch.Tensor, eps: float = 1e-8
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 quantization along the LAST axis:
    ``scale = max(amax(|x|), eps) / 127`` and ``q = round(x / scale)``
    (a division, and round half to even, so the codes match the JAX
    package's bit for bit).  Returns ``(q_int8, scale_f32)`` with the
    scale's last axis kept as 1."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True),
                            eps) / 127.0
    return torch.round(x32 / scale).to(torch.int8), scale


def _llama3_scaled_freqs(freqs: torch.Tensor, factor: float,
                         low_freq_factor: float, high_freq_factor: float,
                         original_max_len: int) -> torch.Tensor:
    """Llama-3.1's ``rope_type='llama3'`` frequency scaling: wavelengths
    shorter than the high-freq cutoff keep their frequency, longer than
    the low-freq cutoff divide by ``factor``, and the band between
    interpolates."""
    low_wavelen = original_max_len / low_freq_factor
    high_wavelen = original_max_len / high_freq_factor
    wavelen = 2.0 * math.pi / freqs
    smooth = (original_max_len / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    smooth = torch.clamp(smooth, 0.0, 1.0)
    interp = (1.0 - smooth) * freqs / factor + smooth * freqs
    return torch.where(
        wavelen < high_wavelen, freqs,
        torch.where(wavelen > low_wavelen, freqs / factor, interp))


def _rope_freqs(d: int, theta: float, scaling, device) -> torch.Tensor:
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=device) / d))
    if scaling is not None:
        freqs = _llama3_scaled_freqs(freqs, *scaling)
    return freqs


def _rope_tables(positions: torch.Tensor, freqs: torch.Tensor):
    """cos/sin ``[B, T, 1, D/2]`` (or ``[1, T, 1, D/2]`` for ``[T]``
    positions)."""
    if positions.dim() == 1:
        positions = positions[None]
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles)[:, :, None], torch.sin(angles)[:, :, None]


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    # interleaved pairs (x[..., ::2], x[..., 1::2]), as the JAX package
    # rotates them — not the half-split layout of HF checkpoints
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def rotary_embed(x: torch.Tensor, positions: torch.Tensor, theta: float,
                 scaling=None) -> torch.Tensor:
    """Apply rotary position embedding.  x: [B, T, H, D]; positions: [T]
    (as in JAX) or [B, T] (one row of positions per batch row).
    ``scaling``: optional ``(factor, low_freq_factor, high_freq_factor,
    original_max_len)`` tuple enabling llama3-style scaling."""
    freqs = _rope_freqs(x.shape[-1], theta, scaling, x.device)
    return _apply_rotary(x, *_rope_tables(positions, freqs))


def _cached_attention(q, k_all, v_all, idx):
    """Grouped-query attention over the whole K/V cache without
    repeating K/V heads, in f32 with a ``-1e30`` mask.

    q: [B, T, n_q, D] at global positions ``idx[b] + arange(T)``;
    k_all/v_all: KV-head-major [B, n_kv, S, D]; idx: scalar or [B].
    Returns [B, T, n_q, D] in q's dtype."""
    b, t, n_q, d = q.shape
    n_kv, s = k_all.shape[1], k_all.shape[2]
    rep = n_q // n_kv
    q5 = q.reshape(b, t, n_kv, rep, d).float()
    scores = torch.einsum("btkrd,bksd->bkrts", q5,
                          k_all.float()) * (1.0 / d ** 0.5)
    idx = torch.as_tensor(idx, device=q.device).reshape(-1, 1)
    q_pos = idx + torch.arange(t, device=q.device)            # [B|1, T]
    mask = (torch.arange(s, device=q.device)[None, None, :]
            <= q_pos[:, :, None])                              # [B|1, T, S]
    scores = torch.where(mask[:, None, None], scores, -1e30)
    # every query row sees at least its own key (just written)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrts,bksd->btkrd", p, v_all.float())
    return out.reshape(b, t, n_q, d).to(q.dtype)


def _exact_float(device: torch.device, n_terms: int) -> torch.dtype:
    """The float type whose products of int8 codes, summed over
    ``n_terms``, are exact: f32 while every partial sum stays below 2^24
    (``127² · n_terms < 2^24``) and the card's f32 products are not
    rounded to TF32; f64 (exact below 2^53) otherwise."""
    tf32 = device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32
    if 127 * 127 * n_terms < 2 ** 24 and not tf32:
        return torch.float32
    return torch.float64


def _cached_attention_int8(q, kq_all, ks_all, vq_all, vs_all, idx):
    """Grouped-query cached attention with both contractions over int8
    codes (the ``param_quant='w8a8'`` + ``kv_quant='int8'`` prefill path).

    The key scale is constant along head_dim, so it multiplies the score
    columns afterwards; the value scale folds into the probabilities
    before they are quantized per row (one amax scale), as ``QuantDense``
    does to activations.  Rounding beyond the cache's own int8 snap: the
    queries' and the probabilities' per-row int8 quantization.  Each
    contraction is an exact integer product computed in the float type of
    :func:`_exact_float` (f32 at head_dim 128 and at cache lengths up to
    1024).

    q: [B, T, n_q, D] at positions ``idx[b] + arange(T)``; kq_all/vq_all:
    int8 [B, n_kv, S, D]; ks_all/vs_all: f32 [B, n_kv, S]; idx: scalar or
    [B].  Returns [B, T, n_q, D] in q's dtype."""
    b, t, n_q, d = q.shape
    n_kv, s = kq_all.shape[1], kq_all.shape[2]
    # the value contraction's integer sum reaches 127 * 127 * S, past
    # INT32_MAX near S ~ 133k (the JAX package accumulates in int32)
    if s > 131072:
        raise ValueError(
            f"kv_quant='int8' + w8a8 decode supports cache length <= "
            f"131072 (int32 accumulator overflow at ~133k); got {s}")
    rep = n_q // n_kv
    qq, qs = _amax_quantize(q.reshape(b, t, n_kv, rep, d))
    acc = _exact_float(q.device, d)
    s32 = torch.einsum("btkrd,bksd->bkrts", qq.to(acc), kq_all.to(acc))
    # scales: q per row [B,T,KV,R,1] -> [B,KV,R,T,1]; k per position
    # [B,KV,S] broadcasts directly
    scores = (s32.float() * qs.permute(0, 2, 3, 1, 4)
              * ks_all[:, :, None, None, :] * (1.0 / d ** 0.5))
    idx = torch.as_tensor(idx, device=q.device).reshape(-1, 1)
    q_pos = idx + torch.arange(t, device=q.device)            # [B|1, T]
    mask = (torch.arange(s, device=q.device)[None, None, :]
            <= q_pos[:, :, None])                              # [B|1, T, S]
    scores = torch.where(mask[:, None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1)                          # [B,KV,R,T,S]
    pv = p * vs_all[:, :, None, None, :]
    # a probability row sums to 1, so its amax is >= 1/S: the tiny eps
    # only guards fully padded rows
    pq, ps = _amax_quantize(pv, eps=1e-30)
    acc = _exact_float(q.device, s)
    o32 = torch.einsum("bkrts,bksd->btkrd", pq.to(acc), vq_all.to(acc))
    out = o32.float() * ps.permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, n_q, d).to(q.dtype)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` over int8, accumulated exactly in int32
    (``torch._int_mm``: cuBLASLt's int8 GEMM on the card, an integer
    product on the CPU).  On the card cuBLASLt refuses M <= 16 (a decode
    step at capacity 8 has M = 8) and K or N that are not multiples of 8,
    so the operands get zero rows and columns there, which leave the
    product's kept entries exact.  It reads ``b`` fastest in column-major
    storage (``QuantDense``'s kernel)."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    m, k = a.shape
    n = b.shape[1]
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    return torch._int_mm(a, b)[:m, :n]


@dataclasses.dataclass
class KVCache:
    """The decode-layout K/V cache of every layer, for ``B`` rows.

    ``key``/``value``: ``[L, B, KV, S, D]`` in the compute dtype, or
    int8 with ``key_scale``/``value_scale`` ``[L, B, KV, S]`` f32 (one
    scale per cached vector).  ``index``: ``[B]`` int32, each row's next
    write position.  A forward writes its K/V in place at ``index`` and
    then advances it; positions above a row's index are masked.

    A tp-sharded cache (``shards = tp > 1``, from ``init_cache(...,
    keep_tp=True)``) holds each shard's own ``KV / tp`` heads, the shards
    folded into the batch shard-major: ``[L, tp * B, KV / tp, S, D]``
    (rows ``s * B ..`` are shard ``s``'s), with one ``[B]`` index."""
    key: torch.Tensor
    value: torch.Tensor
    index: torch.Tensor
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None
    shards: int = 1

    @property
    def quantized(self) -> bool:
        return self.key_scale is not None

    @property
    def max_len(self) -> int:
        return self.key.shape[3]

    def tensors(self):
        """Every tensor of the cache (K/V, scales when quantized, index)."""
        out = [self.key, self.value, self.index]
        if self.quantized:
            out += [self.key_scale, self.value_scale]
        return out

    def rows(self, start: int, stop: int) -> "KVCache":
        """Views of rows ``start:stop``: writes through them land in
        this cache."""
        if self.shards > 1:
            raise ValueError("a tp-sharded cache keeps each row's shards "
                             "apart; it has no contiguous row views")
        return KVCache(
            self.key[:, start:stop], self.value[:, start:stop],
            self.index[start:stop],
            None if self.key_scale is None
            else self.key_scale[:, start:stop],
            None if self.value_scale is None
            else self.value_scale[:, start:stop])


class Dense(nn.Module):
    """flax ``nn.Dense(use_bias=False)``: ``x @ kernel`` in ``dtype``,
    kernel ``[in, out]`` stored in ``param_dtype`` (default ``dtype``)
    and cast to ``dtype`` on every call."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype, device,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(n_in, n_out, dtype=param_dtype or dtype,
                        device=device), requires_grad=False)

    def forward(self, x):
        w = self.kernel.to(self.dtype)
        if w.dim() == 3:
            # a stage-stacked kernel [S, in, out] (the pipeline): x's
            # rows are stage-major, stage s's multiplied by its slice
            s = w.shape[0]
            y = torch.bmm(x.to(self.dtype).reshape(s, -1, x.shape[-1]), w)
            return y.reshape(*x.shape[:-1], w.shape[-1])
        return x.to(self.dtype) @ w


class QuantDense(nn.Module):
    """The JAX package's ``QuantDense``: an int8 kernel ``[in, out]`` and
    an f32 per-output-channel ``scale [out]`` (from
    :func:`~bluefog_tpu_torch.models.quant.quantize_llama_params`).  The
    scale is constant along the contraction, so ``x @ (W_q * s) == (x @
    W_q) * s`` exactly.

    * ``act_quant=False`` (``param_quant='int8'``, weight-only): the
      product runs in ``dtype`` (``x.to(dtype) @ W_q.to(dtype)``), then
      the scale is applied in f32 and the result cast (casting the scale
      to bf16 first would add its own rounding).
    * ``act_quant=True`` (``'w8a8'``): the activations quantize per row
      (one f32 amax scale each) and the product is s8 x s8 -> s32
      (:func:`int8_matmul`), scaled by both scales in f32.

    ``out_f32`` returns f32 (the logits head).  The kernel has flax's
    ``[in, out]`` shape in column-major storage (``[out, in]``
    contiguous), the operand layout cuBLASLt's int8 GEMM reads fast."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype, device,
                 out_f32: bool = False, act_quant: bool = False):
        super().__init__()
        self.dtype = dtype
        self.out_f32 = out_f32
        self.act_quant = act_quant
        self.kernel = nn.Parameter(
            torch.zeros(n_out, n_in, dtype=torch.int8, device=device).t(),
            requires_grad=False)
        self.scale = nn.Parameter(
            torch.ones(n_out, dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x):
        if self.act_quant:
            xq, xs = _amax_quantize(x)
            y = int8_matmul(xq.reshape(-1, xq.shape[-1]), self.kernel)
            out = y.reshape(*x.shape[:-1], -1).float() * xs * self.scale
            return out if self.out_f32 else out.to(self.dtype)
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.out_f32:
            return y.float() * self.scale
        return (y.float() * self.scale).to(self.dtype)

    def forward_shards(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The row-parallel form: ``x [n, M, in / n]``, shard ``s``
        multiplying its kernel rows ``s * in / n ..`` and applying the
        whole (replicated) scale, as a device of the JAX mesh does before
        the psum; under ``act_quant`` each shard quantizes its own slice
        of a row.  Returns ``[n, M, out]``."""
        k = self.kernel.shape[0] // n
        if self.act_quant:
            xq, xs = _amax_quantize(x)
            y = torch.stack([int8_matmul(xq[s], self.kernel[s * k:
                                                           (s + 1) * k])
                             for s in range(n)])
            out = y.float() * xs * self.scale
            return out if self.out_f32 else out.to(self.dtype)
        w = self.kernel.to(self.dtype)
        y = torch.bmm(x.to(self.dtype), w.view(n, k, -1))
        if self.out_f32:
            return y.float() * self.scale
        return (y.float() * self.scale).to(self.dtype)


def _dense(cfg: LlamaConfig, n_in: int, n_out: int, device,
           param_dtype=None) -> nn.Module:
    """The projection the config asks for: ``Dense`` in the trained
    precision, or the int8 ``QuantDense`` under ``param_quant``."""
    if cfg.param_quant != "none":
        return QuantDense(n_in, n_out, cfg.dtype, device,
                          act_quant=cfg.param_quant == "w8a8")
    return Dense(n_in, n_out, cfg.dtype, device, param_dtype)


class RMSNorm(nn.Module):
    """RMSNorm computed in f32 with an f32 scale, cast back to x's
    dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt(
            torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        if self.scale.dim() == 2:
            # stage-stacked scales [S, dim] over stage-major rows
            s = self.scale.shape[0]
            return (normed.reshape(s, -1, x.shape[-1])
                    * self.scale[:, None]).reshape(x.shape).to(x.dtype)
        return (normed * self.scale).to(x.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: rows of the table (stored in ``param_dtype``,
    default ``dtype``) in ``dtype``."""

    def __init__(self, vocab: int, dim: int, dtype, device,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.empty(vocab, dim, dtype=param_dtype or dtype,
                        device=device), requires_grad=False)

    def forward(self, tokens):
        return F.embedding(tokens.long(), self.embedding).to(self.dtype)


def vocab_parallel_embed(embed: Embed, tokens: torch.Tensor,
                         cfg: LlamaConfig) -> torch.Tensor:
    """JAX's ``VocabParallelEmbed`` over the token embedding ``embed``
    (``cfg.vocab_parallel``): the ``[vocab, dim]`` table's VOCAB rows
    shard over the bound ``tp_axis``, shard ``s`` holding rows ``s *
    vocab / tp ..`` (the parameter keeps its full shape and its name, so
    checkpoints move between layouts); an id outside a shard's rows looks
    up a clamped row masked to zero, and the shards' partial rows merge
    through one psum (a reduce-scatter to the seq-sharded stream under
    ``tp_seq_shard``).  Each shard's table gradient is its own rows'."""
    return _vocab_parallel_rows(embed.embedding, embed.dtype, tokens, cfg)


def _vocab_parallel_rows(table: torch.Tensor, dtype: torch.dtype,
                         tokens: torch.Tensor, cfg: LlamaConfig
                         ) -> torch.Tensor:
    """:func:`vocab_parallel_embed` over the table ``[vocab, dim]``
    itself (rows in ``dtype``)."""
    axis = _tp_axis(cfg)
    n = axis.size
    v_local = cfg.vocab_size // n
    lo = axis.index(tokens.device) * v_local                  # [n]
    lo = lo.reshape(n, *(1,) * tokens.dim())
    local = tokens.long()[None] - lo                          # [n, ...]
    valid = (local >= 0) & (local < v_local)
    # each shard's clamped row of its own slice, as a global row
    rows = local.clamp(0, v_local - 1) + lo
    x = F.embedding(rows, table).to(dtype)
    x = torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    return _leave_tp_region(x, cfg, axis)


def _pmax_nograd(x: torch.Tensor, axis) -> torch.Tensor:
    """``lax.pmax`` with a zero gradient: the log-sum-exp shift, whose
    gradient cancels in ``logz - tlogit``."""
    return axis.pmax(x.detach())


def vocab_parallel_xent(local_logits: torch.Tensor, targets: torch.Tensor,
                        axis_name) -> torch.Tensor:
    """Exact next-token cross-entropy over VOCAB-SHARDED logits.

    ``local_logits``: ``[tp, ..., vocab / tp]``, each shard's columns
    stacked shard-major (what a ``vocab_parallel`` :class:`Llama`
    returns); ``targets``: ``[...]`` global token ids; ``axis_name``: the
    tp axis (a bound name or the :class:`MeshAxis`).  One ``pmax`` (no
    gradient: the log-sum-exp shift) and two psums; each shard's logit
    gradient is ``softmax - onehot`` on its own columns.  Returns the
    mean loss, replicated (a scalar held once: JAX's identical per-shard
    scalar)."""
    axis = bound_axis(axis_name)
    n = axis.size
    v_local = local_logits.shape[-1]
    logits32 = local_logits.float()
    m = _pmax_nograd(logits32.amax(dim=-1), axis)                 # [...]
    se = axis.psum(torch.exp(logits32 - m[None, ..., None]).sum(-1))
    logz = m + torch.log(se)
    lo = (axis.index(logits32.device) * v_local).reshape(
        n, *(1,) * targets.dim())
    local = targets.long()[None] - lo                             # [n, ...]
    valid = (local >= 0) & (local < v_local)
    tlogit = torch.gather(logits32, -1, local.clamp(0, v_local - 1)[
        ..., None])[..., 0]
    tlogit = axis.psum(torch.where(valid, tlogit, torch.zeros(
        (), dtype=tlogit.dtype, device=tlogit.device)))
    return (logz - tlogit).mean()


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        dense = lambda n_in, n_out: _dense(  # noqa: E731
            cfg, n_in, n_out, device, param_dtype)
        self.wq = dense(cfg.dim, cfg.n_heads * hd)
        self.wk = dense(cfg.dim, cfg.n_kv_heads * hd)
        self.wv = dense(cfg.dim, cfg.n_kv_heads * hd)
        self.wo = dense(cfg.n_heads * hd, cfg.dim)

    def forward(self, x, rope, cache: Optional[KVCache] = None,
                layer: int = 0, idx=None, rows=None, write_pos=None):
        """The full-sequence causal path (``Attention.__call__`` without
        ``decode``), or with ``cache`` the decode path.  Under tensor
        parallelism every shard of the bound ``tp_axis`` runs at once:
        its ``n_heads / tp`` query and ``n_kv_heads / tp`` kv heads folded
        into the attention's batch, shard-major, and its row-parallel
        ``wo`` partial merged by the region's psum."""
        cfg = self.cfg
        tp = _tp_axis(cfg)
        if tp is not None:
            x = _enter_tp_region(x, cfg, tp)
        b, t, _ = x.shape
        hd = cfg.head_dim
        q = self.wq(x).reshape(b, t, cfg.n_heads, hd)
        k = self.wk(x).reshape(b, t, cfg.n_kv_heads, hd)
        v = self.wv(x).reshape(b, t, cfg.n_kv_heads, hd)
        q = _apply_rotary(q, *rope)
        k = _apply_rotary(k, *rope)
        n = 1
        if tp is not None:
            n = tp.size
            q, k, v = (_shard_heads(z, n) for z in (q, k, v))
        bb, h = n * b, cfg.n_heads // n
        if cache is not None:
            out = self._decode_attend(q, k, v, cache, layer, idx, rows,
                                      write_pos)
        elif cfg.attn_mode in ("ring", "ulysses"):
            # the sequence shards ride folded in the batch: [(tp,)
            # (stages,) S, B, ...] -> [S, tp * stages * B, ...] for the
            # sequence-parallel attention, and back
            axis = _sp_axis(cfg)
            s_n = axis.n_local
            o = n * (self.wq.kernel.shape[0] if self.wq.kernel.dim() == 3
                     else 1)
            split = lambda z: z.reshape(  # noqa: E731
                o, s_n, bb // (o * s_n), *z.shape[1:]).transpose(
                    0, 1).reshape(s_n, bb // s_n, *z.shape[1:])
            attend = (ring_attention if cfg.attn_mode == "ring"
                      else ulysses_attention)
            out = attend(split(q), split(k), split(v), axis, causal=True,
                         impl=cfg.attn_impl)
            out = out.reshape(s_n, o, bb // (o * s_n),
                              *out.shape[2:]).transpose(0, 1)
        elif cfg.attn_impl == "flash":
            out = flash_attention(
                q, k, v, causal=True,
                block_q=min(cfg.attn_flash_block_size, t),
                block_k=min(cfg.attn_flash_block_k, t))
        elif cfg.attn_impl == "splash":
            out = splash_attention(
                q, k, v, causal=True,
                block_q=min(cfg.attn_flash_block_size, t),
                block_kv=min(cfg.attn_flash_block_k, t))
        elif cfg.attn_mode == "blockwise":
            out = blockwise_attention(q, k, v, cfg.attn_block_size,
                                      causal=True)
        else:
            out = full_attention(q, k, v, causal=True)
        t_out = out.shape[-3]
        if tp is None:
            return self.wo(out.reshape(b, t_out, cfg.n_heads * hd))
        out = out.reshape(n, b, t_out, h * hd)
        return _leave_tp_region(_row_parallel(self.wo, out, n), cfg, tp)

    def _decode_attend(self, q, k, v, cache, layer, idx, rows, write_pos):
        """Write this call's K/V at the rows' cache positions (rotary
        already at the true absolute positions), then attend over the
        cache."""
        t = q.shape[1]
        # caches live KV-head-major [B, KV, S, D]; indexing [rows, :, pos]
        # addresses them as [B, T, KV, D], the projections' own layout
        k_all, v_all = cache.key[layer], cache.value[layer]
        if cache.quantized:
            kq, ks = _amax_quantize(k)
            vq, vs = _amax_quantize(v)
            ks_all = cache.key_scale[layer]
            vs_all = cache.value_scale[layer]
            k_all[rows, :, write_pos] = kq
            v_all[rows, :, write_pos] = vq
            ks_all[rows, :, write_pos] = ks[..., 0]
            vs_all[rows, :, write_pos] = vs[..., 0]
            if t == 1:
                return decode_attention_int8(q, k_all, ks_all, v_all, vs_all,
                                             idx)
            if self.cfg.param_quant == "w8a8" and cache.max_len <= 1024:
                # both contractions over the int8 codes; longer caches
                # take the dequantized path below (the JAX package's
                # static gate: the probabilities' re-quantization is
                # work linear in S x heads)
                return _cached_attention_int8(q, k_all, ks_all, v_all,
                                              vs_all, idx)
            return _cached_attention(q, k_all.float() * ks_all[..., None],
                                     v_all.float() * vs_all[..., None], idx)
        k_all[rows, :, write_pos] = k.to(k_all.dtype)
        v_all[rows, :, write_pos] = v.to(v_all.dtype)
        if t == 1:
            return decode_attention(q, k_all, v_all, idx)
        return _cached_attention(q, k_all, v_all, idx)


class FeedForward(nn.Module):
    """SwiGLU: ``w2(silu(w1 x) * w3 x)``; under tensor parallelism
    column-parallel ``w1``/``w3`` and a row-parallel ``w2`` over the
    bound ``tp_axis`` (``ffn_dim / tp`` hidden units a shard), one psum."""

    def __init__(self, cfg: LlamaConfig, device, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.w1 = _dense(cfg, cfg.dim, cfg.ffn_dim, device, param_dtype)
        self.w3 = _dense(cfg, cfg.dim, cfg.ffn_dim, device, param_dtype)
        self.w2 = _dense(cfg, cfg.ffn_dim, cfg.dim, device, param_dtype)

    def forward(self, x):
        cfg = self.cfg
        tp = _tp_axis(cfg)
        if tp is None:
            return self.w2(F.silu(self.w1(x)) * self.w3(x))
        x = _enter_tp_region(x, cfg, tp)
        h = _shard_cols(F.silu(self.w1(x)) * self.w3(x), tp.size)
        return _leave_tp_region(_row_parallel(self.w2, h, tp.size), cfg, tp)


def moe_combine_weights(probs: torch.Tensor, top_k: int, cap: int,
                        router: str = "topk") -> torch.Tensor:
    """Routing combine weights ``[g, G, E, cap]`` (f32) from per-group
    expert probabilities ``probs [g, G, E]``.

    ``router="topk"``: token choice: each token takes its ``top_k``
    experts in ``top_k`` rounds of argmax with masking (the first maximum
    on ties, as ``jnp.argmax``), each bounded by the per-expert per-group
    capacity ``cap`` in token order; overflow tokens drop to the
    residual.  The gate is read from the MASKED probs: a later round that
    re-picks an expert whose probability underflowed to zero adds 0.

    ``router="expert_choice"``: each expert takes its top-``cap`` tokens
    per group (``cap`` clamped to ``G``; a stable descending sort, so
    ties go to the lower token index as in ``lax.top_k``): dropless and
    balanced by construction, but not causal.

    Each ``[g, s, e, c]`` entry receives at most one gate, so the weights
    are scattered into place: the values, and their gradients with
    respect to ``probs``, are those of the JAX package's one-hot
    products."""
    g, G, E = probs.shape
    if router == "expert_choice":
        cap = min(cap, G)
        scores = probs.transpose(1, 2)                          # [g, E, G]
        order = torch.sort(scores, dim=-1, descending=True,
                           stable=True).indices[..., :cap]      # [g, E, cap]
        gate_vals = torch.gather(scores, 2, order)
        out = torch.zeros(g, E, cap, G, dtype=torch.float32,
                          device=probs.device)
        out = out.scatter(3, order[..., None], gate_vals[..., None].float())
        return out.permute(0, 3, 1, 2)
    masked = probs
    combine = torch.zeros(g, G, E * cap, dtype=torch.float32,
                          device=probs.device)
    counts = torch.zeros(g, E, dtype=torch.int64, device=probs.device)
    experts = torch.arange(E, device=probs.device)
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)                      # [g, G]
        gate = torch.gather(masked, 2, idx[..., None])[..., 0]  # [g, G]
        onehot = (idx[..., None] == experts).to(torch.int64)    # [g, G, E]
        # position of each token within its expert's per-group queue,
        # offset by what previous rounds already enqueued
        pos = torch.cumsum(onehot, dim=1) - onehot + counts[:, None, :]
        pos_tok = torch.sum(pos * onehot, dim=-1)               # [g, G]
        keep = pos_tok < cap
        slot = idx * cap + pos_tok.clamp(max=cap - 1)
        combine = combine.scatter_add(
            2, slot[..., None], (gate.float() * keep)[..., None])
        counts = counts + torch.sum(onehot * keep[..., None], dim=1)
        masked = masked * (1 - onehot).to(masked.dtype)
    return combine.reshape(g, G, E, cap)


def _dropless_factor(cfg: LlamaConfig) -> float:
    """The capacity factor of dropless routing (the decode layout): at
    least ``n_experts``, so every token fits its experts' queues."""
    return max(cfg.capacity_factor, float(cfg.n_experts))


def moe_group_shape(cfg: LlamaConfig, tokens: int, dropless: bool = False
                    ) -> Tuple[int, int, int]:
    """``(g, G, cap)`` of routing ``tokens`` tokens: ``G``, the largest
    divisor of ``tokens`` not above ``moe_group_size`` (all of them when
    it is 0 or above), ``g = tokens // G`` groups, and the per-expert,
    per-group capacity ``max(1, int(capacity_factor * G * top_k / E))``.
    ``dropless`` (the decode layout) raises the capacity factor to
    ``n_experts``, whatever config the module was built from."""
    G = tokens
    if 0 < cfg.moe_group_size < tokens:
        G = cfg.moe_group_size
        while tokens % G:
            G -= 1
    factor = _dropless_factor(cfg) if dropless else cfg.capacity_factor
    return (tokens // G, G,
            max(1, int(factor * G * cfg.moe_top_k / cfg.n_experts)))


class MoEFeedForward(nn.Module):
    """Top-k routed mixture-of-experts SwiGLU FFN (JAX
    ``MoEFeedForward``).  Over an expert axis (``ep_size > 1``, the bound
    ``ep_axis``) shard ``s`` evaluates its ``E / ep`` experts ``s * E / ep
    ..`` on the replicated tokens and the shards' partial outputs merge
    through one psum.

    Routing is GROUPED (``cfg.moe_group_size``): tokens route within
    groups of ``G`` tokens, the largest divisor of the token count ``s``
    not above ``moe_group_size`` (a warning when it collapses below half
    of it), with per-group capacity ``max(1, int(capacity_factor * G *
    top_k / E))``.  The router is an f32 ``Dense`` (``router.kernel [dim,
    E]``) on the f32 tokens; dispatch and combine are products against
    the ``[g, G, E, cap]`` one-hot tensors, as JAX computes them, and the
    experts ``w1``/``w3 [E, dim, ffn_dim]``, ``w2 [E, ffn_dim, dim]`` (f32
    under ``param_dtype=torch.float32``) run as batched products in
    ``cfg.dtype``.  ``dropless=True`` (the decode layout) raises the
    capacity factor to ``n_experts``.  Under sequence parallelism the
    input holds the bound axis's shards folded into the batch, and each
    shard routes its own tokens.  Returns ``(out, aux)``: the output in
    x's dtype and the Switch aux loss (f32 scalar, or ``[S]`` one per
    shard)."""

    def __init__(self, cfg: LlamaConfig, device, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        E, d, h = cfg.n_experts, cfg.dim, cfg.ffn_dim
        dtype = param_dtype or cfg.dtype
        self.router = Dense(d, E, torch.float32, device, torch.float32)
        self.w1 = nn.Parameter(torch.empty(E, d, h, dtype=dtype,
                                           device=device),
                               requires_grad=False)
        self.w3 = nn.Parameter(torch.empty(E, d, h, dtype=dtype,
                                           device=device),
                               requires_grad=False)
        self.w2 = nn.Parameter(torch.empty(E, h, d, dtype=dtype,
                                           device=device),
                               requires_grad=False)

    def forward(self, x, dropless: bool = False):
        if self.w1.dim() == 4:
            # stage-stacked experts [S, E, ...] (the pipeline): each stage
            # routes its own stage-major rows, so routing groups and
            # capacities stay inside one stage's microbatch
            n = self.w1.shape[0]
            outs, auxes = zip(*(
                self._route(xs, self.router.kernel[i], self.w1[i],
                            self.w3[i], self.w2[i], dropless)
                for i, xs in enumerate(x.reshape(n, -1, *x.shape[1:]))))
            return torch.cat(outs), torch.stack(auxes)
        return self._route(x, self.router.kernel, self.w1, self.w3, self.w2,
                           dropless)

    def _route(self, x, router, w1, w3, w2, dropless):
        cfg = self.cfg
        b, t, d = x.shape
        E = cfg.n_experts
        shards = 1
        if cfg.attn_mode in ("ring", "ulysses") and cfg.sp_axis is not None:
            shards = _sp_axis(cfg).n_local
        s = b * t // shards                      # tokens a shard routes
        g, G, cap = moe_group_shape(cfg, s, dropless)
        g *= shards
        logits = x.reshape(-1, d).float() @ router.float()      # [., E]
        probs = torch.softmax(logits, dim=-1)
        combine = moe_combine_weights(probs.reshape(g, G, E),
                                      cfg.moe_top_k, cap, cfg.moe_router)
        cap = combine.shape[-1]   # expert_choice clamps cap to G
        if 0 < cfg.moe_group_size < s and G < cfg.moe_group_size // 2:
            from bluefog_tpu_torch.logging_util import get_logger
            get_logger().warning(
                "MoE grouped routing: token count %d has no divisor "
                "near moe_group_size=%d; effective group collapsed to "
                "%d (capacity %d tokens/expert/group). Pad the "
                "batch*seq token count to a multiple of the group size "
                "to restore routing quality.", s, cfg.moe_group_size,
                G, cap)
        dt = cfg.dtype
        dispatch = (combine > 0.0).to(dt)                 # [g, G, E, cap]
        flat = x.reshape(g, G, d).to(dt)
        expert_in = torch.einsum("gsec,gsd->egcd", dispatch, flat)
        expert_in = expert_in.reshape(E, g * cap, d)
        gate_h = torch.bmm(expert_in, w1.to(dt))
        up_h = torch.bmm(expert_in, w3.to(dt))
        expert_out = torch.bmm(F.silu(gate_h) * up_h, w2.to(dt))
        expert_out = expert_out.reshape(E, g, cap, d)
        ep = _ep_axis(cfg)
        if ep is None:
            out = torch.einsum("egcd,gsec->gsd", expert_out,
                               combine.to(dt))
        else:
            # shard s holds experts s * E / ep ..: its partial combine
            # over them, merged by the axis's psum (the tokens and the
            # router logits are replicated, held once)
            n = ep.size
            out = ep.psum(torch.einsum(
                "negcd,gsnec->ngsd", expert_out.unflatten(0, (n, E // n)),
                combine.to(dt).unflatten(2, (n, E // n))))
        # the Switch load-balancing loss (eq. 4) of each shard's tokens
        probs = probs.reshape(shards, s, E)
        top1 = (torch.argmax(probs, dim=-1)[..., None]
                == torch.arange(E, device=x.device)).float()
        aux = E * torch.sum(top1.mean(dim=1) * probs.mean(dim=1), dim=-1)
        return (out.reshape(b, t, d).to(x.dtype),
                aux if shards > 1 else aux[0])


class Block(nn.Module):
    """Attention and the FFN (``moe_ffn`` when ``cfg.n_experts``, else
    ``feed_forward``) with pre-norm residuals.  Returns ``(x, aux)``,
    ``aux`` the MoE FFN's aux loss (None for a dense block)."""

    def __init__(self, cfg: LlamaConfig, device, param_dtype=None):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.attention = Attention(cfg, device, param_dtype)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        if cfg.n_experts:
            self.moe_ffn = MoEFeedForward(cfg, device, param_dtype)
        else:
            self.feed_forward = FeedForward(cfg, device, param_dtype)

    def forward(self, x, rope, *cache_args):
        x = x + self.attention(self.attention_norm(x), rope, *cache_args)
        if hasattr(self, "moe_ffn"):
            out, aux = self.moe_ffn(self.ffn_norm(x),
                                    dropless=bool(cache_args))
            return x + out, aux
        return x + self.feed_forward(self.ffn_norm(x)), None


class Llama(nn.Module):
    """The Llama decoder's parameters and its two forwards (see the
    module docstring).

    ``cfg`` may be a training or a decode config (the parameters are the
    same).  ``param_dtype=torch.float32`` stores every parameter in f32
    (the training layout, flax's ``param_dtype``); the default (None)
    stores them in the dtype each call casts them to (the serving
    layout).  Parameters are drawn at the scale of flax's default
    initializers (normal with std ``1/sqrt(fan_in)`` for every
    projection, ``1/sqrt(vocab)`` for the embedding, ones for the norms;
    a ``param_quant`` config's int8 kernels stay zero and their scales
    one, as flax initializes ``QuantDense``)
    from ``generator`` (default: seed 0 on ``device``); load trained
    ones with ``load_state_dict`` (see
    :func:`bluefog_tpu_torch.interop.llama_params_from_flax`)."""

    def __init__(self, cfg: LlamaConfig, device: Union[str, torch.device]
                 = "cuda", generator: Optional[torch.Generator] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.tok_embeddings = Embed(cfg.vocab_size, cfg.dim, cfg.dtype, dev,
                                    param_dtype)
        self.layers = nn.ModuleList(Block(cfg, dev, param_dtype)
                                    for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, dev)
        if cfg.param_quant != "none":
            # the int8 head: the scale lands in f32, so the logits keep
            # f32 range around int8-rounded products
            self.output = QuantDense(cfg.dim, cfg.vocab_size, cfg.dtype, dev,
                                     out_f32=True,
                                     act_quant=cfg.param_quant == "w8a8")
        else:
            head_dtype = (torch.float32 if cfg.logits_dot_in_fp32
                          else cfg.dtype)
            self.output = Dense(cfg.dim, cfg.vocab_size, head_dtype, dev,
                                param_dtype)
        self.register_buffer(
            "rope_freqs", _rope_freqs(cfg.head_dim, cfg.rope_theta,
                                      cfg.rope_scaling, dev),
            persistent=False)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        self.init_weights_(generator)

    @property
    def device(self) -> torch.device:
        return self.rope_freqs.device

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """Redraw every parameter from ``generator`` (see the class
        docstring for the scales)."""
        for mod in self.modules():
            if isinstance(mod, Dense):
                mod.kernel.normal_(0.0, mod.kernel.shape[0] ** -0.5,
                                   generator=generator)
            elif isinstance(mod, Embed):
                mod.embedding.normal_(0.0, mod.embedding.shape[0] ** -0.5,
                                      generator=generator)
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)
            elif isinstance(mod, MoEFeedForward):
                for w in (mod.w1, mod.w3, mod.w2):
                    w.normal_(0.0, w.shape[-2] ** -0.5,
                              generator=generator)

    def retarget(self, cfg: LlamaConfig) -> "Llama":
        """A twin of this module that shares its parameters and buffers
        and runs ``cfg``: a config of the same parameter layout, another
        tp layout of the same model, say (the param tree does not depend
        on ``tp_size``)."""
        memo = {id(t): t for t in itertools.chain(self.parameters(),
                                                  self.buffers())}
        twin = copy.deepcopy(self, memo)
        for mod in twin.modules():
            if hasattr(mod, "cfg"):
                mod.cfg = cfg
        return twin

    def state(self, release: bool = False) -> Dict[str, torch.Tensor]:
        """The parameters as ``{state-dict name: tensor}``: detached
        copies, or with ``release=True`` the tensors themselves, the
        module keeping only their shapes (on the ``meta`` device) so the
        caller's state is the one copy on the card.  A released module
        still runs :meth:`apply`, which is given every parameter."""
        params = {k: v.detach() if release else v.detach().clone()
                  for k, v in self.named_parameters()}
        if release:
            for mod in self.modules():
                for name, p in mod._parameters.items():
                    mod._parameters[name] = nn.Parameter(
                        torch.empty_like(p, device="meta"),
                        requires_grad=False)
        return params

    def apply(self, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
              **kwargs) -> torch.Tensor:
        """The forward over the given parameters (``torch.func.
        functional_call``, by state-dict name): the functional form the
        losses and ``build_train_step`` use."""
        return torch.func.functional_call(self, params, (tokens,), kwargs)

    def forward(self, tokens: torch.Tensor, cache: Optional[KVCache] = None,
                all_logits: bool = False, *, pos_offset: int = 0,
                return_hidden: bool = False, return_aux: bool = False):
        """With ``cache``: the decode layout (see :meth:`_decode`).
        Without: the training forward, tokens ``[B, T]`` at positions
        ``pos_offset + arange(T)`` -> f32 logits ``[B, T, vocab]``, or the
        final-norm hidden states ``[B, T, dim]`` with ``return_hidden``
        (the entry of :func:`chunked_xent`).  Under ``attn_mode="ring"``
        or ``"ulysses"`` tokens are the ``[S, B, T_local]`` shards of the
        bound axis ``cfg.sp_axis``, the outputs ``[S, B, T_local, ...]``,
        and ``pos_offset`` an int or one offset per shard (``[S]``).
        ``return_aux``: ``(out, aux)``, ``aux`` the MoE layers' summed
        aux loss (see the module docstring)."""
        if cache is not None:
            return self._decode(tokens, cache, all_logits)
        cfg = self.cfg
        if cfg.decode:
            raise ValueError("a decode config runs with a KVCache: pass "
                             "cache=")
        t = tokens.shape[-1]
        if t > cfg.max_seq_len:
            raise ValueError(f"sequence {t} exceeds max_seq_len "
                             f"{cfg.max_seq_len}")
        tp = _tp_axis(cfg)
        if cfg.tp_seq_shard and t % cfg.tp_size:
            raise ValueError(f"sequence length {t} must divide by tp_size "
                             f"({cfg.tp_size}) under tp_seq_shard")
        positions = torch.arange(t, device=tokens.device)
        shards = None
        if cfg.attn_mode in ("ring", "ulysses"):
            axis = _sp_axis(cfg)
            if tokens.dim() != 3 or tokens.shape[0] != axis.n_local:
                raise ValueError(
                    f"attn_mode={cfg.attn_mode!r} takes the {axis.n_local} "
                    f"shards of {axis!r} stacked: tokens [S, B, T_local], "
                    f"got {tuple(tokens.shape)}")
            shards = tokens.shape[:2]
            if not isinstance(pos_offset, int):   # one offset per shard
                pos_offset = torch.as_tensor(
                    pos_offset, device=tokens.device).reshape(-1, 1, 1)
            # each shard's rows at its own global positions
            positions = (pos_offset + positions).expand(*shards, t)
            positions = positions.reshape(-1, t)
            tokens = tokens.reshape(-1, t)
        else:
            positions = pos_offset + positions
        rope = _rope_tables(positions, self.rope_freqs)
        x = (vocab_parallel_embed(self.tok_embeddings, tokens, cfg)
             if cfg.vocab_parallel else self.tok_embeddings(tokens))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.layers:
            x, layer_aux = (_remat(block, x, rope, cfg.remat_policy)
                            if cfg.remat else block(x, rope))
            if layer_aux is not None:
                aux = aux + layer_aux
        x = self.norm(x)
        if not return_hidden and cfg.vocab_parallel:
            # column-parallel over the vocab: each shard's own logits
            # columns, not merged (the rows re-gathered once under
            # tp_seq_shard: every row's softmax needs every shard)
            x = _shard_cols(self.output(_enter_tp_region(x, cfg, tp)),
                            tp.size).float()
        elif not return_hidden:
            x = self.output(x).float()
        x = x if shards is None else x.unflatten(-3, shards)
        return (x, aux) if return_aux else x

    @torch.no_grad()
    def _decode(self, tokens: torch.Tensor, cache: KVCache,
                all_logits: bool) -> torch.Tensor:
        """tokens: [B, T] ids -> logits [B, 1, vocab] f32 (every position,
        [B, T, vocab], with ``all_logits``).  Writes the tokens' K/V into
        ``cache`` at each row's index and advances it by T."""
        b, t = tokens.shape
        s = cache.max_len
        if t > s:
            raise ValueError(f"{t} tokens exceed the cache length {s}")
        dev = tokens.device
        idx = cache.index
        steps = torch.arange(t, device=dev)
        positions = idx.long()[:, None] + steps                  # [B, T]
        rope = _rope_tables(positions, self.rope_freqs)
        # a write window that would cross the cache end starts earlier,
        # as XLA clamps a dynamic_update_slice start into [0, S - T]
        write_pos = idx.long().clamp(0, s - t)[:, None] + steps  # [B, T]
        n = cache.shards
        tp = _tp_axis(self.cfg)
        if (tp.size if tp is not None else 1) != n:
            raise ValueError(f"a cache of {n} shard(s) for a model of "
                             f"tp_size {self.cfg.tp_size}: build it with "
                             "init_cache(..., keep_tp=tp_size > 1)")
        if n > 1:   # every shard's rows, shard-major
            idx, write_pos = idx.repeat(n), write_pos.repeat(n, 1)
        rows = torch.arange(n * b, device=dev)[:, None]
        x = self.tok_embeddings(tokens)
        for layer, block in enumerate(self.layers):
            x, _ = block(x, rope, cache, layer, idx, rows, write_pos)
        x = self.norm(x)
        if not all_logits:
            x = x[:, -1:]
        logits = self.output(x).float()
        cache.index.add_(t)
        return logits


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``checkpoint_dots_with_no_batch_dims`` as a selective
    checkpoint policy: save the outputs of matrix products without batch
    dims (``x @ kernel`` on ``[B, T, D]`` reaches ``aten.mm``: the seven
    projections of a block) and recompute everything else, ``aten.bmm``
    (batched products), the attention kernels, norms and rope
    included."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(block: Block, x: torch.Tensor, rope,
           policy: str = "none", params=None) -> torch.Tensor:
    """``block(x, rope)`` under ``torch.utils.checkpoint``, its parameters
    passed in as inputs: under ``functional_call`` (``Llama.apply``) the
    recompute in the backward must see the same tensors as the forward,
    not the module's own.  ``policy`` is ``cfg.remat_policy``: "none" and
    "everything" recompute the whole block (flax's ``policy=None`` and
    ``nothing_saveable`` save the same: nothing), "dots" keeps the
    projections' outputs (:func:`_dots_policy`).  ``params`` (``{name:
    tensor}``, the block's names) replaces the block's own parameters
    (the pipeline's stage-stacked slots)."""
    names, tensors = zip(*(params.items() if params is not None
                           else block.named_parameters()))

    def run(x, rope, *tensors):
        return torch.func.functional_call(block, dict(zip(names, tensors)),
                                          (x, rope))

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(run, x, rope, *tensors, use_reentrant=False, **kw)


def _xent_sum(hx: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    logits = (hx.to(dtype) @ w.to(dtype)).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           t.reshape(-1).long(), reduction="sum")


def chunked_xent(h: torch.Tensor, w_kernel: torch.Tensor,
                 targets: torch.Tensor, *, n_chunks: int = 8,
                 dot_in_fp32: bool = True) -> torch.Tensor:
    """Next-token cross-entropy computed chunk by chunk over the sequence,
    so the full ``[B, T, vocab]`` logits never exist at once.

    ``h``: [B, T, dim] final-norm hidden states (``forward(...,
    return_hidden=True)``); ``w_kernel``: [dim, vocab] head kernel;
    ``targets``: [B, T].  Each chunk's logits, log-sum-exp and target
    gather run inside ``torch.utils.checkpoint`` (JAX: ``jax.checkpoint``
    under ``lax.map``): the forward holds one chunk's logits, the
    backward recomputes them.  The mean over B·T, as the plain loss."""
    b, s, _ = h.shape
    if s % n_chunks:
        raise ValueError(f"seq len {s} % n_chunks {n_chunks} != 0")
    c = s // n_chunks
    dtype = torch.float32 if dot_in_fp32 else h.dtype
    total = None
    for i in range(n_chunks):
        part = checkpoint(_xent_sum, h[:, i * c:(i + 1) * c], w_kernel,
                          targets[:, i * c:(i + 1) * c], dtype,
                          use_reentrant=False)
        total = part if total is None else total + part
    return total / (b * s)


def llama_chunked_xent_loss_fn(model: Llama, *, n_chunks: int = 8):
    """``loss_fn(params, (inputs, targets))``: the decoder stack as usual,
    the head and cross-entropy through :func:`chunked_xent`.  ``params``
    is ``{state-dict name: tensor}`` (``model.state()``).  As the JAX
    builder does, it refuses an MoE config with ``moe_aux_weight > 0``
    (the chunked path carries no aux term: use :func:`llama_loss_fn`);
    and, as JAX does, a vocab-parallel or tp_seq_shard config."""
    cfg = model.cfg
    if cfg.vocab_parallel:
        raise ValueError("chunked xent: use vocab_parallel_xent with "
                         "vocab_parallel configs")
    if cfg.tp_seq_shard:
        raise ValueError("chunked xent: hidden states are seq-sharded "
                         "under tp_seq_shard but targets are not")
    if cfg.n_experts and cfg.moe_aux_weight > 0.0:
        raise ValueError("chunked xent does not collect MoE aux "
                         "intermediates; use the plain loss")

    def loss_fn(params, batch):
        inp, tgt = batch
        h = model.apply(params, inp, return_hidden=True)
        return chunked_xent(h, params["output.kernel"], tgt,
                            n_chunks=n_chunks,
                            dot_in_fp32=cfg.logits_dot_in_fp32)

    return loss_fn


def llama_loss_fn(model: Llama, *, pos_offset: int = 0):
    """``loss_fn(params, (inputs, targets))``: the mean next-token
    cross-entropy of the full f32 logits, the plain loss of
    ``examples/llama_benchmark.py`` (``optax.
    softmax_cross_entropy_with_integer_labels`` averaged over B·T).

    Under ``attn_mode="ring"`` or ``"ulysses"`` the batch is the ``[S, B,
    T_local]`` shards of the bound axis, each shard at ``pos_offset +
    index * T_local``, and the loss is each shard's mean, ``[S]``: what
    each device of the JAX mesh returns.  ``build_train_step(sp_axis=)``
    takes their mean, JAX's ``pmean`` over the axis.

    An MoE config with ``moe_aux_weight > 0`` adds ``moe_aux_weight`` x
    the layers' summed aux loss (each shard's own under sequence
    parallelism), as ``examples/llama_benchmark.py``'s loss does.  A
    ``vocab_parallel`` config takes :func:`vocab_parallel_xent` over its
    vocab-sharded logits (the same loss), as the benchmark does."""
    cfg = model.cfg
    sp = cfg.attn_mode in ("ring", "ulysses")
    want_aux = cfg.n_experts > 0 and cfg.moe_aux_weight > 0.0

    def loss_fn(params, batch):
        inp, tgt = batch
        off = pos_offset
        if sp:
            off = off + _sp_axis(cfg).index(inp.device) * inp.shape[-1]
        logits = model.apply(params, inp, pos_offset=off,
                             return_aux=want_aux)
        if want_aux:
            logits, aux = logits
        ce = _xent(cfg, logits, tgt, sp)
        return ce + cfg.moe_aux_weight * aux if want_aux else ce

    return loss_fn


def _xent(cfg: LlamaConfig, logits: torch.Tensor, tgt: torch.Tensor,
          sp: bool) -> torch.Tensor:
    """The mean next-token cross-entropy of :meth:`Llama.forward`'s
    logits: over the vocab-sharded columns under ``vocab_parallel``, and
    each sequence shard's own (``[S]``) under ``sp``."""
    if cfg.vocab_parallel and sp:
        # each sequence shard's loss over the vocab-sharded columns
        return torch.stack([vocab_parallel_xent(
            logits[:, i], tgt[i], cfg.tp_axis)
            for i in range(tgt.shape[0])])
    if cfg.vocab_parallel:
        return vocab_parallel_xent(logits, tgt, cfg.tp_axis)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tgt.reshape(-1).long(),
                         reduction="none" if sp else "mean")
    return ce.reshape(tgt.shape[0], -1).mean(1) if sp else ce


def llama_circular_layout(variables: Dict[str, torch.Tensor], n_stages: int,
                          n_loops: int, inverse: bool = False
                          ) -> Dict[str, torch.Tensor]:
    """Permute the layers into (or, with ``inverse=True``, back out of)
    the circular pipeline's storage order: storage slot ``g``
    (``layers.{g}.…``) takes the leaves of layer ``perm[g]``
    (``parallel.pipeline.circular_layer_permutation``), every other leaf
    as it is, in the same key order.  Apply it before ``rank_major``
    when training with ``llama_pp_loss_fn(..., n_loops > 1)``, and
    inversely to export the natural layer order.  The tensors are not
    copied."""
    from bluefog_tpu_torch.parallel.pipeline import \
        circular_layer_permutation

    n_layers = 1 + max(int(k.split(".")[1]) for k in variables
                       if k.startswith("layers."))
    perm = circular_layer_permutation(n_layers, n_stages, n_loops).tolist()
    if inverse:
        perm = sorted(range(n_layers), key=perm.__getitem__)
    out = {}
    for k in variables:
        if k.startswith("layers."):
            _, g, leaf = k.split(".", 2)
            out[k] = variables[f"layers.{perm[int(g)]}.{leaf}"]
        else:
            out[k] = variables[k]
    return out


def llama_pp_loss_fn(cfg: LlamaConfig, *, pp_axis: str, n_stages: int,
                     n_micro: int, n_loops: int = 1):
    """The next-token cross-entropy ``loss_fn(params, (inputs, targets))``
    with the decoder stack run as a pipeline over ``pp_axis``
    (``parallel.pipeline.gpipe``; ``gpipe_circular`` when ``n_loops >
    1``), the JAX package's builder of the same name.

    ``params`` is the port's state dict (``{name: tensor}``, the plain
    model's tree: checkpoints move freely between pipeline layouts);
    stage ``s`` owns layers ``s * L / S ..`` in storage order
    (``llama_param_specs(pp_axis=)``), and with ``n_loops > 1`` the layers
    must be in the circular storage order first
    (:func:`llama_circular_layout`; ``n_micro >= n_stages``).  Every stage
    runs on the one device, each layer slot one pass over all stages
    (see the module docstring); the pp axis must be bound (the train
    step binds it).  The batch size must divide by ``n_micro``.

    Returns each stage's loss, ``[S]`` (``[S, S_sp]`` under ring or
    Ulysses attention, each sequence shard's): the last stage's
    cross-entropy, 0 on the others (JAX's masked per-device loss), plus,
    for a MoE config with ``moe_aux_weight > 0``, each stage's own aux
    over its real microbatch ticks divided by ``n_micro``, unmasked.
    ``build_train_step(pp_axis=)`` sums the stages (JAX's psum over pp).
    The embedding runs once (stage 0's input) and the final norm and
    head run once (on the last stage's outputs).  Composes with
    ``vocab_parallel`` over a tp axis and with ring or Ulysses sequence
    parallelism (rotary offsets from the sp shard index); refuses, with
    JAX's errors, ``scan_layers=False``, a depth that does not divide by
    ``n_stages * n_loops``, and ``tp_seq_shard``."""
    if not cfg.scan_layers:
        raise ValueError("pipeline parallelism requires scan_layers=True "
                         "(the stacked-layer param layout is what shards "
                         "over the pipeline axis)")
    if cfg.n_layers % (n_stages * n_loops):
        raise ValueError(f"n_layers ({cfg.n_layers}) must divide by "
                         f"n_stages*n_loops ({n_stages}*{n_loops})")
    if cfg.tp_seq_shard:
        raise ValueError(
            "tp_seq_shard is not supported in the pipeline loss builder "
            "yet (the stage boundary would have to carry seq-sharded "
            "activations through the pp permute); use it with the plain "
            "stack, or pp without tp_seq_shard")

    from bluefog_tpu_torch.parallel.pipeline import gpipe, gpipe_circular

    # the modules the plain model runs, applied to the given tensors, so
    # the pipeline cannot diverge from the plain model's math
    block = Block(cfg, "meta")
    final_norm = RMSNorm(cfg.dim, cfg.norm_eps, "meta")
    head = Dense(cfg.dim, cfg.vocab_size, torch.float32
                 if cfg.logits_dot_in_fp32 else cfg.dtype, "meta")
    want_aux = cfg.n_experts > 0 and cfg.moe_aux_weight > 0.0
    sp = cfg.attn_mode in ("ring", "ulysses")
    per_stage = cfg.n_layers // n_stages
    chunk = per_stage // n_loops
    # each leaf stacked in the dtype its product computes in: the norms'
    # scales and the MoE router in f32
    leaves = {name: torch.float32 if name.endswith("norm.scale")
              or name.startswith("moe_ffn.router.") else cfg.dtype
              for name, _ in block.named_parameters()}

    def stacked(params):
        """Each layer slot of a chunk: ``{leaf: [S, ...]}`` (``[S,
        n_loops, ...]`` for the circular schedule)."""
        slots = []
        for l in range(chunk):
            rows = [s * per_stage + r * chunk + l for s in range(n_stages)
                    for r in range(n_loops)]
            slot = {}
            for name, dt in leaves.items():
                w = torch.stack([params[f"layers.{i}.{name}"].to(dt)
                                 for i in rows])
                slot[name] = (w.unflatten(0, (n_stages, n_loops))
                              if n_loops > 1 else w)
            slots.append(slot)
        return slots

    def loss_fn(params, batch):
        inp, tgt = batch
        b, t = inp.shape[-2:]
        if b % n_micro:
            raise ValueError(f"batch size {b} must divide by n_micro "
                             f"({n_micro})")
        bm = b // n_micro
        dev = inp.device
        positions = torch.arange(t, device=dev)
        s_n = 1
        if sp:
            axis = _sp_axis(cfg)
            s_n = axis.n_local
            if inp.dim() != 3 or inp.shape[0] != s_n:
                raise ValueError(
                    f"attn_mode={cfg.attn_mode!r} takes the {s_n} shards "
                    f"of {axis!r} stacked: tokens [S, B, T_local], got "
                    f"{tuple(inp.shape)}")
            # rows stage-major, then sequence shard, each shard's rows at
            # its own global positions
            off = (axis.index(dev) * t).reshape(1, s_n, 1, 1)
            positions = (off + positions).expand(
                n_stages, s_n, bm, t).reshape(-1, t)
        rope = _rope_tables(positions, _rope_freqs(
            cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, dev))
        table = params["tok_embeddings.embedding"]
        x = (_vocab_parallel_rows(table, cfg.dtype, inp, cfg)
             if cfg.vocab_parallel
             else F.embedding(inp.long(), table).to(cfg.dtype))
        d = x.shape[-1]
        x_micro = (x.reshape(s_n, n_micro, bm, t, d).transpose(0, 1)
                   if sp else x.reshape(n_micro, bm, t, d))

        def stage_fn(slots, x):
            h, aux = x.reshape(-1, t, d), None
            for lp in slots:
                h, a = (_remat(block, h, rope, cfg.remat_policy, lp)
                        if cfg.remat
                        else torch.func.functional_call(block, lp,
                                                        (h, rope)))
                if a is not None:
                    aux = a if aux is None else aux + a
            return (h.reshape(x.shape), aux) if want_aux \
                else h.reshape(x.shape)

        slots = stacked(params)
        run = (functools.partial(gpipe_circular, n_loops=n_loops)
               if n_loops > 1 else gpipe)
        outs = run(stage_fn, slots, x_micro, pp_axis, n_stages,
                   with_aux=want_aux)
        if want_aux:
            outs, aux_sum = outs
        h = (outs.transpose(0, 1) if sp else outs).reshape(-1, t, d)
        h = torch.func.functional_call(final_norm,
                                       {"scale": params["norm.scale"]}, (h,))
        w = {"kernel": params["output.kernel"]}
        if cfg.vocab_parallel:
            tp = _tp_axis(cfg)
            logits = _shard_cols(torch.func.functional_call(
                head, w, (_enter_tp_region(h, cfg, tp),)), tp.size).float()
        else:
            logits = torch.func.functional_call(head, w, (h,)).float()
        if sp:
            logits = logits.unflatten(-3, (s_n, b))
        ce = _xent(cfg, logits, tgt, sp)
        # the last stage's loss; the other stages' are masked to 0
        loss = torch.cat([ce.new_zeros((n_stages - 1,) + ce.shape),
                          ce[None]])
        if want_aux:
            # each stage's own routers' aux, unmasked, a mean over its
            # real microbatches
            loss = loss + cfg.moe_aux_weight * aux_sum / n_micro
        return loss

    return loss_fn


def llama_param_specs(params_or_shapes, rank_axis: Optional[str] = "bf",
                      tp_axis: Optional[str] = "tp",
                      ep_axis: Optional[str] = "ep",
                      pp_axis: Optional[str] = None,
                      vocab_axis: Optional[str] = None
                      ) -> Dict[str, tuple]:
    """The JAX package's ``llama_param_specs`` over the port's state
    dict (``{name: tensor or shape}``, the leaves WITHOUT the rank
    axis): ``{name: spec}``, a spec being the tuple of axis names (or
    None) per dim of the rank-major leaf that ``batch_specs`` uses (JAX's
    ``PartitionSpec``), trailing Nones stripped.  Column-parallel kernels
    (``wq/wk/wv/w1/w3``) and their per-output-channel ``scale`` shard
    their last dim over ``tp_axis``, row-parallel kernels (``wo/w2``)
    their second-to-last; MoE expert tensors (under ``moe_ffn``, not the
    router) their expert dim over ``ep_axis``; with ``vocab_axis`` the
    embedding its vocab rows and the head its vocab columns.
    ``rank_axis=None`` gives specs without the rank dim.

    ``pp_axis`` marks the leaves the pipeline's stages own: every leaf
    under ``layers.*``, the set JAX shards over pp (dim 0 of its scanned
    stack).  The port keeps per-layer leaves, so a stage owns whole
    leaves (layer ``i`` is stage ``i // (L / S)``'s): the rank entry of
    such a leaf's spec is ``(rank_axis, pp_axis)``, the rank axis and
    the stage axis that holds the leaf, its other dims as without pp.
    ``build_train_step``, ``optax_state_specs`` and the edge account read
    the pp axis there (a stage-owned leaf counts as split over the
    stages, what one JAX device holds).  It needs ``rank_axis``."""
    if pp_axis is not None and rank_axis is None:
        raise ValueError("llama_param_specs(pp_axis=) marks a stage-owned "
                         "leaf on its rank entry (rank_axis, pp_axis): "
                         "give rank_axis")
    column = ("wq", "wk", "wv", "w1", "w3")
    row = ("wo", "w2")
    out = {}
    for name, leaf in params_or_shapes.items():
        parts = name.split(".")
        tagged = "/" + "/".join(parts) + "/"
        nd = len(leaf.shape)
        is_scale = parts[-1] == "scale"
        dims = [None] * nd
        if vocab_axis is not None and "/tok_embeddings/" in tagged \
                and nd >= 2:
            dims[0] = vocab_axis
        elif vocab_axis is not None and "/output/" in tagged and nd >= 1:
            dims[-1] = vocab_axis
        elif "/moe_ffn/" in tagged:
            if ep_axis is not None and "/router/" not in tagged and nd >= 3:
                dims[-3] = ep_axis
        elif any(f"/{k}/" in tagged for k in column) \
                and (nd >= 2 or (is_scale and nd >= 1)):
            if tp_axis is not None:
                dims[-1] = tp_axis
        elif any(f"/{k}/" in tagged for k in row) and nd >= 2 \
                and not is_scale:
            if tp_axis is not None:
                dims[-2] = tp_axis
        while dims and dims[-1] is None:
            dims.pop()
        rank = (rank_axis if pp_axis is None or parts[0] != "layers"
                else (rank_axis, pp_axis))
        out[name] = tuple(dims) if rank_axis is None else (rank, *dims)
    return out

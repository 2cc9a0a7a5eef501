"""Llama decoder in its decode layout (K/V-cached, last-position logits).

Port of ``bluefog_tpu/models/llama.py``, the parts the serving path
runs: :class:`LlamaConfig` (every field kept, so configs map one to
one), ``RMSNorm``, ``_llama3_scaled_freqs``/``rotary_embed``,
``_amax_quantize``, the ``Attention._decode_attend`` cache path,
``_cached_attention``, ``FeedForward``, ``Block`` and ``Llama``.
Deviations from the JAX package:

* Only the decode layout is ported: :class:`Llama` always writes the
  K/V cache it is given and returns the last position's logits
  (``all_logits=True`` keeps every position, as in JAX).  The training
  forward, and with it tensor/sequence parallelism, ring/ulysses
  attention, MoE, remat and the flash/splash kernels, waits for the
  Llama-training slice; ``QuantDense`` (``param_quant``) and the w8a8
  integer attention ``_cached_attention_int8`` wait for a later serving
  slice.  Configs that need them raise ``NotImplementedError``.
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
  ``x @ kernel`` in ``cfg.dtype``.  The parameters are stored in the
  dtype flax casts them to on every call (``cfg.dtype`` for the
  projections and the embedding, f32 for the norms and for the logits
  head under ``logits_dot_in_fp32``), not as f32 masters: the forward is
  the same, and the card holds half the bytes.
* The decoder stack is a Python loop over ``nn.ModuleList`` layers (JAX
  could ``nn.scan`` them; ``interop/from_jax.py`` reads both layouts).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.parallel.decode_attention import (
    decode_attention, decode_attention_int8)

__all__ = ["LlamaConfig", "Llama", "KVCache", "RMSNorm", "rotary_embed"]

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


def require_ported(cfg: LlamaConfig) -> None:
    """Raise ``NotImplementedError`` for a config whose parameters or
    decode numerics need a part of the JAX model not ported yet."""
    later = []
    if cfg.tp_size > 1 or cfg.tp_axis is not None:
        later.append("tensor parallelism (tp_axis/tp_size): the tp decode "
                     "slice")
    if cfg.attn_mode in ("ring", "ulysses") or cfg.sp_axis is not None:
        later.append(f"attn_mode={cfg.attn_mode!r}: the Llama-training "
                     "slice")
    if cfg.n_experts:
        later.append("MoE (n_experts > 0): the Llama-training slice")
    if cfg.param_quant != "none":
        later.append(f"param_quant={cfg.param_quant!r} (QuantDense, w8a8 "
                     "attention): a later serving slice")
    if cfg.decode and cfg.attn_impl != "xla":
        later.append(f"attn_impl={cfg.attn_impl!r} in a decode config: "
                     "the Llama-training slice")
    if later:
        raise NotImplementedError(
            "not ported to bluefog_tpu_torch yet: " + "; ".join(later))


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


@dataclasses.dataclass
class KVCache:
    """The decode-layout K/V cache of every layer, for ``B`` rows.

    ``key``/``value``: ``[L, B, KV, S, D]`` in the compute dtype, or
    int8 with ``key_scale``/``value_scale`` ``[L, B, KV, S]`` f32 (one
    scale per cached vector).  ``index``: ``[B]`` int32, each row's next
    write position.  A forward writes its K/V in place at ``index`` and
    then advances it; positions above a row's index are masked."""
    key: torch.Tensor
    value: torch.Tensor
    index: torch.Tensor
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None

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
        return KVCache(
            self.key[:, start:stop], self.value[:, start:stop],
            self.index[start:stop],
            None if self.key_scale is None
            else self.key_scale[:, start:stop],
            None if self.value_scale is None
            else self.value_scale[:, start:stop])


class Dense(nn.Module):
    """flax ``nn.Dense(use_bias=False)``: ``x @ kernel`` in the kernel's
    dtype, kernel ``[in, out]``."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype, device):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(n_in, n_out, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, x):
        return x.to(self.kernel.dtype) @ self.kernel


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
        return (normed * self.scale).to(x.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: the table, stored in the compute dtype."""

    def __init__(self, vocab: int, dim: int, dtype, device):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.empty(vocab, dim, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, tokens):
        return F.embedding(tokens.long(), self.embedding)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.wq = Dense(cfg.dim, cfg.n_heads * hd, cfg.dtype, device)
        self.wk = Dense(cfg.dim, cfg.n_kv_heads * hd, cfg.dtype, device)
        self.wv = Dense(cfg.dim, cfg.n_kv_heads * hd, cfg.dtype, device)
        self.wo = Dense(cfg.n_heads * hd, cfg.dim, cfg.dtype, device)

    def forward(self, x, cache: KVCache, layer: int, idx, rope, rows,
                write_pos):
        """``_decode_attend``: write this call's K/V at the rows' cache
        positions (rotary at the true absolute positions), then attend
        over the cache."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.head_dim
        q = self.wq(x).reshape(b, t, cfg.n_heads, hd)
        k = self.wk(x).reshape(b, t, cfg.n_kv_heads, hd)
        v = self.wv(x).reshape(b, t, cfg.n_kv_heads, hd)
        q = _apply_rotary(q, *rope)
        k = _apply_rotary(k, *rope)
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
                out = decode_attention_int8(q, k_all, ks_all, v_all,
                                            vs_all, idx)
            else:
                out = _cached_attention(q, k_all.float() * ks_all[..., None],
                                        v_all.float() * vs_all[..., None],
                                        idx)
        else:
            k_all[rows, :, write_pos] = k.to(k_all.dtype)
            v_all[rows, :, write_pos] = v.to(v_all.dtype)
            if t == 1:
                out = decode_attention(q, k_all, v_all, idx)
            else:
                out = _cached_attention(q, k_all, v_all, idx)
        return self.wo(out.reshape(b, t, cfg.n_heads * hd))


class FeedForward(nn.Module):
    """SwiGLU: ``w2(silu(w1 x) * w3 x)``."""

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.w1 = Dense(cfg.dim, cfg.ffn_dim, cfg.dtype, device)
        self.w3 = Dense(cfg.dim, cfg.ffn_dim, cfg.dtype, device)
        self.w2 = Dense(cfg.ffn_dim, cfg.dim, cfg.dtype, device)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.attention = Attention(cfg, device)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.feed_forward = FeedForward(cfg, device)

    def forward(self, x, cache, layer, idx, rope, rows, write_pos):
        x = x + self.attention(self.attention_norm(x), cache, layer, idx,
                               rope, rows, write_pos)
        return x + self.feed_forward(self.ffn_norm(x))


class Llama(nn.Module):
    """The Llama decoder's parameters and its decode-layout forward.

    ``cfg`` may be a training or a decode config (the parameters are the
    same); the forward is always the decode layout.  Parameters are
    drawn at the scale of flax's default initializers (normal with std
    ``1/sqrt(fan_in)`` for every projection, ``1/sqrt(vocab)`` for the
    embedding, ones for the norms) from ``generator`` (default: seed 0
    on ``device``); load trained ones with ``load_state_dict`` (see
    :func:`bluefog_tpu_torch.interop.llama_params_from_flax`)."""

    def __init__(self, cfg: LlamaConfig, device: Union[str, torch.device]
                 = "cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        require_ported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.tok_embeddings = Embed(cfg.vocab_size, cfg.dim, cfg.dtype, dev)
        self.layers = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, dev)
        head_dtype = torch.float32 if cfg.logits_dot_in_fp32 else cfg.dtype
        self.output = Dense(cfg.dim, cfg.vocab_size, head_dtype, dev)
        self.register_buffer(
            "rope_freqs", _rope_freqs(cfg.head_dim, cfg.rope_theta,
                                      cfg.rope_scaling, dev),
            persistent=False)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        self.init_weights_(generator)

    @property
    def device(self) -> torch.device:
        return self.output.kernel.device

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

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, cache: KVCache,
                all_logits: bool = False) -> torch.Tensor:
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
        rows = torch.arange(b, device=dev)[:, None]
        x = self.tok_embeddings(tokens)
        for layer, block in enumerate(self.layers):
            x = block(x, cache, layer, idx, rope, rows, write_pos)
        x = self.norm(x)
        if not all_logits:
            x = x[:, -1:]
        logits = self.output(x).float()
        cache.index.add_(t)
        return logits

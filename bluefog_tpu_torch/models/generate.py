"""Autoregressive generation with K/V caching.

Port of ``bluefog_tpu/models/generate.py``: ``decode_config``,
``init_cache``, ``prefill_cache``, ``decode_token_step``,
``verify_window`` (speculative decoding's multi-token verify) and
``llama_generate``, with ``weight_quant`` (the int8 ``QuantDense``
layouts).  Deviations from the JAX package:

* The token loop is an eager Python loop (JAX ran one ``lax.scan``
  inside ``jit``), and the caches are updated in place.
* ``prefill_cache``/``decode_token_step`` take the :class:`Llama`
  module, which holds the parameters (JAX passed a param tree).
* ``llama_generate`` takes a port state dict or a :class:`Llama` as
  ``variables``; temperature sampling draws Gumbel noise from the
  ``torch.Generator`` given as ``rng`` (JAX split a PRNG key), so
  sampled streams are deterministic per generator, not bit-equal to
  ``jax.random``'s.  Greedy decoding is the same argmax.
* Every single-token step runs the decode-attention kernel (JAX's
  ``decode_attn="pallas"``).  ``decode_attn`` is taken for signature
  compatibility: ``"auto"`` resolves to ``"pallas"``, and on a CUDA
  device any other value than ``"pallas"`` is refused, because the port
  has no second lowering there.  On the CPU every value runs the
  kernel's plain version.
* ``weight_quant`` needs the state dict that
  :func:`~bluefog_tpu_torch.models.quant.quantize_llama_params` gives (or
  a :class:`Llama` built from a ``param_quant`` config); the module is
  built from the decode config, since ``LlamaConfig`` takes
  ``param_quant`` only with ``decode=True``.
* MoE configs decode with DROPLESS routing, as in JAX: ``decode_config``
  raises the capacity factor to ``n_experts`` (every token gets its full
  top-k combine whatever it is batched with, so the cached decode equals
  the dropless full forward), keeps ``moe_group_size``, and refuses the
  non-causal ``moe_router="expert_choice"``.
* The tp-sharded decode (``keep_tp=True``, ``llama_generate(...,
  mesh=)``): ``mesh=`` takes the tp axis itself
  (:class:`~bluefog_tpu_torch.parallel.collectives.MeshAxis`, the port's
  stand-in for a one-axis tp mesh), bound over the whole generation.
  Every shard runs at once on one device: its heads' K/V cache folded
  into the cache's batch (``init_cache(..., keep_tp=True)``), its
  attention through the decode kernel at the per-shard shape, its
  row-parallel partials merged by the axis's psum.  The logits are
  replicated (held once), so every shard samples the same token from
  the one generator.  The weights are the tp=1 tree: each shard
  computes from its slice (per-output-channel scales shard with their
  kernel under ``weight_quant``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping, Optional, Union

import torch

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.models.llama import (KVCache, Llama, LlamaConfig,
                                            _dropless_factor)
from bluefog_tpu_torch.parallel.collectives import MeshAxis, bind_axis

__all__ = ["init_cache", "llama_generate", "decode_config",
           "prefill_cache", "decode_token_step", "verify_window",
           "build_model"]

def decode_config(cfg: LlamaConfig, max_len: int, *, keep_tp: bool = False,
                  kv_quant: str = "none", weight_quant: str = "none",
                  decode_attn: str = "auto") -> LlamaConfig:
    """The decode layout of ``cfg``: ``decode=True``, cache length
    ``max_len``, training-time knobs cleared (as in JAX; tensor
    parallelism KEPT with ``keep_tp``); an MoE config decodes dropless
    (capacity factor raised to ``n_experts``).  Raises
    ``NotImplementedError`` for ``moe_router="expert_choice"``
    (non-causal)."""
    moe = {}
    if cfg.n_experts:
        if cfg.moe_router != "topk":
            raise NotImplementedError(
                "llama_generate supports only moe_router='topk' "
                "(expert_choice is non-causal and cannot decode)")
        moe = dict(capacity_factor=_dropless_factor(cfg))
    if decode_attn == "auto":
        decode_attn = "pallas"  # the port has one decode lowering
    tp = {} if keep_tp else {"tp_axis": None, "tp_size": 1}
    return dataclasses.replace(
        cfg, decode=True, max_seq_len=max_len, attn_mode="full",
        attn_impl="xla", sp_axis=None, ep_axis=None, ep_size=1,
        remat=False, remat_policy="none", kv_quant=kv_quant,
        param_quant=weight_quant, decode_attn=decode_attn,
        vocab_parallel=False, tp_seq_shard=False, **moe, **tp)


def check_decode_attn(dcfg: LlamaConfig, device: torch.device) -> None:
    """On the card every single-token step runs the CUDA kernel; refuse
    a config that asks for another lowering there."""
    if device.type == "cuda" and dcfg.decode_attn != "pallas":
        raise ValueError(
            f"decode_attn={dcfg.decode_attn!r}: on a CUDA device the port "
            "decodes only through its decode-attention kernel ('pallas' "
            "or 'auto')")


def init_cache(cfg: LlamaConfig, batch_size: int, max_len: int,
               keep_tp: bool = False, kv_quant: str = "none",
               device: Union[str, torch.device] = "cuda") -> KVCache:
    """Zero K/V caches for ``batch_size`` sequences of up to ``max_len``
    tokens; ``kv_quant='int8'`` gives the int8 + per-vector-scale
    layout.  With ``keep_tp`` and ``cfg.tp_size > 1`` the cache is
    PER-SHARD: each shard's ``n_kv_heads / tp`` heads, the shards folded
    into the batch (:class:`KVCache`)."""
    if kv_quant not in ("none", "int8"):
        raise ValueError(f"kv_quant {kv_quant!r} not in ('none', 'int8')")
    return _zero_cache(cfg, batch_size, max_len, kv_quant,
                       resolve_device(device),
                       cfg.tp_size if keep_tp else 1)


def _zero_cache(cfg: LlamaConfig, batch_size: int, max_len: int,
                kv_quant: str, dev: torch.device,
                shards: int = 1) -> KVCache:
    """The cache layout on ``dev`` (the ``meta`` device gives its shapes
    alone)."""
    shape = (cfg.n_layers, shards * batch_size, cfg.n_kv_heads // shards,
             max_len, cfg.head_dim)
    index = torch.zeros(batch_size, dtype=torch.int32, device=dev)
    if kv_quant == "int8":
        return KVCache(
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(shape, dtype=torch.int8, device=dev), index,
            torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            shards)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev), index,
                   shards=shards)


def prefill_cache(model: Llama, cache: KVCache, tokens: torch.Tensor):
    """Cache-writing prefill: one multi-token forward writes ``tokens``'s
    K/V into ``cache`` at its current index.  Returns ``(logits, cache)``
    with logits ``[B, 1, V]`` (decode layout)."""
    return model(tokens, cache), cache


def decode_token_step(model: Llama, cache: KVCache, tok: torch.Tensor):
    """One incremental decode step: append ``tok [B, 1]``'s K/V and
    return ``(last_logits [B, V], cache)``."""
    return model(tok, cache)[:, -1], cache


def verify_window(model: Llama, cache: KVCache, tokens: torch.Tensor):
    """Multi-token cached forward that keeps EVERY position's logits:
    append ``tokens [B, T]``'s K/V (as :func:`prefill_cache` does) and
    return ``(logits [B, T, V], cache)``.  Speculative decoding's verify
    step: position ``i``'s logits are the target's distribution after
    ``tokens[:, :i+1]``."""
    return model(tokens, cache, all_logits=True), cache


# the config fields a decode forward of the port does not read to size or
# compute its parameters (decode_config sets or clears them)
_DECODE_FIELDS = ("decode", "max_seq_len", "attn_mode", "attn_impl",
                  "attn_block_size", "attn_flash_block_size",
                  "attn_flash_block_k", "sp_axis", "ep_axis", "ep_size",
                  "remat", "remat_policy", "scan_layers", "kv_quant",
                  "param_quant", "decode_attn", "vocab_parallel",
                  "tp_seq_shard", "tp_axis", "tp_size",
                  # a decode forward routes MoE tokens dropless itself
                  "capacity_factor")


def _model_fields(cfg: LlamaConfig) -> LlamaConfig:
    return dataclasses.replace(
        cfg, **{f: getattr(LlamaConfig, f) for f in _DECODE_FIELDS})


def build_model(variables: Union[Llama, Mapping[str, torch.Tensor]],
                dcfg: LlamaConfig, device: torch.device) -> Llama:
    """``variables`` as a :class:`Llama` on ``device`` for the decode
    config ``dcfg``: a module is used as it is (built from a config of
    the same model, with ``dcfg``'s ``param_quant``), a state dict is
    loaded into a new module built from ``dcfg``.  A mismatch between
    ``dcfg.param_quant`` and the weights' layout raises ``ValueError``,
    as the JAX package's ``quantize_llama_params`` contract does."""
    from bluefog_tpu_torch.models.quant import is_quantized_params

    matches = (variables.cfg.param_quant == dcfg.param_quant
               if isinstance(variables, Llama)
               else is_quantized_params(variables)
               == (dcfg.param_quant != "none"))
    if not matches:
        raise ValueError(
            "weight_quant='int8'/'w8a8' requires params converted by "
            "quantize_llama_params (and full-precision params require "
            "weight_quant='none'); got a mismatched tree")
    if isinstance(variables, Llama):
        if _model_fields(variables.cfg) != _model_fields(dcfg):
            raise ValueError("the Llama module was built from another "
                             "config than the one given")
        if variables.device != device:
            raise ValueError(f"the Llama module lives on "
                             f"{variables.device}, not {device}")
        tp = dict(tp_axis=dcfg.tp_axis, tp_size=dcfg.tp_size)
        if (variables.cfg.tp_axis, variables.cfg.tp_size) != tuple(
                tp.values()):
            # the same weights in the decode's tp layout
            return variables.retarget(dataclasses.replace(variables.cfg,
                                                          **tp))
        return variables
    model = Llama(dcfg, device)
    model.load_state_dict(variables)
    return model


def _sample(logits: torch.Tensor, temperature: float,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=rng, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return (logits / temperature + gumbel).argmax(dim=-1).to(torch.int32)


@torch.no_grad()
def llama_generate(variables, cfg: LlamaConfig, prompt, max_new_tokens: int,
                   *, temperature: float = 0.0,
                   rng: Optional[torch.Generator] = None,
                   max_len: Optional[int] = None, mesh=None,
                   kv_quant: str = "none", weight_quant: str = "none",
                   decode_attn: str = "auto", eos_id: Optional[int] = None,
                   device: Union[str, torch.device] = "cuda"
                   ) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt``
    ``[B, T_prompt]``: one prefill call, then one decode step per token
    (greedy at ``temperature == 0``, else sampled with ``rng``, a
    ``torch.Generator`` on ``device``).  ``eos_id``: once a row has
    emitted it, its later positions are ``eos_id``.  Returns
    ``[B, T_prompt + max_new_tokens]`` int32 on ``device``: prompt ‖
    generation.  ``weight_quant`` "int8" or "w8a8" runs every projection
    and the head from int8 kernels (``variables`` from
    :func:`~bluefog_tpu_torch.models.quant.quantize_llama_params`)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens ({max_new_tokens}) must be >= 1")
    tp = cfg.tp_size > 1 and mesh is not None
    if tp:
        if not isinstance(mesh, MeshAxis):
            raise TypeError(
                f"mesh= takes the tp axis itself, MeshAxis("
                f"{cfg.tp_axis!r}, {cfg.tp_size}) (the port has no Mesh), "
                f"got {type(mesh).__name__}")
        if mesh.name != cfg.tp_axis or mesh.size != cfg.tp_size:
            raise ValueError(f"mesh={mesh!r} is not the config's tp axis "
                             f"({cfg.tp_axis!r}, {cfg.tp_size})")
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    b, t_prompt = prompt.shape
    total = t_prompt + max_new_tokens
    max_len = max_len or total
    if max_len < total:
        raise ValueError(f"max_len ({max_len}) < prompt + new tokens "
                         f"({total})")
    if temperature > 0.0 and rng is None:
        raise ValueError("temperature sampling needs rng=")
    dcfg = decode_config(cfg, max_len, keep_tp=tp, kv_quant=kv_quant,
                         weight_quant=weight_quant, decode_attn=decode_attn)
    check_decode_attn(dcfg, dev)
    model = build_model(variables, dcfg, dev)
    cache = init_cache(dcfg, b, max_len, keep_tp=tp, kv_quant=kv_quant,
                       device=dev)
    with bind_axis(mesh) if tp else contextlib.nullcontext():
        return _generate(model, cache, prompt, max_new_tokens, temperature,
                         rng, eos_id)


def _generate(model: Llama, cache: KVCache, prompt: torch.Tensor,
              max_new_tokens: int, temperature: float,
              rng: Optional[torch.Generator], eos_id: Optional[int]
              ) -> torch.Tensor:
    b = prompt.shape[0]
    dev = prompt.device
    logits, cache = prefill_cache(model, cache, prompt)
    tok = _sample(logits[:, -1], temperature, rng)
    out = [tok]
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(max_new_tokens - 1):
        last, cache = decode_token_step(model, cache, tok[:, None])
        nxt = _sample(last, temperature, rng)
        if eos_id is not None:
            # a row is done once it has EMITTED eos; its later positions
            # freeze to eos_id (the first eos itself is part of the
            # output)
            done = done | (tok == eos_id)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        tok = nxt
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)

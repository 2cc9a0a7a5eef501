"""Autoregressive generation with K/V caching.

Port of ``bluefog_tpu/models/generate.py``: ``decode_config``,
``init_cache``, ``prefill_cache``, ``decode_token_step`` and
``llama_generate``.  Deviations from the JAX package:

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
* Not ported yet: the tp-sharded decode (``keep_tp=True``,
  ``_tp_generate_program``), ``weight_quant`` (``QuantDense``), MoE
  decode and ``verify_window`` (speculative decoding).  They raise
  ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import torch

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.models.llama import (KVCache, Llama, LlamaConfig,
                                            require_ported)

__all__ = ["init_cache", "llama_generate", "decode_config",
           "prefill_cache", "decode_token_step", "build_model"]


def decode_config(cfg: LlamaConfig, max_len: int, *, keep_tp: bool = False,
                  kv_quant: str = "none", weight_quant: str = "none",
                  decode_attn: str = "auto") -> LlamaConfig:
    """The decode layout of ``cfg``: ``decode=True``, cache length
    ``max_len``, training-time knobs cleared (as in JAX).  Raises
    ``NotImplementedError`` for what the port does not serve yet."""
    if keep_tp:
        raise NotImplementedError(
            "tp-sharded decode (keep_tp=True) waits for the tp decode "
            "slice of bluefog_tpu_torch")
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE decode waits for the Llama-training slice of "
            "bluefog_tpu_torch")
    if decode_attn == "auto":
        decode_attn = "pallas"  # the port has one decode lowering
    dcfg = dataclasses.replace(
        cfg, decode=True, max_seq_len=max_len, attn_mode="full",
        attn_impl="xla", sp_axis=None, ep_axis=None, ep_size=1,
        remat=False, remat_policy="none", kv_quant=kv_quant,
        param_quant=weight_quant, decode_attn=decode_attn,
        vocab_parallel=False, tp_seq_shard=False, tp_axis=None, tp_size=1)
    require_ported(dcfg)
    return dcfg


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
    layout."""
    if keep_tp:
        raise NotImplementedError(
            "tp-sharded caches wait for the tp decode slice")
    if kv_quant not in ("none", "int8"):
        raise ValueError(f"kv_quant {kv_quant!r} not in ('none', 'int8')")
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_len,
             cfg.head_dim)
    index = torch.zeros(batch_size, dtype=torch.int32, device=dev)
    if kv_quant == "int8":
        return KVCache(
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(shape, dtype=torch.int8, device=dev), index,
            torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev), index)


def prefill_cache(model: Llama, cache: KVCache, tokens: torch.Tensor):
    """Cache-writing prefill: one multi-token forward writes ``tokens``'s
    K/V into ``cache`` at its current index.  Returns ``(logits, cache)``
    with logits ``[B, 1, V]`` (decode layout)."""
    return model(tokens, cache), cache


def decode_token_step(model: Llama, cache: KVCache, tok: torch.Tensor):
    """One incremental decode step: append ``tok [B, 1]``'s K/V and
    return ``(last_logits [B, V], cache)``."""
    return model(tok, cache)[:, -1], cache


def build_model(variables: Union[Llama, Mapping[str, torch.Tensor]],
                cfg: LlamaConfig, device: torch.device) -> Llama:
    """``variables`` as a :class:`Llama` on ``device``: a module is used
    as it is (its config must equal ``cfg``), a state dict is loaded into
    a new module."""
    if isinstance(variables, Llama):
        if variables.cfg != cfg:
            raise ValueError("the Llama module was built from another "
                             "config than the one given")
        if variables.device != device:
            raise ValueError(f"the Llama module lives on "
                             f"{variables.device}, not {device}")
        return variables
    model = Llama(cfg, device)
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
    generation."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens ({max_new_tokens}) must be >= 1")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (tp-sharded decode) waits for the tp decode slice")
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
    dcfg = decode_config(cfg, max_len, kv_quant=kv_quant,
                         weight_quant=weight_quant, decode_attn=decode_attn)
    check_decode_attn(dcfg, dev)
    model = build_model(variables, cfg, dev)
    cache = init_cache(dcfg, b, max_len, kv_quant=kv_quant, device=dev)

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

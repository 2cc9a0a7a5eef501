"""HuggingFace Llama checkpoint import.

Port of ``bluefog_tpu/interop/hf_llama.py``: :func:`llama_config_from_hf`
maps a ``transformers.LlamaConfig`` (or any object with its attributes,
such as a ``types.SimpleNamespace``) onto the port's
:class:`~bluefog_tpu_torch.models.LlamaConfig`, and
:func:`llama_params_from_hf` converts a ``LlamaForCausalLM``'s weights (the
model, or a mapping of torch tensors or numpy arrays in HF's names) into
the port's :class:`~bluefog_tpu_torch.models.Llama` state dict.  This
module never imports ``transformers``.

HF stores the q/k projections in the half-split rotary layout
(``rotate_half``); the port, like the JAX package and the original Meta
weights, rotates interleaved even/odd pairs, so the q/k rows are
inverse-permuted.  torch's ``Linear`` stores ``[out, in]`` and the port's
``Dense`` keeps flax's ``[in, out]``, so every projection is transposed.
The mapping is a pure permutation of the entries.

Deviations: the state dict's tensors keep their dtype unless ``dtype=``
is given (the JAX importer casts every leaf to f32 masters;
``Llama.load_state_dict`` casts into the parameters' storage either
way), and they land on ``device`` (default ``"cuda"``).  The scanned
layer layout has no counterpart: the port always keeps ``layers.{i}``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import torch

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.models.llama import LlamaConfig

__all__ = ["llama_config_from_hf", "llama_params_from_hf"]


def llama_config_from_hf(hf_config, **overrides) -> LlamaConfig:
    """Map a ``transformers.LlamaConfig`` (read with ``getattr``) onto the
    port's config.  Compute/layout knobs (dtype, attn_impl, ...) are
    orthogonal to the checkpoint and pass through ``overrides``.

    ``rope_type='llama3'`` scaling (Llama-3.1+) maps onto the model's
    ``rope_scaling_*`` fields; other scaling kinds and projection biases
    raise, since a silent pass-through would convert a checkpoint into a
    model whose logits quietly diverge from ``transformers``'."""
    rope_scaling = getattr(hf_config, "rope_scaling", None)
    scaling_fields = {}
    if rope_scaling not in (None, {}):
        kind = rope_scaling.get("rope_type",
                                rope_scaling.get("type", None))
        if kind == "default":
            pass  # explicit no-op scaling
        elif kind == "llama3":
            # all four sub-fields are required (transformers validates
            # them too): a guessed default would diverge silently
            required = ("factor", "low_freq_factor", "high_freq_factor",
                        "original_max_position_embeddings")
            missing = [k for k in required if k not in rope_scaling]
            if missing:
                raise ValueError(
                    f"rope_scaling={rope_scaling!r} is missing required "
                    f"llama3 field(s) {missing}; refusing to guess — "
                    "the scaled frequencies would silently diverge "
                    "from transformers'.")
            scaling_fields = dict(
                rope_scaling_kind="llama3",
                rope_scaling_factor=float(rope_scaling["factor"]),
                rope_scaling_low_freq_factor=float(
                    rope_scaling["low_freq_factor"]),
                rope_scaling_high_freq_factor=float(
                    rope_scaling["high_freq_factor"]),
                rope_scaling_original_max_len=int(
                    rope_scaling["original_max_position_embeddings"]))
        else:
            raise NotImplementedError(
                f"rope_scaling={rope_scaling!r} is not supported: only "
                "rope_type='llama3' (Llama-3.1 style) frequency scaling "
                "is implemented; other kinds would make the converted "
                "model's logits quietly diverge from transformers'.")
    for flag in ("attention_bias", "mlp_bias"):
        if getattr(hf_config, flag, False):
            raise NotImplementedError(
                f"{flag}=True is not supported: the port's projections "
                "are bias-free, so the bias tensors would be silently "
                "dropped.")
    base = dict(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        hidden_dim=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        norm_eps=float(hf_config.rms_norm_eps),
        **scaling_fields,
    )
    base.update(overrides)
    return LlamaConfig(**base)


def _unpermute_rotary(w: torch.Tensor, n_heads: int,
                      dim: int) -> torch.Tensor:
    """HF's converter permutes q/k rows from the interleaved rotary layout
    to its half-split one with ``w.view(H, hd//2, 2, D).transpose(1, 2)``;
    this is the inverse, restoring the interleaved pairing the port's
    rotary embedding uses."""
    out_dim = w.shape[0]
    hd = out_dim // n_heads
    return (w.reshape(n_heads, 2, hd // 2, dim).transpose(1, 2)
            .reshape(out_dim, dim))


def llama_params_from_hf(model_or_state_dict, cfg: LlamaConfig,
                         dtype: Optional[torch.dtype] = None,
                         device: Union[str, torch.device] = "cuda"
                         ) -> Dict[str, torch.Tensor]:
    """Convert HF ``LlamaForCausalLM`` weights (the model, or its state
    dict of torch tensors or numpy arrays) to the port's state dict for
    ``Llama(cfg)`` on ``device``, each tensor cast to ``dtype`` when it
    is given.  Tied embeddings (no ``lm_head.weight``) give the head the
    embedding's rows."""
    dev = resolve_device(device)
    sd: Mapping[str, Any]
    if hasattr(model_or_state_dict, "state_dict"):
        sd = model_or_state_dict.state_dict()
    else:
        sd = dict(model_or_state_dict)

    # per tensor, so the peak stays about one checkpoint tensor above the
    # checkpoint itself
    def take(name, transform=None):
        t = torch.as_tensor(sd[name]).to(dev)
        if dtype is not None:
            t = t.to(dtype)
        if transform is not None:
            t = transform(t)
        return t.contiguous()

    def kernel(name):  # torch Linear stores [out, in]; Dense [in, out]
        return take(name, lambda a: a.T)

    hd = cfg.head_dim
    q0 = sd["model.layers.0.self_attn.q_proj.weight"]
    k0 = sd["model.layers.0.self_attn.k_proj.weight"]
    if not (tuple(q0.shape) == (cfg.n_heads * hd, cfg.dim)
            and tuple(k0.shape) == (cfg.n_kv_heads * hd, cfg.dim)):
        raise ValueError(
            "state_dict geometry does not match cfg (heads/dim/kv_heads)")
    out = {"tok_embeddings.embedding": take("model.embed_tokens.weight")}
    for i in range(cfg.n_layers):
        hf, port = f"model.layers.{i}.", f"layers.{i}."
        out[port + "attention_norm.scale"] = take(
            hf + "input_layernorm.weight")
        out[port + "attention.wq.kernel"] = take(
            hf + "self_attn.q_proj.weight",
            lambda a: _unpermute_rotary(a, cfg.n_heads, cfg.dim).T)
        out[port + "attention.wk.kernel"] = take(
            hf + "self_attn.k_proj.weight",
            lambda a: _unpermute_rotary(a, cfg.n_kv_heads, cfg.dim).T)
        out[port + "attention.wv.kernel"] = kernel(
            hf + "self_attn.v_proj.weight")
        out[port + "attention.wo.kernel"] = kernel(
            hf + "self_attn.o_proj.weight")
        out[port + "ffn_norm.scale"] = take(
            hf + "post_attention_layernorm.weight")
        out[port + "feed_forward.w1.kernel"] = kernel(
            hf + "mlp.gate_proj.weight")
        out[port + "feed_forward.w3.kernel"] = kernel(
            hf + "mlp.up_proj.weight")
        out[port + "feed_forward.w2.kernel"] = kernel(
            hf + "mlp.down_proj.weight")
    out["norm.scale"] = take("model.norm.weight")
    head = ("lm_head.weight" if "lm_head.weight" in sd
            else "model.embed_tokens.weight")  # tied embeddings
    out["output.kernel"] = kernel(head)
    return out

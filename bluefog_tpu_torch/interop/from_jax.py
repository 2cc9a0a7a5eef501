"""The JAX package's model parameters as the port's state.

:func:`resnet_params_from_flax` carries a ResNet's ``params`` and
``batch_stats``, :func:`vit_params_from_flax` a ViT's and
:func:`mlp_params_from_flax` an ``MLP``'s or ``MnistNet``'s params (end
of the module); the rest of this docstring is Llama's.

:func:`llama_params_from_flax` takes the param tree of
``bluefog_tpu.models.Llama`` as numpy arrays (e.g.
``jax.tree.map(np.asarray, variables)``), in either layer layout:

* unrolled: ``layer_{i}/...`` subtrees;
* ``scan_layers=True``: one ``layers/block/...`` subtree whose leaves
  carry a leading ``[n_layers]`` axis (``nn.scan``, JAX llama.py).

An MoE config's layers carry ``moe_ffn/router/kernel`` and the expert
tensors ``moe_ffn/w1``, ``w3``, ``w2`` (leading ``[n_experts]`` axis) in
place of ``feed_forward``.

Flax path ``a/b/c`` becomes state-dict key ``a.b.c``, with ``layer_{i}``
(or row ``i`` of the scanned subtree) becoming ``layers.{i}``.  Dense
kernels KEEP flax's ``[in, out]`` layout: the port computes ``x @ kernel``
(``models/llama.py``'s ``Dense``), so nothing is transposed.  Arrays
keep their dtype; ``Llama.load_state_dict`` casts each into the
parameter's storage dtype.  A tree from the JAX package's
``quantize_llama_params`` carries ``{"kernel": int8, "scale": f32}``
per quantized module; it becomes the port's ``<module>.kernel`` (int8,
``[in, out]``) and ``<module>.scale``, the layout ``QuantDense`` loads.
This module imports numpy and torch only.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.models.llama import LlamaConfig
from bluefog_tpu_torch.models.quant import QUANT_KERNELS, is_quantized_params

__all__ = ["llama_params_from_flax", "llama_param_shapes",
           "resnet_params_from_flax", "vit_params_from_flax",
           "mlp_params_from_flax"]

_LAYER = re.compile(r"^layer_(\d+)$")


def llama_param_shapes(cfg: LlamaConfig,
                       quantized: bool = False) -> Dict[str, tuple]:
    """State-dict key -> shape of the port's :class:`Llama` for ``cfg``;
    ``quantized`` adds the per-output-channel ``scale`` of every module of
    :data:`~bluefog_tpu_torch.models.quant.QUANT_KERNELS` (the
    ``param_quant`` layout)."""
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    shapes = {"tok_embeddings.embedding": (cfg.vocab_size, cfg.dim),
              "norm.scale": (cfg.dim,),
              "output.kernel": (cfg.dim, cfg.vocab_size)}
    per_layer = {
        "attention_norm.scale": (cfg.dim,),
        "attention.wq.kernel": (cfg.dim, cfg.n_heads * hd),
        "attention.wk.kernel": (cfg.dim, kv * hd),
        "attention.wv.kernel": (cfg.dim, kv * hd),
        "attention.wo.kernel": (cfg.n_heads * hd, cfg.dim),
        "ffn_norm.scale": (cfg.dim,),
    }
    if cfg.n_experts:
        # the global expert tree: a checkpoint trained at ep_size > 1
        # has the same shapes, so it loads too
        E = cfg.n_experts
        per_layer.update({
            "moe_ffn.router.kernel": (cfg.dim, E),
            "moe_ffn.w1": (E, cfg.dim, cfg.ffn_dim),
            "moe_ffn.w3": (E, cfg.dim, cfg.ffn_dim),
            "moe_ffn.w2": (E, cfg.ffn_dim, cfg.dim)})
    else:
        per_layer.update({
            "feed_forward.w1.kernel": (cfg.dim, cfg.ffn_dim),
            "feed_forward.w3.kernel": (cfg.dim, cfg.ffn_dim),
            "feed_forward.w2.kernel": (cfg.ffn_dim, cfg.dim)})
    for i in range(cfg.n_layers):
        for k, shape in per_layer.items():
            shapes[f"layers.{i}.{k}"] = shape
    if quantized:
        for key, shape in list(shapes.items()):
            if key.endswith(".kernel") and key.split(".")[-2] in \
                    QUANT_KERNELS:
                shapes[key[:-len("kernel")] + "scale"] = shape[-1:]
    return shapes


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def llama_params_from_flax(params_np: Mapping, cfg: LlamaConfig,
                           device: Union[str, torch.device] = "cuda"
                           ) -> Dict[str, torch.Tensor]:
    """Convert the JAX Llama param tree (``{"params": ...}`` or the bare
    tree, numpy leaves; full precision or ``quantize_llama_params``'s int8
    layout) to the port's state dict on ``device``.  Raises
    ``ValueError`` on a missing, extra or misshapen parameter."""
    dev = resolve_device(device)
    tree = params_np.get("params", params_np)
    flat: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(tree):
        if path[:2] == ("layers", "block"):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{'/'.join(path)}: scanned axis "
                                 f"{arr.shape[0]} != n_layers "
                                 f"{cfg.n_layers}")
            rest = ".".join(path[2:])
            for i in range(arr.shape[0]):
                flat[f"layers.{i}.{rest}"] = arr[i]
            continue
        m = _LAYER.match(path[0])
        if m:
            path = ("layers", m.group(1)) + path[1:]
        flat[".".join(path)] = arr
    want = llama_param_shapes(cfg, quantized=is_quantized_params(flat))
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"param tree does not match the config: missing "
                         f"{missing[:4]}, unexpected {extra[:4]}")
    for key, shape in want.items():
        if flat[key].shape != shape:
            raise ValueError(f"{key}: shape {flat[key].shape} != {shape}")
    # np.array copies: jax-backed leaves are read-only buffers
    return {key: torch.from_numpy(np.array(flat[key])).to(dev)
            for key in want}


# flax's auto-name of a bottleneck's expansion conv, by pallas_conv1x1
_EXPAND = {False: "Conv_2", True: "_PallasConv1x1_0"}


def resnet_params_from_flax(variables_np: Mapping, model,
                            device: Union[str, torch.device] = "cuda"
                            ) -> Tuple[Dict[str, torch.Tensor],
                                       Dict[str, torch.Tensor]]:
    """Convert the JAX ResNet's variables (``{"params": ...,
    "batch_stats": ...}``, numpy leaves) to the port's ``(params,
    batch_stats)`` dicts for ``model`` (a
    :class:`bluefog_tpu_torch.models.ResNet`), on ``device``.

    Flax path ``a/b/c`` becomes key ``a.b.c``; conv kernels go from HWIO
    to OIHW, Dense kernels keep ``[in, out]``.  Either ``pallas_conv1x1``
    naming of the flax tree is taken: a bottleneck's expansion conv
    (``Conv_2`` without it, ``_PallasConv1x1_0`` with it) is renamed to
    the model's.  Raises ``ValueError`` on a missing, extra or misshapen
    entry."""
    dev = resolve_device(device)
    want = getattr(model, "pallas_conv1x1", False)
    out = []
    for coll, ref in (("params", dict(model.named_parameters())),
                      ("batch_stats", dict(model.named_buffers()))):
        flat: Dict[str, np.ndarray] = {}
        for path, arr in _flatten(variables_np.get(coll, {})):
            path = tuple(_EXPAND[want] if p == _EXPAND[not want] else p
                         for p in path)
            if arr.ndim == 4:               # conv kernel, HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            flat[".".join(path)] = arr
        out.append(_match(flat, ref, coll, dev))
    return out[0], out[1]


def _match(flat: Dict[str, np.ndarray], ref: Mapping[str, torch.Tensor],
           coll: str, dev: torch.device) -> Dict[str, torch.Tensor]:
    """``flat`` (key -> array) as f32 tensors on ``dev`` in ``ref``'s
    order, after checking that the keys and shapes are ``ref``'s."""
    missing = sorted(set(ref) - set(flat))
    extra = sorted(set(flat) - set(ref))
    if missing or extra:
        raise ValueError(f"{coll} do not match the model: missing "
                         f"{missing[:4]}, unexpected {extra[:4]}")
    for key, t in ref.items():
        if tuple(flat[key].shape) != tuple(t.shape):
            raise ValueError(f"{coll} {key}: shape {flat[key].shape} "
                             f"!= {tuple(t.shape)}")
    # np.array copies: jax-backed leaves are read-only buffers
    return {key: torch.from_numpy(np.array(flat[key], np.float32)).to(dev)
            for key in ref}


def vit_params_from_flax(variables_np: Mapping, model,
                         device: Union[str, torch.device] = "cuda"
                         ) -> Dict[str, torch.Tensor]:
    """Convert the JAX ViT's params (``{"params": ...}`` or the bare tree,
    numpy leaves) to the state dict of ``model`` (a
    :class:`bluefog_tpu_torch.models.ViT`) on ``device``.  Flax path
    ``a/b/c`` becomes key ``a.b.c``; nothing is transposed (the port
    keeps the patch kernel HWIO and Dense kernels ``[in, out]``).
    Raises ``ValueError`` on a missing, extra or misshapen entry."""
    tree = variables_np.get("params", variables_np)
    flat = {".".join(path): arr for path, arr in _flatten(tree)}
    return _match(flat, dict(model.named_parameters()), "params",
                  resolve_device(device))


def mlp_params_from_flax(variables_np: Mapping, model,
                         device: Union[str, torch.device] = "cuda"
                         ) -> Dict[str, torch.Tensor]:
    """Convert the JAX ``MLP``'s or ``MnistNet``'s params (numpy leaves)
    to the state dict of ``model`` (the port's :class:`~bluefog_tpu_torch.
    models.MLP` or :class:`~bluefog_tpu_torch.models.MnistNet`) on
    ``device``: conv kernels go from HWIO to OIHW, Dense kernels keep
    ``[in, out]``.  Raises ``ValueError`` on a missing, extra or
    misshapen entry."""
    tree = variables_np.get("params", variables_np)
    flat = {".".join(path): arr.transpose(3, 2, 0, 1) if arr.ndim == 4
            else arr for path, arr in _flatten(tree)}
    return _match(flat, dict(model.named_parameters()), "params",
                  resolve_device(device))

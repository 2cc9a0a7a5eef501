"""The JAX package's Llama parameters as the port's state dict.

:func:`llama_params_from_flax` takes the param tree of
``bluefog_tpu.models.Llama`` as numpy arrays (e.g.
``jax.tree.map(np.asarray, variables)``), in either layer layout:

* unrolled: ``layer_{i}/...`` subtrees;
* ``scan_layers=True``: one ``layers/block/...`` subtree whose leaves
  carry a leading ``[n_layers]`` axis (``nn.scan``, JAX llama.py).

Flax path ``a/b/c`` becomes state-dict key ``a.b.c``, with ``layer_{i}``
(or row ``i`` of the scanned subtree) becoming ``layers.{i}``.  Dense
kernels KEEP flax's ``[in, out]`` layout: the port computes ``x @ kernel``
(``models/llama.py``'s ``Dense``), so nothing is transposed.  Arrays
keep their dtype; ``Llama.load_state_dict`` casts each into the
parameter's storage dtype.  This module imports numpy and torch only.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Union

import numpy as np
import torch

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.models.llama import LlamaConfig

__all__ = ["llama_params_from_flax", "llama_param_shapes"]

_LAYER = re.compile(r"^layer_(\d+)$")


def llama_param_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    """State-dict key -> shape of the port's :class:`Llama` for ``cfg``."""
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
        "feed_forward.w1.kernel": (cfg.dim, cfg.ffn_dim),
        "feed_forward.w3.kernel": (cfg.dim, cfg.ffn_dim),
        "feed_forward.w2.kernel": (cfg.ffn_dim, cfg.dim),
    }
    for i in range(cfg.n_layers):
        for k, shape in per_layer.items():
            shapes[f"layers.{i}.{k}"] = shape
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
    tree, numpy leaves) to the port's state dict on ``device``.  Raises
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
    want = llama_param_shapes(cfg)
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

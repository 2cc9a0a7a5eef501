"""Model zoo of the port (``bluefog_tpu.models``'s counterpart).

This slice ports the Llama decoder's decode layout and generation;
ResNet, MLP, ViT and the Llama training losses wait for later slices
(ROADMAP.md).
"""

from bluefog_tpu_torch.models.llama import KVCache, Llama, LlamaConfig
from bluefog_tpu_torch.models.generate import (decode_config, init_cache,
                                               llama_generate)

__all__ = ["Llama", "LlamaConfig", "KVCache", "llama_generate",
           "init_cache", "decode_config"]

"""Model zoo of the port (``bluefog_tpu.models``'s counterpart).

Ported so far: the Llama decoder's decode layout and generation (slice
1), the ResNet family (slice 2), and the Llama training forward with
its losses (slice 3).  MLP and ViT wait for later slices (ROADMAP.md).
"""

from bluefog_tpu_torch.models.llama import (KVCache, Llama, LlamaConfig,
                                            chunked_xent,
                                            llama_chunked_xent_loss_fn,
                                            llama_loss_fn)
from bluefog_tpu_torch.models.generate import (decode_config, init_cache,
                                               llama_generate)
from bluefog_tpu_torch.models.resnet import (BasicBlock, BottleneckBlock,
                                             ResNet, ResNet18, ResNet34,
                                             ResNet50, ResNet101, ResNet152)

__all__ = ["Llama", "LlamaConfig", "KVCache", "llama_loss_fn",
           "chunked_xent", "llama_chunked_xent_loss_fn", "llama_generate",
           "init_cache", "decode_config", "ResNet", "BasicBlock",
           "BottleneckBlock", "ResNet18", "ResNet34", "ResNet50",
           "ResNet101", "ResNet152"]

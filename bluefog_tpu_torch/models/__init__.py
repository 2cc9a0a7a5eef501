"""Model zoo of the port (``bluefog_tpu.models``'s counterpart).

Ported: the Llama decoder's decode layout and generation (slice 1), the
ResNet family (slice 2), the Llama training forward with its losses
(slice 3; splash attention and ``remat_policy="dots"`` in slice 4), and
the ViT family, ``MLP`` and ``MnistNet`` (slice 4): the whole zoo; and
the int8 weight layouts of serving (``quantize_llama_params``, slice
11); and the model axes (slice 17): tensor parallelism with
``vocab_parallel`` and ``tp_seq_shard``, experts over an ep axis, TP
decode, ``llama_param_specs`` and ``vocab_parallel_xent``; and the
pipeline (slice 18): ``llama_pp_loss_fn``, ``llama_circular_layout`` and
``llama_param_specs(pp_axis=)``.
"""

from bluefog_tpu_torch.models.llama import (KVCache, Llama, LlamaConfig,
                                            chunked_xent,
                                            llama_chunked_xent_loss_fn,
                                            llama_circular_layout,
                                            llama_loss_fn,
                                            llama_param_specs,
                                            llama_pp_loss_fn,
                                            vocab_parallel_xent)
from bluefog_tpu_torch.models.generate import (decode_config, init_cache,
                                               llama_generate)
from bluefog_tpu_torch.models.quant import quantize_llama_params
from bluefog_tpu_torch.models.mlp import MLP, MnistNet
from bluefog_tpu_torch.models.resnet import (BasicBlock, BottleneckBlock,
                                             ResNet, ResNet18, ResNet34,
                                             ResNet50, ResNet101, ResNet152)
from bluefog_tpu_torch.models.vit import ViT, ViT_B16, ViT_S16, ViTConfig

__all__ = ["Llama", "LlamaConfig", "KVCache", "llama_loss_fn",
           "chunked_xent", "llama_chunked_xent_loss_fn", "llama_generate",
           "llama_param_specs", "vocab_parallel_xent", "llama_pp_loss_fn",
           "llama_circular_layout",
           "init_cache", "decode_config", "quantize_llama_params",
           "ResNet", "BasicBlock",
           "BottleneckBlock", "ResNet18", "ResNet34", "ResNet50",
           "ResNet101", "ResNet152", "ViT", "ViTConfig", "ViT_S16",
           "ViT_B16", "MLP", "MnistNet"]

"""Bridges into the port: the JAX package's Llama, ResNet, ViT and MLP
parameters as port state (``from_jax``), and HuggingFace Llama
checkpoints (``hf_llama``)."""

from bluefog_tpu_torch.interop.hf_llama import (llama_config_from_hf,
                                                llama_params_from_hf)
from bluefog_tpu_torch.interop.from_jax import (llama_param_shapes,
                                                llama_params_from_flax,
                                                mlp_params_from_flax,
                                                resnet_params_from_flax,
                                                vit_params_from_flax)

__all__ = ["llama_params_from_flax", "llama_param_shapes",
           "resnet_params_from_flax", "vit_params_from_flax",
           "mlp_params_from_flax", "llama_config_from_hf",
           "llama_params_from_hf"]

"""Bridges into the port: the JAX package's Llama, ResNet, ViT and MLP
parameters as port state (``from_jax``), HuggingFace Llama checkpoints
(``hf_llama``), and TensorFlow tensors over the port's eager ops
(``interop.tf`` / ``bluefog_tpu_torch.interop.tf_adapter``, imported on
first use so that this package does not load tensorflow)."""

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


def __getattr__(name):
    # PEP 562 lazy import: touching interop.tf / TFAdapter is what pays
    # TensorFlow's multi-second import, not `import
    # bluefog_tpu_torch.interop`.  importlib (not `from ... import`)
    # avoids re-entering this hook.
    if name in ("tf", "tf_adapter"):
        import importlib

        return importlib.import_module(
            "bluefog_tpu_torch.interop.tf_adapter")
    if name == "TFAdapter":
        import importlib

        mod = importlib.import_module("bluefog_tpu_torch.interop.tf_adapter")
        return mod.TFAdapter
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

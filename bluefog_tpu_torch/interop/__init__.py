"""Bridges into the port: the JAX package's Llama parameters as a port
state dict (``from_jax``).  The HF importer waits for a later slice."""

from bluefog_tpu_torch.interop.from_jax import (llama_param_shapes,
                                                llama_params_from_flax)

__all__ = ["llama_params_from_flax", "llama_param_shapes"]

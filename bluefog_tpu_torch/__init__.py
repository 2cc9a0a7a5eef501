"""bluefog_tpu_torch — the PyTorch/CUDA port of ``bluefog_tpu``.

A second package beside the JAX one, with the same module paths, run on
an NVIDIA H100.  It imports torch and numpy, never jax or the JAX
package.  This slice serves Llama through the continuous-batching
engine (``serving``, ``models``), with the decode-attention kernel
(``parallel.decode_attention``, CUDA source in ``csrc/``).  Entry points
take ``device=`` (default ``"cuda"``) and raise without CUDA unless
``device="cpu"`` is passed.
"""

from bluefog_tpu_torch import models, serving  # noqa: F401
from bluefog_tpu_torch.models import (Llama, LlamaConfig, init_cache,
                                      llama_generate)
from bluefog_tpu_torch.serving import Request, ServingEngine

__all__ = ["models", "serving", "Llama", "LlamaConfig", "init_cache",
           "llama_generate", "Request", "ServingEngine"]

"""bluefog_tpu_torch — the PyTorch/CUDA port of ``bluefog_tpu``.

A second package beside the JAX one, with the same module paths, run on
an NVIDIA H100.  It imports torch and numpy, never jax, networkx or the
JAX package.  Ported so far: serving Llama through the
continuous-batching engine (``serving``, ``models``, kernel
``parallel.decode_attention``), and decentralized training
(``topology``, ``parallel.collectives``, ``optim.build_train_step``)
of the ResNet family (``models.resnet``, kernel ``parallel.conv1x1``)
and of Llama (``models.llama``'s training forward and
``llama_loss_fn``, kernels ``parallel.flash_attention`` and
``parallel.splash``), ViT (``models.vit``), ``MLP`` and ``MnistNet``.
CUDA sources live in ``csrc/``.  Entry points take ``device=`` (default
``"cuda"``) and raise without CUDA unless ``device="cpu"`` is passed.
"""

from bluefog_tpu_torch import models, optim, serving, topology  # noqa: F401
from bluefog_tpu_torch.models import (MLP, Llama, LlamaConfig, MnistNet,
                                      ResNet, ResNet18, ResNet34, ResNet50,
                                      ResNet101, ResNet152, ViT, ViT_B16,
                                      ViT_S16, ViTConfig, init_cache,
                                      llama_generate, llama_loss_fn)
from bluefog_tpu_torch.optim import (build_train_step, consensus_distance,
                                     rank_major)
from bluefog_tpu_torch.parallel.collectives import StackedBackend
from bluefog_tpu_torch.serving import Request, ServingEngine
from bluefog_tpu_torch.topology import (ExponentialTwoGraph, Topology,
                                        DynamicTopology,
                                        one_peer_dynamic_schedule,
                                        uniform_topology_spec)

__all__ = ["models", "optim", "serving", "topology", "Llama",
           "LlamaConfig", "init_cache", "llama_generate", "llama_loss_fn",
           "Request",
           "ServingEngine", "ResNet", "ResNet18", "ResNet34", "ResNet50",
           "ResNet101", "ResNet152", "ViT", "ViTConfig", "ViT_S16",
           "ViT_B16", "MLP", "MnistNet", "build_train_step", "rank_major",
           "consensus_distance", "StackedBackend", "ExponentialTwoGraph",
           "Topology", "DynamicTopology", "one_peer_dynamic_schedule",
           "uniform_topology_spec"]

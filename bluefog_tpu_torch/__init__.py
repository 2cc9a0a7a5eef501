"""bluefog_tpu_torch — the PyTorch/CUDA port of ``bluefog_tpu``.

A second package beside the JAX one, with the same module paths, run on
an NVIDIA H100.  It imports torch and numpy, never jax, networkx or the
JAX package.  Its public surface is the JAX package's eager,
BlueFog-compatible API (``api``, re-exported here: ``bf.init(size=,
device=)``, ``bf.neighbor_allreduce``, ``bf.win_put``, ... on rank-major
tensors of ``size`` ranks stacked on one card, or, under the ``bfrun``
launcher ``python -m bluefog_tpu_torch.run``, of each process's ranks in
a ``torch.distributed`` job; ``context``, ``windows``) and its optimizer
wrappers (``optim.wrappers``).  Ported so far: serving Llama through the
continuous-batching engine (``serving``, ``models``, kernel
``parallel.decode_attention``), and decentralized training
(``topology``, ``parallel.collectives``, ``optim.build_train_step``)
of the ResNet family (``models.resnet``, kernel ``parallel.conv1x1``)
and of Llama (``models.llama``'s training forward and
``llama_loss_fn``, kernels ``parallel.flash_attention`` and
``parallel.splash``; sequence parallelism over a ``SeqAxis``:
``parallel.ring_attention``, ``parallel.ulysses``), ViT
(``models.vit``), ``MLP`` and ``MnistNet``,
with the train step's decentralized modes (the skip guard, health
telemetry, bucketed overlap, the int8 and stochastic-rounding wires,
error-feedback top-k mixing, the hierarchical exchange and push-sum),
the serving fleet's router over gossiped gauges (``serving.FleetRouter``),
observability (``observe``: metrics, spans, exporters, fleet
aggregation, the step profiler), the input pipeline (``data``: the
sampler, the native loader, ``device_prefetch``), checkpoints
(``checkpoint.Checkpointer``) and fault-tolerant training
(``resilience``: fault plans, the failure detector, healing,
``run_resilient``; ``elastic``: membership and rejoin), the routed
mixture-of-experts Llama (``models.llama``'s ``MoEFeedForward``, its
dropless decode) and the expert-sharded step over the compiled
all-to-all (``moe``, ``optim.MoEConfig``, ``topology.torus``,
``topology.compiler``), the closed-loop topology control plane
(``topology.TopologyControlPlane``, ``run_resilient(control=)``) and the
fleet simulator (``sim``, with the arrival generators of
``benchutil``).  CUDA sources live in ``csrc/``.  Entry points
take ``device=`` (default ``"cuda"``) and raise without CUDA unless
``device="cpu"`` is passed.
"""

from bluefog_tpu_torch.version import __version__
from bluefog_tpu_torch import models, optim, serving, topology  # noqa: F401
# Flat API re-exports (reference: bluefog/torch/__init__.py:34-110).
from bluefog_tpu_torch.api import (  # noqa: F401
    init, shutdown, is_initialized, size, local_size, rank, local_rank,
    machine_size, machine_rank, load_topology, set_topology,
    is_topo_weighted, load_machine_topology, set_machine_topology,
    is_machine_topo_weighted, in_neighbor_ranks, out_neighbor_ranks,
    in_neighbor_machine_ranks, out_neighbor_machine_ranks, is_homogeneous,
    suspend, resume, set_skip_negotiate_stage, get_skip_negotiate_stage,
    mpi_threads_supported, unified_mpi_window_model_supported, nccl_built,
    # collectives
    allreduce, allreduce_nonblocking, allreduce_, allreduce_nonblocking_,
    allgather, allgather_nonblocking, broadcast, broadcast_nonblocking,
    broadcast_, broadcast_nonblocking_, neighbor_allgather,
    neighbor_allgather_nonblocking, neighbor_allreduce,
    neighbor_allreduce_nonblocking, hierarchical_neighbor_allreduce,
    hierarchical_neighbor_allreduce_nonblocking, pair_gossip,
    pair_gossip_nonblocking, barrier, poll, synchronize, wait,
    # windows
    win_create, win_free, win_update, win_update_then_collect, win_put,
    win_put_nonblocking, win_get, win_get_nonblocking, win_accumulate,
    win_accumulate_nonblocking, win_set_value, win_wait, win_poll,
    win_mutex, win_lock, win_unlock, win_fence, get_win_version,
    get_current_created_window_names, win_associated_p,
    turn_on_win_ops_with_associated_p, turn_off_win_ops_with_associated_p,
    # timeline
    timeline_start_activity, timeline_end_activity, timeline_context,
    # rank-major tensor helpers
    rank_sharded, from_rank_values, to_rank_values,
)
from bluefog_tpu_torch.utility import (  # noqa: F401
    allreduce_parameters, broadcast_optimizer_state, broadcast_parameters)
from bluefog_tpu_torch.compressor import (  # noqa: F401
    CompressedOptimizer, QuantizedCompressor, RandomKCompressor,
    TopKCompressor)
from bluefog_tpu_torch.optim.wrappers import (  # noqa: F401
    CommunicationType, DistributedAdaptThenCombineOptimizer,
    DistributedAdaptWithCombineOptimizer, DistributedAllreduceOptimizer,
    DistributedGradientAllreduceOptimizer,
    DistributedHierarchicalNeighborAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer, DistributedPullGetOptimizer,
    DistributedPushSumOptimizer, DistributedWinPutOptimizer)
from bluefog_tpu_torch.models import (MLP, Llama, LlamaConfig, MnistNet,
                                      ResNet, ResNet18, ResNet34, ResNet50,
                                      ResNet101, ResNet152, ViT, ViT_B16,
                                      ViT_S16, ViTConfig, init_cache,
                                      llama_generate, llama_loss_fn)
from bluefog_tpu_torch.optim import (GuardConfig, HealthConfig,
                                     HealthVector, MixCompressConfig,
                                     MixState, build_train_step,
                                     consensus_distance, push_sum_weights,
                                     rank_major)
from bluefog_tpu_torch.parallel.collectives import (ProcessBackend, SeqAxis,
                                                    StackedBackend,
                                                    bind_axis)
from bluefog_tpu_torch.serving import Request, ServingEngine
from bluefog_tpu_torch import checkpoint, data, elastic, resilience  # noqa: F401
from bluefog_tpu_torch.data import (DataLoader, DistributedSampler,  # noqa: F401
                                    device_prefetch, load_cifar10,
                                    load_mnist)
from bluefog_tpu_torch import moe  # noqa: F401
from bluefog_tpu_torch.optim.functional import MoEConfig
from bluefog_tpu_torch.topology import (ExponentialTwoGraph, Topology,
                                        DynamicTopology,
                                        default_pod_schedule,
                                        InferDestinationFromSourceRanks,
                                        InferSourceFromDestinationRanks,
                                        one_peer_dynamic_schedule,
                                        uniform_topology_spec)


__all__ = ["__version__", "models", "optim", "serving", "topology", "Llama",
           "LlamaConfig", "init_cache", "llama_generate", "llama_loss_fn",
           "Request",
           "ServingEngine", "ResNet", "ResNet18", "ResNet34", "ResNet50",
           "ResNet101", "ResNet152", "ViT", "ViTConfig", "ViT_S16",
           "ViT_B16", "MLP", "MnistNet", "build_train_step", "rank_major",
           "consensus_distance", "push_sum_weights", "GuardConfig",
           "HealthConfig", "HealthVector", "MixCompressConfig", "MixState",
           "StackedBackend", "ProcessBackend", "SeqAxis", "bind_axis",
           "ExponentialTwoGraph",
           "Topology", "DynamicTopology", "one_peer_dynamic_schedule",
           "uniform_topology_spec", "InferDestinationFromSourceRanks",
           "InferSourceFromDestinationRanks", "checkpoint", "data",
           "elastic", "resilience", "DataLoader", "DistributedSampler",
           "device_prefetch", "load_mnist", "load_cifar10", "moe",
           "MoEConfig", "default_pod_schedule"]

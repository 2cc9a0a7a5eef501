"""Decentralized optimizers of the port (``bluefog_tpu.optim``'s
counterpart): the eager ``torch.optim`` wrappers over the ``bf.*`` API
(``wrappers``: gradient allreduce, CTA, ATC, win-put, pull-get,
push-sum), the functional train step over the stacked and process
backends with every mode of the JAX builder, sequence parallelism
(``sp_axis``), the model axes (``mesh_axes``, ``param_specs``,
``opt_state_specs``, with ``rank_major_init``, ``rank_spec_tree`` and
``optax_state_specs``), the pipeline (``pp_axis``) and the
expert-sharded MoE step (``moe=``, with :class:`MoEConfig`, also over
``sp_axis``), and the shared bucket planner (``fusion``)."""

from bluefog_tpu_torch.optim import functional, fusion, wrappers  # noqa: F401
from bluefog_tpu_torch.optim.functional import (ELEMENTWISE_OPTIMIZERS,
                                                GuardConfig, HealthConfig,
                                                HealthVector,
                                                MixCompressConfig, MixState,
                                                MoEConfig, build_train_step,
                                                comm_weight_inputs,
                                                consensus_distance,
                                                optax_state_specs,
                                                push_sum_weights,
                                                rank_major, rank_major_init,
                                                rank_spec_tree)
from bluefog_tpu_torch.optim.fusion import (FusionPlan, plan_groups,
                                            size_balanced_threshold)
from bluefog_tpu_torch.optim.wrappers import (
    CommunicationType, DistributedAdaptThenCombineOptimizer,
    DistributedAdaptWithCombineOptimizer, DistributedAllreduceOptimizer,
    DistributedGradientAllreduceOptimizer,
    DistributedHierarchicalNeighborAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer, DistributedPullGetOptimizer,
    DistributedPushSumOptimizer, DistributedWinPutOptimizer)

__all__ = ["functional", "fusion", "wrappers", "CommunicationType",
           "DistributedGradientAllreduceOptimizer",
           "DistributedAdaptWithCombineOptimizer",
           "DistributedAdaptThenCombineOptimizer",
           "DistributedAllreduceOptimizer",
           "DistributedNeighborAllreduceOptimizer",
           "DistributedHierarchicalNeighborAllreduceOptimizer",
           "DistributedWinPutOptimizer", "DistributedPullGetOptimizer",
           "DistributedPushSumOptimizer", "build_train_step", "rank_major",
           "rank_major_init", "rank_spec_tree", "optax_state_specs",
           "consensus_distance", "comm_weight_inputs", "push_sum_weights",
           "GuardConfig", "HealthConfig", "HealthVector",
           "MixCompressConfig", "MixState", "MoEConfig",
           "ELEMENTWISE_OPTIMIZERS",
           "FusionPlan", "plan_groups", "size_balanced_threshold"]

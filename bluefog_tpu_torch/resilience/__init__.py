"""Resilience subsystem: fault injection, failure detection, topology
healing, and guarded-rollback training.

Port of ``bluefog_tpu.resilience``, exporting what the JAX package's
does.  Faults change a guarded step's *inputs* (the batch, the combine
weights), never the step:

* :mod:`~bluefog_tpu_torch.resilience.faults` — deterministic fault plans
  (NaN/Inf gradient bursts, rank death, preemption, host stalls) injected
  through the batch, and the serving plans of
  :mod:`bluefog_tpu_torch.serving.resilience`;
* :mod:`~bluefog_tpu_torch.resilience.detector` — per-rank numeric health
  from the guard's isfinite reduce + process liveness from the heartbeat
  beacons;
* :mod:`~bluefog_tpu_torch.resilience.healing` — dead-rank excision as a
  weight re-planning problem: row-stochasticity-preserving healed
  weights delivered as the guarded step's ``comm_weights`` data;
* :mod:`~bluefog_tpu_torch.resilience.runner` — ``run_resilient``, the
  skip -> detect -> heal -> rollback-with-backoff control loop over the
  :class:`~bluefog_tpu_torch.checkpoint.Checkpointer`.

The step half lives in ``optim.functional``:
``build_train_step(..., guard=GuardConfig(...))``.  The GROWTH
direction of the lifecycle — ranks that join back, with quarantined
bootstrap and the exact inverse of healing — is the sibling package
:mod:`bluefog_tpu_torch.elastic` (``run_resilient(elastic=...)``).
"""

from bluefog_tpu_torch.optim.functional import (  # noqa: F401
    GuardConfig,
    comm_weight_inputs,
)
from bluefog_tpu_torch.resilience.faults import (  # noqa: F401
    Fault,
    FaultPlan,
    PREEMPT,
    ServingFault,
    ServingFaultPlan,
)
from bluefog_tpu_torch.resilience.detector import (  # noqa: F401
    FailureDetector,
    update_health,
)
from bluefog_tpu_torch.resilience.healing import (  # noqa: F401
    consensus_simulation,
    heal_spec,
    heal_weights,
    healed_comm_weights,
    is_row_stochastic,
    mixing_matrix,
    mixing_matrix_from_weights,
    row_sums,
)
from bluefog_tpu_torch.resilience.runner import (  # noqa: F401
    ResilienceEvent,
    ResilientResult,
    run_resilient,
)
# the growth direction of the lifecycle rides run_resilient(elastic=...),
# so its config is part of this package's surface too
from bluefog_tpu_torch.elastic.membership import ElasticConfig  # noqa: F401

__all__ = [
    "ElasticConfig",
    "GuardConfig",
    "comm_weight_inputs",
    "Fault",
    "FaultPlan",
    "PREEMPT",
    "ServingFault",
    "ServingFaultPlan",
    "FailureDetector",
    "update_health",
    "consensus_simulation",
    "heal_spec",
    "heal_weights",
    "healed_comm_weights",
    "is_row_stochastic",
    "mixing_matrix",
    "mixing_matrix_from_weights",
    "row_sums",
    "ResilienceEvent",
    "ResilientResult",
    "run_resilient",
]

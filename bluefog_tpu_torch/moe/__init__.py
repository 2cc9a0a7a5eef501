"""Mixture-of-experts expert parallelism over the compiled all-to-all.

Port of ``bluefog_tpu/moe``.  The topology compiler synthesizes the
dispatch schedule
(:func:`bluefog_tpu_torch.topology.compiler.compile_all_to_all`); this
package is the workload side: :mod:`bluefog_tpu_torch.moe.dispatch`
lowers a schedule to the permutes the compiler predicted, run through a
rank backend, and owns the ``(route_table, capacity_mask)`` resilience
data, and :mod:`bluefog_tpu_torch.moe.layer` is a small top-1-routed
expert layer with capacity-factor overflow as data.  Expert weights stay
rank-local; everything else mixes through the ordinary
``build_train_step(..., moe=MoEConfig(...))`` combine.
"""

from bluefog_tpu_torch.moe.dispatch import (
    DispatchPlan,
    all_to_all_dispatch,
    capacity_mask_of,
    default_route_table,
    dispatch_plan,
    expert_owner,
    heal_route_table,
    naive_all_to_all,
)
from bluefog_tpu_torch.moe.layer import (
    default_capacity,
    init_moe_params,
    make_moe_loss,
    moe_apply,
)

__all__ = [
    "DispatchPlan",
    "all_to_all_dispatch",
    "capacity_mask_of",
    "default_route_table",
    "dispatch_plan",
    "expert_owner",
    "heal_route_table",
    "naive_all_to_all",
    "default_capacity",
    "init_moe_params",
    "make_moe_loss",
    "moe_apply",
]

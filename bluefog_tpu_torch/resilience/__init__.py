"""Deterministic serving fault plans (``bluefog_tpu.resilience``'s
:mod:`~bluefog_tpu_torch.resilience.faults`, its serving half) that
:mod:`bluefog_tpu_torch.serving.resilience` injects.  The training plans,
detection, healing and the resilient runner wait for ROADMAP.md Queue 1,
item 12.
"""

from bluefog_tpu_torch.resilience.faults import (ServingFault,
                                                 ServingFaultPlan)

__all__ = ["ServingFault", "ServingFaultPlan"]

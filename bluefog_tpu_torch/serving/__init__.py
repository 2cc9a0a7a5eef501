"""Continuous-batching serving engine (``bluefog_tpu.serving``'s
counterpart): the slot-pooled engine, its scheduler, pool and metrics.
The prefix cache, speculative decoding, the fleet router and serving
resilience wait for later slices (ROADMAP.md).
"""

from bluefog_tpu_torch.serving.engine import (Request, RequestRejected,
                                              ServingEngine)
from bluefog_tpu_torch.serving.kv_pool import SlotPool
from bluefog_tpu_torch.serving.metrics import ServingMetrics, percentile
from bluefog_tpu_torch.serving.scheduler import FifoScheduler

__all__ = ["ServingEngine", "Request", "RequestRejected", "SlotPool",
           "FifoScheduler", "ServingMetrics", "percentile"]

"""Continuous-batching serving engine (``bluefog_tpu.serving``'s
counterpart): the slot-pooled engine with speculative decoding and
drain, its scheduler, pool and metrics, the chunk-hashed prefix cache,
serving resilience (fault injection around an engine, token-exact
failover, seeded backoff), and the decentralized fleet router over
gossiped gauges (``FleetRouter``).
"""

from bluefog_tpu_torch.serving.engine import (Request, RequestRejected,
                                              ServingEngine,
                                              SpeculativeConfig)
from bluefog_tpu_torch.serving.fleet import (SIGNAL_NAMES, FleetRouter,
                                             FleetSaturated, RouterSnapshot,
                                             collect_serving_signals)
from bluefog_tpu_torch.serving.kv_pool import SlotPool
from bluefog_tpu_torch.serving.metrics import ServingMetrics, percentile
from bluefog_tpu_torch.serving.prefix_cache import PrefixCache
from bluefog_tpu_torch.serving.resilience import (FaultyReplica,
                                                  backoff_sleep,
                                                  failover_stranded,
                                                  seeded_backoff)
from bluefog_tpu_torch.serving.scheduler import FifoScheduler

__all__ = ["ServingEngine", "Request", "RequestRejected",
           "SpeculativeConfig", "SlotPool", "PrefixCache", "FifoScheduler",
           "ServingMetrics", "percentile", "FaultyReplica",
           "failover_stranded", "seeded_backoff", "backoff_sleep",
           "FleetRouter", "FleetSaturated", "RouterSnapshot",
           "collect_serving_signals", "SIGNAL_NAMES"]

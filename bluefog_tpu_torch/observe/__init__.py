"""Observability of the port: the metrics registry and the span tracer
(copies of ``bluefog_tpu.observe.registry``/``tracer``).  The step
profiler, exporters, fleet aggregation and the flight recorder wait for
later slices.  Opt out of publication with ``BLUEFOG_OBSERVE=0``.
"""

from bluefog_tpu_torch.observe.registry import (Counter, Gauge, Histogram,
                                                MetricsRegistry, enabled,
                                                get_registry, percentile)
from bluefog_tpu_torch.observe.tracer import (Tracer, get_tracer,
                                              publish_tracer)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "enabled",
           "get_registry", "percentile", "Tracer", "get_tracer",
           "publish_tracer"]

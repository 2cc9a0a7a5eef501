"""Observability of the port: the metrics registry and the span tracer
(copies of ``bluefog_tpu.observe.registry``/``tracer``) and the
decision flight recorder (``blackbox``, bound lazily as in the JAX
package).  The step profiler, exporters and fleet aggregation wait for
ROADMAP.md Queue 1, item 12.  Opt out of publication with
``BLUEFOG_OBSERVE=0``.
"""

from bluefog_tpu_torch.observe.registry import (Counter, Gauge, Histogram,
                                                MetricsRegistry, enabled,
                                                get_registry, percentile)
from bluefog_tpu_torch.observe.tracer import (Tracer, get_tracer,
                                              publish_tracer)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "enabled",
           "get_registry", "percentile", "Tracer", "get_tracer",
           "publish_tracer", "BlackBox", "DecisionEvent", "explain",
           "get_blackbox", "record_decision"]

_BLACKBOX_EXPORTS = ("BlackBox", "DecisionEvent", "explain",
                     "get_blackbox", "record_decision")


def __getattr__(name):
    if name in _BLACKBOX_EXPORTS:
        from bluefog_tpu_torch.observe import blackbox as _blackbox
        return getattr(_blackbox, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")

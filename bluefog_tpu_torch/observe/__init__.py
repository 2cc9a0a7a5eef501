"""Unified observability of the port (``bluefog_tpu.observe``'s
counterpart), every name the JAX package exports:

* ``registry`` and ``tracer`` — copies of the JAX package's metrics
  registry and span tracer;
* ``stepprof`` — ``profile_step`` returns a :class:`StepProfile`
  (FLOPs, per-collective bytes, device time and FLOPs by kernel, each
  exchange's window and, given a link rate, the overlap accounting,
  MFU), rebuilt on ``torch.profiler`` and the flop counter in place of
  XLA's compiled module; ``verify_collective_contract`` and
  ``hlo_op_breakdown`` (``benchutil``'s) read a profiled run where JAX
  reads HLO;
* ``export`` — Prometheus text / JSONL event log / Chrome trace, plus
  the one-call ``snapshot()``;
* ``fleet`` — decentralized cross-rank aggregation by push-sum gossip
  (``FleetAggregator``), the per-edge traffic account
  (``bf_edge_bytes_total{src,dst}``) and the ``StragglerDetector``;
* ``blackbox`` — the decision flight recorder, bound lazily as in the
  JAX package.

Opt out of publication with ``BLUEFOG_OBSERVE=0``.
"""

from bluefog_tpu_torch.observe.registry import (Counter, Gauge, Histogram,
                                                MetricsRegistry, enabled,
                                                get_registry, percentile)
from bluefog_tpu_torch.observe.tracer import (Tracer, get_tracer,
                                              publish_tracer)
from bluefog_tpu_torch.observe.stepprof import (StepProfile,
                                                hlo_op_breakdown,
                                                profile_step,
                                                verify_collective_contract)
from bluefog_tpu_torch.observe.export import (chrome_trace, jsonl_events,
                                              prometheus_text, snapshot)
from bluefog_tpu_torch.observe.fleet import (FleetAggregate,
                                             FleetAggregator,
                                             StragglerDetector,
                                             collect_local, edge_list,
                                             push_sum_matrix,
                                             record_edge_traffic)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "enabled",
    "get_registry", "percentile",
    "Tracer", "get_tracer", "publish_tracer",
    "StepProfile", "profile_step", "hlo_op_breakdown",
    "verify_collective_contract",
    "prometheus_text", "jsonl_events", "chrome_trace", "snapshot",
    "FleetAggregate", "FleetAggregator", "StragglerDetector",
    "collect_local", "edge_list", "push_sum_matrix",
    "record_edge_traffic",
    "BlackBox", "DecisionEvent", "explain", "get_blackbox",
    "record_decision",
]

_BLACKBOX_EXPORTS = ("BlackBox", "DecisionEvent", "explain",
                     "get_blackbox", "record_decision")


def __getattr__(name):
    if name in _BLACKBOX_EXPORTS:
        from bluefog_tpu_torch.observe import blackbox as _blackbox
        return getattr(_blackbox, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")

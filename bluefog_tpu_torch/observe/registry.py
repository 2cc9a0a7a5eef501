"""Process-local metrics registry: counters, gauges, windowed histograms.

Port of ``bluefog_tpu/observe/registry.py`` (the whole module): a copy,
because importing anything under ``bluefog_tpu`` loads jax.  The only
change is that :func:`enabled` reads :mod:`bluefog_tpu_torch.config`.

One registry for the whole process (``get_registry()``); every subsystem
of the port publishes into it (in this slice: the serving engine and
the timeline writer).  Design constraints:

* **host-side only** — a metric update is a dict lookup plus a float
  add; nothing here is ever traced, so enabling observability cannot
  change a compiled program (asserted via jit cache sizes in
  tests/test_observe.py, the same way the resilience suite pins its
  zero-recompile contract);
* **labeled families** — ``registry.counter("bf_ops_total", op=...)``
  returns the per-label child; children are created on first touch and
  live for the process (Prometheus semantics);
* **windowed histograms** — percentiles (p50/p99 via
  :func:`percentile`) over the last ``window`` observations, because a
  serving dashboard wants *recent* tail latency, while ``count``/``sum``
  stay lifetime totals.

Publication is opt-out: ``BLUEFOG_OBSERVE=0`` makes every built-in
publisher skip the registry (and the tracer); see :func:`enabled`.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["percentile", "enabled", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "get_registry"]


def percentile(values, q: float) -> float:
    """Linear-interpolation percentile (numpy's default); 0.0 on empty —
    summaries stay total-function even for a load that never finished a
    request.  (Promoted from ``serving/metrics.py``, which re-exports it
    for backward compatibility.)"""
    vals = [v for v in values if v is not None]
    if not vals:
        return 0.0
    return float(np.percentile(np.asarray(vals, np.float64), q))


def enabled() -> bool:
    """Whether the built-in publishers (serving engine, resilience
    runner, eager ops, train-step wrappers, timeline) write into the
    registry/tracer.  ``BLUEFOG_OBSERVE=0`` opts out; read dynamically
    so tests can flip it per-case.  Note this gates *publication* only:
    a registry you hold and update yourself always works.  (The env
    access itself lives in :func:`bluefog_tpu_torch.config.observe_raw`;
    imported lazily — config comes up before the observe layer.)"""
    from bluefog_tpu_torch import config as bfconfig

    return bfconfig.observe_raw()


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter.  ``inc`` only; resets with its registry.
    Updates are locked: producers include multi-threaded callers (the
    handle API, per-thread tracer tracks), and an unlocked ``+=`` can
    lose increments between its load and store."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc by {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (inc/dec locked, like
    :class:`Counter`)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Windowed histogram: percentiles over the last ``window``
    observations, lifetime ``count``/``sum`` totals (observations
    locked, like :class:`Counter`)."""

    __slots__ = ("_window", "_count", "_sum", "_lock")

    def __init__(self, window: int = 2048):
        if window < 1:
            raise ValueError(f"window ({window}) must be >= 1")
        self._window: deque = deque(maxlen=window)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._window.append(float(value))
            self._count += 1
            self._sum += float(value)

    def percentile(self, q: float) -> float:
        return percentile(self.window_values, q)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def window_values(self) -> List[float]:
        # copy under the lock: iterating a maxlen deque while a
        # producer appends raises "deque mutated during iteration" —
        # the scrape path must not crash under the load it observes
        with self._lock:
            return list(self._window)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Metric families keyed by ``(name, labels)``.

    The accessors (``counter``/``gauge``/``histogram``) create on first
    touch and return the existing child afterwards — call them on the
    hot path, there is no separate registration step.  A name is bound
    to ONE kind for the registry's lifetime (re-declaring
    ``bf_ops_total`` as a gauge raises), matching Prometheus's model.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._kinds: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}

    def _get(self, kind: str, name: str, help: str, window: Optional[int],
             labels: Dict[str, object]):
        key = (name, _label_key(labels))
        with self._lock:
            have = self._kinds.get(name)
            if have is None:
                self._kinds[name] = kind
                self._help[name] = help
            elif have != kind:
                raise ValueError(
                    f"metric {name!r} is already a {have}, not a {kind}")
            metric = self._metrics.get(key)
            if metric is None:
                # None -> default; 0 stays 0 so Histogram's own
                # window-validation ValueError is not masked
                metric = (Histogram(2048 if window is None else window)
                          if kind == "histogram" else _KINDS[kind]())
                self._metrics[key] = metric
            return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, None, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, None, labels)

    def histogram(self, name: str, help: str = "", window: int = 2048,
                  **labels) -> Histogram:
        return self._get("histogram", name, help, window, labels)

    def collect(self) -> Iterator[tuple]:
        """Yield ``(name, kind, help, labels_dict, metric)`` sorted by
        (name, labels) — the deterministic order the exporters emit."""
        with self._lock:
            items = sorted(self._metrics.items())
        for (name, lkey), metric in items:
            yield (name, self._kinds[name], self._help.get(name, ""),
                   dict(lkey), metric)

    def snapshot(self) -> dict:
        """``{name: [{"labels": {...}, ...values}]}`` — the structured
        (JSON-ready) view; histograms carry count/sum/p50/p99."""
        out: dict = {}
        for name, kind, _help, labels, m in self.collect():
            rec: dict = {"labels": labels}
            if kind == "histogram":
                rec.update(count=m.count, sum=m.sum,
                           p50=m.percentile(50), p99=m.percentile(99))
            else:
                rec["value"] = m.value
            out.setdefault(name, []).append(rec)
        return out

    def reset(self) -> None:
        """Drop every metric (tests; a long-lived process keeps its
        registry for life, Prometheus-style)."""
        with self._lock:
            self._kinds.clear()
            self._help.clear()
            self._metrics.clear()


_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global registry every built-in publisher writes to."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
    return _registry

"""Exporters: Prometheus text, structured JSONL event log, Chrome trace.

Port of ``bluefog_tpu/observe/export.py`` (the whole module), copied
because importing anything under ``bluefog_tpu`` loads jax; only the
imports changed.

Three formats over the same two stores (the global
:class:`~bluefog_tpu_torch.observe.registry.MetricsRegistry` and
:class:`~bluefog_tpu_torch.observe.tracer.Tracer`):

* :func:`prometheus_text` — the text exposition format a scrape
  endpoint serves (``# TYPE`` headers, ``name{label="v"} value`` lines;
  histograms as ``_count``/``_sum`` plus ``quantile`` samples);
* :func:`jsonl_events` — one JSON object per tracer event, the
  machine-greppable log (``{"ph","name","track","ts_us","pid"}``);
* :func:`chrome_trace` — the chrome://tracing JSON array, identical in
  shape to what the timeline file writers stream.

``snapshot()`` is the one-call dump (``bf.observe.snapshot()``): the
structured metrics + trace summary as a dict, optionally written to a
directory as ``metrics.prom`` / ``events.jsonl`` / ``trace.json``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from bluefog_tpu_torch.observe import registry as _registry_mod
from bluefog_tpu_torch.observe import tracer as _tracer_mod

__all__ = ["prometheus_text", "jsonl_events", "chrome_trace", "snapshot"]


def _prom_escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _prom_help_escape(v: str) -> str:
    # HELP text escapes only backslash and newline (label values also
    # escape the double quote) — exposition format spec
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_prom_escape(str(v))}"'
                    for k, v in sorted(items.items()))
    return "{" + body + "}"


def prometheus_text(registry=None) -> str:
    """The registry in Prometheus text exposition format (one ``# TYPE``
    per family; histograms exported as summaries: lifetime
    ``_count``/``_sum`` + windowed p50/p99 ``quantile`` samples)."""
    reg = registry if registry is not None else _registry_mod.get_registry()
    lines = []
    last_name = None
    for name, kind, help, labels, m in reg.collect():
        if name != last_name:
            if help:
                lines.append(f"# HELP {name} {_prom_help_escape(help)}")
            lines.append(f"# TYPE {name} "
                         f"{'summary' if kind == 'histogram' else kind}")
            last_name = name
        if kind == "histogram":
            lines.append(f"{name}_count{_prom_labels(labels)} {m.count}")
            lines.append(f"{name}_sum{_prom_labels(labels)} {m.sum}")
            for q in (0.5, 0.99):
                val = m.percentile(q * 100)
                lines.append(
                    f"{name}{_prom_labels(labels, {'quantile': q})} {val}")
        else:
            lines.append(f"{name}{_prom_labels(labels)} {m.value}")
    return "\n".join(lines) + ("\n" if lines else "")


def _jsonl(events, pid: int) -> str:
    lines = []
    for phase, name, track, ts in events:
        lines.append(json.dumps({"ph": phase, "name": name, "track": track,
                                 "ts_us": round(ts, 3), "pid": pid}))
    return "\n".join(lines) + ("\n" if lines else "")


def jsonl_events(tracer=None) -> str:
    """The tracer's buffered events as one JSON object per line."""
    tr = tracer if tracer is not None else _tracer_mod.get_tracer()
    return _jsonl(tr.events(), tr.pid)


def chrome_trace(tracer=None) -> list:
    """The tracer's buffered events as a chrome://tracing event list."""
    tr = tracer if tracer is not None else _tracer_mod.get_tracer()
    return tr.to_chrome_trace()


def snapshot(out_dir: Optional[str] = None) -> dict:
    """One-call dump of the whole observability state.

    Returns ``{"metrics": registry.snapshot(), "trace": {"n_events",
    "dropped_events"}}``; with ``out_dir`` also writes ``metrics.prom``
    (Prometheus text), ``events.jsonl`` (structured log), and
    ``trace.json`` (Chrome trace) there and records the paths under
    ``"files"``."""
    reg = _registry_mod.get_registry()
    tr = _tracer_mod.get_tracer()
    events = tr.events()  # ONE buffer copy feeds count + both formats
    snap = {
        "metrics": reg.snapshot(),
        "trace": {"n_events": len(events),
                  "dropped_events": tr.dropped_events},
    }
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        files = {}
        for fname, payload in (
                ("metrics.prom", prometheus_text(reg)),
                ("events.jsonl", _jsonl(events, tr.pid)),
                ("trace.json",
                 json.dumps(tr.chrome_events(events, tr.pid)))):
            path = os.path.join(out_dir, fname)
            with open(path, "w") as f:
                f.write(payload)
            files[fname] = path
        snap["files"] = files
    return snap

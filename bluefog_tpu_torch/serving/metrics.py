"""Serving metrics + request-lifecycle spans, on the observe substrate.

Port of ``bluefog_tpu/serving/metrics.py`` (``ServingMetrics``) over the
port's own registry, tracer and timeline.  It adds one signal the JAX
engine has no use for: the wall time of each decode call
(:meth:`ServingMetrics.on_decode_step`), summarized as
``decode_step_ms_p50`` together with the number of device decode steps
run (``decode_steps``).  The prefix-cache, speculative-decoding and
failover counters of the JAX summary come with those features in a
later slice.

Numbers a serving operator actually pages on:

* **TTFT** (time to first token): submit -> first generated token, the
  user-visible latency of the prefill path + queueing.
* **Request latency**: submit -> retire.
* **Aggregate tokens/s**: generated tokens over the serving window — the
  throughput continuous batching exists to maximize.
* **Slot occupancy / queue depth**: sampled once per engine step; low
  occupancy under load means admission is the bottleneck, deep queues
  mean capacity is.

Everything is published twice, through the unified observability layer
(:mod:`bluefog_tpu_torch.observe`):

* the :class:`~bluefog_tpu_torch.observe.registry.MetricsRegistry` —
  counters (``bf_serving_requests_total``,
  ``bf_serving_retired_total{outcome=}``), windowed histograms
  (``bf_serving_ttft_seconds``, ``bf_serving_latency_seconds``), and
  per-step gauges, scrapeable as Prometheus text;
* the :class:`~bluefog_tpu_torch.observe.tracer.Tracer` — one track per
  request (``admission -> prefill -> decode -> retire``), which the
  Chrome-trace timeline exports when started: load a timeline in
  chrome://tracing and the continuous-batching interleaving is visible
  directly — staggered prefills riding between decode steps.

``summary()`` keeps its original dict shape (the operator dashboard the
serving tests and bench consume); ``BLUEFOG_OBSERVE=0`` stops the
registry/tracer publication while leaving the summary intact.

All timestamps come from the engine's injected clock, so tests drive
virtual time and percentiles are deterministic.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from bluefog_tpu_torch import timeline as timeline_mod
from bluefog_tpu_torch.observe import registry as obs_registry
from bluefog_tpu_torch.observe import tracer as obs_tracer
from bluefog_tpu_torch.observe.registry import percentile

__all__ = ["ServingMetrics", "percentile"]


class _RequestRecord:
    __slots__ = ("submit_t", "admit_t", "first_token_t", "finish_t",
                 "n_tokens", "outcome", "tracer")

    def __init__(self, submit_t: float, tracer=None):
        self.submit_t = submit_t
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self.n_tokens = 0
        self.outcome: Optional[str] = None
        # the tracer the request's spans BEGAN on, pinned at submit: a
        # BLUEFOG_OBSERVE flip or timeline stop mid-request must not
        # send the closing E records to a different tracer than the Bs
        # (same policy as context._timeline_open)
        self.tracer = tracer


class ServingMetrics:
    """Per-engine request records + publication into the global
    registry/tracer (opt out with ``BLUEFOG_OBSERVE=0``; pass an
    explicit ``registry=`` to isolate, e.g. per-test)."""

    def __init__(self, registry=None):
        self._req: Dict[object, _RequestRecord] = {}
        self._occupancy: List[float] = []
        self._queue_depth: List[int] = []
        self.n_rejected = 0
        self.last_step_ts: Optional[float] = None
        self._registry = registry
        self.n_prefill_chunks = 0
        # device decode steps run and the wall time of each decode call
        self.n_decode_steps = 0
        self._decode_call_seconds: List[float] = []

    # -- observe plumbing --------------------------------------------- #
    def _reg(self):
        if self._registry is not None:
            return self._registry
        if not obs_registry.enabled():
            return None
        return obs_registry.get_registry()

    def _tracer(self):
        return obs_tracer.effective_tracer(timeline_mod.get_timeline())

    def _span(self, rid, activity: Optional[str]):
        """Close the request's open span and (unless retiring) open the
        next lifecycle phase on its per-request track — on the tracer
        the request's spans began on."""
        rec = self._req.get(rid)
        tr = rec.tracer if rec is not None else None
        if tr is None:
            return
        track = f"request.{rid}"
        tr.end(track)
        if activity is not None:
            tr.begin(track, activity)

    # -- lifecycle events (engine calls these) ------------------------ #
    def on_submit(self, rid, now: float):
        tr = self._tracer()
        self._req[rid] = _RequestRecord(now, tracer=tr)
        if tr is not None:
            tr.begin(f"request.{rid}", "admission")
        reg = self._reg()
        if reg is not None:
            reg.counter("bf_serving_requests_total",
                        "requests submitted").inc()

    def on_reject(self, rid, now: float):
        self.n_rejected += 1
        reg = self._reg()
        if reg is not None:
            reg.counter("bf_serving_rejected_total",
                        "requests refused (backpressure or too long)").inc()

    def on_admit(self, rid, now: float):
        self._req[rid].admit_t = now
        self._span(rid, "prefill")

    def on_first_token(self, rid, now: float):
        rec = self._req[rid]
        rec.first_token_t = now
        rec.n_tokens += 1
        self._span(rid, "decode")
        reg = self._reg()
        if reg is not None:
            reg.histogram("bf_serving_ttft_seconds",
                          "submit -> first token").observe(
                              now - rec.submit_t)
            reg.counter("bf_serving_tokens_total",
                        "tokens generated").inc()

    def on_token(self, rid, now: float):
        self._req[rid].n_tokens += 1
        reg = self._reg()
        if reg is not None:
            reg.counter("bf_serving_tokens_total",
                        "tokens generated").inc()

    def on_retire(self, rid, now: float, outcome: str):
        rec = self._req[rid]
        rec.finish_t = now
        rec.outcome = outcome
        self._span(rid, "retire")
        self._span(rid, None)
        tr = rec.tracer
        if tr is not None:
            tr.instant(f"request.{rid}.{outcome}")
        reg = self._reg()
        if reg is not None:
            reg.counter("bf_serving_retired_total",
                        "requests retired", outcome=outcome).inc()
            reg.histogram("bf_serving_latency_seconds",
                          "submit -> retire").observe(now - rec.submit_t)

    def on_prefill_chunk(self):
        """One prefill chunk ran (a model forward over one chunk)."""
        self.n_prefill_chunks += 1
        reg = self._reg()
        if reg is not None:
            reg.counter("bf_serving_prefill_chunks_total",
                        "cold prefill chunks computed").inc()

    def on_decode_step(self, n_steps: int, seconds: float):
        """One decode call advanced every slot ``n_steps`` tokens in
        ``seconds`` of wall time (token fetch included)."""
        self.n_decode_steps += n_steps
        self._decode_call_seconds.append(seconds / n_steps)
        reg = self._reg()
        if reg is not None:
            reg.histogram("bf_serving_decode_step_seconds",
                          "wall time of one device decode step"
                          ).observe(seconds / n_steps)

    def on_step(self, occupancy: float, queue_depth: int,
                step_seconds: Optional[float] = None,
                now: Optional[float] = None):
        self._occupancy.append(occupancy)
        self._queue_depth.append(queue_depth)
        if now is not None:
            # the replica's liveness heartbeat (engine-clock seconds):
            # the fleet router's staleness guard compares this against
            # its own clock — a replica that stops stepping stops
            # advancing it and goes suspect after BLUEFOG_REPLICA_STALE_S
            self.last_step_ts = now
        reg = self._reg()
        if reg is not None:
            reg.counter("bf_serving_steps_total", "engine steps").inc()
            reg.gauge("bf_serving_slot_occupancy",
                      "active slots / capacity, last step").set(occupancy)
            reg.gauge("bf_serving_queue_depth",
                      "queued requests, last step").set(queue_depth)
            if now is not None:
                reg.gauge("bf_serving_last_step_ts",
                          "engine-clock time of the last step").set(now)
            if step_seconds is not None:
                # the engine's measured step wall time, in the SAME
                # histogram family the train loop reports into — the
                # per-rank step-time signal the fleet gossip
                # (observe.fleet.collect_local) aggregates
                reg.histogram("bf_step_wall_seconds",
                              "train/engine step wall time",
                              loop="serving").observe(step_seconds)

    # -- summaries ----------------------------------------------------- #
    def ttfts(self) -> List[float]:
        return [r.first_token_t - r.submit_t for r in self._req.values()
                if r.first_token_t is not None]

    def latencies(self) -> List[float]:
        return [r.finish_t - r.submit_t for r in self._req.values()
                if r.finish_t is not None]

    def summary(self) -> dict:
        """One dict with the operator dashboard: percentile latencies,
        aggregate tokens/s over the active window, mean occupancy/queue
        depth, and outcome counts."""
        recs = list(self._req.values())
        finished = [r for r in recs if r.finish_t is not None]
        tokens = sum(r.n_tokens for r in recs)
        if finished:
            t0 = min(r.submit_t for r in recs)
            t1 = max(r.finish_t for r in finished)
            window = max(t1 - t0, 1e-12)
        else:
            window = 0.0
        outcomes: Dict[str, int] = {}
        for r in recs:
            if r.outcome:
                outcomes[r.outcome] = outcomes.get(r.outcome, 0) + 1
        ttft = self.ttfts()
        lat = self.latencies()
        return {
            "n_requests": len(recs),
            "n_finished": len(finished),
            "n_rejected": self.n_rejected,
            "outcomes": outcomes,
            "tokens_generated": tokens,
            "tokens_per_sec": (tokens / window) if window else 0.0,
            "ttft_p50": percentile(ttft, 50),
            "ttft_p99": percentile(ttft, 99),
            "latency_p50": percentile(lat, 50),
            "latency_p99": percentile(lat, 99),
            "mean_slot_occupancy": (float(np.mean(self._occupancy))
                                    if self._occupancy else 0.0),
            "mean_queue_depth": (float(np.mean(self._queue_depth))
                                 if self._queue_depth else 0.0),
            "max_queue_depth": (int(np.max(self._queue_depth))
                                if self._queue_depth else 0),
            "prefill_chunks": self.n_prefill_chunks,
            "decode_steps": self.n_decode_steps,
            "decode_step_ms_p50": 1e3 * percentile(
                self._decode_call_seconds, 50),
        }

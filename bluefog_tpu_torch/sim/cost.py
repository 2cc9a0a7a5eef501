"""Calibrated cost model: virtual seconds per unit of real work.

Port of ``bluefog_tpu/sim/cost.py``, copied unchanged but for the
engine: :func:`measure_step_cost` submits the port's
:class:`~bluefog_tpu_torch.serving.engine.Request` to the port's
``ServingEngine`` (on the card, one step's wall time includes its
device work, since the engine reads its tokens back each step).

TACCL's lesson (arXiv:2111.04867) applies to simulators as much as to
schedule synthesis: a cost model is only trustworthy when it is
anchored to measured executions.  :class:`CostModel` holds the handful
of per-operation costs a fleet simulation charges —

* ``step_s`` — one serving-engine iteration under full decode slots
  (the lockstep tick cost every busy replica pays);
* ``prefill_chunk_s`` — one cold prefill chunk (a model forward over
  one chunk; the engine budgets prefill work per step, so the sim
  prices it the same way);
* ``gossip_round_s`` — one fleet push-sum gossip round (the router's
  ``poll`` converges in a measured number of rounds; the sim charges
  ``rounds * gossip_round_s`` per poll);
* ``train_step_s`` — one training step's device compute, EXCLUDING the
  wire (the link-cost actor bills the wire per active edge);
* ``wire_unit_s`` — virtual seconds per unit of ``PodSpec`` round cost
  (per-link pricing stays in ``PodSpec``: the sim multiplies its
  contention-priced cost units by this scale, the same convention the
  adaptive-topology bench's virtual wire established);
* ``a2a_unit_s`` — virtual seconds per unit of all-to-all dispatch
  cost (``compile_all_to_all``'s per-round charges).  Separate from
  ``wire_unit_s`` because expert dispatch moves activations, not
  parameter deltas: its payload scales with tokens per step, so its
  calibration anchor differs from the mixing wire's.

Two ways to get one:

* **Committed constants** (the default construction): the gated
  ``fleet_sim`` bench runs on a frozen model so its event-log digest
  and headline numbers are cross-host deterministic and gateable.
* **Measured** (:meth:`CostModel.from_engine` /
  :func:`measure_step_cost`): one capture of the real engine — the
  calibration workflow the validation runs use, so sim and real runs
  share one measured timebase.

Calibration is the one place the sim touches wall time, and it does so
only through an INJECTED ``timer`` callable (callers pass
``time.perf_counter``).  There is deliberately no default: sim code
takes no wall-clock reads, so the caller owning the measurement owns
the timer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["CostModel", "measure_step_cost"]


def measure_step_cost(engine, prompts: Sequence, *,
                      timer: Callable[[], float],
                      new_tokens: int = 32,
                      warmup: int = 3, reps: int = 12) -> float:
    """Median wall seconds of one real engine step under FULL slots —
    the per-tick device cost a simulated replica charges.  ``timer``
    must be injected (e.g. ``time.perf_counter``); the sim package
    itself never reads the wall clock."""
    if timer is None:
        raise ValueError(
            "measure_step_cost needs an injected timer (e.g. "
            "time.perf_counter) — sim code takes no wall-clock reads")
    from bluefog_tpu_torch.serving.engine import Request

    for p in prompts:
        engine.submit(Request(prompt=np.asarray(p, np.int32),
                              max_new_tokens=int(new_tokens)))
    for _ in range(warmup):
        engine.step()
    samples = []
    for _ in range(reps):
        t0 = timer()
        engine.step()
        samples.append(timer() - t0)
    return float(np.median(samples))


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Virtual seconds per unit of simulated work (see module docs).
    Frozen: a run's costs are part of its deterministic identity — the
    event-log digest is only meaningful against a fixed model."""

    step_s: float = 2e-3
    prefill_chunk_s: float = 1e-3
    gossip_round_s: float = 1e-4
    train_step_s: float = 1e-3
    wire_unit_s: float = 1e-3
    a2a_unit_s: float = 1e-3

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not (v >= 0.0):
                raise ValueError(f"{f.name} must be >= 0, got {v}")

    # -- charges -------------------------------------------------------- #
    def poll_s(self, rounds: int) -> float:
        """One router poll: the gossip converged in ``rounds`` push-sum
        rounds (the snapshot records it)."""
        return float(rounds) * self.gossip_round_s

    def wire_s(self, cost_units: float) -> float:
        """Convert ``PodSpec`` contention-priced cost units (a round's
        bottleneck-link charge) into virtual seconds."""
        return float(cost_units) * self.wire_unit_s

    def a2a_s(self, cost_units: float) -> float:
        """Convert an all-to-all dispatch round's ``PodSpec`` cost
        units (``compile_all_to_all`` pricing) into virtual seconds."""
        return float(cost_units) * self.a2a_unit_s

    # -- calibration ---------------------------------------------------- #
    @classmethod
    def from_engine(cls, engine, prompts: Sequence, *,
                    timer: Callable[[], float],
                    new_tokens: int = 32, warmup: int = 3,
                    reps: int = 12, **overrides) -> "CostModel":
        """Calibrate ``step_s`` (and, absent overrides,
        ``prefill_chunk_s`` — one chunk is one bounded forward, same
        order as a full-slot step) from ONE measured capture of the
        real engine; remaining fields keep their committed defaults
        unless overridden."""
        step_s = measure_step_cost(engine, prompts, timer=timer,
                                   new_tokens=new_tokens,
                                   warmup=warmup, reps=reps)
        fields = {"step_s": step_s,
                  "prefill_chunk_s": overrides.pop("prefill_chunk_s",
                                                   step_s)}
        fields.update(overrides)
        return cls(**fields)

"""Seeded arrival-time generators for serving traces.

Port of the arrival generators of ``bluefog_tpu/benchutil.py``
(:func:`poisson_arrivals`, :func:`diurnal_arrivals`,
:func:`flash_crowd_arrivals` and their shared unit-rate substrate),
copied unchanged: numpy only, pure functions of their arguments, so the
port's traces are bit-equal to the JAX package's.  The simulator
(:mod:`bluefog_tpu_torch.sim.traces`) and ``chip_smoke.py`` build their
request traces from them.  The rest of ``benchutil`` (device timing,
MFU, the HLO accounting and the bench gate) waits for ROADMAP.md
Queue 1, item 13.
"""

from __future__ import annotations

import numpy as np

__all__ = ["poisson_arrivals", "diurnal_arrivals", "flash_crowd_arrivals"]


def poisson_arrivals(rate: float, n: int, seed: int = 0) -> np.ndarray:
    """Arrival times (seconds, ascending, starting at 0.0) of ``n``
    Poisson arrivals at ``rate`` requests/s: the cumulative sum of
    seeded exponential inter-arrival gaps.  Pure function of
    ``(rate, n, seed)`` — no wall clock anywhere — so every caller
    replays the SAME trace."""
    if rate <= 0:
        raise ValueError(f"rate ({rate}) must be positive")
    if n < 1:
        return np.zeros((0,), np.float64)
    gaps = np.random.RandomState(seed).exponential(1.0 / rate, size=n)
    gaps[0] = 0.0
    return np.cumsum(gaps)


def _unit_poisson_targets(n: int, seed: int) -> np.ndarray:
    """Unit-rate Poisson cumulative targets — the shared substrate of
    the non-homogeneous generators below (inversion method: arrival
    *i* lands where the cumulative rate function crosses target *i*).
    Same convention as :func:`poisson_arrivals`: first arrival at 0."""
    gaps = np.random.RandomState(seed).exponential(1.0, size=n)
    gaps[0] = 0.0
    return np.cumsum(gaps)


def diurnal_arrivals(rate: float, n: int, seed: int = 0, *,
                     period: float = 60.0, depth: float = 0.5,
                     phase: float = 0.0) -> np.ndarray:
    """Arrival times of ``n`` requests from a sinusoidally modulated
    Poisson process — the diurnal load shape: instantaneous rate
    ``rate * (1 + depth * sin(2*pi*t/period + phase))`` requests/s.
    Exact inversion of the cumulative rate function (vectorized
    bisection), so counts over any window match its integral in
    expectation and the trace is a pure function of the arguments —
    no thinning, no wall clock, no resampling loop.  ``0 <= depth < 1``
    keeps the rate strictly positive."""
    if rate <= 0:
        raise ValueError(f"rate ({rate}) must be positive")
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"depth ({depth}) must be in [0, 1)")
    if period <= 0:
        raise ValueError(f"period ({period}) must be positive")
    if n < 1:
        return np.zeros((0,), np.float64)
    targets = _unit_poisson_targets(n, seed)
    w = 2.0 * np.pi / period
    amp = rate * depth / w

    def cum_rate(t):
        return rate * t + amp * (np.cos(phase) - np.cos(w * t + phase))

    # cum_rate(t) >= rate*t - 2*amp, so t <= (target + 2*amp)/rate
    lo = np.zeros(n, np.float64)
    hi = (targets + 2.0 * amp) / rate + 1.0
    for _ in range(64):  # bisection to ~1 ulp of the window width
        mid = 0.5 * (lo + hi)
        below = cum_rate(mid) < targets
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    out = 0.5 * (lo + hi)
    out[0] = 0.0
    return out


def flash_crowd_arrivals(rate: float, n: int, seed: int = 0, *,
                         at: float = 0.0, factor: float = 4.0,
                         duration: float = 1.0) -> np.ndarray:
    """Arrival times of ``n`` requests from a Poisson process at
    ``rate`` requests/s with one flash crowd: inside ``[at, at +
    duration)`` the rate jumps to ``rate * factor``.  The cumulative
    rate function is piecewise linear, so the inversion is closed-form
    and exact; outside the burst the trace statistics match
    :func:`poisson_arrivals` at the same base rate.  Deterministic in
    ``(rate, n, seed, at, factor, duration)``."""
    if rate <= 0:
        raise ValueError(f"rate ({rate}) must be positive")
    if factor <= 0:
        raise ValueError(f"factor ({factor}) must be positive")
    if duration < 0 or at < 0:
        raise ValueError(f"burst window (at={at}, duration={duration}) "
                         f"must be non-negative")
    if n < 1:
        return np.zeros((0,), np.float64)
    targets = _unit_poisson_targets(n, seed)
    c1 = rate * at                           # cum rate at burst start
    c2 = c1 + rate * factor * duration       # cum rate at burst end
    out = np.where(
        targets < c1, targets / rate,
        np.where(targets < c2,
                 at + (targets - c1) / (rate * factor),
                 at + duration + (targets - c2) / rate))
    return out.astype(np.float64)

"""Seeded arrival-time generators for serving traces, and the collective
contract check.

Port of the arrival generators of ``bluefog_tpu/benchutil.py``
(:func:`poisson_arrivals`, :func:`diurnal_arrivals`,
:func:`flash_crowd_arrivals` and their shared unit-rate substrate),
copied unchanged: numpy only, pure functions of their arguments, so the
port's traces are bit-equal to the JAX package's.  The simulator
(:mod:`bluefog_tpu_torch.sim.traces`) and ``chip_smoke.py`` build their
request traces from them.

:func:`verify_collective_contract` holds a step's exchanges to their
predicted sketch as the JAX package's does, reading the exchange tally
of a :class:`~bluefog_tpu_torch.observe.StepProfile` where JAX reads
HLO text.  The rest of ``benchutil`` (device timing, MFU, the HLO
accounting and the bench gate) waits for ROADMAP.md Queue 1, item 13.
"""

from __future__ import annotations

import numpy as np

__all__ = ["poisson_arrivals", "diurnal_arrivals", "flash_crowd_arrivals",
           "verify_collective_contract"]


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


def _tally_of(profile) -> dict:
    """``{kind: {"count", "bytes", "payloads", "groups"?}}`` of a
    StepProfile (its ``collective_bytes``, ``collective_payloads`` and
    ``collective_groups``) or of a tally dict as it is."""
    if isinstance(profile, str) or hasattr(profile, "as_text"):
        raise TypeError(
            "verify_collective_contract reads a StepProfile (or its "
            "exchange tally) of a step the port ran; there is no HLO text "
            "in the port")
    if not hasattr(profile, "collective_bytes"):
        return profile
    out = {}
    for kind, rec in profile.collective_bytes.items():
        out[kind] = dict(rec, payloads=list(
            profile.collective_payloads.get(kind, ())))
        if kind in profile.collective_groups:
            out[kind]["groups"] = profile.collective_groups[kind]
    return out


def verify_collective_contract(profile, predicted, payload_bytes,
                               *, round_index=None) -> list:
    """Hold a step's exchanges to their declared collective sketch: the
    JAX package's ``verify_collective_contract``, on what the port's
    step ran instead of a lowered program.

    ``profile`` is a :class:`~bluefog_tpu_torch.observe.StepProfile` (or
    its tally, ``{kind: {"count", "bytes", "payloads", "groups"}}``):
    one device's view of each exchange, as JAX's HLO is one device's
    program.  ``predicted`` is a ``CompiledTopology.predicted_collectives
    (payload_bytes)`` / ``CompiledHierarchicalTopology`` dict, or one
    built from ``train_step.mix_wire_layout``.  A profile covers the
    steps it ran, so ``round_index=None`` holds it to the per-period
    totals (a profile of one step is one period of a one-round
    schedule) and ``round_index=i`` to ``per_round[i]`` (a step that ran
    round ``i``).

    Returns a list of mismatch strings, empty when the contract holds:
    the prediction's internal consistency, the permute count, every
    permute payload admissible (``payload_bytes``, one size or a
    collection: compressed mixing moves one size per bucket), the total
    bytes, and for hierarchical predictions the grouped all-reduce count
    and its machine groups (recorded in the tally where JAX reads
    ``replica_groups``)."""
    tally = _tally_of(profile)
    problems = []

    per_round = predicted.get("per_round", [])
    # internal consistency of the prediction itself: the per-period
    # totals must be the per-round sum, or the dict was tampered/stale
    if per_round:
        tot_p = sum(r["permutes"] for r in per_round)
        if tot_p != predicted["permutes_per_period"]:
            problems.append(
                f"prediction inconsistent: per_round permutes sum {tot_p}"
                f" != permutes_per_period "
                f"{predicted['permutes_per_period']}")
        tot_b = float(sum(r["permutes"] * r["bytes_per_permute"]
                          for r in per_round))
        if tot_b != predicted["bytes_per_period"]:
            problems.append(
                f"prediction inconsistent: per_round bytes sum {tot_b}"
                f" != bytes_per_period {predicted['bytes_per_period']}")

    permutes = tally.get("collective-permute", {})
    payloads = [int(b) for b in permutes.get("payloads", ())]
    if round_index is None:
        want_p = predicted["permutes_per_period"]
        want_bytes = predicted["bytes_per_period"]
        want_r = predicted.get("all_reduces_per_period")
    else:
        rp = per_round[round_index]
        want_p = rp["permutes"]
        want_bytes = rp["permutes"] * rp["bytes_per_permute"]
        want_r = rp.get("all_reduces")
        payload_bytes = rp.get("bytes_per_permute", payload_bytes)

    where = ("step" if round_index is None else f"round {round_index}")
    if len(payloads) != want_p:
        problems.append(
            f"{where}: {len(payloads)} collective-permutes ran, "
            f"predicted {want_p}")
    admissible = (set(int(p) for p in payload_bytes)
                  if isinstance(payload_bytes, (set, frozenset, list,
                                                tuple))
                  else {int(payload_bytes)})
    bad = [b for b in payloads if b not in admissible]
    if bad:
        problems.append(
            f"{where}: permute payloads {bad} not in predicted "
            f"{sorted(admissible)} bytes")
    got_bytes = sum(payloads)
    if got_bytes != want_bytes:
        problems.append(
            f"{where}: {got_bytes} permute bytes ran, predicted "
            f"{want_bytes}")
    if want_r is not None:
        reduces = tally.get("all-reduce", {})
        got_r = int(reduces.get("count", 0))
        if got_r != want_r:
            problems.append(
                f"{where}: {got_r} all-reduces ran, predicted {want_r}")
        groups = predicted.get("all_reduce_groups")
        size = predicted.get("all_reduce_group_size")
        if got_r and groups and size and size > 1:
            expect = tuple(tuple(range(g * size, (g + 1) * size))
                           for g in range(groups))
            if expect not in [tuple(tuple(x) for x in gs)
                              for gs in reduces.get("groups", ())]:
                problems.append(
                    f"{where}: grouped all-reduce missing machine "
                    f"decomposition {[list(g) for g in expect]}")
    return problems

"""Byte-stable rendering of event details.

Port of ``canonical_detail`` from ``bluefog_tpu/sim/engine.py``, copied
unchanged (host bookkeeping; importing it from the JAX package would load
jax).  The flight recorder (:mod:`bluefog_tpu_torch.observe.blackbox`)
digests its lines with it.  The seeded event engine, its log and the
virtual clock come with their first caller, the simulator of ROADMAP.md
Queue 1, item 12 (the simulator).
"""

from __future__ import annotations

import numpy as np

__all__ = ["canonical_detail"]


def _fmt_value(v) -> str:
    """One deterministic rendering per value type.  Floats go through
    ``%.9g`` (enough digits to distinguish any two virtual times the
    sim produces, few enough that the text is platform-stable); bools
    before ints because ``bool`` is an ``int`` subclass."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return format(float(v), ".9g")
    return str(v)


def canonical_detail(**detail) -> str:
    """The sorted-key ``k=v`` tail of the canonical event rendering,
    with every value through :func:`_fmt_value` (``%.9g`` floats).
    Nested dicts canonicalize recursively as ``{k=v ...}`` and
    lists/tuples as ``[v ...]``, so a telemetry snapshot digests
    byte-stably too.  The decision flight recorder
    (:mod:`bluefog_tpu_torch.observe.blackbox`) digests its lines with it,
    as the JAX package's recorder and event log do."""

    def render(v) -> str:
        if isinstance(v, dict):
            inner = " ".join(
                f"{k}={render(v[k])}" for k in sorted(v, key=str))
            return "{" + inner + "}"
        if isinstance(v, (list, tuple)):
            return "[" + " ".join(render(x) for x in v) + "]"
        return _fmt_value(v)

    return " ".join(f"{k}={render(detail[k])}" for k in sorted(detail))

"""The one virtual clock every simulated component shares.

Port of ``bluefog_tpu/sim/clock.py``, copied unchanged: the clock every
:mod:`bluefog_tpu_torch.sim` actor is built around.

The contract is deliberately tiny so the clock is injectable anywhere a
``time.monotonic``-shaped callable is accepted (``ServingEngine``,
``FleetRouter``, ``ServingMetrics`` heartbeats): calling the clock reads
virtual seconds; nothing inside :mod:`bluefog_tpu_torch.sim` ever reads
the wall clock (``tests/test_torch_sim.py`` scans the package's source
for wall-clock reads).  Determinism follows: the same
seed replays the same virtual timeline byte-for-byte on any host, at
any host speed.
"""

from __future__ import annotations

__all__ = ["VirtualClock"]


class VirtualClock:
    """Monotone virtual time in seconds.  ``clock()`` reads it; the
    simulation driver advances it (``advance``/``jump_to``) — never the
    actors, so one tick's readers all agree on "now"."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` virtual seconds (``dt >= 0`` —
        virtual time never rewinds; a negative step would reorder
        already-logged events)."""
        if dt < 0:
            raise ValueError(f"virtual time cannot rewind (dt={dt})")
        self.t += float(dt)
        return self.t

    def jump_to(self, t: float) -> float:
        """Advance to absolute time ``t`` if it is in the future; a
        past ``t`` is a no-op (idle-jump semantics: the fleet loop
        jumps to the next arrival only when everyone is idle)."""
        self.t = max(self.t, float(t))
        return self.t

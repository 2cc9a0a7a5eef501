"""The simulator's byte-stable event rendering (``bluefog_tpu.sim``'s
counterpart, its first piece): the flight recorder (``observe.blackbox``)
formats its digested lines with
:func:`~bluefog_tpu_torch.sim.engine.canonical_detail`.  The clock, the
event engine, the cost model, traces, wire and the serving and training
fleets wait for ROADMAP.md Queue 1, item 12 (the simulator).
"""

from bluefog_tpu_torch.sim.engine import canonical_detail

__all__ = ["canonical_detail"]

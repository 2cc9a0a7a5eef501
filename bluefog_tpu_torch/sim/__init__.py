"""Fleet-scale discrete-event simulation: real control plane, virtual time.

Port of ``bluefog_tpu/sim``: the numpy host code copied unchanged over
the port's own control planes, so the port's simulator gives the JAX
package's event logs and chain digests byte for byte
(``tests/test_torch_sim*.py``), and is held to the port's real loops:
``run_resilient`` at n=8 and a lockstep fleet of real ``ServingEngine``
replicas.

Every scale claim a real-engine bench can make tops out near the host's
core count; this package lifts the ceiling by replacing only the DEVICE
work with a calibrated cost model while the CONTROL decisions stay with
the production code — the same
:class:`~bluefog_tpu_torch.serving.fleet.FleetRouter`,
:class:`~bluefog_tpu_torch.elastic.MembershipController`,
:class:`~bluefog_tpu_torch.observe.fleet.StragglerDetector`, and
:class:`~bluefog_tpu_torch.topology.TopologyControlPlane` a hardware fleet
runs, fed through the same ``observe`` registry families they read in
production.  TACCL's discipline applies (arXiv:2111.04867): the cost
model is calibrated from one measured capture of the real engine, and
the simulator itself is validated against lockstep real-engine runs at
small n — routing decisions bit-equal, dynamics within tolerance —
before any large-n number is quoted.

* :mod:`~bluefog_tpu_torch.sim.clock` — the one :class:`VirtualClock`;
* :mod:`~bluefog_tpu_torch.sim.engine` — seeded event heap +
  :class:`EventLog` with a streaming SHA-256 (same seed ⇒ byte-equal
  log, O(1) memory at a million events);
* :mod:`~bluefog_tpu_torch.sim.cost` — :class:`CostModel`: committed
  constants for gated runs, ``from_engine`` calibration for validation
  (wall time only through an injected timer — the package reads no
  wall clock);
* :mod:`~bluefog_tpu_torch.sim.wire` — :class:`LinkWire`, the torus-priced
  link-cost actor billing ``bf_edge_seconds_total`` (the control
  plane's telemetry feed);
* :mod:`~bluefog_tpu_torch.sim.traces` — request traces and
  :class:`ChurnSchedule` riding ``FaultPlan`` semantics (arrival-time
  generators live in :mod:`bluefog_tpu_torch.benchutil`);
* :mod:`~bluefog_tpu_torch.sim.serving` — :class:`SimReplica` (the serving
  engine's exact host bookkeeping, device work costed) +
  :class:`SimServingFleet` around the real router;
* :mod:`~bluefog_tpu_torch.sim.training` — :class:`SimTrainingFleet` driving
  the real topology control plane / membership / straggler stack at
  n=1024 and beyond.
"""

from bluefog_tpu_torch.sim.clock import VirtualClock  # noqa: F401
from bluefog_tpu_torch.sim.cost import (  # noqa: F401
    CostModel,
    measure_step_cost,
)
from bluefog_tpu_torch.sim.engine import (  # noqa: F401
    EventLog,
    Simulation,
    format_event,
)
from bluefog_tpu_torch.sim.serving import (  # noqa: F401
    SimReplica,
    SimRequest,
    SimServingFleet,
)
from bluefog_tpu_torch.sim.traces import (  # noqa: F401
    ChurnAction,
    ChurnSchedule,
    RequestTrace,
)
from bluefog_tpu_torch.sim.training import SimTrainingFleet  # noqa: F401
from bluefog_tpu_torch.sim.wire import LinkWire  # noqa: F401

__all__ = [
    "VirtualClock",
    "EventLog",
    "Simulation",
    "format_event",
    "CostModel",
    "measure_step_cost",
    "LinkWire",
    "RequestTrace",
    "ChurnAction",
    "ChurnSchedule",
    "SimRequest",
    "SimReplica",
    "SimServingFleet",
    "SimTrainingFleet",
]

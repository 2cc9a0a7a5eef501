"""Virtual topology library of the port: static graph generators,
weights, dynamic schedules, reverse-edge inference (``infer``) and the
device-ready ``Topology`` spec (``bluefog_tpu.topology``'s counterpart,
numpy only).

``torus``, ``compiler`` and ``control`` wait for a later slice
(ROADMAP.md, Queue 1, item 12).
"""

from bluefog_tpu_torch.topology.graphs import (  # noqa: F401
    DiGraph,
    ExponentialTwoGraph,
    ExponentialGraph,
    SymmetricExponentialGraph,
    MeshGrid2DGraph,
    StarGraph,
    RingGraph,
    FullyConnectedGraph,
    IsTopologyEquivalent,
    IsRegularGraph,
    GetRecvWeights,
    GetSendWeights,
    circulant_graph,
)
from bluefog_tpu_torch.topology.dynamic import (  # noqa: F401
    GetDynamicOnePeerSendRecvRanks,
    GetExp2DynamicSendRecvMachineRanks,
    GetInnerOuterRingDynamicSendRecvRanks,
    GetInnerOuterExpo2DynamicSendRecvRanks,
    one_peer_round,
    one_peer_dynamic_schedule,
    inner_outer_ring_round,
    inner_outer_expo2_round,
    exp2_machine_round,
)
from bluefog_tpu_torch.topology.spec import (  # noqa: F401
    Topology,
    DynamicTopology,
    ShiftClass,
    self_weights_of,
    uniform_topology_spec,
)
from bluefog_tpu_torch.topology.infer import (  # noqa: F401
    InferDestinationFromSourceRanks,
    InferSourceFromDestinationRanks,
)

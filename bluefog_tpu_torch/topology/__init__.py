"""Virtual topology library of the port: static graph generators,
weights, dynamic schedules, reverse-edge inference (``infer``), the
device-ready ``Topology`` spec, the torus schedules and congestion
accounting (``torus``), the topology compiler (``compiler``, with
the all-to-all schedule the MoE dispatch runs) and the closed-loop
topology control plane (``control``: detect, re-plan, hot-swap the
combine weights as data): ``bluefog_tpu.topology``'s counterpart.
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
from bluefog_tpu_torch.topology.torus import (  # noqa: F401
    TorusSpec,
    torus_one_peer_schedule,
    torus_shift_round,
    round_congestion,
    schedule_congestion,
    consensus_contraction,
    rounds_from_contraction,
    rounds_to_consensus,
    score_schedule,
    default_pod_schedule,
)
from bluefog_tpu_torch.topology.compiler import (  # noqa: F401
    PodSpec,
    Sketch,
    CompiledTopology,
    CompiledHierarchicalTopology,
    compile_topology,
    expand_machine_pairs,
    menu_schedules,
)
from bluefog_tpu_torch.topology.control import (  # noqa: F401
    TopologyControlPlane,
    swap_comm_weights,
    swap_mix_ratio,
)

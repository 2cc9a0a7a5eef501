"""Dynamic (time-varying) topology generators.

Port of ``bluefog_tpu/topology/dynamic.py`` (reference:
bluefog/common/topology_util.py:315-554).  Each per-rank generator yields
``(send_ranks, recv_ranks)`` per round; the world-level round functions
(``*_round``) return the full send map of a round, which is what a
``DynamicTopology`` is built from.  Rounds are deterministic functions of
the round index, so every rank computes the same permutation without any
negotiation.  Graphs are the port's
:class:`~bluefog_tpu_torch.topology.graphs.DiGraph`; numpy only.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from bluefog_tpu_torch.topology.graphs import DiGraph, ExponentialTwoGraph
from bluefog_tpu_torch.topology.spec import DynamicTopology

__all__ = [
    "GetDynamicOnePeerSendRecvRanks",
    "GetExp2DynamicSendRecvMachineRanks",
    "GetInnerOuterRingDynamicSendRecvRanks",
    "GetInnerOuterExpo2DynamicSendRecvRanks",
    "one_peer_round",
    "one_peer_dynamic_schedule",
    "inner_outer_ring_round",
    "inner_outer_expo2_round",
    "exp2_machine_round",
]


def _clockwise_successors(topo: DiGraph) -> List[List[int]]:
    """Per-rank out-neighbors (self excluded), ordered clockwise starting
    just after the rank itself (reference topology_util.py:335-343)."""
    size = topo.number_of_nodes()
    ordered = []
    for rank in range(size):
        succ = [s for s in topo.successors(rank) if s != rank]
        succ.sort(key=lambda s: (s - rank) % size)
        ordered.append(succ)
    return ordered


def one_peer_round(topo: DiGraph, index: int) -> Dict[int, int]:
    """Send map {src: dst} for round ``index`` of the one-peer dynamic
    schedule over base graph ``topo``."""
    ordered = _clockwise_successors(topo)
    send = {}
    for rank, succ in enumerate(ordered):
        if succ:
            send[rank] = succ[index % len(succ)]
    return send


def one_peer_dynamic_schedule(topo, rounds: int = None) -> list:
    """The full cycle of one-peer rounds as ``DynamicTopology`` specs with
    the reference's uniform combine weights 1/(in_degree+1) (reference
    torch/mpi_ops.py:504-510).  Feed it to
    ``optim.functional.build_train_step(schedule=...)``: step ``s`` runs
    round ``s % len(schedule)``.

    ``topo``: a DiGraph, or an int n for ExponentialTwoGraph(n).
    """
    if isinstance(topo, int):
        topo = ExponentialTwoGraph(topo)
    n = topo.number_of_nodes()
    if rounds is None:
        rounds = max(1, max(
            len(s) for s in _clockwise_successors(topo)) if n > 1 else 1)
    schedule = []
    for i in range(rounds):
        send = one_peer_round(topo, i)
        recv: Dict[int, List[int]] = {r: [] for r in range(n)}
        for src, dst in send.items():
            recv[dst].append(src)
        edge_weights, selfs = {}, []
        for r in range(n):
            w = 1.0 / (len(recv[r]) + 1)
            selfs.append(w)
            for src in recv[r]:
                edge_weights[(src, r)] = w
        schedule.append(DynamicTopology.from_edges(n, edge_weights, selfs))
    return schedule


def GetDynamicOnePeerSendRecvRanks(
    topo: DiGraph, self_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Yield ([send_rank], recv_ranks) per round: each rank cycles clockwise
    through its out-neighbors; the recv set is the exact inverse
    (reference topology_util.py:315-357)."""
    index = 0
    while True:
        send = one_peer_round(topo, index)
        recv_ranks = sorted(src for src, dst in send.items() if dst == self_rank)
        yield [send[self_rank]], recv_ranks
        index += 1


def exp2_machine_round(num_machines: int, machine_id: int,
                       index: int) -> Tuple[int, int]:
    """(send_machine, recv_machine) for the exponential-2 machine schedule."""
    exp2_size = int(np.log2(num_machines - 1)) if num_machines > 1 else 0
    dist = 2 ** (index % (exp2_size + 1))
    return (machine_id + dist) % num_machines, (machine_id - dist) % num_machines


def GetExp2DynamicSendRecvMachineRanks(
    world_size: int, local_size: int, self_rank: int, local_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Yield ([send_machine], [recv_machine]) cycling over power-of-2 machine
    distances; homogeneous placement required
    (reference topology_util.py:360-397)."""
    assert self_rank % local_size == local_rank, (
        "It should be used under homogeneous environment only."
    )
    assert world_size % local_size == 0, (
        "It should be used under homogeneous environment only."
    )
    assert world_size > local_size, "It should be used under at least two machines case."
    machine_id = self_rank // local_size
    num_machines = world_size // local_size
    index = 0
    while True:
        send_m, recv_m = exp2_machine_round(num_machines, machine_id, index)
        yield [send_m], [recv_m]
        index += 1


def _ring_peers(
    local_rank: int, outside_id: int, nodes_per_machine: int
) -> Tuple[int, int]:
    """Send/recv local ids for the inner ring that skips ``outside_id``."""
    send_local = (local_rank + 1) % nodes_per_machine
    if send_local == outside_id:
        send_local = (send_local + 1) % nodes_per_machine
    recv_local = (local_rank - 1) % nodes_per_machine
    if recv_local == outside_id:
        recv_local = (recv_local - 1) % nodes_per_machine
    return send_local, recv_local


def inner_outer_ring_round(
    world_size: int, local_size: int, self_rank: int, index: int
) -> Tuple[int, int]:
    """(send_rank, recv_rank) for the inner-ring/outer-ring schedule: one
    designated local rank per round talks ring-wise across machines, everyone
    else rings within the machine (skipping the outside-goer)."""
    num_machines = world_size // local_size
    machine_id, local_rank = divmod(self_rank, local_size)
    outside_id = index % local_size
    if outside_id == local_rank:
        send = ((machine_id + 1) % num_machines) * local_size + local_rank
        recv = ((machine_id - 1) % num_machines) * local_size + local_rank
    else:
        send_local, recv_local = _ring_peers(local_rank, outside_id, local_size)
        send = machine_id * local_size + send_local
        recv = machine_id * local_size + recv_local
    return send, recv


def GetInnerOuterRingDynamicSendRecvRanks(
    world_size: int, local_size: int, self_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Reference topology_util.py:399-463."""
    assert world_size % local_size == 0, (
        "It should be used under homogeneous environment only."
    )
    assert local_size > 2, (
        "Unsupported case: nodes_per_machine must exceed 2. Consider "
        "hierarchical_neighbor_allreduce or "
        "GetDynamicOnePeerSendRecvRanks instead."
    )
    index = 0
    while True:
        send, recv = inner_outer_ring_round(world_size, local_size, self_rank, index)
        yield [send], [recv]
        index += 1


def inner_outer_expo2_round(
    world_size: int, local_size: int, self_rank: int, index: int
) -> Tuple[int, int]:
    """(send_rank, recv_rank) for the inner-exp2/outer-exp2 schedule."""
    num_machines = world_size // local_size
    machine_id, local_rank = divmod(self_rank, local_size)
    outside_id = index % local_size
    exp2_out = int(np.log2(num_machines - 1))
    exp2_in = 0 if local_size == 2 else int(np.log2(local_size - 2))

    if outside_id == local_rank:
        dist = 2 ** (index % (exp2_out + 1))
        send = ((machine_id + dist) % num_machines) * local_size + local_rank
        recv = ((machine_id - dist) % num_machines) * local_size + local_rank
        return send, recv

    # Inner exp2 over the remaining local ranks, hopping over the outside-goer.
    dist = 2 ** (index % (exp2_in + 1))
    send_dist = dist + 1 if dist >= (outside_id - local_rank) % local_size else dist
    recv_dist = dist + 1 if dist >= (local_rank - outside_id) % local_size else dist
    send = machine_id * local_size + (local_rank + send_dist) % local_size
    recv = machine_id * local_size + (local_rank - recv_dist) % local_size
    return send, recv


def GetInnerOuterExpo2DynamicSendRecvRanks(
    world_size: int, local_size: int, self_rank: int
) -> Iterator[Tuple[List[int], List[int]]]:
    """Reference topology_util.py:466-554."""
    assert world_size % local_size == 0, (
        "It should be used under homogeneous environment only."
    )
    assert local_size > 2, (
        "Unsupported case: nodes_per_machine must exceed 2. Consider "
        "hierarchical_neighbor_allreduce or "
        "GetDynamicOnePeerSendRecvRanks instead."
    )
    index = 0
    while True:
        send, recv = inner_outer_expo2_round(world_size, local_size, self_rank, index)
        yield [send], [recv]
        index += 1

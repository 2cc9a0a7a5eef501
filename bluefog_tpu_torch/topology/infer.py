"""Infer reverse edge sets of a dynamic topology.

Port of ``bluefog_tpu/topology/infer.py`` (a copy; numpy only).
Reference parity: bluefog/torch/topology_util.py:22-108
(``InferSourceFromDestinationRanks`` / ``InferDestinationFromSourceRanks``).

The reference implements these as collective calls (two allgathers) because
each MPI rank only knows its own send/recv set.  Under SPMD every process
computes the full world mapping deterministically, so these are pure host
functions over the world view: pass ``ranks_per_rank`` as a list of lists
(entry r = that rank's dst/src list).  The optional ``rank`` argument selects
one rank's answer, matching the reference's per-rank return.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["InferSourceFromDestinationRanks", "InferDestinationFromSourceRanks"]


def _check_world(ranks_per_rank: Sequence[Sequence[int]]) -> None:
    size = len(ranks_per_rank)
    for self_rank, lst in enumerate(ranks_per_rank):
        for r in lst:
            if not isinstance(r, (int, np.integer)):
                raise AssertionError("contain element that is not integer.")
            if r < 0 or r >= size:
                raise AssertionError(
                    "contain element that is not between 0 and size-1."
                )
        if len(set(lst)) != len(lst):
            raise AssertionError("contain duplicated elements.")
        if self_rank in lst:
            raise AssertionError("contain self rank.")


def _invert(ranks_per_rank: Sequence[Sequence[int]]) -> List[List[int]]:
    size = len(ranks_per_rank)
    inverse: List[List[int]] = [[] for _ in range(size)]
    for src, lst in enumerate(ranks_per_rank):
        for dst in sorted(lst):
            inverse[dst].append(src)
    return inverse


def _adjacency(ranks_per_rank: Sequence[Sequence[int]], transpose: bool) -> np.ndarray:
    size = len(ranks_per_rank)
    w = np.eye(size)
    for k, adj in enumerate(ranks_per_rank):
        w[k, sorted(adj)] = 1
    if transpose:
        w = w.T
    # Reference normalization (torch/topology_util.py:108): divide entry
    # (i, j) by the sum of row j ("column normalized style").
    return w / w.sum(axis=1)


def InferSourceFromDestinationRanks(
    dst_ranks_per_rank: Sequence[Sequence[int]],
    construct_adjacency_matrix: bool = False,
    rank: Optional[int] = None,
) -> Union[List, Tuple[List, np.ndarray]]:
    """Given every rank's destination list, return every rank's source list
    (or ``rank``'s if given); optionally the weighted adjacency matrix."""
    _check_world(dst_ranks_per_rank)
    sources = _invert(dst_ranks_per_rank)
    result = sources if rank is None else sources[rank]
    if not construct_adjacency_matrix:
        return result
    return result, _adjacency(dst_ranks_per_rank, transpose=False)


def InferDestinationFromSourceRanks(
    src_ranks_per_rank: Sequence[Sequence[int]],
    construct_adjacency_matrix: bool = False,
    rank: Optional[int] = None,
) -> Union[List, Tuple[List, np.ndarray]]:
    """Given every rank's source list, return every rank's destination list
    (or ``rank``'s if given); optionally the weighted adjacency matrix."""
    _check_world(src_ranks_per_rank)
    dests = _invert(src_ranks_per_rank)
    result = dests if rank is None else dests[rank]
    if not construct_adjacency_matrix:
        return result
    return result, _adjacency(src_ranks_per_rank, transpose=True)

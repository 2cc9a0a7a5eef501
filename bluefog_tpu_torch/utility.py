"""Model/optimizer state distribution helpers.

Port of ``bluefog_tpu/utility.py`` (reference bluefog/torch/utility.py:
broadcast_parameters:26, allreduce_parameters:58,
broadcast_optimizer_state:89).  Parameters are ``{name: tensor}`` dicts
whose tensors are rank-major ``[size, ...]`` (a tensor without the
leading rank axis is taken as replicated and tiled into rank-major form).
Rank-major tensors are written in place, as the reference does.
"""

from __future__ import annotations

from typing import Dict

import torch

from bluefog_tpu_torch import api
from bluefog_tpu_torch.context import get_context

__all__ = [
    "broadcast_parameters",
    "allreduce_parameters",
    "broadcast_optimizer_state",
]


def _is_rank_major(t: torch.Tensor) -> bool:
    return t.dim() >= 1 and t.shape[0] == get_context().size()


def _leaf_broadcast(leaf: torch.Tensor, root_rank: int) -> torch.Tensor:
    if _is_rank_major(leaf):
        with torch.no_grad():
            return api.broadcast_(leaf, root_rank)
    n = get_context().size()
    tiled = leaf.unsqueeze(0).expand((n,) + tuple(leaf.shape))
    return api.broadcast(tiled.contiguous(), root_rank)


def broadcast_parameters(params: Dict[str, torch.Tensor],
                         root_rank: int = 0) -> Dict[str, torch.Tensor]:
    """Broadcast rank ``root_rank``'s parameters to every rank, in place
    for rank-major tensors (reference torch/utility.py:26-55, used to make
    initial models consistent).  Returns the dict."""
    return {k: _leaf_broadcast(v, root_rank) for k, v in params.items()}


def allreduce_parameters(params: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Average parameters across all ranks, in place (reference
    torch/utility.py:58-86).  Returns the dict."""
    with torch.no_grad():
        return {k: api.allreduce_(v, average=True)
                for k, v in params.items()}


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> torch.optim.Optimizer:
    """Broadcast the rank-major state of a ``torch.optim`` optimizer over
    rank-major params (momentum buffers, Adam moments and per-rank step
    counts) from ``root_rank`` to every rank, in place (reference
    torch/utility.py:89-216).  State that is not rank-major (a scalar
    step count) is the same on every rank and stays.  Returns the
    optimizer."""
    for state in optimizer.state.values():
        for value in state.values():
            if isinstance(value, torch.Tensor) and _is_rank_major(value):
                with torch.no_grad():
                    api.broadcast_(value, root_rank)
    return optimizer

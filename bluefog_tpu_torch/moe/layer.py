"""A small expert-sharded MoE layer: top-1 router, capacity-factor
overflow as data, dispatch over the compiled all-to-all.

Port of ``bluefog_tpu/moe/layer.py``.  Each rank hosts ONE expert
replica (``dispatch.expert_owner``); the router and any surrounding
dense weights are SHARED consensus state (mixed by the neighbor
combine), while the ``expert`` leaves stay rank-local:
``build_train_step(..., moe=MoEConfig(...))`` makes that split.
Routing decisions, capacity overflow and expert liveness are all DATA
(``route_table``, ``capacity_mask``, the keep mask), so membership churn
and re-plans run on the same step.

Where the JAX package runs one rank's slice under ``shard_map``, every
function here takes the rank-major tensors of the ranks a backend holds
(leading axis ``n_local``) and computes them together; the all-to-all
moves shards between ranks through the backend.  Parameters are a
``{name: tensor}`` dict with the JAX tree's paths as dotted names:
``expert.wi``, ``expert.wo``, ``router.w``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from bluefog_tpu_torch import config as _config
from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.moe.dispatch import DispatchPlan, all_to_all_dispatch

# This module legitimately constructs weight tables from scratch: the
# analysis lint's weight-matrix-bypass rule treats it as an authority
# (everywhere else, tables must come from the shared helpers here).
_WEIGHT_AUTHORITY = True

__all__ = [
    "default_capacity",
    "init_moe_params",
    "moe_apply",
    "make_moe_loss",
]


def default_capacity(tokens_per_rank: int, n_ranks: int,
                     factor: Optional[float] = None) -> int:
    """Per-destination shard depth: ``ceil(factor * tokens / n)``,
    ``factor`` defaulting to the ``BLUEFOG_MOE_CAPACITY_FACTOR`` knob.
    Every destination rank receives at most this many tokens from each
    source: the static shard shape the wire carries."""
    if factor is None:
        factor = _config.moe_capacity_factor()
    if factor <= 0:
        raise ValueError(f"capacity factor must be > 0, got {factor}")
    return max(1, math.ceil(factor * tokens_per_rank / n_ranks))


def init_moe_params(generator: torch.Generator, d_model: int, d_hidden: int,
                    n_experts: int, *, n_ranks: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """One rank's parameters: a shared router head ``router.w [d_model,
    n_experts]`` plus the LOCAL expert MLP ``expert.wi [d_model,
    d_hidden]`` and ``expert.wo [d_hidden, d_model]``, f32, normal with
    std ``1/sqrt(fan_in)``, drawn from ``generator`` (a
    ``torch.Generator`` on ``device``).  With ``n_ranks`` the tensors are
    rank-major ``[n_ranks, ...]``, rank after rank from the one
    generator (every rank's draw differs, as JAX's per-rank keys do).
    The ``expert`` leaves are what ``MoEConfig`` keeps out of the
    mixing."""
    dev = resolve_device(device)
    lead = () if n_ranks is None else (int(n_ranks),)

    def normal(shape, fan_in):
        out = torch.empty(lead + shape, dtype=torch.float32, device=dev)
        for row in (out,) if n_ranks is None else out:
            row.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
        return out

    router = normal((d_model, n_experts), d_model)
    wi = normal((d_model, d_hidden), d_model)
    wo = normal((d_hidden, d_model), d_hidden)
    return {"expert.wi": wi, "expert.wo": wo, "router.w": router}


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: rows out of ``[0, n)`` are all zero."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_apply(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
              route_row: torch.Tensor, capacity_mask: torch.Tensor, *,
              plan: DispatchPlan, backend, capacity: int,
              wire_dtype: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE layer on the ranks' ``tokens [n_local, B, D]``: route
    top-1, pack per-destination shards up to ``capacity`` (overflow in
    batch order drops; the keep mask is returned), run the compiled
    dispatch, apply each rank's LOCAL expert MLP to everything that
    arrived, and retrace the wire back (``plan.transpose()``) for the
    gate-weighted combine.  Dropped and dead-routed tokens pass through
    on the residual path.

    ``route_row [n_local, n_experts]`` is each rank's row of the route
    table and ``capacity_mask [n_local, n]`` each rank's copy of the
    liveness vector (rank-major like every other per-rank operand: a
    heal swaps them wholesale).  Returns ``(output [n_local, B, D], keep
    [n_local, B] bool)``."""
    n = plan.n
    dtype = tokens.dtype
    logits = torch.bmm(tokens, params["router.w"])             # [k, B, E]
    gates = torch.softmax(logits, dim=-1)
    expert = torch.argmax(logits, dim=-1)                      # first max
    gate = torch.gather(gates, 2, expert[..., None])[..., 0]   # [k, B]
    dst = torch.gather(route_row.long(), 1, expert)            # [k, B]

    # capacity: position of each token within its destination group, in
    # batch order (the overflow drop set is a pure function of the batch
    # and the route data)
    dst_onehot = _one_hot(dst, n, dtype)                       # [k, B, n]
    before = torch.cumsum(dst_onehot, dim=1) - dst_onehot
    pos = torch.sum(before * dst_onehot, dim=2).to(torch.int64)
    alive = torch.gather(capacity_mask, 1, dst) > 0
    keep = (pos < capacity) & alive                            # [k, B]

    comb = (dst_onehot[..., None]
            * _one_hot(pos, capacity, dtype)[:, :, None, :]
            * keep[..., None, None].to(dtype))                 # [k,B,n,C]
    shards = torch.einsum("kbnc,kbd->kncd", comb, tokens)      # [k,n,C,D]

    arrived = all_to_all_dispatch(shards, plan, backend,
                                  wire_dtype=wire_dtype)
    flat = arrived.reshape(arrived.shape[0], n * capacity, -1)
    hidden = torch.relu(torch.bmm(flat, params["expert.wi"]))
    processed = torch.bmm(hidden, params["expert.wo"]).reshape(
        arrived.shape)
    returned = all_to_all_dispatch(processed, plan.transpose(), backend,
                                   wire_dtype=wire_dtype)

    combined = torch.einsum("kbnc,kncd->kbd", comb, returned)
    out = tokens + combined * gate[..., None]
    return out, keep


def make_moe_loss(plan: DispatchPlan, backend, capacity: int,
                  wire_dtype: Optional[str] = None):
    """``loss_fn(params, batch)`` for ``build_train_step(...,
    moe=MoEConfig(...))``: ``batch`` is ``(tokens, route_table,
    capacity_mask)``, every leaf RANK-MAJOR (tokens ``[n, B, D]``, the
    route table ``[n, n_experts]``, the liveness mask tiled ``[n, n]``),
    so a heal swaps batch data and nothing else.  It runs on every rank
    the backend holds at once (the dispatch crosses ranks) and returns
    each rank's loss, ``[n_local]``: the mean squared change of its
    tokens."""

    def loss_fn(params, batch):
        tokens, route_row, capacity_mask = batch
        out, _ = moe_apply(params, tokens, route_row, capacity_mask,
                           plan=plan, backend=backend, capacity=capacity,
                           wire_dtype=wire_dtype)
        return torch.square(out - tokens).mean(dim=(1, 2))

    return loss_fn

"""Decentralized train steps over rank-major state.

Port of ``bluefog_tpu/optim/functional.py``'s ``build_train_step`` for
the stacked backend (:class:`~bluefog_tpu_torch.parallel.collectives.
StackedBackend`), in the place of the JAX package's one compiled SPMD
program over a ``Mesh``.  Every state tensor is rank-major (leading
``[n_ranks]`` axis, one device); one step

1. runs forward and backward rank after rank (``loss_fn`` on rank r's
   slices, ``torch.autograd.grad``), so only one rank's activations are
   alive at a time, and writes rank r's gradient into a stacked buffer;
2. combines as ``comm_mode`` says (``functional.py:2012-2032``):

   * ``"cta"``: combine the params, then update the COMBINED params
     with the gradients taken at the pre-combine params;
   * ``"atc"``: update, then combine;
   * ``"gradient_allreduce"``: average the gradients over ranks, update;
   * ``"none"``: update only (local SGD);

   only params are mixed (batch statistics and optimizer state stay
   local), and with ``num_steps_per_communication=k`` the combine runs
   only when ``step % k == 0``;
3. updates with a ``torch.optim`` optimizer built over the stacked
   tensors.  SGD, Adam and AdamW update element by element, so each
   rank's slice gets exactly its own update; ``optax.sgd(lr,
   momentum=m)`` is ``torch.optim.SGD(lr=lr, momentum=m, dampening=0)``.
   Optimizers with per-tensor norms (LARS, LAMB, clipping) would mix
   ranks on stacked tensors and are refused.

The combine weights are runtime tensors, one ``(class_weights,
self_weights)`` pair per round, as the JAX package's fused builder passes
them (``comm_weight_inputs``); with ``schedule=`` step ``s`` runs round
``s % len(schedule)``.

State is updated IN PLACE: the params dict's tensors are the optimizer's
own (the step checks this), the batch statistics are overwritten rank by
rank, and the step returns the same objects.  ``opt_state`` is the
optimizer itself, which holds torch's optimizer state (momentum buffers
``[n_ranks, ...]``).

Features of the JAX builder this slice leaves out raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch

from bluefog_tpu_torch import config as _config
from bluefog_tpu_torch.parallel import collectives as C
from bluefog_tpu_torch.parallel.collectives import StackedBackend
from bluefog_tpu_torch.topology.spec import DynamicTopology, Topology

CommSpec = Union[Topology, DynamicTopology]

__all__ = ["build_train_step", "rank_major", "consensus_distance",
           "comm_weight_inputs", "ELEMENTWISE_OPTIMIZERS"]

ELEMENTWISE_OPTIMIZERS = (torch.optim.SGD, torch.optim.Adam,
                          torch.optim.AdamW)

_MODES_ITEM = "ROADMAP.md Queue 1, item 5 (the remaining train-step modes)"
_LLAMA_ITEM = "ROADMAP.md Queue 1, item 10 (the Llama training slice)"


def _not_ported(what: str, item: str = _MODES_ITEM):
    raise NotImplementedError(
        f"{what} is not ported to bluefog_tpu_torch yet; see {item}")


def rank_major(tree: Dict[str, torch.Tensor],
               backend: StackedBackend) -> Dict[str, torch.Tensor]:
    """Stack ``backend.size`` copies of every leaf of ``{name: tensor}``
    along a new leading rank axis on the backend's device: the initial
    state of decentralized training, every rank at the same point (the
    reference gets this from broadcast_parameters)."""
    return backend.rank_major(tree)


def consensus_distance(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean squared distance of each rank's parameters from the rank
    mean (float32 scalar), over every leaf of rank-major ``params``."""
    total = None
    count = 0
    for leaf in params.values():
        leaf = leaf.float()
        mean = leaf.mean(dim=0, keepdim=True)
        part = ((leaf - mean) ** 2).sum()
        total = part if total is None else total + part
        count += leaf.numel()
    return total / count


def comm_weight_inputs(specs: Sequence[CommSpec]) -> tuple:
    """One ``(class_weights [n_classes, n], self_weights [n])`` float64
    pair per round: the combine weights as runtime data."""
    return tuple((C.class_recv_weights(s), C.self_weight_vector(s))
                 for s in specs)


def _slice(tree, r: int):
    if isinstance(tree, torch.Tensor):
        return tree[r]
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_slice(v, r) for v in tree)
    raise TypeError(f"batch leaves must be rank-major tensors, got "
                    f"{type(tree)}")


def _check_config(comm_mode, topology, schedule, hierarchical,
                  hierarchical_local_size, sp_axis, pp_axis, batch_specs,
                  param_specs, opt_state_specs, compress, overlap, guard,
                  health, moe):
    if comm_mode not in ("cta", "atc", "gradient_allreduce", "push_sum",
                         "none"):
        raise ValueError(f"unknown comm_mode {comm_mode!r}")
    if comm_mode == "push_sum":
        _not_ported("comm_mode='push_sum'")
    if comm_mode in ("cta", "atc") and (topology is None) == (schedule is None):
        raise ValueError(
            "neighbor modes need exactly one of topology= or schedule=")
    if guard is not None:
        _not_ported("guard= (the guarded resilient step)")
    if health is not None:
        _not_ported("health= (the HealthVector output)")
    if overlap not in ("none", "bucketed"):
        raise ValueError(f"unknown overlap mode {overlap!r}")
    if overlap == "bucketed":
        _not_ported("overlap='bucketed'")
    if hierarchical is not None or hierarchical_local_size is not None:
        _not_ported("the hierarchical exchange (hierarchical=)")
    if comm_mode in ("cta", "atc") and _config.hier_local_size() is not None:
        _not_ported("the hierarchical exchange (BLUEFOG_HIER_LOCAL_SIZE)")
    if moe is not None:
        _not_ported("moe= (the expert-sharded step)", _LLAMA_ITEM)
    if sp_axis is not None or pp_axis is not None:
        _not_ported("sp_axis / pp_axis (sequence and pipeline parallelism)",
                    _LLAMA_ITEM)
    if any(s is not None for s in (batch_specs, param_specs,
                                   opt_state_specs)):
        _not_ported("model-parallel layouts (batch_specs / param_specs / "
                    "opt_state_specs)", _LLAMA_ITEM)
    if not _config.fuse_epilogues():
        _not_ported("BLUEFOG_FUSE_EPILOGUES=0 (the JAX package's pre-fusion "
                    "builders; the port has the fused pipeline's numerics "
                    "only)")
    if compress is None and comm_mode in ("cta", "atc"):
        compress = _config.mix_compress()
    if compress is not None and not isinstance(compress, str):
        _not_ported("compress=MixCompressConfig (error-feedback top-k "
                    "mixing)")
    if compress in ("int8_sr", "topk"):
        _not_ported(f"compress={compress!r}")
    if compress is not None:
        if compress not in ("int8", "bf16"):
            raise ValueError(f"unknown compress mode {compress!r}")
        if comm_mode not in ("cta", "atc"):
            raise ValueError("compress= is only honored by the cta/atc "
                             f"combine (got comm_mode={comm_mode!r})")
    return compress


def build_train_step(
    loss_fn: Callable,
    optimizer: torch.optim.Optimizer,
    backend: StackedBackend,
    *,
    comm_mode: str = "cta",
    topology: Optional[CommSpec] = None,
    schedule: Optional[Sequence[CommSpec]] = None,
    num_steps_per_communication: int = 1,
    hierarchical_local_size: Optional[int] = None,
    hierarchical: Any = None,
    sp_axis: Optional[str] = None,
    pp_axis: Optional[str] = None,
    batch_specs: Any = None,
    param_specs: Any = None,
    opt_state_specs: Any = None,
    donate: bool = True,
    has_aux: bool = False,
    compress: Optional[str] = None,
    overlap: str = "none",
    overlap_buckets: int = 4,
    guard: Any = None,
    health: Any = None,
    moe: Any = None,
) -> Callable:
    """One decentralized optimizer step over ``backend``'s ranks.

    ``loss_fn(params, batch) -> scalar loss`` runs on ONE rank's slices
    (the leading rank axis stripped; ``params`` a ``{name: tensor}``
    dict).  With ``has_aux=True`` it is ``loss_fn(params, aux, batch) ->
    (loss, new_aux)`` for mutable model state (batch-norm statistics) and
    the step takes and returns the rank-major ``aux`` dict.

    ``optimizer``: a ``torch.optim.SGD``, ``Adam`` or ``AdamW`` built over
    the rank-major param tensors.  ``comm_mode``, ``topology``/
    ``schedule``, ``num_steps_per_communication`` and ``compress``
    (``None``, ``"bf16"``, ``"int8"``; default ``BLUEFOG_MIX_COMPRESS``)
    mean what they mean in the JAX package.  ``donate`` has no effect:
    the state is always updated in place.

    Returns ``train_step(params, aux, opt_state, batch, step) -> (params,
    aux, opt_state, loss)`` with ``has_aux``, else ``train_step(params,
    opt_state, batch, step) -> (params, opt_state, loss)``; ``opt_state``
    is ``optimizer`` and ``loss`` a float32 ``[n_ranks]`` tensor.
    """
    del donate, overlap_buckets
    compress = _check_config(
        comm_mode, topology, schedule, hierarchical, hierarchical_local_size,
        sp_axis, pp_axis, batch_specs, param_specs, opt_state_specs,
        compress, overlap, guard, health, moe)
    if not isinstance(backend, StackedBackend):
        raise TypeError(f"backend must be a StackedBackend, got "
                        f"{type(backend).__name__} (the torch.distributed "
                        "backend is ROADMAP.md Queue 1, item 6)")
    if type(optimizer) not in ELEMENTWISE_OPTIMIZERS:
        raise TypeError(
            f"{type(optimizer).__name__} is not an element-wise optimizer: "
            "on rank-major tensors only "
            f"{[c.__name__ for c in ELEMENTWISE_OPTIMIZERS]} update each "
            "rank's slice with its own values")
    k_comm = int(num_steps_per_communication)
    if k_comm < 1:
        raise ValueError(f"num_steps_per_communication must be >= 1, got "
                         f"{k_comm}")
    n = backend.size
    specs = (list(schedule) if schedule is not None
             else [topology] if topology is not None else [])
    neighbor = comm_mode in ("cta", "atc") and bool(specs)
    for s in specs:
        if s.size != n:
            raise ValueError(f"topology of {s.size} ranks on a backend of "
                             f"{n}")
    weights_host = comm_weight_inputs(specs) if neighbor else ()
    weights_dev: Dict[tuple, list] = {}
    opt_params = {id(p) for g in optimizer.param_groups for p in g["params"]}

    def round_weights(r: int, device, dtype):
        key = (r, device, dtype)
        if key not in weights_dev:
            acc = C._accum_dtype(dtype)
            cw, sw = weights_host[r]
            weights_dev[key] = (cw.to(device=device, dtype=acc),
                                sw.to(device=device, dtype=acc))
        return weights_dev[key]

    def combine(params: Dict[str, torch.Tensor], step: int):
        """Mix every param leaf with its neighbors, in place.  The combine
        is elementwise, so without the int8 wire (whose absmax scale is
        per tensor) the leaves of one dtype are mixed as one flat
        ``[n, numel]`` buffer: the same arithmetic in a handful of
        launches instead of several per leaf."""
        if not neighbor or step % k_comm != 0:
            return
        r = step % len(specs)
        spec = specs[r]
        if compress == "int8":
            groups = [[p] for p in params.values()]
        else:
            by_dtype: Dict[torch.dtype, list] = {}
            for p in params.values():
                by_dtype.setdefault(p.dtype, []).append(p)
            groups = list(by_dtype.values())
        with torch.no_grad():
            for group in groups:
                flat = (group[0] if len(group) == 1 else
                        torch.cat([p.reshape(n, -1) for p in group], dim=1))
                cw, sw = round_weights(r, flat.device, flat.dtype)
                mixed = backend.neighbor_allreduce(
                    flat, spec, compress=compress, class_weights=cw,
                    self_weights=sw)
                if len(group) == 1:
                    group[0].copy_(mixed)
                    continue
                off = 0
                for p in group:
                    k = p[0].numel()
                    p.copy_(mixed[:, off:off + k].view_as(p))
                    off += k

    def run(params, aux, opt_state, batch, step):
        if opt_state is not optimizer:
            raise ValueError("opt_state must be the optimizer the step was "
                             "built with (it holds the optimizer state)")
        step = int(step)
        tensors = list(params.values())
        for name, p in params.items():
            if id(p) not in opt_params:
                raise ValueError(f"param {name!r} is not one of the "
                                 "optimizer's tensors")
            if p.shape[0] != n:
                raise ValueError(f"param {name!r} has {p.shape[0]} ranks, "
                                 f"the backend {n}")
        grads = [torch.empty_like(p) for p in tensors]
        losses = torch.empty(n, dtype=torch.float32,
                             device=tensors[0].device)
        for r in range(n):
            p_r = {k: v[r].detach().requires_grad_(True)
                   for k, v in params.items()}
            b_r = _slice(batch, r)
            with torch.enable_grad():
                if has_aux:
                    loss, new_aux = loss_fn(p_r, _slice(aux, r), b_r)
                else:
                    loss = loss_fn(p_r, b_r)
                gs = torch.autograd.grad(loss, list(p_r.values()))
            with torch.no_grad():
                for g_all, g in zip(grads, gs):
                    g_all[r].copy_(g)
                losses[r] = loss.detach().float()
                if has_aux:
                    for k, v in new_aux.items():
                        aux[k][r].copy_(v)
            del loss, gs, p_r
        if comm_mode == "gradient_allreduce":
            grads = [backend.allreduce(g, average=True) for g in grads]
        if comm_mode == "cta":
            combine(params, step)
        for p, g in zip(tensors, grads):
            p.grad = g
        optimizer.step()
        for p in tensors:
            p.grad = None
        if comm_mode == "atc":
            combine(params, step)
        return params, aux, optimizer, losses

    if has_aux:
        def train_step(params, aux, opt_state, batch, step):
            return run(params, aux, opt_state, batch, step)
    else:
        def train_step(params, opt_state, batch, step):
            params, _, opt_state, loss = run(params, None, opt_state,
                                             batch, step)
            return params, opt_state, loss

    # the in-place combine(params, step) the step runs, exposed for timing
    train_step.combine = combine
    return train_step

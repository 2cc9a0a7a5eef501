"""Decentralized train steps over rank-major state.

Port of ``bluefog_tpu/optim/functional.py``'s ``build_train_step`` over
a :class:`~bluefog_tpu_torch.parallel.collectives.RankBackend`, in the
place of the JAX package's one compiled SPMD program over a ``Mesh``:
every rank stacked on one device (``StackedBackend``), or ``k`` ranks in
each process of a ``torch.distributed`` job (``ProcessBackend``).  Every
state tensor is rank-major with a leading axis of the ranks this process
holds (``backend.n_local``); one step

1. runs forward and backward rank after rank (``loss_fn`` on rank r's
   slices, ``torch.autograd.grad``), so only one rank's activations are
   alive at a time, and writes rank r's gradient into a stacked buffer;
2. combines as ``comm_mode`` says:

   * ``"cta"``: combine the params, then update the COMBINED params
     with the gradients taken at the pre-combine params;
   * ``"atc"``: update, then combine;
   * ``"gradient_allreduce"``: average the gradients over ranks, update;
   * ``"push_sum"``: column-stochastic mix of the extended payload
     [params ‖ ps_weight], de-bias by the mixed weight, update;
   * ``"none"``: update only (local SGD);

   only params are mixed (batch statistics and optimizer state stay
   local), and with ``num_steps_per_communication=k`` the combine runs
   only when ``step % k == 0``;
3. updates with a ``torch.optim`` optimizer built over the stacked
   tensors.  SGD updates element by element through ``torch.optim.SGD``
   itself (``optax.sgd(lr, momentum=m)`` is ``SGD(lr=lr, momentum=m,
   dampening=0)``).  Adam and AdamW run torch's capturable update form
   with one step count PER RANK (``state["step"]`` is ``[n_ranks]``), as
   optax keeps one count per rank: a rank whose step the guard skips
   falls one count behind.  Optimizers with per-tensor norms (LARS,
   LAMB, clipping) would mix ranks on stacked tensors and are refused.

**The fused per-bucket epilogue.**  The param tree is planned into
``EpiloguePlan`` buckets (``optim/fusion.py``, the JAX plan leaf for
leaf): one bucket per leaf on the plain path, ``overlap_buckets``
size-balanced buckets under ``overlap="bucketed"``.  Each bucket's
quantize → exchange → dequantize → consensus partial runs as one pass,
and the guard's isfinite reduce and the health norms accumulate as
per-rank partials.  Where the exchange is elementwise (no int8 wire, no
top-k mixing) the plain path mixes consecutive leaves of one dtype as
flat buffers of up to 256 MiB a rank: the same arithmetic per element in
a handful of launches.  Under the int8 wires the absmax scale is per
bucket, as in JAX.

On CUDA tensors ``overlap="bucketed"`` runs each bucket's exchange on a
side stream ordered by events: under ``"cta"`` the exchange reads the
step's starting params while the forward and backward run, writing into
its own buffers, which are copied into the params before the update;
under unguarded ``"atc"`` bucket i's exchange runs while bucket i+1's
update is applied.

The combine weights are runtime tensors, one ``(class_weights,
self_weights)`` pair per round, as the JAX package's fused builder passes
them (``comm_weight_inputs``; the guarded step takes them as an
argument); with ``schedule=`` step ``s`` runs round ``s % len(schedule)``.

State is updated IN PLACE: the params dict's tensors are the optimizer's
own (the step checks this), the batch statistics are overwritten rank by
rank, the push-sum weight and the ``MixState`` buffers are written in
place, and the step returns the same objects.  ``opt_state`` is the
optimizer itself, or ``(optimizer, ps_weight)`` under push-sum, or
``(optimizer, MixState)`` under top-k mixing.  No step reads a device
value on the host.

Sequence parallelism (``sp_axis``), the model axes (``mesh_axes``:
tensor and expert parallelism, with ``param_specs`` /
``opt_state_specs``) and pipeline parallelism (``pp_axis``) run inside
step 1: each rank's forward and backward take all of its shards and
stages at once, the axes bound (see :func:`build_train_step`).  The
expert-sharded step (``moe=``, :class:`MoEConfig`) runs step 1 once over
every rank this process holds, since its all-to-all crosses ranks inside
the forward, and mixes only the shared leaves; it composes with
``sp_axis``.

**Per-device wire buckets.**  Under model-parallel specs the int8 wires
and top-k mixing keep a state per bucket of what ONE JAX device holds
(its absmax scale, its selection, its stochastic-rounding stream, its
``MixState`` rows).  The port stacks every shard and stage of a rank on
one device, so those modes plan and exchange their buckets over the
per-device view of the rank's leaves (``optim/fusion.py``'s
``DeviceLayout``): each sharded leaf's slice, each replicated leaf whole
on every device, and under ``pp_axis`` a stage's layers of one weight
name as one leaf.  A bucket is packed ``[n, devices, numel]`` and
exchanged in one pass for every device; a replicated leaf is written
back from device 0 (JAX's ``out_specs=P("bf")`` keeps the first
device's copy).  The elementwise exchanges (none, bf16) keep the
whole-rank buckets: per element they are the same arithmetic.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from bluefog_tpu_torch import config as _config
from bluefog_tpu_torch.compressor import _resolve_k
from bluefog_tpu_torch.optim import fusion as _fusion
from bluefog_tpu_torch.parallel import collectives as C
from bluefog_tpu_torch.parallel.collectives import RankBackend
from bluefog_tpu_torch.topology.spec import DynamicTopology, Topology

CommSpec = Union[Topology, DynamicTopology]

__all__ = ["GuardConfig", "HealthConfig", "HealthVector",
           "MixCompressConfig", "MixState", "MoEConfig", "build_train_step",
           "rank_major", "rank_major_init", "rank_spec_tree",
           "optax_state_specs", "consensus_distance", "comm_weight_inputs",
           "push_sum_weights", "ELEMENTWISE_OPTIMIZERS"]

ELEMENTWISE_OPTIMIZERS = (torch.optim.SGD, torch.optim.Adam,
                          torch.optim.AdamW)

# the name of the rank axis in a batch spec, the JAX package's mesh axis
RANK_AXIS = "bf"

# Per-rank bytes of one flat buffer of the elementwise exchange: enough to
# mix ResNet-50 (102 MB a rank) in one pass, and a bound on the combine's
# transient memory (three buffers of this size times the ranks) at
# Llama width, where one buffer per dtype would be gigabytes.
_FLAT_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Fault-tolerance policy of :func:`build_train_step`.  Only its
    PRESENCE changes the step (the non-finite skip guard, the ``skipped``
    output and the runtime combine weights); the fields are host-side
    policy for :func:`bluefog_tpu_torch.resilience.run_resilient`:
    ``max_consecutive_bad``, the rollback backoff ``backoff_base`` /
    ``backoff_factor`` / ``max_backoff`` and ``max_rollbacks``."""

    max_consecutive_bad: int = 3
    backoff_base: float = 0.5
    backoff_factor: float = 2.0
    max_backoff: float = 30.0
    max_rollbacks: int = 8


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """In-step health telemetry of :func:`build_train_step`: the step
    also returns a :class:`HealthVector`.  ``consensus=False`` reports 0.0
    for the consensus distance and skips its reduction."""

    consensus: bool = True


class HealthVector(NamedTuple):
    """Per-rank health scalars a step returns under ``health=``, each a
    float32 ``[n]`` tensor: ``loss``; ``grad_norm``, the L2 norm of the
    rank's LOCAL gradients; ``update_norm``, the L2 norm of the update
    (new minus old params, before any combine); ``skipped``, the guard's
    flag, or without a guard the would-skip bit; ``consensus``,
    ``‖x_i − Σ_j w_ij x_j‖`` from the exchange's pre and post buffers (0
    when no neighbor combine ran this step)."""

    loss: Any
    grad_norm: Any
    update_norm: Any
    skipped: Any
    consensus: Any


@dataclasses.dataclass(frozen=True)
class MixCompressConfig:
    """Error-feedback compressed parameter mixing (``compress="topk"`` is
    these defaults, with ``BLUEFOG_MIX_COMPRESS_RATIO`` consulted).  The
    wire carries ``topk(x − ref + e)`` per bucket
    (:func:`~bluefog_tpu_torch.parallel.collectives.mix_compress_exchange`).

    * ``ratio``: the build ratio; it fixes each bucket's k.  The LIVE
      ratio is ``MixState.ratio`` (``k_live <= k``).  ``>= 1.0`` builds
      the ordinary uncompressed exchange.
    * ``values``: ``"int8"``, ``"int8_sr"`` or ``"none"`` (f32 values).
    * ``error_feedback``: accumulate the residual into ``e``."""

    ratio: float = 0.25
    values: str = "int8"
    error_feedback: bool = True


class MixState(NamedTuple):
    """Per-rank error-feedback mixing state, rank-major float32, carried
    as ``opt_state = (optimizer, MixState)``; build it with
    ``train_step.init_mix_state(params)``.  ``ratio`` [n]: each rank's
    live ratio; per compressible bucket, ``err`` [n, numel], ``ref``
    [n, R, numel] (one row per schedule round) and ``mirror`` [n, G,
    numel] (``G`` = the sum of ``mix_mirror_slots`` over the rounds).
    Under per-device buckets ``numel`` is ``devices * numel``: each
    device's row, shard-major (JAX's ``P("bf", None, rest)`` gathered;
    ``train_step.mix_state_specs``)."""

    ratio: Any
    err: Any
    ref: Any
    mirror: Any


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Expert-sharded MoE policy for :func:`build_train_step`: which
    parameter leaves are EXPERT-LOCAL and therefore kept out of the
    neighbor combine.  Everything else (router, embeddings, dense trunk)
    keeps flowing through the ordinary cta/atc combine, so the guard,
    health and compressed mixing compose unchanged; the expert
    all-to-all itself lives inside ``loss_fn``
    (:mod:`bluefog_tpu_torch.moe`), not in the builder.

    * ``n_experts``: expert count (each rank hosts replica
      ``rank % n_experts``; see ``moe.dispatch.expert_owner``);
    * ``capacity``: per-destination shard depth of the dispatch wire
      (``moe.layer.default_capacity`` derives one from the
      ``BLUEFOG_MOE_CAPACITY_FACTOR`` knob);
    * ``expert_path_tokens``: a param whose name contains any of these
      substrings is expert-local (the port's dotted names, the
      counterpart of ``jax.tree_util.keystr``; the default matches the
      ``expert.*`` leaves of ``moe.layer.init_moe_params``)."""

    n_experts: int
    capacity: int
    expert_path_tokens: Tuple[str, ...] = ("expert",)

    def __post_init__(self):
        if self.n_experts < 1 or self.capacity < 1:
            raise ValueError(
                f"MoEConfig needs n_experts >= 1 and capacity >= 1, "
                f"got {self.n_experts} / {self.capacity}")
        if not self.expert_path_tokens:
            raise ValueError("expert_path_tokens must be non-empty — "
                             "an MoE step with no local leaves is just "
                             "a dense step")


def _moe_shared_mask(names: Sequence[str], moe: MoEConfig) -> list:
    """Per-leaf booleans in ``names`` order: True = shared (mixed by the
    combine), False = expert-local (never on the mixing wire)."""
    return [not any(tok in name for tok in moe.expert_path_tokens)
            for name in names]


def rank_major(tree: Dict[str, torch.Tensor], backend: RankBackend,
               specs: Optional[Dict[str, tuple]] = None
               ) -> Dict[str, torch.Tensor]:
    """Stack ``backend.n_local`` copies of every leaf of ``{name:
    tensor}`` (one per rank this process holds) along a new leading rank
    axis on the backend's device: the initial state of decentralized
    training, every rank at the same point (the reference gets this from
    broadcast_parameters).  ``specs`` (``llama_param_specs``' form, the
    rank axis first) names a model-parallel layout: each rank still holds
    every shard of its leaves (the model takes each shard's slice), so
    only the specs' form is checked."""
    if specs is not None:
        _check_spec_form(tree, specs)
    return backend.rank_major(tree)


def _rank_entry(entry) -> Optional[tuple]:
    """The axes a spec's rank entry names beyond the rank axis: ``()``
    for ``"bf"``, ``("pp",)`` for a stage-owned leaf's ``("bf", "pp")``
    (``llama_param_specs(pp_axis=)``); None when it is neither."""
    if entry == RANK_AXIS:
        return ()
    if (isinstance(entry, tuple) and entry and entry[0] == RANK_AXIS
            and all(isinstance(a, str) for a in entry)):
        return entry[1:]
    return None


def _check_spec_form(tree, specs) -> None:
    """Every spec of ``specs`` names a leaf of ``tree`` (leaves without
    the rank axis) and is a tuple that starts with the rank axis (or
    ``(rank axis, pp axis)`` for a stage-owned leaf), one entry per dim
    of the rank-major leaf at most."""
    for k, spec in specs.items():
        if k not in tree:
            raise ValueError(f"specs names {k!r}, which the tree does "
                             "not hold")
        if not (isinstance(spec, tuple) and spec
                and _rank_entry(spec[0]) is not None
                and len(spec) <= tree[k].dim() + 1):
            raise ValueError(f"specs[{k!r}] = {spec!r}: a tuple of axis "
                             f"names that starts with {RANK_AXIS!r}, one "
                             "per dim at most")


def rank_major_init(init_fn: Callable[[], Dict[str, torch.Tensor]],
                    backend: RankBackend,
                    specs: Optional[Dict[str, tuple]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Rank-major state built on the backend's device with no host
    staging copy: ``init_fn()`` builds one rank's leaves, on the device,
    leaf after leaf they are broadcast into an uninitialized ``[n_local,
    ...]`` stack there, and each single copy is dropped before the next
    stack is allocated.  Under ``bfrun`` each process builds only its own
    rows (``n_local``).  ``specs``: as :func:`rank_major`."""
    dev = backend.device
    with torch.device(dev):
        tree = init_fn()
    if specs is not None:
        _check_spec_form(tree, specs)
    out = {}
    for k in list(tree):
        leaf = tree.pop(k).detach()
        stacked = torch.empty((backend.n_local,) + tuple(leaf.shape),
                              dtype=leaf.dtype, device=dev)
        stacked.copy_(leaf.to(dev).unsqueeze(0).expand_as(stacked))
        out[k] = stacked
        del leaf
    return out


def rank_spec_tree(tree, axis_name: str = RANK_AXIS) -> Dict[str, tuple]:
    """The spec of every leaf of ``{name: ...}``: the leading rank axis
    only, ``(axis_name,)``."""
    return {k: (axis_name,) for k in tree}


def optax_state_specs(optimizer: torch.optim.Optimizer, params_shapes,
                      param_specs, axis_name: str = RANK_AXIS
                      ) -> Dict[str, Dict[str, tuple]]:
    """The specs of a torch optimizer's state, the port's counterpart of
    JAX's map over an optax state: ``{param name: {state key: spec}}``.
    ``params_shapes``: ``{name: tensor or shape}`` WITHOUT the rank
    axis, ``param_specs``: ``{name: spec}`` (``llama_param_specs``).  A
    state tensor of its param's shape (momentum, Adam's moments)
    inherits the param's spec; every other entry (Adam's per-rank
    ``step``, a shape-reduced statistic) is ``(axis_name,)`` — but a
    shape-reduced leaf of a MODEL-PARALLEL param raises, as in JAX:
    factored optimizers do not compose with model-parallel shardings.
    The state is read from one step of ``type(optimizer)`` with its
    hyperparameters on zero tensors of the params' shapes (on the
    ``meta`` device where the optimizer runs there)."""
    shapes = {k: tuple(getattr(v, "shape", v)) for k, v in
              params_shapes.items()}
    state = None
    for device in ("meta", "cpu"):
        probe = [torch.zeros(sh, device=device, requires_grad=True)
                 for sh in shapes.values()]
        opt = type(optimizer)(probe, **optimizer.defaults)
        for t in probe:
            t.grad = torch.zeros_like(t)
        try:
            opt.step()
        except (RuntimeError, NotImplementedError):
            if device == "meta":
                continue
            raise
        state = [opt.state[t] for t in probe]
        break
    out = {}
    for (name, shape), st in zip(shapes.items(), state):
        spec = (param_specs if isinstance(param_specs, tuple)
                else param_specs[name])
        entry = {}
        for key, v in st.items():
            v_shape = tuple(getattr(v, "shape", ()))
            if v_shape == shape:
                entry[key] = spec
                continue
            model_axes = [a for a in _spec_axes(spec) if a != axis_name]
            if v_shape and model_axes:
                raise ValueError(
                    f"optimizer state leaf of shape {v_shape} is "
                    f"shape-reduced relative to its param {shape} whose "
                    f"spec {spec} is model-parallel over {model_axes} — "
                    "factored optimizers (e.g. adafactor) do not compose "
                    "with model-parallel param shardings here; pass an "
                    "explicit opt_state_specs tree that shards the "
                    "factored moments to match, or use a non-factored "
                    "optimizer")
            entry[key] = (axis_name,)
        out[name] = entry
    return out


def consensus_distance(params: Dict[str, torch.Tensor],
                       backend: Optional[RankBackend] = None
                       ) -> torch.Tensor:
    """Mean squared distance of each rank's parameters from the rank
    mean (float32 scalar), over every leaf of rank-major ``params``.
    With a ``backend`` whose ranks span processes, every rank's rows are
    gathered first (a collective: every process calls it)."""
    total = None
    count = 0
    for leaf in params.values():
        if backend is not None:
            leaf = backend.gather_ranks(leaf)
        leaf = leaf.float()
        mean = leaf.mean(dim=0, keepdim=True)
        part = ((leaf - mean) ** 2).sum()
        total = part if total is None else total + part
        count += leaf.numel()
    return total / count


def comm_weight_inputs(specs: Sequence[CommSpec]) -> tuple:
    """One ``(class_weights [n_classes, n], self_weights [n])`` float64
    pair per round: the combine weights as runtime data (the guarded
    step's ``comm_weights`` argument)."""
    return tuple((C.class_recv_weights(s), C.self_weight_vector(s))
                 for s in specs)


def push_sum_weights(backend: RankBackend) -> torch.Tensor:
    """The push-sum weight vector, 1 per rank this process holds
    (float32 ``[n_local]`` on the backend's device): ``opt_state =
    (optimizer, push_sum_weights(b))`` for ``comm_mode="push_sum"``."""
    return torch.ones(backend.n_local, dtype=torch.float32,
                      device=backend.device)


def _slice(tree, r: int):
    if isinstance(tree, torch.Tensor):
        return tree[r]
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_slice(v, r) for v in tree)
    raise TypeError(f"batch leaves must be rank-major tensors, got "
                    f"{type(tree)}")


def _ranks(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-rank ``[n]`` tensor shaped to broadcast against ``like``."""
    return mask.reshape((like.shape[0],) + (1,) * (like.dim() - 1))


def _sq_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-rank float32 sum of squares of rank-major ``x``: ``[n]``."""
    return x.float().reshape(x.shape[0], -1).square().sum(dim=1)


def _finite_rows(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)


class _Plan(NamedTuple):
    """The exchange plan of a leaf list: per exchange group its leaf
    indices and ``EpiloguePlan`` bucket (None for a flat dtype group),
    its compressible-bucket index (or None), and under per-device
    buckets its ``DeviceLayout`` view indices (``layout``; None
    otherwise)."""

    groups: list
    comp: list
    views: list
    layout: Optional[_fusion.DeviceLayout]

    def pack(self, tensors, g: int) -> torch.Tensor:
        """Group ``g``'s buffer: ``[n, numel]``, or ``[n, devices,
        numel]`` for per-device buckets."""
        if self.layout is not None:
            return self.layout.pack(tensors, self.views[g])
        return _fusion.pack_bucket(tensors, self.groups[g][0])

    def unpack(self, out, tensors, g: int) -> None:
        if self.layout is not None:
            self.layout.unpack(out, tensors, self.views[g])
        else:
            _unpack_into(out, tensors, self.groups[g][0])


def _unpack_into(out, tensors, idx):
    """Copy a combined bucket buffer back into its leaves."""
    if len(idx) == 1:
        tensors[idx[0]].copy_(out)
        return
    n = out.shape[0]
    off = 0
    for i in idx:
        k = tensors[i][0].numel()
        tensors[i].copy_(out[:, off:off + k].view(tensors[i].shape))
        off += k


# The loops over a step's leaves live in functions of their own: a
# loop variable left bound in the step's frame keeps the last leaf's
# gradient, update or snapshot alive through the combine (gigabytes
# at 8B width).
def _copy_rank_rows(dst, r: int, src) -> None:
    """Row ``r`` of each rank-major tensor of ``dst`` from ``src``."""
    for d, x in zip(dst, src):
        d[r].copy_(x)


def _grad_sq(grads, zero: torch.Tensor) -> torch.Tensor:
    """Per-rank float32 sum of squares of every floating gradient."""
    acc = zero
    for g in grads:
        if g.dtype.is_floating_point:
            acc = acc + _sq_rows(g)
    return acc


def _track_update(tensors, old, idx, ok, upd_sq, floats_only: bool):
    """``ok`` and-ed with each rank's update of the leaves ``idx`` being
    finite, and ``upd_sq`` (or None) plus their squares."""
    for i in idx:
        if floats_only and not tensors[i].dtype.is_floating_point:
            continue
        u = tensors[i] - old[i]
        ok = ok & _finite_rows(u)
        if upd_sq is not None:
            upd_sq = upd_sq + _sq_rows(u)
    return ok, upd_sq


def _guard_select(tensors, old, ok) -> None:
    """The skip guard's select: a rank whose ``ok`` is false gets its
    old values back, elementwise, in place."""
    for p, o in zip(tensors, old):
        torch.where(_ranks(ok, p), p, o, out=p)


def _leaf_cons_sq(pre, out, tensors, idx, n):
    """Per-leaf squared consensus partials of one bucket, summed in leaf
    order (the unfused builders' tree walk)."""
    acc = torch.zeros(n, dtype=torch.float32, device=out.device)
    pre2, out2 = pre.reshape(n, -1), out.reshape(n, -1)
    off = 0
    for i in idx:
        k = tensors[i][0].numel()
        d = pre2[:, off:off + k].float() - out2[:, off:off + k].float()
        acc = acc + d.square().sum(dim=1)
        off += k
    return acc


def _rank_adam(optimizer, tensors, grads, n) -> None:
    """torch.optim.Adam/AdamW's capturable update form (the bias
    corrections as tensors), with ``state["step"]`` a float32 ``[n]``
    count per rank instead of one count per tensor: optax keeps one count
    per rank, and a rank the guard skips must fall behind."""
    todo = {id(p): g for p, g in zip(tensors, grads)}
    decoupled_type = isinstance(optimizer, torch.optim.AdamW)
    for group in optimizer.param_groups:
        lr = group["lr"]
        beta1, beta2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        decoupled = group.get("decoupled_weight_decay", decoupled_type)
        for p in group["params"]:
            g = todo.get(id(p))
            if g is None:
                continue
            if group.get("maximize", False):
                g = -g
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.zeros(n, dtype=torch.float32,
                                            device=p.device)
                state["exp_avg"] = torch.zeros_like(p)
                state["exp_avg_sq"] = torch.zeros_like(p)
            elif state["step"].dim() == 0:   # a count torch.optim kept
                state["step"] = state["step"].to(
                    device=p.device, dtype=torch.float32).expand(n).clone()
            step_t = state["step"]
            step_t += 1
            if wd != 0:
                if decoupled:
                    p.mul_(1 - lr * wd)
                else:
                    g = g.add(p, alpha=wd)
            m, v = state["exp_avg"], state["exp_avg_sq"]
            m.lerp_(g, 1 - beta1)
            v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
            t = _ranks(step_t, p)
            step_size_neg = (lr / (1 - beta1 ** t)).neg()
            bc2_sqrt = (1 - beta2 ** t).sqrt()
            denom = (v.sqrt() / (bc2_sqrt * step_size_neg)).add_(
                eps / step_size_neg)
            p.addcdiv_(m, denom)


def _snapshot_state(optimizer, tensors, n):
    """Clones of every rank-major optimizer-state tensor of ``tensors``
    (momentum, Adam moments and counts), keyed by param."""
    snap = {}
    for p in tensors:
        snap[id(p)] = {k: v.clone() for k, v in optimizer.state[p].items()
                       if isinstance(v, torch.Tensor) and v.dim() >= 1
                       and v.shape[0] == n}
    return snap


def _select_state(optimizer, tensors, snap, ok, n) -> None:
    """Restore a skipped rank's optimizer state (``ok[r]`` false): state
    created by this step (the first momentum buffer) restores to zero,
    what optax's init holds."""
    for p in tensors:
        old = snap[id(p)]
        for k, v in optimizer.state[p].items():
            if not (isinstance(v, torch.Tensor) and v.dim() >= 1
                    and v.shape[0] == n):
                continue
            prev = old.get(k)
            if prev is None:
                prev = torch.zeros((), dtype=v.dtype, device=v.device)
            torch.where(_ranks(ok, v), v, prev, out=v)


def _observed_step(step_fn: Callable, labels: dict,
                   edge_traffic: Optional[tuple] = None,
                   mixed: Optional[Callable[[str], bool]] = None,
                   leaf_shards: Optional[Callable] = None
                   ) -> Callable:
    """Host-side observability of a built step: each call increments
    ``bf_train_steps_total{comm_mode,overlap,guarded}`` and runs inside a
    ``train_step`` span on the ``train`` track (nothing when
    ``BLUEFOG_OBSERVE=0``).  The span measures host dispatch: torch is
    asynchronous on the card, so synchronize before reading it as a step
    time.

    ``edge_traffic`` — ``(specs, step_argpos, k_comm, n_local, n_ranks,
    filtered, local_size)`` for the neighbor modes: per on-cycle call,
    the round's edges each get the per-rank parameter payload added to
    ``bf_edge_bytes_total{src,dst}`` through
    ``observe.fleet.record_edge_traffic`` (logical bytes, computed once
    from the params' sizes on the host: wire compression is not folded
    in, and no device value is read).  ``filtered`` bills the
    weight-filtered push-sum edges (``push_sum_mix`` moves only
    nonzero-weight edges) instead of every declared edge.  Under a
    hierarchical exchange (``local_size`` set, ``specs`` machine-level)
    the intra-machine ring edges bill as ``link="ici"`` and the expanded
    machine edges as ``link="dcn"``, as in the JAX package.  ``mixed``
    (a predicate on param names) bills only the leaves the combine moves
    (the shared leaves under ``moe=``).  ``leaf_shards`` (params ->
    ``{name: pieces}``, under model-parallel ``param_specs``) bills what
    one JAX device sends: each leaf's bytes over the pieces its spec
    splits it into."""
    from bluefog_tpu_torch import observe

    payload_cache: list = []
    pairs_cache: dict = {}

    def record_edges(args) -> None:
        specs, step_argpos, k_comm, n_local, n_ranks, filtered, \
            local_size = edge_traffic
        try:
            step_i = int(args[step_argpos])
        except (TypeError, ValueError, IndexError):
            return
        if step_i % k_comm != 0:
            return
        if not payload_cache:
            pieces = (leaf_shards(args[0]) if leaf_shards is not None
                      else {})
            payload_cache.append(sum(
                t.numel() * t.element_size() // pieces.get(k, 1)
                for k, t in args[0].items()
                if mixed is None or mixed(k)) // max(n_local, 1))
        from bluefog_tpu_torch.observe import fleet as _fleet

        si = step_i % len(specs)
        pairs = pairs_cache.get(si)
        if pairs is None:
            if local_size:
                L = int(local_size)
                dcn = [(ms * L + j, md * L + j)
                       for (ms, md) in _fleet.edge_list(specs[si])
                       for j in range(L)]
                ici = [(g[k], g[(k + 1) % len(g)])
                       for g in C.machine_groups(n_ranks, L) if len(g) > 1
                       for k in range(len(g))]
                pairs = (("ici", ici), ("dcn", dcn))
            else:
                pairs = ((None, _fleet.gossip_edge_list(specs[si])
                          if filtered else _fleet.edge_list(specs[si])),)
            pairs_cache[si] = pairs
        for link, leg in pairs:
            if leg:
                _fleet.record_edge_traffic(specs[si], payload_cache[0],
                                           pairs=leg, link=link)

    def step(*args, **kwargs):
        tr = observe.publish_tracer()
        if tr is None:
            return step_fn(*args, **kwargs)
        observe.get_registry().counter(
            "bf_train_steps_total", "train-step dispatches", **labels).inc()
        if edge_traffic is not None:
            record_edges(args)
        with tr.span("train", "train_step"):
            return step_fn(*args, **kwargs)

    return step


def _check_specs(spec, axes) -> None:
    """``batch_specs`` is one spec for every batch leaf: a tuple of axis
    names, one per dim, that starts with the rank axis ``"bf"`` and names
    at most one of the step's axes (``axes``: name -> axis, the sequence
    axis and the ``mesh_axes``), once."""
    if not (isinstance(spec, tuple) and spec and spec[0] == RANK_AXIS
            and all(e is None or isinstance(e, str) for e in spec)):
        raise ValueError(
            f"batch_specs {spec!r}: a tuple of axis names (str or None), one "
            f"per batch dim, the first the rank axis {RANK_AXIS!r}")
    names = [e for e in spec[1:] if e is not None]
    unknown = [e for e in names if e not in axes]
    if unknown:
        raise ValueError(f"batch_specs {spec!r} names {unknown}, which "
                         "neither sp_axis nor mesh_axes holds")
    if len(names) > 1:
        raise ValueError(f"batch_specs {spec!r} splits the batch over "
                         f"{names}: name one axis, once")


def _spec_axes(spec) -> list:
    """The axis names a spec tuple shards over (entries may be a name,
    None, or a tuple of names)."""
    out = []
    for e in spec or ():
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                out.append(a)
    return out


def _check_param_specs(params, param_specs, axes) -> Dict[str, int]:
    """Hold ``param_specs`` (``{name: spec}`` or one spec for every leaf)
    to the rank-major ``params``: each spec starts with the rank axis
    (with the pp axis for a stage-owned leaf), fits its leaf's dims,
    names only ``axes`` (the step's mesh axes) and splits each named dim
    evenly.  Returns ``{name: shards}``, the number of pieces each leaf
    is split into (its bytes over that are what one JAX device holds: a
    stage-owned leaf counts the stages, each holding its share of the
    layers)."""
    out = {}
    for name, leaf in params.items():
        spec = (param_specs if isinstance(param_specs, tuple)
                else param_specs.get(name))
        if spec is None:
            raise ValueError(f"param_specs has no spec for {name!r}")
        extra = (_rank_entry(spec[0]) if isinstance(spec, tuple) and spec
                 else None)
        if extra is None:
            raise ValueError(f"param_specs[{name!r}] = {spec!r}: a tuple "
                             f"of axis names that starts with "
                             f"{RANK_AXIS!r}")
        if len(spec) > leaf.dim():
            raise ValueError(f"param_specs[{name!r}] = {spec!r} has more "
                             f"dims than the leaf {tuple(leaf.shape)}")
        shards = 1
        for a in extra:
            if a not in axes:
                raise ValueError(f"param_specs[{name!r}] gives {a!r} the "
                                 "leaf's stage, but the step has no such "
                                 "pp_axis")
            shards *= axes[a].size
        for d, e in enumerate(spec[1:], start=1):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is None:
                    continue
                if a not in axes:
                    raise ValueError(
                        f"param_specs[{name!r}] shards over {a!r}, which "
                        "mesh_axes does not hold")
                if leaf.shape[d] % axes[a].size:
                    raise ValueError(
                        f"param_specs[{name!r}]: dim {d} of {name!r} "
                        f"({leaf.shape[d]}) does not split over "
                        f"{axes[a]!r}")
                shards *= axes[a].size
        out[name] = shards
    return out


def _shard_batch(tree, spec, n: int, lead: int = 0):
    """One rank's batch (``lead=0``; every rank's, rank-major, with
    ``lead=1``) with every leaf split along the dim the spec names
    (counted with the rank axis) into its ``n`` shards, stacked
    shard-major after the ``lead`` dims; with no dim named, the batch as
    it is (every shard sees it whole, as in JAX)."""
    dims = [i - 1 + lead for i, e in enumerate(spec) if i and e is not None]
    if not dims:
        return tree
    if isinstance(tree, dict):
        return {k: _shard_batch(v, spec, n, lead) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_shard_batch(v, spec, n, lead) for v in tree)
    d = dims[0]
    if tree.shape[d] % n:
        raise ValueError(f"batch dim {d + 1 - lead} of size {tree.shape[d]} "
                         f"does not split into {n} sequence shards")
    return tree.unflatten(d, (n, tree.shape[d] // n)).movedim(
        d, lead).contiguous()


def _shard_mean(loss: torch.Tensor, n: int, lead: int = 0) -> torch.Tensor:
    """The loss of a sequence-parallel ``loss_fn``: its per-shard losses'
    mean (JAX's ``pmean`` over the axis), or a scalar as it is; with
    ``lead=1`` each rank's (rank-major ``[n_local, n]`` or ``[n_local]``)."""
    if loss.dim() == lead + 1 and loss.shape[lead] == n:
        return loss.mean(lead)
    if loss.dim() > lead:
        raise ValueError(f"under sp_axis loss_fn returns each of the {n} "
                         f"shards' losses ([{n}]) or a scalar, got "
                         f"{tuple(loss.shape)}")
    return loss


def _stage_sum(loss: torch.Tensor, n: int, lead: int = 0) -> torch.Tensor:
    """The loss of a pipeline ``loss_fn``: its per-stage losses ``[S,
    ...]`` summed over the stages (JAX's ``psum`` over pp of the
    last-stage-masked losses), or a scalar as it is; with ``lead=1``
    each rank's."""
    if loss.dim() > lead and loss.shape[lead] == n:
        return loss.sum(lead)
    if loss.dim() > lead:
        raise ValueError(f"under pp_axis loss_fn returns each of the {n} "
                         f"stages' losses ([{n}, ...]) or a scalar, got "
                         f"{tuple(loss.shape)}")
    return loss


def _resolve_modes(backend, comm_mode, topology, schedule, hierarchical,
                   hierarchical_local_size, sp_axis, pp_axis, batch_specs,
                   param_specs, opt_state_specs, compress, overlap,
                   overlap_buckets, guard, moe, mesh_axes):
    """The JAX builder's checks, in its order and with its messages.
    Returns (specs, hierarchical_local_size, compress, mix, fused, the
    mesh axes by name (the pp axis among them), the batch-splittable
    axes by name, the pp axis or None)."""
    if comm_mode not in ("cta", "atc", "gradient_allreduce", "push_sum",
                         "none"):
        raise ValueError(f"unknown comm_mode {comm_mode!r}")
    needs_topo = comm_mode in ("cta", "atc", "push_sum")
    if needs_topo and (topology is None) == (schedule is None):
        raise ValueError(
            "neighbor modes need exactly one of topology= or schedule=")
    hls = hierarchical_local_size
    if hierarchical is not None:
        # a PodSpec (duck-typed: machines / chips_per_machine) or a plain
        # int local size: either way the intra-machine group width
        hier_l = int(getattr(hierarchical, "chips_per_machine",
                             hierarchical))
        if hls is not None and int(hls) != hier_l:
            raise ValueError(
                f"hierarchical={hierarchical!r} (local size {hier_l}) "
                f"conflicts with hierarchical_local_size={hls!r}")
        hls = hier_l
    if hls is None and comm_mode in ("cta", "atc"):
        hls = _config.hier_local_size()
    if comm_mode == "push_sum" and hls is not None:
        raise ValueError(
            "hierarchical_local_size is not supported with "
            "comm_mode='push_sum' (flat rank-level push-sum only)")
    specs = (list(schedule) if schedule is not None
             else [topology] if topology is not None else [])
    if hls is not None and comm_mode in ("cta", "atc"):
        hls = int(hls)
        C.validate_machine_decomposition(backend.size, hls, specs)
        machines = getattr(hierarchical, "machines", None)
        if machines is not None and int(machines) * hls != backend.size:
            raise ValueError(
                f"hierarchical pod of {machines} machines x {hls} chips "
                f"does not cover the {backend.size}-rank backend")
    elif comm_mode not in ("cta", "atc"):
        hls = None
    if pp_axis is not None and param_specs is None:
        raise ValueError(
            "pp_axis requires param_specs: the spec tree is what tells "
            "pipeline-sharded leaves (layer stacks, NOT reduced over pp) "
            "apart from pp-replicated ones (embeddings/head, psum'd)")
    if sp_axis is not None and not isinstance(sp_axis, C.SeqAxis):
        raise TypeError(
            f"sp_axis must be the axis itself, SeqAxis({sp_axis!r}, size): "
            "the port has no mesh to hold its size")
    axes = {}
    for ax in mesh_axes:
        if not isinstance(ax, C.MeshAxis) or isinstance(ax, C.SeqAxis):
            raise TypeError(
                f"mesh_axes takes the model axes themselves, MeshAxis("
                f"name, size) (the sequence axis goes to sp_axis=), got "
                f"{ax!r}")
        if ax.name == RANK_AXIS or ax.name in axes or (
                sp_axis is not None and ax.name == sp_axis.name):
            raise ValueError(f"mesh_axes: axis name {ax.name!r} is taken")
        axes[ax.name] = ax
    pp = pp_axis
    if pp is not None:
        if not isinstance(pp, C.MeshAxis) or isinstance(pp, C.SeqAxis):
            raise TypeError(
                f"pp_axis must be the axis itself, MeshAxis({pp!r}, "
                "n_stages): the port has no mesh to hold its size")
        if pp.name in axes or pp.name == RANK_AXIS or (
                sp_axis is not None and pp.name == sp_axis.name):
            raise ValueError(f"pp_axis: axis name {pp.name!r} is taken")
        axes[pp.name] = pp
    if sp_axis is not None:
        axes_b = dict(axes, **{sp_axis.name: sp_axis})
    else:
        axes_b = axes
    if batch_specs is not None:
        _check_specs(batch_specs, axes_b)
    if param_specs is not None and not isinstance(param_specs,
                                                  (tuple, dict)):
        raise TypeError("param_specs is {name: spec} or one spec tuple, "
                        f"got {type(param_specs).__name__}")
    if compress is None and comm_mode in ("cta", "atc"):
        compress = _config.mix_compress()
    mix = None
    if isinstance(compress, MixCompressConfig):
        mix, compress = compress, None
    elif compress == "topk":
        env_ratio = _config.mix_compress_ratio()
        mix = (MixCompressConfig() if env_ratio is None
               else MixCompressConfig(ratio=env_ratio))
        compress = None
    if mix is not None:
        if comm_mode not in ("cta", "atc"):
            raise ValueError(
                "compress='topk' (error-feedback compressed mixing) rides "
                f"the cta/atc combine only (got comm_mode={comm_mode!r})")
        if mix.values not in ("int8", "int8_sr", "none"):
            raise ValueError(
                f"unknown MixCompressConfig values mode {mix.values!r}")
        if not mix.ratio > 0:
            raise ValueError(
                f"MixCompressConfig.ratio must be > 0, got {mix.ratio}")
        if mix.ratio >= 1.0:
            # keep-everything: the ordinary uncompressed exchange
            mix = None
    if compress is not None:
        if compress not in ("int8", "int8_sr", "bf16"):
            raise ValueError(f"unknown compress mode {compress!r}")
        if comm_mode not in ("cta", "atc"):
            raise ValueError("compress= is only honored by the cta/atc "
                             f"combine (got comm_mode={comm_mode!r})")
    if overlap not in ("none", "bucketed"):
        raise ValueError(f"unknown overlap mode {overlap!r}")
    if guard is not None and comm_mode == "push_sum":
        raise ValueError(
            "guard= does not compose with comm_mode='push_sum': the "
            "(params, ps_weight) pair must mix as a unit, and a per-rank "
            "skip would break the column-stochastic sum(ps) == n "
            "invariant")
    if moe is not None and comm_mode not in ("cta", "atc"):
        raise ValueError(
            "moe= (expert-sharded MoE) partitions the NEIGHBOR combine "
            "into shared/expert leaves, so it needs comm_mode='cta' or "
            f"'atc' (got {comm_mode!r}); gradient_allreduce would "
            "average expert gradients across ranks hosting DIFFERENT "
            "experts, and push_sum's (x, w) pair cannot be split")
    if overlap == "bucketed":
        if comm_mode not in ("cta", "atc", "push_sum"):
            raise ValueError(
                "overlap='bucketed' buckets the cta/atc/push_sum neighbor "
                f"exchange only (got comm_mode={comm_mode!r}); "
                "gradient_allreduce relies on XLA's all-reduce combiner")
        if overlap_buckets < 1:
            raise ValueError(
                f"overlap_buckets must be >= 1, got {overlap_buckets}")
    fused = _config.fuse_epilogues()
    if not fused:
        if mix is not None:
            raise ValueError(
                "compress='topk' (error-feedback compressed mixing) needs "
                "the fused epilogue pipeline — unset "
                "BLUEFOG_FUSE_EPILOGUES=0 (the pre-fusion builders have no "
                "ef_encode/ef_decode stages)")
        if moe is not None:
            raise ValueError(
                "moe= (expert-sharded MoE) needs the fused epilogue "
                "pipeline — unset BLUEFOG_FUSE_EPILOGUES=0 (the pre-fusion "
                "builders mix the whole param tree and would drag expert "
                "leaves onto the wire)")
        if comm_mode == "push_sum" and overlap == "bucketed":
            raise ValueError(
                "overlap='bucketed' with comm_mode='push_sum' needs the "
                "fused epilogue pipeline (unset BLUEFOG_FUSE_EPILOGUES=0): "
                "the unfused builder mixes the extended payload whole")
    return specs, hls, compress, mix, fused, axes, axes_b, pp


def build_train_step(
    loss_fn: Callable,
    optimizer: torch.optim.Optimizer,
    backend: RankBackend,
    *,
    comm_mode: str = "cta",
    topology: Optional[CommSpec] = None,
    schedule: Optional[Sequence[CommSpec]] = None,
    num_steps_per_communication: int = 1,
    hierarchical_local_size: Optional[int] = None,
    hierarchical: Any = None,
    sp_axis: Optional[C.SeqAxis] = None,
    mesh_axes: Sequence[C.MeshAxis] = (),
    pp_axis: Optional[C.MeshAxis] = None,
    batch_specs: Any = None,
    param_specs: Any = None,
    opt_state_specs: Any = None,
    donate: bool = True,
    has_aux: bool = False,
    compress: Union[str, MixCompressConfig, None] = None,
    overlap: str = "none",
    overlap_buckets: int = 4,
    guard: Optional[GuardConfig] = None,
    health: Optional[HealthConfig] = None,
    moe: Optional[MoEConfig] = None,
) -> Callable:
    """One decentralized optimizer step over ``backend``'s ranks.

    ``loss_fn(params, batch) -> scalar loss`` runs on ONE rank's slices
    (the leading rank axis stripped; ``params`` a ``{name: tensor}``
    dict).  With ``has_aux=True`` it is ``loss_fn(params, aux, batch) ->
    (loss, new_aux)`` for mutable model state (batch-norm statistics) and
    the step takes and returns the rank-major ``aux`` dict.

    ``optimizer``: a ``torch.optim.SGD``, ``Adam`` or ``AdamW`` built over
    the rank-major param tensors.  The other arguments mean what they
    mean in the JAX package:

    * ``comm_mode``, ``topology``/``schedule``,
      ``num_steps_per_communication``;
    * ``compress``: ``None``, ``"bf16"``, ``"int8"``, ``"int8_sr"``
      (stochastic rounding, one draw per (step, bucket), see
      ``collectives.wire_generator``), ``"topk"`` or a
      :class:`MixCompressConfig` (error-feedback top-k mixing; then
      ``opt_state = (optimizer, train_step.init_mix_state(params))``);
      default ``BLUEFOG_MIX_COMPRESS``;
    * ``overlap="bucketed"`` / ``overlap_buckets``: one exchange per
      size-balanced bucket (cta/atc/push_sum);
    * ``guard=GuardConfig()``: a rank whose loss or update is non-finite
      skips the step (params, aux and optimizer state keep their values,
      selected elementwise, with no host branch); the combine stays
      outside the select.  Under gradient_allreduce one rank's NaN
      reaches every rank and all skip;
    * ``health=HealthConfig()``: the step also returns a
      :class:`HealthVector`;
    * ``hierarchical=`` (an int or anything with ``chips_per_machine``)
      / ``hierarchical_local_size=`` / ``BLUEFOG_HIER_LOCAL_SIZE``: the
      exact intra-machine mean, then the machine-level exchange over the
      MACHINE-level ``topology``/``schedule``;
    * ``comm_mode="push_sum"``: ``opt_state = (optimizer,
      push_sum_weights(backend))``;
    * ``sp_axis=SeqAxis(name, S)`` with ``batch_specs``: sequence
      parallelism.  ``batch_specs`` is a tuple of axis names, one per
      batch dim, for every batch leaf (JAX's ``PartitionSpec``: ``("bf",
      None, "sp")`` is ``P("bf", None, "sp")``); the first dim is the
      rank axis ``"bf"``.  Each rank's leaves are split along the dim it
      names into S shards stacked shard-major (``[n, B, T]`` -> ``[S, B,
      T/S]`` per rank); with no dim named (JAX's default ``P("bf")``)
      they reach ``loss_fn`` whole.  A rank's forward and
      backward run all its shards together with the axis bound
      (``bind_axis``), so ring attention sees every shard's K/V;
      ``loss_fn`` returns each shard's loss (``[S]``, as
      ``llama_loss_fn`` does) or a scalar, and the step differentiates
      the shards' mean: the loss and gradients JAX's ``pmean`` over the
      axis gives.  Params stay replicated over the axis, so every
      ``comm_mode``, the guard, health and bucketed overlap compose with
      it, on either backend.

    * ``mesh_axes=(MeshAxis("tp", tp),)`` with ``param_specs`` and
      ``opt_state_specs``: the model axes a JAX mesh carries besides
      ``"bf"`` (tensor parallelism, experts over an ep axis), each given
      as the axis object (the port has no mesh to hold their sizes) and
      bound over every forward and backward, as ``shard_map`` binds its
      axis names.  ``param_specs`` (``{name: spec}`` or one spec, a
      spec the tuple of axis names ``llama_param_specs`` gives, the
      rank axis first) and ``opt_state_specs`` (``optax_state_specs``'
      map) are checked against the params and the optimizer at the first
      step.  A rank holds every shard of its leaves (the model computes
      each shard from its slice), so the update and every elementwise
      exchange (cta, atc, gradient_allreduce, push_sum, hierarchical,
      the bf16 wire) are the same arithmetic as JAX's per device; the
      edge account bills what one JAX device sends (each leaf's bytes
      over its spec's shard count).  The int8 wires and top-k mixing,
      whose scale and selection are per bucket of one device's shards,
      run over per-device buckets (see the module docstring), their
      ``MixState`` one row per device; the consensus partial sums every
      device's.  The guard and health
      read every shard of a rank (JAX's outputs read its first shard's
      device).  ``batch_specs`` may split one batch dim over a model
      axis as over the sequence axis.

    * ``pp_axis=MeshAxis("pp", S)``: pipeline parallelism
      (``llama_pp_loss_fn``), the axis itself as for ``sp_axis``; it
      needs ``param_specs`` (JAX's error), whose
      stage-owned leaves carry the axis on their rank entry
      (``llama_param_specs(pp_axis=)``).  The axis is bound over the
      forward and backward with the others; ``loss_fn`` returns each
      stage's loss (``[S]``, ``[S, S_sp]`` under ``sp_axis``) and the
      step differentiates their sum, JAX's psum over pp.  The stages of
      a rank are held together, so a leaf JAX replicates over pp (the
      embedding, the final norm, the head) is held once and autograd
      gives it the sum JAX's psum restores; every ``comm_mode``, the
      guard and health compose with it, stage-owned leaves joining the
      combine like any other leaf.

    * ``moe=MoEConfig(n_experts, capacity)``: the expert-sharded step
      (cta or atc).  ``loss_fn(params, batch)`` (``loss_fn(params, aux,
      batch)`` with ``has_aux``) then runs ONCE over every rank this
      process holds, rank-major params and batch as they are (the
      all-to-all inside it crosses ranks, :mod:`bluefog_tpu_torch.moe`),
      and returns each rank's loss, ``[n_local]``; the step
      differentiates their sum, so each rank's gradient also carries
      what its experts did for the other ranks' tokens (JAX's transpose
      of ``ppermute``).  Only the shared leaves (names without an
      ``expert_path_tokens`` substring) enter the neighbor combine, its
      flat buffers, the top-k mixing state and the
      ``bf_edge_bytes_total`` account; expert leaves get their optimizer
      update and never touch the wire.  The guard and health read every
      leaf.  Under ``overlap="bucketed"`` atc applies the whole update
      before the combine, as JAX plans no interleaved branches under
      ``moe``.  With ``sp_axis`` the axis is bound over that one call,
      ``batch_specs`` splits each leaf's named dim into shards placed
      after the rank axis (``[n_local, S, ...]``), and ``loss_fn`` may
      return each rank's shards' losses (``[n_local, S]``): each rank's
      loss is their mean, JAX's pmean over the axis.

    ``BLUEFOG_FUSE_EPILOGUES=0`` takes the health reductions in the JAX
    package's pre-fusion order (per leaf, over the whole tree) and
    refuses top-k mixing and bucketed push-sum, as JAX does.  ``donate``
    has no effect: the state is always updated in place.

    Returns ``train_step(params, aux, opt_state, batch, step) -> (params,
    aux, opt_state, loss)`` with ``has_aux``, else ``train_step(params,
    opt_state, batch, step) -> (params, opt_state, loss)``; ``loss`` is a
    float32 ``[n_local]`` tensor (the ranks this process holds).  Under
    ``guard=`` the step takes
    ``comm_weights`` after ``step`` (``train_step.default_comm_weights``;
    ``()`` without neighbor weights) and returns ``skipped`` ([n] int32)
    after ``loss``; under ``health=`` the ``HealthVector`` comes last.
    """
    del donate
    specs, hls, compress, mix, fused, axes, axes_b, pp = _resolve_modes(
        backend, comm_mode, topology, schedule, hierarchical,
        hierarchical_local_size, sp_axis, pp_axis, batch_specs,
        param_specs, opt_state_specs, compress, overlap, overlap_buckets,
        guard, moe, tuple(mesh_axes))
    if not isinstance(backend, RankBackend):
        raise TypeError(f"backend must be a StackedBackend or a "
                        f"ProcessBackend, got {type(backend).__name__}")
    if type(optimizer) not in ELEMENTWISE_OPTIMIZERS:
        raise TypeError(
            f"{type(optimizer).__name__} is not an element-wise optimizer: "
            "on rank-major tensors only "
            f"{[c.__name__ for c in ELEMENTWISE_OPTIMIZERS]} update each "
            "rank's slice with its own values")
    adam = type(optimizer) is not torch.optim.SGD
    # which batch dim an axis's shards split; JAX's default P("bf")
    # splits none
    specs_b = batch_specs if batch_specs is not None else (RANK_AXIS,)
    split_names = [e for e in specs_b[1:] if e is not None]
    split_axis = axes_b[split_names[0]] if split_names else None
    # the axes bound over every forward and backward, as shard_map binds
    # its mesh axis names
    bound = ([sp_axis] if sp_axis is not None else []) + list(axes.values())
    shard_axis = sp_axis or split_axis
    shards_of: Dict[tuple, Dict[str, int]] = {}
    opt_specs_checked: list = []

    def bind_axes():
        stack = contextlib.ExitStack()
        for ax in bound:
            stack.enter_context(C.bind_axis(ax))
        return stack

    def leaf_shards(params) -> Dict[str, int]:
        """``{name: pieces}`` of the model-parallel layout (every leaf 1
        without ``param_specs``), checked once per param tree."""
        key = tuple((k, tuple(v.shape)) for k, v in params.items())
        got = shards_of.get(key)
        if got is None:
            got = (dict.fromkeys(params, 1) if param_specs is None
                   else _check_param_specs(params, param_specs, axes))
            if opt_state_specs is not None and not opt_specs_checked:
                want = optax_state_specs(
                    optimizer, {k: v[0] for k, v in params.items()},
                    param_specs if param_specs is not None
                    else rank_spec_tree(params))
                if opt_state_specs != want:
                    raise ValueError(
                        "opt_state_specs differ from optax_state_specs("
                        "optimizer, params, param_specs): the port's "
                        "optimizer state follows its params leaf for "
                        f"leaf ({want!r})")
                opt_specs_checked.append(True)
            shards_of[key] = got
        return got
    if adam and any(g.get("amsgrad") for g in optimizer.param_groups):
        raise ValueError("amsgrad=True is not supported by the port's "
                         "per-rank Adam update")
    k_comm = int(num_steps_per_communication)
    if k_comm < 1:
        raise ValueError(f"num_steps_per_communication must be >= 1, got "
                         f"{k_comm}")
    n = backend.n_local   # the leading axis of every state tensor
    unit = hls or 1
    for s in specs:
        if s.size * unit != backend.size:
            raise ValueError(f"topology of {s.size} ranks on a backend of "
                             f"{backend.size}")
    neighbor = comm_mode in ("cta", "atc") and bool(specs)
    push_sum = comm_mode == "push_sum"
    guarded = guard is not None
    want_health = health is not None
    want_cons = want_health and health.consensus
    bucketed = overlap == "bucketed"
    n_buckets = int(overlap_buckets) if bucketed else None
    wire_sr = compress == "int8_sr"
    wire_compress = "int8" if wire_sr else compress
    mix_on = mix is not None
    mix_slots = [C.mix_mirror_slots(s) for s in specs] if mix_on else []
    mix_offsets = [int(v) for v in np.cumsum([0] + mix_slots)]
    stage_compress = compress if not mix_on else (
        "int8" if mix.values in ("int8", "int8_sr") else None)
    # per-bucket exchanges wherever a bucket carries its own state: an
    # int8 scale, a stochastic-rounding draw, the top-k mixing rows
    per_bucket = bucketed or wire_compress == "int8" or mix_on
    # the model axes' devices of a rank (each one a (rank, index on every
    # axis)); where a bucket carries its own state the buckets are
    # planned and exchanged per device, as JAX's devices hold them
    dev_axes = [(a, ax.size) for a, ax in axes.items()]
    per_device = (param_specs is not None
                  and int(np.prod([s for _, s in dev_axes])) > 1
                  and (wire_compress == "int8" or mix_on))
    default_w = comm_weight_inputs(specs) if neighbor else ()
    shared_names: Dict[tuple, list] = {}

    def mixed_leaves(params) -> Dict[str, torch.Tensor]:
        """The leaves the combine moves, by name: every leaf, or under
        ``moe`` the shared ones (raising when the tokens match every
        leaf)."""
        if moe is None:
            return params
        key = tuple(params)
        mask = shared_names.get(key)
        if mask is None:
            mask = shared_names[key] = _moe_shared_mask(key, moe)
        if not any(mask):
            raise ValueError(
                f"MoEConfig.expert_path_tokens "
                f"{moe.expert_path_tokens!r} match EVERY param "
                "leaf — nothing left to mix, the fleet would "
                "never reach consensus")
        return {k: v for (k, v), m in zip(params.items(), mask) if m}
    opt_params = {id(p) for g in optimizer.param_groups for p in g["params"]}
    weights_dev: Dict[tuple, tuple] = {}
    plans: Dict[tuple, _Plan] = {}
    streams: Dict[str, Any] = {}

    def plan_for(leaves: Dict[str, torch.Tensor]) -> _Plan:
        """The exchange plan of ``{name: rank-major leaf}`` from the
        EpiloguePlan, cached per leaf signature.  Under per-device
        buckets the plan is made on each device's leaves (the
        ``DeviceLayout`` of ``param_specs``), which every device of a
        rank shares."""
        tensors = list(leaves.values())
        key = (tuple(leaves), _fusion.leaf_signature(tensors))
        got = plans.get(key)
        if got is None:
            layout, views = None, []
            kw = dict(compress=stage_compress, guard=guarded,
                      health=want_health, consensus=want_cons, mix=mix_on)
            if per_device:
                layout = _fusion.DeviceLayout.for_leaves(
                    list(leaves), tensors, param_specs, dev_axes)
                plan = _fusion.EpiloguePlan.for_leaves(layout.views,
                                                       n_buckets, **kw)
                groups = [(layout.members(b.leaves), b)
                          for b in plan.buckets]
                views = [list(b.leaves) for b in plan.buckets]
            elif per_bucket:
                plan = _fusion.EpiloguePlan.for_leaves(
                    tensors, n_buckets, skip_leading_axis=True, **kw)
                groups = [(list(b.leaves), b) for b in plan.buckets]
            else:
                rows = _fusion.bucket_signature(tensors, True)
                groups = [(idx, None) for idx in
                          _fusion.plan_groups(rows, _FLAT_BYTES)]
            comp, ci = [], 0
            for _, b in groups:
                inexact = b is not None and b.dtype.startswith(
                    ("float", "bfloat"))
                comp.append(ci if mix_on and inexact else None)
                ci += comp[-1] is not None
            got = plans[key] = _Plan(groups, comp, views, layout)
        return got

    def round_weights(r, comm_weights, device, dtype):
        """Round r's weights on ``device`` in ``dtype``.  Host tables are
        copied once per distinct value (a copy per step would stall the
        stream); tensors already on the device are used as they are."""
        cw, sw = comm_weights[r]
        if cw.device == device and sw.device == device:
            return cw.to(dtype), sw.to(dtype)
        key = (r, cw.numpy().tobytes(), sw.numpy().tobytes(), str(device),
               dtype)
        got = weights_dev.get(key)
        if got is None:
            got = weights_dev[key] = (cw.to(device=device, dtype=dtype),
                                      sw.to(device=device, dtype=dtype))
        return got

    def side_stream(device):
        key = str(device)
        if key not in streams:
            streams[key] = torch.cuda.Stream(device=device)
        return streams[key]

    def exchange(pre, spec, r, bucket, ci, step, comm_weights, mix_state):
        """One bucket's (or one dtype group's) exchange stage; a
        per-device bucket is ``[n, devices, numel]``."""
        dev = pre.device
        if ci is not None:
            cw, sw = round_weights(r, comm_weights, dev, torch.float32)
            off, rows = mix_offsets[r], mix_slots[r]
            numel = pre.shape[-1] if per_device else pre[0].numel()
            out, nr, nm, ne = backend.mix_compress_exchange(
                pre, spec, ref_row=mix_state.ref[ci][:, r],
                mirrors=mix_state.mirror[ci][:, off:off + rows],
                err=mix_state.err[ci], ratio=mix_state.ratio,
                k=_resolve_k(None, mix.ratio, numel), values=mix.values,
                error_feedback=mix.error_feedback, class_weights=cw,
                self_weights=sw,
                generator=(C.wire_generator(dev, step, bucket.index)
                           if mix.values == "int8_sr" else None),
                hierarchical_local_size=hls, per_device=per_device)
            mix_state.ref[ci][:, r].copy_(nr)
            mix_state.mirror[ci][:, off:off + rows].copy_(nm)
            mix_state.err[ci].copy_(ne)
            return out
        cw, sw = round_weights(r, comm_weights, dev,
                               C._accum_dtype(pre.dtype))
        gen = (C.wire_generator(dev, step, bucket.index) if wire_sr
               else None)
        if hls is not None:
            return backend.hierarchical_neighbor_allreduce(
                pre, spec, hls, compress=wire_compress, class_weights=cw,
                self_weights=sw, generator=gen, per_device=per_device)
        return backend.neighbor_allreduce(
            pre, spec, compress=wire_compress, class_weights=cw,
            self_weights=sw, generator=gen, per_device=per_device)

    def cons_part(pre, out, tensors, idx):
        """The consensus partial [n] of one group: summed over every
        device of a per-device bucket (a replicated leaf once per
        device, as each JAX device holds its copy)."""
        if not fused and not per_device:
            return _leaf_cons_sq(pre, out, tensors, idx, n)
        return _sq_rows(pre.float() - out.float())

    def combine_group(leaves, g, step, comm_weights, mix_state):
        """Pack, exchange and consensus partial of exchange group ``g``
        of ``{name: leaf}``: (out buffer, partial or None)."""
        plan = plan_for(leaves)
        tensors = list(leaves.values())
        idx, bucket = plan.groups[g]
        r = step % len(specs)
        pre = plan.pack(tensors, g)
        out = exchange(pre, specs[r], r, bucket, plan.comp[g], step,
                       comm_weights, mix_state)
        part = None
        if want_cons and pre.dtype.is_floating_point:
            part = cons_part(pre, out, tensors, idx)
        return out, part

    def combine(leaves, step, comm_weights, mix_state, on_side=False,
                commit_each=False):
        """Every exchange group of ``{name: leaf}`` into its own out
        buffer; returns (outs, consensus sq [n]).  ``on_side``: on the
        CUDA side stream, which first waits for the main stream's work so
        far.  ``commit_each``: write each group back into its leaves as
        soon as it is exchanged (no group reads another's leaves), and
        return no buffers: one group's buffer alive at a time."""
        dev = next(iter(leaves.values())).device
        cons = torch.zeros(n, dtype=torch.float32, device=dev)
        if on_side:
            main, side = torch.cuda.current_stream(dev), side_stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                outs, cons = combine(leaves, step, comm_weights, mix_state)
            for o in outs:
                o.record_stream(main)
            cons.record_stream(main)
            return outs, cons
        outs = []
        plan = plan_for(leaves)
        for g in range(len(plan.groups)):
            out, part = combine_group(leaves, g, step, comm_weights,
                                      mix_state)
            if commit_each:
                plan.unpack(out, list(leaves.values()), g)
            else:
                outs.append(out)
            if part is not None:
                cons = cons + part
            del out, part
        return outs, cons

    def commit(leaves, outs):
        plan = plan_for(leaves)
        tensors = list(leaves.values())
        with torch.no_grad():
            for g, out in enumerate(outs):
                plan.unpack(out, tensors, g)

    def apply_update(tensors, grads, subset=None):
        """The optimizer's update of ``tensors`` (or of the leaf indices
        ``subset``) with ``grads``."""
        sel = range(len(tensors)) if subset is None else subset
        if adam:
            _rank_adam(optimizer, [tensors[i] for i in sel],
                       [grads[i] for i in sel], n)
            return
        for i in sel:
            tensors[i].grad = grads[i]
        optimizer.step()
        for i in sel:
            tensors[i].grad = None

    def push_sum_round(leaves, ps, step):
        """Re-bias, mix and de-bias the params in place (f32 throughout);
        returns the consensus partial [n]."""
        groups = plan_for(leaves).groups
        tensors = list(leaves.values())
        spec = specs[step % len(specs)]
        bufs = [_fusion.pack_bucket(tensors, idx) for idx, _ in groups]
        ps_b = lambda x: _ranks(ps, x)  # noqa: E731
        biased = [buf.float() * ps_b(buf) for buf in bufs]
        mixed, mixed_ps = backend.push_sum_mix(biased, ps, spec)
        cons = torch.zeros(n, dtype=torch.float32, device=ps.device)
        outs = []
        for (idx, _), pre, mixed_b in zip(groups, bufs, mixed):
            deb = (mixed_b / _ranks(mixed_ps, mixed_b)).to(pre.dtype)
            if want_cons and pre.dtype.is_floating_point:
                cons = cons + cons_part(pre, deb, tensors, idx)
            outs.append(deb)
        commit(leaves, outs)
        ps.copy_(mixed_ps)
        return cons

    def run(params, aux, opt_state, batch, step, comm_weights):
        mix_state = ps = None
        if mix_on or push_sum:
            if not (isinstance(opt_state, tuple) and len(opt_state) == 2):
                raise ValueError(
                    "opt_state must be (optimizer, " + (
                        "train_step.init_mix_state(params))" if mix_on
                        else "push_sum_weights(backend))"))
            opt, extra = opt_state
            if mix_on:
                mix_state = extra
            else:
                ps = extra
        else:
            opt = opt_state
        if opt is not optimizer:
            raise ValueError("opt_state must hold the optimizer the step "
                             "was built with (it holds the optimizer "
                             "state)")
        step = int(step)
        tensors = list(params.values())
        for name, p in params.items():
            if id(p) not in opt_params:
                raise ValueError(f"param {name!r} is not one of the "
                                 "optimizer's tensors")
            if p.shape[0] != n:
                raise ValueError(f"param {name!r} has {p.shape[0]} ranks, "
                                 f"the backend {n}")
        leaf_shards(params)
        dev = tensors[0].device
        on_cycle = step % k_comm == 0
        overlap_dev = bucketed and dev.type == "cuda"
        # the leaves the combine moves (the shared ones under moe)
        mixed = mixed_leaves(params)
        plan = plan_for(mixed)
        zero = torch.zeros(n, dtype=torch.float32, device=dev)
        cons = zero
        # cta + bucketed: the exchange reads the step's starting params,
        # so it starts now (on the side stream on CUDA) and writes into
        # its own buffers while the forward and backward run
        early = None
        if neighbor and comm_mode == "cta" and bucketed and on_cycle:
            early = combine(mixed, step, comm_weights, mix_state,
                            on_side=overlap_dev)
        aux_old = ({k: v.clone() for k, v in aux.items()}
                   if guarded and has_aux else None)
        # rank r's gradients land in row r (under moe autograd gives
        # every rank's at once)
        grads = ([torch.empty_like(p) for p in tensors] if moe is None
                 else None)
        losses = torch.empty(n, dtype=torch.float32, device=dev)
        if moe is not None:
            # the expert-sharded forward crosses ranks: every rank at once
            p_all = {k: v.detach().requires_grad_(True)
                     for k, v in params.items()}
            b_all = batch
            if split_axis is not None:
                b_all = _shard_batch(batch, specs_b, split_axis.size, lead=1)
            with torch.enable_grad(), bind_axes():
                if has_aux:
                    loss, new_aux = loss_fn(p_all, aux, b_all)
                else:
                    loss = loss_fn(p_all, b_all)
                # each rank's stages summed and shards averaged
                if pp is not None:
                    loss = _stage_sum(loss, pp.size, lead=1)
                if shard_axis is not None:
                    loss = _shard_mean(loss, shard_axis.size, lead=1)
                if tuple(loss.shape) != (n,):
                    raise ValueError(
                        f"under moe= loss_fn returns each of the {n} "
                        f"ranks' losses ([{n}]), got {tuple(loss.shape)}")
                grads = list(torch.autograd.grad(loss.sum(),
                                                 list(p_all.values())))
            with torch.no_grad():
                losses.copy_(loss.detach().float())
                if has_aux:
                    for k, v in new_aux.items():
                        aux[k].copy_(v)
            del loss, p_all
        for r in range(n if moe is None else 0):
            p_r = {k: v[r].detach().requires_grad_(True)
                   for k, v in params.items()}
            b_r = _slice(batch, r)
            if split_axis is not None:
                b_r = _shard_batch(b_r, specs_b, split_axis.size)
            # the step's axes are bound over the forward and backward
            with torch.enable_grad(), bind_axes():
                if has_aux:
                    loss, new_aux = loss_fn(p_r, _slice(aux, r), b_r)
                else:
                    loss = loss_fn(p_r, b_r)
                if pp is not None:
                    loss = _stage_sum(loss, pp.size)
                if shard_axis is not None:
                    loss = _shard_mean(loss, shard_axis.size)
                gs = torch.autograd.grad(loss, list(p_r.values()))
            with torch.no_grad():
                _copy_rank_rows(grads, r, gs)
                losses[r] = loss.detach().float()
                if has_aux:
                    for k, v in new_aux.items():
                        aux[k][r].copy_(v)
            del loss, gs, p_r
        with torch.no_grad():
            grad_sq = _grad_sq(grads, zero) if want_health else None
            if comm_mode == "gradient_allreduce":
                grads = [backend.allreduce(g, average=True) for g in grads]
            if push_sum and on_cycle:
                cons = push_sum_round(mixed, ps, step)
            if neighbor and comm_mode == "cta" and on_cycle:
                if early is None:
                    outs, cons = combine(mixed, step, comm_weights,
                                         mix_state)
                else:
                    outs, cons = early
                    if overlap_dev:
                        torch.cuda.current_stream(dev).wait_stream(
                            side_stream(dev))
                commit(mixed, outs)
                del outs, early
            track = guarded or want_health
            old = [p.clone() for p in tensors] if track else None
            snap = _snapshot_state(optimizer, tensors, n) if guarded else None
            interleave = (neighbor and comm_mode == "atc" and bucketed
                          and not guarded and on_cycle and moe is None)
            upd_sq = zero if want_health else None
            ok = torch.isfinite(losses)
            if interleave:
                # bucket i's update, then its exchange (on the side stream
                # on CUDA) while bucket i+1's update is applied
                main = torch.cuda.current_stream(dev) if overlap_dev else None
                parts = []
                for g, (idx, _) in enumerate(plan.groups):
                    apply_update(tensors, grads, idx)
                    if track:
                        ok, upd_sq = _track_update(tensors, old, idx, ok,
                                                   upd_sq, False)
                    if overlap_dev:
                        side = side_stream(dev)
                        side.wait_stream(main)
                        with torch.cuda.stream(side):
                            out, part = combine_group(
                                mixed, g, step, comm_weights, mix_state)
                            plan.unpack(out, tensors, g)
                        if part is not None:
                            part.record_stream(main)
                    else:
                        out, part = combine_group(mixed, g, step,
                                                  comm_weights, mix_state)
                        plan.unpack(out, tensors, g)
                    if part is not None:
                        parts.append(part)
                    del out, part
                if overlap_dev:
                    main.wait_stream(side_stream(dev))
                for part in parts:
                    cons = cons + part
            else:
                apply_update(tensors, grads)
                if track:
                    ok, upd_sq = _track_update(tensors, old,
                                               range(len(tensors)), ok,
                                               upd_sq, True)
            # the update is applied: the stacked gradients (a copy of the
            # params' size) go before the combine allocates its buffers
            del grads
            skipped = None
            if guarded:
                # the skip guard: an elementwise select over params, aux
                # and optimizer state, no host branch; with every rank
                # healthy it writes the update's own bits back
                _guard_select(tensors, old, ok)
                if has_aux:
                    for k, v in aux.items():
                        torch.where(_ranks(ok, v), v, aux_old[k], out=v)
                _select_state(optimizer, tensors, snap, ok, n)
                skipped = (~ok).to(torch.int32)
            del old, snap
            if neighbor and comm_mode == "atc" and on_cycle \
                    and not interleave:
                cons = combine(mixed, step, comm_weights, mix_state,
                               commit_each=True)[1]
            hv = None
            if want_health:
                hv = HealthVector(
                    loss=losses, grad_norm=grad_sq.sqrt(),
                    update_norm=upd_sq.sqrt(),
                    skipped=((~ok).float() if skipped is None
                             else skipped.float()),
                    consensus=cons.sqrt())
        return params, aux, opt_state, losses, skipped, hv

    def outputs(res, with_aux):
        params, aux, opt_state, loss, skipped, hv = res
        outs = ((params, aux, opt_state, loss) if with_aux
                else (params, opt_state, loss))
        if guarded:
            outs = outs + (skipped,)
        if want_health:
            outs = outs + (hv,)
        return outs

    if guarded:
        if has_aux:
            def train_step(params, aux, opt_state, batch, step,
                           comm_weights):
                return outputs(run(params, aux, opt_state, batch, step,
                                   comm_weights), True)
        else:
            def train_step(params, opt_state, batch, step, comm_weights):
                return outputs(run(params, None, opt_state, batch, step,
                                   comm_weights), False)
    elif has_aux:
        def train_step(params, aux, opt_state, batch, step):
            return outputs(run(params, aux, opt_state, batch, step,
                               default_w), True)
    else:
        def train_step(params, opt_state, batch, step):
            return outputs(run(params, None, opt_state, batch, step,
                               default_w), False)

    # the edge account only for modes that run a neighbor exchange (a
    # topology passed with "none" or "gradient_allreduce" moves nothing)
    edge_traffic = ((list(specs), 4 if has_aux else 3, k_comm, n,
                     backend.size, push_sum, hls if neighbor else None)
                    if specs and (neighbor or push_sum) else None)
    step_fn = _observed_step(train_step, dict(
        comm_mode=comm_mode, overlap="bucketed" if bucketed else "none",
        guarded="true" if guarded else "false"), edge_traffic,
        None if moe is None
        else lambda k: _moe_shared_mask((k,), moe)[0],
        None if param_specs is None else leaf_shards)

    def init_mix_state(params) -> MixState:
        """The MixState for rank-major ``params``: ``err`` zero, ``ref``
        and ``mirror`` each rank's OWN packed params (exact when every
        rank starts from the same params, the ``rank_major`` init; ranks
        that start diverged should zero them instead).  Under per-device
        buckets each row packs every device's bucket, shard-major."""
        leaf_shards(params)
        leaves = mixed_leaves(params)
        tensors = list(leaves.values())
        R, G = len(specs), int(sum(mix_slots))
        plan = plan_for(leaves)
        errs, refs, mirs = [], [], []
        for g, ci in enumerate(plan.comp):
            if ci is None:
                continue
            flat = plan.pack(tensors, g).reshape(n, -1).float()
            errs.append(torch.zeros_like(flat))
            refs.append(flat[:, None, :].expand(n, R, -1).clone())
            mirs.append(flat[:, None, :].expand(n, G, -1).clone())
        return MixState(
            ratio=torch.full((n,), float(mix.ratio), dtype=torch.float32,
                             device=tensors[0].device),
            err=tuple(errs), ref=tuple(refs), mirror=tuple(mirs))

    def mix_wire_layout(params) -> tuple:
        """Per compressible bucket: ``{bucket, numel, k, wire_bytes}``,
        the bytes one permute of that bucket moves per device (``numel``
        one device's packed size: model-parallel layouts exchange
        shards, so each device moves its own wire)."""
        leaf_shards(params)
        leaves = mixed_leaves(params)
        tensors = list(leaves.values())
        plan = plan_for(leaves)
        rows = []
        for g, ((idx, b), ci) in enumerate(zip(plan.groups, plan.comp)):
            if ci is None:
                continue
            numel = (plan.layout.numel(plan.views[g]) if per_device else
                     sum(tensors[i][0].numel() for i in idx))
            k = _resolve_k(None, mix.ratio, numel)
            rows.append(dict(bucket=b.index, numel=numel, k=k,
                             wire_bytes=C.mix_wire_bytes(numel, k,
                                                         mix.values)))
        return tuple(rows)

    def set_mix_ratio(opt_state, ratio):
        """A new opt_state with every rank's LIVE ratio set to ``ratio``
        (data only: ``k_live`` masks the top-k prefix)."""
        base, ms = opt_state
        return (base, ms._replace(ratio=torch.full_like(ms.ratio,
                                                        float(ratio))))

    def combine_params(params, step, mix_state=None, comm_weights=None):
        """The neighbor combine the step runs, in place on ``params``
        (for timing); returns the consensus sq partials [n]."""
        leaves = mixed_leaves(params)
        with torch.no_grad():
            return combine(leaves, int(step), comm_weights or default_w,
                           mix_state, commit_each=True)[1]

    step_fn.has_aux = has_aux
    step_fn.backend = backend
    step_fn.health_config = health
    step_fn.epilogue_stages = _fusion.epilogue_stages(
        compress=stage_compress, guard=guarded, health=want_health,
        consensus=want_cons, mix=mix_on)
    step_fn.hierarchical_local_size = hls if neighbor else None
    step_fn.mix_config = mix
    step_fn.moe_config = moe
    if neighbor:
        step_fn.combine = combine_params
    if mix_on:
        # which dims of the MixState are per device: the packed axis
        # holds every model axis's devices, shard-major (JAX's
        # P("bf", rest) over the mesh's other axes)
        rest = None
        if per_device:
            names = tuple(a for a, _ in dev_axes)
            rest = names[0] if len(names) == 1 else names
        step_fn.init_mix_state = init_mix_state
        step_fn.mix_wire_layout = mix_wire_layout
        step_fn.set_mix_ratio = set_mix_ratio
        step_fn.mix_state_specs = MixState(
            ratio=(RANK_AXIS,), err=(RANK_AXIS, rest),
            ref=(RANK_AXIS, None, rest), mirror=(RANK_AXIS, None, rest))
    if guarded:
        step_fn.guard_config = guard
    if guarded or neighbor:
        step_fn.default_comm_weights = default_w
    return step_fn

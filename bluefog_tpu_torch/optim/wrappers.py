"""Distributed optimizer wrappers of the port over ``torch.optim``.

Port of ``bluefog_tpu/optim/wrappers.py`` (reference
bluefog/torch/optimizers.py) — the five mechanisms:

=====================================  =======================================
reference (torch.optim subclasses)      this port
=====================================  =======================================
_DistributedOptimizer (:166)            DistributedGradientAllreduceOptimizer
_DistributedReduceOptimizer (:297)      DistributedAdaptWithCombineOptimizer
  (CTA: combine params, then adapt)       (+ the per-comm-type factories)
_DistributedAdaptThenCombine (:485)     DistributedAdaptThenCombineOptimizer
_DistributedWinOptimizer (:844)         DistributedWinPutOptimizer /
  (win_put push / win_get pull)           DistributedPullGetOptimizer
_DistributedPushSumOptimizer (:1026)    DistributedPushSumOptimizer
=====================================  =======================================

Each wraps a base ``torch.optim`` optimizer (``SGD``, ``Adam`` or
``AdamW``: ``optim.functional.ELEMENTWISE_OPTIMIZERS``) built over
RANK-MAJOR params (tensors of the eager context whose leading axis holds
this process's ranks, one slice per rank; every rank when one process
holds them all, and per process under bfrun).  The caller writes each rank's gradient into ``.grad``
rank-major; ``step()`` reads it, communicates and updates the params IN
PLACE.  Adam and AdamW keep one step count per rank, as in
``build_train_step``.  In the JAX package, optax returns new params;
here the communication reads the params exactly where the JAX step
does:

* CTA combines the params, then updates them with the gradients taken
  before the combine;
* ATC updates, then combines;
* gradient allreduce averages ``.grad``, then updates;
* the window optimizers put/get through per-param windows and combine
  with ``win_update``; push-sum concatenates ``[param ‖ ps_weight]`` per
  leaf (window value's last column) and de-biases after the collect.

Every collective of one step is enqueued (nonblocking, per fusion
buffer of ``BLUEFOG_FUSION_THRESHOLD`` bytes a rank, planned by
``optim.fusion.FusionPlan``) before the first wait.  ``self_weight``,
``src_weights`` and ``dst_weights`` are attributes re-read every step
(reference optimizers.py:326-331); ``num_steps_per_communication``
gives local-SGD-style periodic communication (:343-348).

Window names come from the params' names (``named_parameters``, default
``"<group>.<index>"``), as ``"param.<name>"``; the JAX package derives
them from pytree key paths.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from bluefog_tpu_torch import api
from bluefog_tpu_torch import config as bfconfig
from bluefog_tpu_torch.context import get_context
from bluefog_tpu_torch.optim.functional import (ELEMENTWISE_OPTIMIZERS,
                                                _rank_adam)
from bluefog_tpu_torch.optim.fusion import FusionPlan

__all__ = [
    "CommunicationType",
    "DistributedGradientAllreduceOptimizer",
    "DistributedAdaptWithCombineOptimizer",
    "DistributedAdaptThenCombineOptimizer",
    "DistributedAllreduceOptimizer",
    "DistributedNeighborAllreduceOptimizer",
    "DistributedHierarchicalNeighborAllreduceOptimizer",
    "DistributedWinPutOptimizer",
    "DistributedPullGetOptimizer",
    "DistributedPushSumOptimizer",
]

NamedParams = Union[Dict[str, torch.Tensor],
                    Iterable[Tuple[str, torch.Tensor]], None]


class CommunicationType(enum.Enum):
    """Reference optimizers.py:28-35."""

    neighbor_allreduce = "neighbor.allreduce"
    hierarchical_neighbor_allreduce = "hierarchical.neighbor.allreduce"
    allreduce = "allreduce"
    empty = "empty"


class _DistributedOptimizerBase:
    """Shared machinery: the base optimizer, the communication cadence and
    the weight knobs."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: NamedParams = None,
                 num_steps_per_communication: int = 1):
        if type(optimizer) not in ELEMENTWISE_OPTIMIZERS:
            raise TypeError(
                f"{type(optimizer).__name__} is not an element-wise "
                "optimizer: on rank-major tensors only "
                f"{[c.__name__ for c in ELEMENTWISE_OPTIMIZERS]} update "
                "each rank's slice with its own values")
        if any(g.get("amsgrad") for g in optimizer.param_groups):
            raise ValueError("amsgrad=True is not supported by the port's "
                             "per-rank Adam update")
        self.optimizer = optimizer
        self._params: List[torch.Tensor] = [
            p for g in optimizer.param_groups for p in g["params"]]
        self._keys = self._param_names(named_parameters)
        self._adam = type(optimizer) is not torch.optim.SGD
        self.num_steps_per_communication = int(num_steps_per_communication)
        # Mutable dynamic-topology knobs (reference optimizers.py:326-331).
        self.self_weight = None
        self.src_weights = None
        self.dst_weights = None
        self._step_count = 0

    def _param_names(self, named_parameters: NamedParams) -> List[str]:
        if named_parameters is None:
            return [f"{gi}.{pi}"
                    for gi, g in enumerate(self.optimizer.param_groups)
                    for pi in range(len(g["params"]))]
        pairs = (named_parameters.items()
                 if isinstance(named_parameters, dict) else named_parameters)
        by_id = {id(t): k for k, t in pairs}
        missing = [i for i, p in enumerate(self._params) if id(p) not in by_id]
        if missing:
            raise ValueError(f"named_parameters does not name the "
                             f"optimizer's params at positions {missing}")
        return [by_id[id(p)] for p in self._params]

    # torch.optim surface ---------------------------------------------------
    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def zero_grad(self, set_to_none: bool = True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict):
        self.optimizer.load_state_dict(state_dict)

    # ----------------------------------------------------------------------
    def _should_communicate(self) -> bool:
        self._step_count += 1
        return self._step_count % self.num_steps_per_communication == 0

    def _base_step(self):
        """The base optimizer's update of every param with a ``.grad``."""
        if not self._adam:
            self.optimizer.step()
            return
        live = [p for p in self._params if p.grad is not None]
        with torch.no_grad():
            _rank_adam(self.optimizer, live, [p.grad for p in live],
                       get_context().n_local())

    def _pipelined(self, tensors: List[torch.Tensor],
                   launch: Callable[[torch.Tensor], int]
                   ) -> List[torch.Tensor]:
        """Dispatch ``launch(buffer) -> handle`` for every fusion buffer,
        then synchronize: every collective is enqueued before the first
        wait.  Leaves are packed into flat ``[n, K]`` buffers first
        (``FusionPlan``; threshold via BLUEFOG_FUSION_THRESHOLD, 0 to
        disable), mirroring the reference's response fusion
        (operations.cc:943-1020).  Records a COMMUNICATE timeline span
        when the timeline is enabled (optimizers.py:112-163)."""
        threshold = bfconfig.fusion_threshold()
        with api.timeline_context(type(self).__name__, "COMMUNICATE"):
            if threshold and len(tensors) > 1:
                plan = FusionPlan.for_leaves(tensors, threshold)
                handles = [launch(b) for b in plan.pack(tensors)]
                return list(plan.unpack(
                    [api.synchronize(h) for h in handles]))
            handles = [launch(t) for t in tensors]
            return [api.synchronize(h) for h in handles]

    def _combine(self, tensors):
        return self._pipelined(
            tensors,
            lambda p: api.neighbor_allreduce_nonblocking(
                p, self_weight=self.self_weight, src_weights=self.src_weights,
                dst_weights=self.dst_weights, enable_topo_check=False))

    def _assign(self, outs):
        """Write communicated values into the params, in place."""
        with torch.no_grad():
            for p, o in zip(self._params, outs):
                p.copy_(o.reshape(p.shape))


class DistributedGradientAllreduceOptimizer(_DistributedOptimizerBase):
    """Horovod-style synchronous gradient averaging (reference
    optimizers.py:166-294, factory :1376-1423)."""

    def step(self, closure=None):
        if self._should_communicate():
            live = [p for p in self._params if p.grad is not None]
            outs = self._pipelined(
                [p.grad for p in live],
                lambda g: api.allreduce_nonblocking(g, average=True))
            with torch.no_grad():
                for p, g in zip(live, outs):
                    p.grad.copy_(g.reshape(p.shape))
        self._base_step()


class DistributedAdaptWithCombineOptimizer(_DistributedOptimizerBase):
    """CTA — combine-then-adapt: neighbor-average the *parameters*, then
    take the base optimizer step with the gradients taken before the
    combine (reference _DistributedReduceOptimizer optimizers.py:297-482,
    factory :1497-1554)."""

    def __init__(self, optimizer, named_parameters: NamedParams = None,
                 communication_type=CommunicationType.neighbor_allreduce,
                 num_steps_per_communication: int = 1):
        super().__init__(optimizer, named_parameters,
                         num_steps_per_communication)
        self.communication_type = communication_type

    def _communicate(self):
        ct = self.communication_type
        if ct == CommunicationType.empty:
            return
        if ct == CommunicationType.allreduce:
            outs = self._pipelined(
                self._params,
                lambda p: api.allreduce_nonblocking(p, average=True))
        elif ct == CommunicationType.hierarchical_neighbor_allreduce:
            outs = self._pipelined(
                self._params,
                lambda p: api.hierarchical_neighbor_allreduce_nonblocking(
                    p, self_weight=self.self_weight,
                    src_machine_weights=self.src_weights,
                    dst_machine_weights=self.dst_weights))
        else:
            outs = self._combine(self._params)
        self._assign(outs)

    def step(self, closure=None):
        if self._should_communicate():
            self._communicate()
        self._base_step()


class DistributedAdaptThenCombineOptimizer(DistributedAdaptWithCombineOptimizer):
    """ATC — adapt-then-combine: take the base step first, then
    neighbor-average the updated parameters (reference
    _DistributedAdaptThenCombine optimizers.py:485-841,
    factory :1426-1494)."""

    def step(self, closure=None):
        self._base_step()
        if self._should_communicate():
            self._communicate()


# Per-communication-type factories (reference optimizers.py:1301-1373) ------
def DistributedAllreduceOptimizer(optimizer, named_parameters=None,
                                  num_steps_per_communication: int = 1):
    return DistributedAdaptWithCombineOptimizer(
        optimizer, named_parameters, CommunicationType.allreduce,
        num_steps_per_communication)


def DistributedNeighborAllreduceOptimizer(optimizer, named_parameters=None,
                                          num_steps_per_communication: int = 1):
    return DistributedAdaptWithCombineOptimizer(
        optimizer, named_parameters, CommunicationType.neighbor_allreduce,
        num_steps_per_communication)


def DistributedHierarchicalNeighborAllreduceOptimizer(
        optimizer, named_parameters=None,
        num_steps_per_communication: int = 1):
    return DistributedAdaptWithCombineOptimizer(
        optimizer, named_parameters,
        CommunicationType.hierarchical_neighbor_allreduce,
        num_steps_per_communication)


class _DistributedWindowOptimizerBase(_DistributedOptimizerBase):
    """Common window lifecycle of the asynchronous-gossip optimizers: one
    window per param, created with the optimizer (reference
    optimizers.py:933-944)."""

    def __init__(self, optimizer, named_parameters: NamedParams = None,
                 num_steps_per_communication: int = 1,
                 window_prefix: Optional[str] = None):
        super().__init__(optimizer, named_parameters,
                         num_steps_per_communication)
        self.window_prefix = (window_prefix + ".") if window_prefix else ""
        self.force_barrier = False
        self._names: List[str] = []
        if get_context().size() > 1:
            self.register_windows()

    def _window_name(self, key: str) -> str:
        return f"{self.window_prefix}param.{key}"

    def _window_value(self, p: torch.Tensor) -> torch.Tensor:
        return p.detach()

    def _zero_init(self) -> bool:
        return False

    def register_windows(self):
        """win_create per param."""
        for key, p in zip(self._keys, self._params):
            name = self._window_name(key)
            if not api.win_create(self._window_value(p), name,
                                  zero_init=self._zero_init()):
                raise ValueError(f"Cannot allocate window for parameter {name}")
            self._names.append(name)

    def unregister_windows(self):
        for name in self._names:
            if name in api.get_current_created_window_names():
                api.win_free(name)
        self._names = []

    def _communicates(self) -> bool:
        if self.force_barrier:
            api.barrier()
        return get_context().size() > 1 and self._should_communicate()


class DistributedWinPutOptimizer(_DistributedWindowOptimizerBase):
    """Asynchronous push gossip: win_put parameters to out-neighbors,
    combine with win_update, then take the base step (reference
    _DistributedWinOptimizer push style, optimizers.py:844-1023,
    factory :1271-1298)."""

    def step(self, closure=None):
        if self._communicates():
            handles = [api.win_put_nonblocking(
                p.detach(), name, dst_weights=self.dst_weights,
                require_mutex=False)
                for p, name in zip(self._params, self._names)]
            outs = []
            for h, name in zip(handles, self._names):
                api.win_wait(h)
                outs.append(api.win_update(name, require_mutex=True))
            self._assign(outs)
        self._base_step()


class DistributedPullGetOptimizer(_DistributedWindowOptimizerBase):
    """Asynchronous pull gossip: win_get from in-neighbors, then combine
    (reference pull style, optimizers.py:844-1023, factory :1225-1268)."""

    def step(self, closure=None):
        if self._communicates():
            handles = []
            for p, name in zip(self._params, self._names):
                # the window tensor tracks the live param, so neighbors'
                # gets see fresh values
                api.win_set_value(name, p.detach())
                handles.append(api.win_get_nonblocking(
                    name, src_weights=self.src_weights, require_mutex=True))
            outs = []
            for h, name in zip(handles, self._names):
                api.win_wait(h)
                outs.append(api.win_update(name, require_mutex=True))
            self._assign(outs)
        self._base_step()


class DistributedPushSumOptimizer(_DistributedWindowOptimizerBase):
    """Push-sum / gradient-push for directed graphs (reference
    _DistributedPushSumOptimizer optimizers.py:1026-1177, factory
    :1180-1222).

    Windows hold the extended payload ``[flatten(param) ‖ ps_weight]``
    (ps_weight init 1).  Each communication:
      1. win_accumulate(extended * a) into out-neighbors, a = 1/(outdeg+1)
         — the same scale applied to self via ``self_weight``;
      2. win_update_then_collect: extended += sum(mailbox); reset mailbox;
      3. de-bias: param = x / ps_weight.
    The invariant sum_i ps_weight_i == size is what the reference's
    associated-P tests assert (test/torch_win_ops_test.py:780-863).
    """

    def __init__(self, optimizer, named_parameters: NamedParams = None,
                 num_steps_per_communication: int = 1,
                 window_prefix: Optional[str] = None):
        super().__init__(optimizer, named_parameters,
                         num_steps_per_communication, window_prefix)
        self.force_barrier = True
        ctx = get_context()
        outdeg = {r: len(ctx.out_neighbor_ranks(r))
                  for r in range(ctx.size())}
        # Uniform column-stochastic weights (reference optimizers.py:1031-1035)
        self.dst_weights = [
            {d: 1.0 / (outdeg[r] + 1) for d in ctx.out_neighbor_ranks(r)}
            for r in range(ctx.size())
        ]
        self.self_weight = [1.0 / (outdeg[r] + 1) for r in range(ctx.size())]

    def _zero_init(self) -> bool:
        return True

    def _window_value(self, p: torch.Tensor) -> torch.Tensor:
        n = p.shape[0]
        return torch.cat([p.detach().reshape(n, -1),
                          torch.ones((n, 1), dtype=p.dtype, device=p.device)],
                         dim=1)

    def ps_weights(self) -> torch.Tensor:
        """The push-sum weight of every rank, ``[n]`` (the first window's
        last column; every window carries the same weights)."""
        return api._wm().window(self._names[0]).value[:, -1]

    def step(self, closure=None):
        if self._communicates():
            outs = []
            for p, name in zip(self._params, self._names):
                win = api._wm().window(name)
                n = p.shape[0]
                # current extended payload: fresh param + current ps weight
                extended = torch.cat([p.detach().reshape(n, -1).to(win.dtype),
                                      win.value[:, -1:]], dim=1)
                api.win_set_value(name, extended)
                h = api.win_accumulate_nonblocking(
                    extended, name, self_weight=self.self_weight,
                    dst_weights=self.dst_weights, require_mutex=True)
                api.win_wait(h)
                collected = api.win_update_then_collect(name)
                outs.append((collected[:, :-1] / collected[:, -1:]).to(p.dtype))
            self._assign(outs)
        self._base_step()

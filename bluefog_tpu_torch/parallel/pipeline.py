"""Pipeline parallelism over a mesh axis: GPipe and the circular schedule.

Port of ``bluefog_tpu/parallel/pipeline.py``.  The JAX package runs the
pipeline as one SPMD program under ``shard_map``: each device of the
``pp`` axis is a stage, a ``lax.scan`` streams the microbatches through
``M + S - 1`` ticks, and one ``lax.ppermute`` shift per tick hands each
stage's activation to the next.  The port keeps the schedule tick for
tick and holds the stages as the model axes hold their shards: every
stage of one data-parallel rank on one device, stacked SHARD-MAJOR along
a leading axis (the :class:`~bluefog_tpu_torch.parallel.collectives.
MeshAxis` convention), so one tick runs every stage at once:

* the carried state is ``[S, ...]`` (stage ``s``'s incoming activation
  at ``[s]``), and stage 0 takes the tick's microbatch in place of its
  row;
* ``stage_fn`` maps every stage's input ``[S, ...]`` to its output in
  one call (the Llama's stage folds the stages into its products' and
  its attention's batch);
* the hop is the axis's :meth:`~bluefog_tpu_torch.parallel.collectives.
  MeshAxis.shift`, whose backward is the reverse hop, as JAX transposes
  a ``ppermute``: the backward pipeline comes from autograd.

Ticks outside a stage's window compute on zeros or on the clamped
re-read of the last microbatch, as in JAX; their outputs never reach the
result, so they carry no gradient, and ``with_aux`` sums a stage's aux
over its valid ticks only.  Values that JAX keeps on the last stage
alone (the pipeline's outputs) are held once: ``gpipe`` returns the
last stage's outputs ``[M, ...]``, where each JAX device returns its own
(only the last stage's meaningful).  The per-stage aux sums are ``[S]``.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_map

from bluefog_tpu_torch.parallel.collectives import (MeshAxis, _device_const,
                                                    bound_axis)

__all__ = ["gpipe", "gpipe_circular", "circular_layer_permutation"]


def _stage_axis(pp_axis: Union[str, MeshAxis], n_stages: int) -> MeshAxis:
    """The bound pipeline axis (``NameError`` when unbound, as
    ``lax.axis_index`` outside ``shard_map``), held to ``n_stages``."""
    axis = bound_axis(pp_axis)
    if axis.size != n_stages:
        raise ValueError(f"n_stages={n_stages} but the bound axis {axis!r} "
                         f"has {axis.size} stages")
    return axis


def _tick_masks(valid, n_ticks: int, n_stages: int, device
                ) -> torch.Tensor:
    """``[n_ticks, S]`` booleans, ``valid(t, s)``: built on the host and
    moved once per schedule (a copy per step would stall the stream)."""
    return _device_const(tuple(tuple(bool(valid(t, s))
                                     for s in range(n_stages))
                               for t in range(n_ticks)), device)


def _run_stage(stage_fn, params, x_in, with_aux: bool):
    if with_aux:
        return stage_fn(params, x_in)
    return stage_fn(params, x_in), None


def _masked_sum(acc, aux: torch.Tensor, valid: torch.Tensor):
    """``acc + where(valid, aux, 0)`` over the stages' rows of ``aux
    [S, ...]`` (``acc`` None before the first tick)."""
    valid = valid.reshape(valid.shape + (1,) * (aux.dim() - 1))
    part = torch.where(valid, aux.float(),
                       torch.zeros((), dtype=torch.float32,
                                   device=aux.device))
    return part if acc is None else acc + part


def gpipe(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
          pp_axis: Union[str, MeshAxis], n_stages: int,
          with_aux: bool = False):
    """Run ``stage_fn`` as a GPipe pipeline over ``pp_axis`` (bound, or
    the axis itself), every stage at once.

    Args:
      stage_fn: ``(stage_params, x) -> y`` with ``x`` every stage's input
        ``[S, ...]`` and ``y`` of its shape; with ``with_aux=True``
        ``(stage_params, x) -> (y, aux)``, ``aux [S]`` each stage's
        scalar (a MoE load-balance term, say; ``[S, ...]`` when a stage
        has several, one per sequence shard say).
      stage_params: a pytree whose tensors lead with ``[S]``: stage
        ``s``'s slice at ``[s]``.
      x_micro: ``[M, ...]`` microbatches entering stage 0 (held once).
      pp_axis: the pipeline axis's name or the axis.
      n_stages: its size.
      with_aux: also sum each stage's aux over the ticks where it
        processes a REAL microbatch (the caller divides by ``M``).

    Returns:
      the last stage's outputs ``[M, ...]`` (with ``with_aux``, and the
      per-stage aux sums ``[S]``, f32, of the aux's shape).
    """
    axis = _stage_axis(pp_axis, n_stages)
    n_micro = x_micro.shape[0]
    n_ticks = n_micro + n_stages - 1
    state = x_micro.new_zeros((n_stages,) + tuple(x_micro.shape[1:]))
    outputs = [None] * n_micro
    aux_acc = None
    # stage s processes microbatch t - s at tick t
    masks = (_tick_masks(lambda t, s: s <= t < s + n_micro, n_ticks,
                         n_stages, x_micro.device) if with_aux else None)
    for t in range(n_ticks):
        # stage 0 ingests microbatch t (clamped re-reads past M never
        # reach the outputs, so they carry no gradient)
        inject = x_micro[min(t, n_micro - 1)]
        x_in = torch.cat([inject[None], state[1:]])
        y, aux = _run_stage(stage_fn, stage_params, x_in, with_aux)
        if with_aux:
            aux_acc = _masked_sum(aux_acc, aux, masks[t])
        # microbatch m exits the last stage at tick m + S - 1
        if t >= n_stages - 1:
            outputs[t - n_stages + 1] = y[n_stages - 1]
        state = axis.shift(y)
    out = torch.stack(outputs)
    return (out, aux_acc) if with_aux else out


def circular_layer_permutation(n_layers: int, n_stages: int,
                               n_loops: int) -> np.ndarray:
    """Layer permutation that turns the natural ``[n_layers]`` order into
    the circular pipeline's storage order: chunk ``c`` (layers ``c*Lc ..
    (c+1)*Lc``) lives on stage ``c % n_stages`` and runs on its loop ``c
    // n_stages``; storage slot ``(s, r, l)`` holds original layer ``(r *
    n_stages + s) * Lc + l``, so each stage's ``n_loops`` chunks sit next
    to each other (JAX shards a leading axis contiguously).  Equal to the
    JAX package's; ``np.argsort`` of it goes back."""
    if n_layers % (n_stages * n_loops):
        raise ValueError(f"n_layers ({n_layers}) must divide by "
                         f"n_stages*n_loops ({n_stages}*{n_loops})")
    lc = n_layers // (n_stages * n_loops)
    perm = np.empty((n_layers,), np.int64)
    g = 0
    for s in range(n_stages):
        for r in range(n_loops):
            c = r * n_stages + s
            for l in range(lc):
                perm[g] = c * lc + l
                g += 1
    return perm


def gpipe_circular(stage_fn: Callable, chunk_params, x_micro: torch.Tensor,
                   pp_axis: Union[str, MeshAxis], n_stages: int,
                   n_loops: int, with_aux: bool = False):
    """The circular (interleaved) pipeline over ``pp_axis``, every stage
    at once.

    Each stage holds ``n_loops`` chunks of layers (round-robin, see
    :func:`circular_layer_permutation`) and every microbatch rides the
    ring ``n_loops`` times.  Loop-major schedule, as JAX's: stage ``s``
    runs (microbatch ``m``, loop ``r``) at tick ``r*M + m + s``, so
    ``n_loops*M + S - 1`` ticks and a bubble of ``(S-1)/(n_loops*M +
    S-1)``; activations returning to stage 0 for their next loop wait in
    a FIFO of depth ``M - S``.  Requires ``M >= S``.

    Args:
      stage_fn: as in :func:`gpipe`; it receives every stage's chunk of
        the tick (stage ``s``'s chunk ``r_s`` at ``[s]``).
      chunk_params: a pytree whose tensors lead with ``[S, n_loops]``:
        each stage's chunks in loop order.
      x_micro / pp_axis / n_stages / with_aux: as in :func:`gpipe`.

    Returns as :func:`gpipe` (the outputs of the last chunk on the last
    stage).
    """
    n_micro = x_micro.shape[0]
    if n_micro < n_stages:
        raise ValueError(
            f"circular pipeline needs n_micro ({n_micro}) >= n_stages "
            f"({n_stages}) — the loop-major schedule stalls otherwise")
    if n_loops == 1:
        return gpipe(stage_fn, tree_map(lambda a: a[:, 0], chunk_params),
                     x_micro, pp_axis, n_stages, with_aux=with_aux)
    axis = _stage_axis(pp_axis, n_stages)
    depth = n_micro - n_stages   # FIFO delay for loop re-entry at stage 0
    n_ticks = n_loops * n_micro + n_stages - 1

    def place(t: int, s: int) -> Tuple[int, int, bool]:
        """(microbatch, loop, active) of stage ``s`` at tick ``t``."""
        rel = t - s
        m = min(max(rel % n_micro, 0), n_micro - 1)
        r = min(max(rel // n_micro, 0), n_loops - 1)
        return m, r, rel >= 0 and rel // n_micro < n_loops

    state = x_micro.new_zeros((n_stages,) + tuple(x_micro.shape[1:]))
    fifo = [state[0]] * max(depth, 1)
    outputs = [torch.zeros_like(x_micro[0])] * n_micro
    aux_acc = None
    masks = (_tick_masks(lambda t, s: place(t, s)[2], n_ticks, n_stages,
                         x_micro.device) if with_aux else None)
    # each distinct (r_0 .. r_{S-1}) of the schedule gathers its chunks
    # once
    chunks = {}
    for t in range(n_ticks):
        where = [place(t, s) for s in range(n_stages)]
        m0 = where[0][0]
        if depth > 0:
            feed = fifo[0]
            fifo = fifo[1:] + [state[0]]
        else:
            feed = state[0]
        # stage 0 takes a fresh microbatch on its first loop, else the
        # activation returning from the last stage
        x0 = x_micro[m0] if t // n_micro == 0 else feed
        x_in = torch.cat([x0[None], state[1:]])
        key = tuple(r for _, r, _ in where)
        if key not in chunks:
            idx = _device_const(key, x_micro.device)
            rows = _device_const(tuple(range(n_stages)), x_micro.device)
            chunks[key] = tree_map(lambda a: a[rows, idx], chunk_params)
        y, aux = _run_stage(stage_fn, chunks[key], x_in, with_aux)
        if with_aux:
            aux_acc = _masked_sum(aux_acc, aux, masks[t])
        m, r, active = where[n_stages - 1]
        if active and r == n_loops - 1:
            outputs[m] = y[n_stages - 1]
        state = axis.shift(y)
    out = torch.stack(outputs)
    return (out, aux_acc) if with_aux else out

"""Ulysses (all-to-all) sequence parallelism.

Port of ``bluefog_tpu/parallel/ulysses.py``, the second sequence-parallel
flavour beside ring attention: one all-to-all re-shards the activations
from sequence-sharded to HEAD-sharded, each shard runs ordinary full (or
flash) attention over the COMPLETE sequence for its share of the heads,
and a second all-to-all re-shards back (the DeepSpeed-Ulysses pattern).
Ulysses caps the sp degree at the kv-head count (``n_kv_heads % S == 0``);
ring attention has no head constraint.

As for :func:`~bluefog_tpu_torch.parallel.ring_attention.ring_attention`
the shards of a :class:`~bluefog_tpu_torch.parallel.collectives.SeqAxis`
are stacked shard-major (q ``[S, B, T_local, H, D]``), and the data moves
only through the axis's ``all_to_all`` (``lax.all_to_all(...,
tiled=True)``), whose backward is the reverse all-to-all as in JAX.
With the shards stacked, the head groups fold into the batch axis: one
attention call (one K2 launch, and one K3a/K3b pair in the backward)
serves every shard.
"""

from __future__ import annotations

from typing import Optional

import torch

from bluefog_tpu_torch.parallel.collectives import bound_axis
from bluefog_tpu_torch.parallel.flash_attention import flash_attention
from bluefog_tpu_torch.parallel.ring_attention import full_attention

__all__ = ["ulysses_attention"]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name, causal: bool = True,
                      scale: Optional[float] = None,
                      impl: str = "xla") -> torch.Tensor:
    """All-to-all sequence-parallel attention over the shards of
    ``axis_name`` (a bound axis name or the ``SeqAxis``).

    q: ``[S, B, T_local, H, D]``, k/v: ``[S, B, T_local, H_kv, D]``, the
    sequence shards with ALL heads (rotary already applied at global
    positions by the caller).  Returns ``[S, B, T_local, H, D]``.  ``H``
    and ``H_kv`` must divide by the axis size.  ``impl="flash"`` runs the
    flash kernels (K2, K3a, K3b on CUDA tensors), anything else
    ``full_attention``, as in JAX (whose ``block_size`` the port does not
    take: the kernels choose their own tiles)."""
    axis = bound_axis(axis_name)
    n = axis.size
    h, n_kv = q.shape[-2], k.shape[-2]
    if h % n or n_kv % n:
        raise ValueError(
            f"ulysses attention shards heads over the sp axis: n_heads "
            f"({h}) and n_kv_heads ({n_kv}) must divide by its size ({n})")
    # [S, B, T/n, H, D] -> [S, B, T, H/n, D]: shard j takes head group j
    qg, kg, vg = (axis.all_to_all(x, 2, 1) for x in (q, k, v))
    s_n, b, t = qg.shape[:3]
    fold = lambda x: x.reshape(s_n * b, t, *x.shape[3:])  # noqa: E731
    if impl == "flash":
        out = flash_attention(fold(qg), fold(kg), fold(vg), causal=causal,
                              scale=scale)
    else:
        out = full_attention(fold(qg), fold(kg), fold(vg), causal=causal,
                             scale=scale)
    # [S, B, T, H/n, D] -> [S, B, T/n, H, D]
    return axis.all_to_all(out.reshape(qg.shape), 1, 2)

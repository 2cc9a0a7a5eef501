"""Slot-pooled K/V caches for the continuous-batching engine.

Port of ``bluefog_tpu/serving/kv_pool.py`` (``SlotPool``).  Every
request owns a SLOT: row ``i`` of one :class:`KVCache` built for
``capacity`` rows (``init_cache(cfg, capacity, max_len)``), in the
full-precision or the int8 + scale layout.  The engine's decode step
runs every slot as one batch of ``capacity`` rows; a prefill chunk runs
on the slot's row view (``cache.rows(slot, slot + 1)``).

Allocation is host-side bookkeeping (a free list).  Freeing a slot
resets its cache index, which alone makes reuse exact: everything above
the index is masked, and the next request overwrites positions as it
writes them.  ``BLUEFOG_KV_ZERO_ON_FREE=1`` (or ``zero_on_free=True``)
also zeroes the slot's K/V: a whole-slot write per retirement that buys
nothing for correctness, and destroys K/V that a
:class:`~bluefog_tpu_torch.serving.prefix_cache.PrefixCache` could have
stashed later (the engine stashes a chunk right after it prefills, so
the prefix cache works in both modes).  With ``prefix=`` the pool
restores cached chunks into a slot (:meth:`SlotPool.restore_prefix`) and
stashes freshly prefilled ones (:meth:`SlotPool.stash_chunk`).
Deviation: the caches are updated in place (JAX rebuilt the pool tree
with jitted scatters).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from bluefog_tpu_torch._device import resolve_device
from bluefog_tpu_torch.models.generate import decode_config, init_cache
from bluefog_tpu_torch.models.llama import LlamaConfig

__all__ = ["SlotPool"]


class SlotPool:
    """Fixed-capacity pool of per-request K/V caches.

    Args:
      cfg: the model's config (normalized through ``decode_config``).
      capacity: number of resident request slots (= the decode batch).
      max_len: per-slot cache length.
      kv_quant: "none" | "int8" — the cache layout.
      zero_on_free: ``True`` zeroes a freed slot's whole cache; the
        default (``None``) follows ``BLUEFOG_KV_ZERO_ON_FREE`` (off).
      device: where the caches live (default ``"cuda"``).
      prefix: an optional
        :class:`~bluefog_tpu_torch.serving.prefix_cache.PrefixCache` whose
        ``chunk`` is the engine's prefill chunk; enables
        :meth:`restore_prefix` / :meth:`stash_chunk`.
    """

    def __init__(self, cfg: LlamaConfig, capacity: int, max_len: int,
                 kv_quant: str = "none",
                 zero_on_free: Optional[bool] = None,
                 device: Union[str, torch.device] = "cuda", prefix=None):
        if capacity < 1:
            raise ValueError(f"capacity ({capacity}) must be >= 1")
        if zero_on_free is None:
            from bluefog_tpu_torch import config as bfconfig

            zero_on_free = bfconfig.kv_zero_on_free()
        dcfg = decode_config(cfg, max_len, kv_quant=kv_quant)
        self.cache = init_cache(dcfg, capacity, max_len, kv_quant=kv_quant,
                                device=resolve_device(device))
        self.capacity = capacity
        self.max_len = max_len
        self.kv_quant = kv_quant
        self.zero_on_free = bool(zero_on_free)
        self.prefix = prefix
        self._seq_axes = None
        if prefix is not None:
            from bluefog_tpu_torch.serving.prefix_cache import seq_axes

            if max_len % prefix.chunk != 0:
                raise ValueError(
                    f"prefix cache chunk ({prefix.chunk}) must divide "
                    f"max_len ({max_len}) — restores land on the same "
                    f"chunk grid prefill writes")
            self._seq_axes = seq_axes(cfg, max_len, kv_quant)
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._in_use: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return len(self._in_use)

    def occupancy(self) -> float:
        """Fraction of slots holding a live request."""
        return len(self._in_use) / self.capacity

    def alloc(self) -> Optional[int]:
        """Claim a slot, or ``None`` when the pool is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._in_use.add(slot)
        return slot

    def free(self, slot: int) -> None:
        """Return ``slot`` to the pool: reset its cache index (always),
        and zero its K/V too under ``zero_on_free``."""
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")
        self._in_use.remove(slot)
        self._free.append(slot)
        view = self.cache.rows(slot, slot + 1)
        for t in (view.tensors() if self.zero_on_free else [view.index]):
            t.zero_()

    # -- prefix reuse --------------------------------------------------- #
    def restore_prefix(self, slot: int, keys: Sequence[str],
                       n: Optional[int] = None) -> int:
        """Copy the longest cached run of ``keys``'s chunks into ``slot``
        (ascending, so the index ends at the restored length) and return
        how many chunks were restored.  ``n`` caps the run when the
        caller already matched (the speculative engine restores the
        MINIMUM of the target and draft matches into both pools)."""
        if self.prefix is None:
            return 0
        from bluefog_tpu_torch.serving.prefix_cache import _restore_chunk

        matched = self.prefix.match(keys) if n is None else int(n)
        for i in range(matched):
            _restore_chunk(self.cache, slot, i * self.prefix.chunk,
                           self.prefix.get(keys[i]), self._seq_axes,
                           self.prefix.chunk)
        return matched

    def stash_chunk(self, slot: int, key: str, pos: int) -> None:
        """Copy the chunk at grid position ``pos`` out of ``slot`` and
        retain it under ``key`` (no-op without a prefix cache).  The
        engine calls it right after a FULL cold chunk prefills, while the
        K/V provably matches the chain hash."""
        if self.prefix is None:
            return
        from bluefog_tpu_torch.serving.prefix_cache import _extract_chunk

        self.prefix.insert(key, _extract_chunk(
            self.cache, slot, pos, self._seq_axes, self.prefix.chunk))

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
also zeroes the slot's K/V.  Deviations: the caches are updated in place
(JAX rebuilt the pool tree with jitted scatters), and the prefix-cache
hooks (``prefix=``, ``restore_prefix``, ``stash_chunk``) wait for a
later serving slice.
"""

from __future__ import annotations

from typing import List, Optional, Union

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
    """

    def __init__(self, cfg: LlamaConfig, capacity: int, max_len: int,
                 kv_quant: str = "none",
                 zero_on_free: Optional[bool] = None,
                 device: Union[str, torch.device] = "cuda"):
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

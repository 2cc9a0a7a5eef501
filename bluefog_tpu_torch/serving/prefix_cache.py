"""Chunk-hashed prefix/KV reuse for the serving slot pool.

Port of ``bluefog_tpu/serving/prefix_cache.py``: ``seq_axes``, the chunk
extract and restore, and :class:`PrefixCache` (chain-hash keys, a
byte-bounded LRU).  A request whose prompt shares whole chunks with an
earlier one admits by COPYING those chunks' K/V into its slot and
prefills only its novel tail.

Why it is exact:

* **Chain hashing over whole chunks.**  Chunk *i*'s key is
  ``sha256(key_{i-1} ‖ tokens_i)``, so two requests share a cached chunk
  iff they share the ENTIRE token prefix up to its end.
* **Only FULL chunks of ``prompt[:-1]`` are cached** (chunked prefill
  covers ``prompt[:-1]``; the last token rides the first decode step).
  A restored chunk is the bytes the prefill of that chunk wrote, at the
  same position of the chunk grid.
* **Restore sets the slot's index** to the restored length; everything
  above it is masked, as after a padded prefill chunk.

Deviations: the payload is a list of CPU tensors, one per cache tensor
with a sequence axis (the K/V codes and, in the int8 layout, their
scales), copied out of the pool's row views; on a CUDA pool they are
pinned, so both copies are stream-ordered DMA (numpy has no bfloat16).
:meth:`PrefixCache.insert` also takes numpy arrays.  The sequence axes
are read from two cache layouts built on the ``meta`` device (shapes
only), where the JAX package shape-evaluated the cache tree.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bluefog_tpu_torch.models.generate import _zero_cache
from bluefog_tpu_torch.models.llama import KVCache, LlamaConfig

__all__ = ["PrefixCache", "seq_axes"]


def seq_axes(cfg: LlamaConfig, max_len: int,
             kv_quant: str = "none") -> Tuple[Optional[int], ...]:
    """Per-tensor sequence axis of ONE request's cache (a
    ``KVCache.rows(slot, slot + 1)`` view), in ``KVCache.tensors()``
    order (None for the index).  Detected by comparing the layout at two
    cache lengths: the axis that scales with ``max_len`` is the sequence
    axis."""
    if kv_quant not in ("none", "int8"):
        raise ValueError(f"kv_quant {kv_quant!r} not in ('none', 'int8')")
    meta = torch.device("meta")
    a = _zero_cache(cfg, 1, max_len, kv_quant, meta).tensors()
    b = _zero_cache(cfg, 1, 2 * max_len, kv_quant, meta).tensors()
    axes: List[Optional[int]] = []
    for ta, tb in zip(a, b):
        diff = [i for i, (sa, sb) in enumerate(zip(ta.shape, tb.shape))
                if sa != sb]
        if not diff:
            axes.append(None)  # the index
        elif len(diff) == 1:
            axes.append(diff[0])
        else:
            raise ValueError(
                f"cache tensor {tuple(ta.shape)} scales {len(diff)} axes "
                "with max_len; prefix extraction needs exactly one")
    return tuple(axes)


def _extract_chunk(cache: KVCache, slot: int, pos: int,
                   axes: Tuple[Optional[int], ...], chunk: int
                   ) -> List[torch.Tensor]:
    """Copy ``slot``'s window ``[pos, pos + chunk)`` of every tensor with
    a sequence axis to the host (pinned when the pool is on the card)."""
    out = []
    view = cache.rows(slot, slot + 1)
    for t, ax in zip(view.tensors(), axes):
        if ax is None:
            continue
        src = t.narrow(ax, pos, chunk)
        dst = torch.empty(src.shape, dtype=src.dtype, device="cpu",
                          pin_memory=src.is_cuda)
        out.append(dst.copy_(src, non_blocking=src.is_cuda))
    return out


def _restore_chunk(cache: KVCache, slot: int, pos: int,
                   leaves: Sequence, axes: Tuple[Optional[int], ...],
                   chunk: int) -> None:
    """Write one cached chunk back into ``slot`` at grid position ``pos``
    and set the slot's index to ``pos + chunk`` (restores run in
    ascending chunk order, so the last one leaves the index at the whole
    restored length)."""
    view = cache.rows(slot, slot + 1)
    it = iter(leaves)
    for t, ax in zip(view.tensors(), axes):
        if ax is None:
            t.fill_(pos + chunk)
            continue
        src = torch.as_tensor(next(it))
        t.narrow(ax, pos, chunk).copy_(src, non_blocking=t.is_cuda)


class PrefixCache:
    """Bounded host-side LRU of prompt-chunk K/V, keyed by chain hash.

    One instance serves one :class:`~bluefog_tpu_torch.serving.SlotPool`
    (a speculative engine keeps a lockstep PAIR: target and draft K/V
    are different tensors for the same tokens).  ``capacity_bytes``
    bounds the payload; ``0`` disables retention (every ``insert`` is
    dropped), which is also the ``BLUEFOG_PREFIX_CACHE_MB=0`` setting."""

    def __init__(self, chunk: int, capacity_bytes: Optional[int] = None):
        if chunk < 1:
            raise ValueError(f"chunk ({chunk}) must be >= 1")
        if capacity_bytes is None:
            from bluefog_tpu_torch import config as bfconfig

            capacity_bytes = bfconfig.prefix_cache_mb() << 20
        self.chunk = int(chunk)
        self.capacity_bytes = int(capacity_bytes)
        self._store: "OrderedDict[str, list]" = OrderedDict()
        self._nbytes = 0
        # observability (the engine folds these into its summary)
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0

    # -- keys ---------------------------------------------------------- #
    def chunk_keys(self, prompt: np.ndarray) -> List[str]:
        """Chain-hash keys of the FULL chunks of ``prompt[:-1]`` (the
        prefill region).  ``keys[i]`` commits to every token through the
        end of chunk *i*, so equal keys mean equal whole prefixes."""
        toks = np.asarray(prompt, np.int32).reshape(-1)
        n_full = max(toks.size - 1, 0) // self.chunk
        h = hashlib.sha256(f"prefix:{self.chunk}".encode())
        keys = []
        for i in range(n_full):
            h = h.copy()
            h.update(toks[i * self.chunk:(i + 1) * self.chunk].tobytes())
            keys.append(h.hexdigest())
        return keys

    # -- store --------------------------------------------------------- #
    def match(self, keys: Sequence[str]) -> int:
        """Length (in chunks) of the longest cached prefix of ``keys``,
        touching each hit for LRU.  A miss at chunk *i* ends the walk:
        chunk *j > i*'s key commits to chunk *i*'s tokens too."""
        n = 0
        for k in keys:
            if k not in self._store:
                self.misses += 1
                break
            self._store.move_to_end(k)
            self.hits += 1
            n += 1
        return n

    def get(self, key: str) -> list:
        return self._store[key]

    def insert(self, key: str, leaves: Sequence) -> None:
        if key in self._store:
            self._store.move_to_end(key)
            return
        payload = list(leaves)
        size = sum(int(a.nbytes) for a in payload)
        if size > self.capacity_bytes:
            return  # a chunk larger than the whole budget never fits
        while self._nbytes + size > self.capacity_bytes and self._store:
            _, old = self._store.popitem(last=False)
            self._nbytes -= sum(int(a.nbytes) for a in old)
            self.evictions += 1
        self._store[key] = payload
        self._nbytes += size
        self.insertions += 1

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: str) -> bool:
        """Membership WITHOUT touching LRU order or hit/miss counters (the
        drain flush asks "already cached?" before paying an extract)."""
        return key in self._store

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "entries": len(self._store),
            "bytes": self._nbytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
            "insertions": self.insertions,
            "evictions": self.evictions,
        }

"""Gradient compression of the port.

Port of ``bluefog_tpu/compressor.py`` (reference
compressor/Compressor.py: TopKCompressor, RandomKCompressor,
QuantizedCompressor; compressor/CompressedOptimizer.py), on rank-major
tensors: every compressor takes a ``[n, ...]`` tensor and compresses each
rank's slice on its own (a compressed gradient is dense, all but k
entries of each rank's slice zeroed).  :class:`CompressedOptimizer`
applies a compressor to every ``.grad`` before the wrapped optimizer's
step: the eager counterpart of JAX's ``compress_gradients`` optax
transform.  Random draws come from explicit ``torch.Generator``s, one
seeded per (seed, step); they are not the JAX package's bits.

There is ONE top-k kernel and ONE k-resolution rule in the port:
:func:`topk_mask_encode` / :func:`topk_mask_decode` (with
:func:`_resolve_k`) back both the gradient compressors and the train
step's error-feedback compressed mixing
(``parallel.collectives.mix_compress_exchange``).

Ties: ``lax.top_k`` breaks ties of equal magnitude by the lowest index;
``torch.topk`` does not promise an order, so :func:`topk_mask_encode`
takes only the threshold from it and keeps the lowest-index ties itself:
the JAX package's selection, ties included.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["TopKCompressor", "RandomKCompressor", "QuantizedCompressor",
           "CompressedOptimizer", "compress_gradients",
           "topk_mask_encode", "topk_mask_decode"]


def _resolve_k(k: Optional[int], percentage: Optional[float],
               numel: int) -> int:
    """Reference argument contract (Compressor.py:16-27)."""
    if k is None and percentage is None:
        raise ValueError("At least one of 'k' or 'percentage' must be "
                         "provided")
    if k is not None and percentage is not None:
        raise ValueError("The 'k' and 'percentage' parameters are mutually "
                         "exclusive.")
    if percentage is not None:
        if percentage < 0 or percentage > 1:
            raise ValueError("'percentage' must be a float number between "
                             "0 and 1")
        return max(int(percentage * numel), 1)
    if int(k) <= 0:
        raise ValueError(f"'k' must be a positive int, got {k}")
    return min(int(k), numel)


def topk_mask_encode(flat: torch.Tensor, k: int,
                     k_live: Optional[torch.Tensor] = None):
    """The ``k`` largest-magnitude entries of each row of ``flat``
    (``[n, numel]``): ``(mask bool [n, numel], vals [n, k])``, the kept
    values in ascending-index order and zeros beyond the row's live count
    ``k_live`` (``[n]`` int, each ``<= k``; a runtime tensor, so a live
    ratio change needs no new shapes).  The selection is ``lax.top_k``'s:
    of the magnitudes equal to the live count's smallest kept one, the
    lowest indices are kept (``torch.topk`` gives the threshold only, as
    it promises no order among ties); a NaN counts as the largest
    magnitude, as in both.  Each temporary of the rows' size is freed
    as soon as it is used: a bucket at 8B width is gigabytes."""
    n, numel = flat.shape
    inf = float("inf")
    mag = flat.abs().nan_to_num_(nan=inf, posinf=inf)
    live = (torch.full((n, 1), k, dtype=torch.int64, device=flat.device)
            if k_live is None else k_live.to(torch.int64).reshape(n, 1))
    # the live count's smallest kept magnitude; every larger one is kept,
    # and of the ties at it the lowest indices fill the count
    t = torch.topk(mag, k, dim=1, sorted=True).values.gather(1, live - 1)
    above = mag > t
    tied = mag == t
    del mag
    room = live - above.sum(dim=1, keepdim=True)
    mask = _row_cumsum(tied.to(torch.int32), inplace=True) <= room
    mask &= tied
    mask |= above
    del tied, above
    # the j-th kept entry's position: the first index where the running
    # count of kept entries reaches j + 1 (numel past the last one)
    ar = torch.arange(k, device=flat.device)
    pos = torch.searchsorted(_row_cumsum(mask.to(torch.int32), inplace=True),
                             (ar + 1).to(torch.int32).expand(n, k)
                             .contiguous())
    valid = pos < numel
    safe = torch.where(valid, pos, torch.zeros_like(pos))
    vals = torch.where(valid, flat.gather(1, safe),
                       torch.zeros((), dtype=flat.dtype, device=flat.device))
    return mask, vals


# columns of one gather in topk_mask_decode
_GATHER_COLUMNS = 1 << 24

# block of the two-level row scan: a scan along a few long rows runs one
# block a row on the card, so each row is scanned in blocks of this many
# entries and the blocks' totals are scanned after
_SCAN_BLOCK = 1024


def _row_cumsum(x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """Inclusive int32 cumsum along dim 1 of a ``[n, numel]`` integer
    tensor (exact: integers), as a scan within blocks plus a scan of the
    block totals, returned contiguous.  ``inplace``: ``x`` is a
    contiguous int32 temporary of the caller's that may hold the scan
    (no copy of the rows' size when ``numel`` is a whole number of
    blocks)."""
    n, numel = x.shape
    pad = (-numel) % _SCAN_BLOCK
    if inplace and not pad:
        blocks = x.view(n, -1, _SCAN_BLOCK)
    else:
        blocks = torch.nn.functional.pad(x.to(torch.int32), (0, pad)
                                         ).reshape(n, -1, _SCAN_BLOCK)
    blocks.cumsum_(dim=2)
    totals = blocks[:, :, -1].cumsum(dim=1, dtype=torch.int32)
    blocks[:, 1:] += totals[:, :-1, None]
    out = blocks.reshape(n, -1)
    return out if not pad else out[:, :numel].contiguous()


def topk_mask_decode(mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Dense ``[n, numel]`` rows from keep-masks plus ascending-index
    values: the inverse of :func:`topk_mask_encode`, a pure gather, so the
    same ``(mask, vals)`` decodes to the same bits on sender and
    receiver."""
    cum = _row_cumsum(mask.to(torch.int32), inplace=True)
    cum.sub_(1).clamp_(0, vals.shape[1] - 1)
    # the gather's int64 index a block of columns at a time (a bucket's
    # index at 8B width would be twice its values' bytes)
    out = torch.empty(cum.shape, dtype=vals.dtype, device=vals.device)
    for c in range(0, cum.shape[1], _GATHER_COLUMNS):
        torch.gather(vals, 1, cum[:, c:c + _GATHER_COLUMNS].long(),
                     out=out[:, c:c + _GATHER_COLUMNS])
    del cum
    return out.masked_fill_(~mask, 0)


class TopKCompressor:
    """Keep the k largest-magnitude entries of each rank's slice, zero the
    rest (dense)."""

    def __init__(self, *, k: Optional[int] = None,
                 percentage: Optional[float] = None):
        _resolve_k(k, percentage, 1 << 30)  # validate eagerly
        self.k = k
        self.percentage = percentage

    def __call__(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        kk = _resolve_k(self.k, self.percentage, flat.shape[1])
        return topk_mask_decode(*topk_mask_encode(flat, kk)).reshape(x.shape)


class RandomKCompressor:
    """Keep k uniformly random entries of each rank's slice, zero the rest
    (dense)."""

    def __init__(self, *, k: Optional[int] = None,
                 percentage: Optional[float] = None):
        _resolve_k(k, percentage, 1 << 30)
        self.k = k
        self.percentage = percentage

    def __call__(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if generator is None:
            raise ValueError("RandomKCompressor needs an explicit "
                             "torch.Generator")
        flat = x.reshape(x.shape[0], -1)
        kk = _resolve_k(self.k, self.percentage, flat.shape[1])
        # k distinct positions per row: the k largest of uniform keys
        keys = torch.rand(flat.shape, generator=generator,
                          device=flat.device)
        idx = torch.topk(keys, kk, dim=1).indices
        out = torch.zeros_like(flat).scatter_(1, idx, flat.gather(1, idx))
        return out.reshape(x.shape)


class QuantizedCompressor:
    """QSGD-style stochastic quantization of each rank's slice to ``s``
    levels of its absmax (reference Compressor.py:80-108)."""

    def __init__(self, s: int):
        self.s = int(s)

    def __call__(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if generator is None:
            raise ValueError("QuantizedCompressor needs an explicit "
                             "torch.Generator")
        flat = x.reshape(x.shape[0], -1).float()
        norm = flat.abs().amax(dim=1, keepdim=True)
        safe = torch.where(norm == 0, torch.ones_like(norm), norm)
        scale = flat.abs() / safe * self.s
        lower = torch.clamp(torch.floor(scale), 0, self.s - 1)
        bump = (torch.rand(flat.shape, generator=generator,
                           device=flat.device) < scale - lower).float()
        out = norm * torch.sign(flat) * (lower + bump) / self.s
        return out.reshape(x.shape).to(x.dtype)


def compress_gradients(compressor, params, generator=None) -> None:
    """Replace every ``.grad`` of ``params`` (rank-major tensors) by its
    compressed value, in place."""
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.grad.copy_(compressor(p.grad, generator=generator))


class CompressedOptimizer:
    """Compress every rank-major ``.grad`` with ``compressor``, then run
    the wrapped optimizer's step (a ``torch.optim`` optimizer or one of
    the distributed wrappers): the reference's CompressedOptimizer
    (CompressedOptimizer.py:9-28).  Step ``t`` draws from a generator
    seeded ``(seed, t)`` on the params' device."""

    def __init__(self, optimizer, compressor, seed: int = 0):
        self.optimizer = optimizer
        self.compressor = compressor
        self.seed = int(seed)
        self._count = 0

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        params = [p for g in self.optimizer.param_groups
                  for p in g["params"]]
        gen = None
        if params:
            gen = torch.Generator(device=params[0].device).manual_seed(
                self.seed * 1_000_003 + self._count)
        compress_gradients(self.compressor, params, gen)
        self._count += 1
        self.optimizer.step()

"""Top-k selection of the port, cut to what the train step's
error-feedback compressed mixing needs.

Port of ``bluefog_tpu/compressor.py``'s k-resolution rule
(``_resolve_k``) and its top-k kernel (``topk_mask_encode`` /
``topk_mask_decode``), on rank-major rows: every function takes a
``[n, numel]`` tensor and works on each rank's row.  The eager gradient
compressors wait for ROADMAP.md Queue 1, item 4.

Ties: ``lax.top_k`` breaks ties of equal magnitude by the lowest index;
``torch.topk`` does not promise an order.  Exact zeros are harmless (a
kept zero decodes to the same zero), so the two agree whenever no two
nonzero magnitudes tie at the k-th place.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["topk_mask_encode", "topk_mask_decode"]


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
    ratio change needs no new shapes).  Dropped candidates go to
    out-of-range positions so the position sort never mixes them in."""
    n, numel = flat.shape
    idx = torch.topk(flat.abs(), k, dim=1, sorted=True).indices
    ar = torch.arange(k, device=flat.device)
    if k_live is None:
        live = torch.ones((n, k), dtype=torch.bool, device=flat.device)
    else:
        live = ar[None, :] < k_live.reshape(n, 1)
    pos = torch.where(live, idx, numel + ar[None, :])
    pos = torch.sort(pos, dim=1).values
    valid = pos < numel
    safe = torch.where(valid, pos, torch.zeros_like(pos))
    vals = torch.where(valid, flat.gather(1, safe),
                       torch.zeros((), dtype=flat.dtype, device=flat.device))
    # scatter-ADD of the valid flags: dropped entries clamp to position 0,
    # and addition cannot let them clobber a kept flag there
    mask = torch.zeros((n, numel), dtype=torch.int32, device=flat.device
                       ).scatter_add_(1, safe, valid.to(torch.int32)) > 0
    return mask, vals


# block of the two-level row scan: a scan along a few long rows runs one
# block a row on the card, so each row is scanned in blocks of this many
# entries and the blocks' totals are scanned after
_SCAN_BLOCK = 1024


def _row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum along dim 1 of a ``[n, numel]`` integer
    tensor (exact: integers), as a scan within blocks plus a scan of the
    block totals."""
    n, numel = x.shape
    blocks = torch.nn.functional.pad(
        x, (0, (-numel) % _SCAN_BLOCK)).reshape(n, -1, _SCAN_BLOCK)
    inner = blocks.cumsum(dim=2, dtype=torch.int32)
    totals = inner[:, :, -1].cumsum(dim=1, dtype=torch.int32)
    offsets = torch.nn.functional.pad(totals[:, :-1], (1, 0))
    return (inner + offsets[:, :, None]).reshape(n, -1)[:, :numel]


def topk_mask_decode(mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Dense ``[n, numel]`` rows from keep-masks plus ascending-index
    values: the inverse of :func:`topk_mask_encode`, a pure gather, so the
    same ``(mask, vals)`` decodes to the same bits on sender and
    receiver."""
    cum = _row_cumsum(mask.to(torch.int32)) - 1
    safe = cum.clamp(0, vals.shape[1] - 1).long()
    return torch.where(mask, vals.gather(1, safe),
                       torch.zeros((), dtype=vals.dtype, device=vals.device))

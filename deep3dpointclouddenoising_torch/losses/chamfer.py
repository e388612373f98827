"""Masked Chamfer distance and the Chamfer-based training losses.

Counterpart of ``deep3dpointclouddenoising_tpu/losses/chamfer.py:30-158``,
over padded (B, P, 3) clouds with float {0,1} masks:

* ``norm_type='L2'``: a point's cost is the squared distance to its
  nearest valid point of the other cloud;
* ``norm_type='L1'``: the sum of absolute coordinate differences to that
  same (squared-distance) nearest point;
* each direction is a masked mean over valid points; the two directions
  add; the batch is reduced by ``batch_reduction``.

The nearest neighbour is searched without gradients and only the matched
pair is recomputed with them: the gradient of ``min_j d(x, y_j)`` is that
of the matched pair, and no (P1, P2, 3) difference tensor is kept for the
backward.  The matched points are gathered by advanced indexing
(``ops.neighbors.gather_rows``), whose backward sorts the indices and adds
each point's gradients in order: ``torch.gather``'s backward adds them by
float atomics on the card, in an order that varies from run to run.  The
search sums ``(x_d - y_d)^2`` coordinate by coordinate in
float32 elementwise arithmetic: no matrix product for TF32 to reach, and
no cancellation of ``|x|^2 - 2 x.y + |y|^2`` between near-duplicate points
(which ``torch.cdist`` uses above 25 rows).  Padding slots of ``y`` are
set to 1e10 before the argmin, so they are never matched; an item whose
``y`` is all padding costs 1e10 per point.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.neighbors import (auto_chunk, auto_compact, compact_supports,
                            gather_rows, pairwise_sqdist)

_BIG = 1e10


def nearest_indices(x: torch.Tensor, y: torch.Tensor, y_mask: torch.Tensor,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """(B, P1) index of each x point's nearest valid y point (the first
    of equal distances), searched without gradients in chunks of
    ``chunk`` x points (default ``ops.neighbors.auto_chunk``'s), over
    the valid y points alone where the whole search is larger than one
    chunk (``ops.neighbors.auto_compact``: the 15,000-point configs,
    whose patches are mostly padding)."""
    with torch.no_grad():
        xs, ys, y_mask = x.detach(), y.detach(), y_mask.float()
        B, P1 = xs.shape[:2]
        cols = None
        if auto_compact(B, P1, ys.shape[1]):
            ys, y_mask, cols = compact_supports(ys, y_mask)
        chunk = chunk or auto_chunk(B, P1, ys.shape[1])
        invalid = (y_mask <= 0.0)[:, None, :]
        out = []
        for s in range(0, P1, chunk):
            d2 = pairwise_sqdist(xs[:, s:s + chunk], ys)
            d2 = torch.where(invalid, torch.full_like(d2, _BIG), d2)
            out.append(torch.argmin(d2, dim=-1))
        idx = torch.cat(out, dim=1)
        return idx if cols is None else torch.gather(cols, 1, idx)


def _nn_one_way(x: torch.Tensor, y: torch.Tensor, y_mask: torch.Tensor,
                norm_type: str, chunk: Optional[int]) -> torch.Tensor:
    """(B, P1): each x point's cost to its nearest valid y point, with
    gradients through the matched pair only."""
    idx = nearest_indices(x, y, y_mask, chunk)
    near = gather_rows(y, idx)
    if norm_type == "L2":
        cost = torch.sum((x - near) ** 2, dim=-1)
    else:
        cost = torch.sum(torch.abs(x - near), dim=-1)
    has_valid = (torch.amax(y_mask, dim=1) > 0.0)[:, None]
    return torch.where(has_valid, cost, torch.full_like(cost, _BIG))


def _masked_mean_per_item(cost: torch.Tensor, mask: torch.Tensor
                          ) -> torch.Tensor:
    return torch.sum(cost * mask, dim=1) / torch.clamp(
        torch.sum(mask, dim=1), min=1.0)


def chamfer_distance(x: torch.Tensor, y: torch.Tensor,
                     x_mask: Optional[torch.Tensor] = None,
                     y_mask: Optional[torch.Tensor] = None,
                     *, norm_type: str = "L2",
                     batch_reduction: Optional[str] = "mean",
                     chunk: Optional[int] = None) -> torch.Tensor:
    """Masked symmetric Chamfer distance of (B, P, 3) clouds; masks
    default to all ones; ``batch_reduction`` 'mean', 'sum' or None for
    the (B,) per-item values."""
    if norm_type not in ("L2", "L1"):
        raise ValueError(f"Norm type {norm_type} not implemented")
    if x_mask is None:
        x_mask = x.new_ones(x.shape[:2])
    if y_mask is None:
        y_mask = y.new_ones(y.shape[:2])
    x_mask, y_mask = x_mask.float(), y_mask.float()
    cx = _nn_one_way(x, y, y_mask, norm_type, chunk)
    cy = _nn_one_way(y, x, x_mask, norm_type, chunk)
    per_item = (_masked_mean_per_item(cx, x_mask)
                + _masked_mean_per_item(cy, y_mask))
    if batch_reduction == "mean":
        return torch.mean(per_item)
    if batch_reduction == "sum":
        return torch.sum(per_item)
    return per_item


def nearest_distances(x: torch.Tensor, y: torch.Tensor,
                      y_mask: Optional[torch.Tensor] = None,
                      *, chunk: Optional[int] = None) -> torch.Tensor:
    """(B, P1) squared distance from each x point to its nearest valid y
    point."""
    if y_mask is None:
        y_mask = y.new_ones(y.shape[:2])
    return _nn_one_way(x, y, y_mask.float(), "L2", chunk)


def _l1_term(pred, target, mask):
    per_point = torch.mean(torch.abs(pred - target), dim=-1)
    return torch.sum(per_point * mask) / torch.clamp(torch.sum(mask),
                                                     min=1.0)


def masked_chamfer_loss(pred: torch.Tensor, target: torch.Tensor,
                        mask: torch.Tensor, points: torch.Tensor,
                        *, norm_type: str = "L2") -> torch.Tensor:
    """Chamfer distance between the clean patch (points + target) and the
    denoised one (points + pred), averaged over the batch."""
    mask = mask.float()
    return chamfer_distance(points + target, points + pred, mask, mask,
                            norm_type=norm_type, batch_reduction="mean")


def masked_chamfer_l1_loss(pred, target, mask, points,
                           *, norm_type: str = "L2") -> torch.Tensor:
    """0.5 * (masked L1 + Chamfer distance)."""
    mask = mask.float()
    l1 = _l1_term(pred, target, mask)
    cd = masked_chamfer_loss(pred, target, mask, points,
                             norm_type=norm_type)
    return 0.5 * (l1 + cd)


def masked_adaptive_l1_chamfer_loss(pred, target, mask, points,
                                    *, converging_to: str = "chamfer"
                                    ) -> torch.Tensor:
    """``l1 + exp(-l1) * cd`` (converging to the Chamfer distance) or
    ``cd + exp(-cd) * l1`` (converging to L1), with the L1-norm Chamfer
    distance so that the two terms are comparable."""
    mask = mask.float()
    l1 = _l1_term(pred, target, mask)
    cd = masked_chamfer_loss(pred, target, mask, points, norm_type="L1")
    if converging_to == "chamfer":
        return l1 + torch.exp(-l1) * cd
    if converging_to == "L1":
        return cd + torch.exp(-cd) * l1
    raise ValueError(f"Limit of loss {converging_to} not implemented")

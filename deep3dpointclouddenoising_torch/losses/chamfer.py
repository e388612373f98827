"""Masked Chamfer distance and the Chamfer-based training losses.

Counterpart of ``deep3dpointclouddenoising_tpu/losses/chamfer.py:30-158``,
over padded (B, P, 3) clouds with float {0,1} masks:

* ``norm_type='L2'``: a point's cost is the squared distance to its
  nearest valid point of the other cloud;
* ``norm_type='L1'``: the sum of absolute coordinate differences to that
  same (squared-distance) nearest point;
* each direction is a masked mean over valid points; the two directions
  add; the batch is reduced by ``batch_reduction``;
* inside a process group the training losses are this rank's share of
  the global batch's loss (``parallel/dist.py``);
* in point-sharded training (``spatial=True``; ``train/trainer.py``)
  ``pred`` is this rank's point rows of each cloud and ``target``,
  ``mask`` and ``points`` are whole: the local denoised rows are matched
  against the whole clean cloud, this rank's rows of the clean cloud
  against the denoised cloud all-gathered whole (whose adjoint returns
  each row's gradient to its owner), and each term is this rank's share
  of the masked mean over the whole cloud.

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
from ..parallel.dist import (all_gather_points, all_reduce_sum,
                             global_sum, group_size, is_distributed,
                             point_rows, replicated_share)
from .masked import masked_l1_loss

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


def _sharded_chamfer_per_item(pred: torch.Tensor, target: torch.Tensor,
                               mask: torch.Tensor, points: torch.Tensor,
                               norm_type: str, group) -> torch.Tensor:
    """(B,) this rank's share of each cloud's Chamfer distance: ``pred``
    its :func:`point_rows` in ``group`` of the clouds whose whole
    ``target``, ``mask`` and ``points`` it is given; the shares of the
    group's ranks sum to the per-item distance."""
    n = points.shape[1]
    rows = point_rows(n, group=group)
    clean = points + target
    denoised_rows = points[:, rows] + pred
    denoised = all_gather_points(denoised_rows.contiguous(), n, group)
    c_clean = _nn_one_way(clean[:, rows], denoised, mask, norm_type, None)
    c_denoised = _nn_one_way(denoised_rows, clean, mask, norm_type, None)
    mine = mask[:, rows]
    count = torch.clamp(torch.sum(mask, dim=1), min=1.0)
    return (torch.sum(c_clean * mine, dim=1) / count
            + torch.sum(c_denoised * mine, dim=1) / count)


def masked_chamfer_loss(pred: torch.Tensor, target: torch.Tensor,
                        mask: torch.Tensor, points: torch.Tensor,
                        *, norm_type: str = "L2", spatial: bool = False,
                        group=None) -> torch.Tensor:
    """Chamfer distance between the clean patch (points + target) and the
    denoised one (points + pred), averaged over the batch; inside a
    process group, this rank's share: its items' sum over the number of
    items on every rank.  With ``spatial``, ``pred`` is this rank's point
    rows (in ``group``, every rank for ``None``) of the clouds whose
    whole ``target``, ``mask`` and ``points`` it is given, and the share
    is its rows' part of each cloud's distance over the batch's count of
    clouds (each counted once, not once a rank of ``group``)."""
    mask = mask.float()
    if spatial:
        per_item = _sharded_chamfer_per_item(pred, target, mask, points,
                                             norm_type, group)
        items = global_sum(per_item.new_tensor(float(per_item.shape[0])))
        return torch.sum(per_item) / (items / group_size(group))
    per_item = chamfer_distance(points + target, points + pred, mask, mask,
                                norm_type=norm_type, batch_reduction=None)
    if not is_distributed():
        return torch.mean(per_item)
    return torch.sum(per_item) / global_sum(
        per_item.new_tensor(float(per_item.shape[0])))


def masked_l1_term(pred, target, mask, *, spatial: bool = False,
                   group=None) -> torch.Tensor:
    """The masked L1 loss (this rank's share inside a process group);
    with ``spatial``, of ``pred``'s rows (in ``group``) of the whole
    ``target`` and ``mask``."""
    if spatial:
        rows = point_rows(target.shape[1], group=group)
        target, mask = target[:, rows], mask[:, rows]
    return masked_l1_loss(pred, target, mask)


def masked_chamfer_l1_loss(pred, target, mask, points,
                           *, norm_type: str = "L2", spatial: bool = False,
                           group=None) -> torch.Tensor:
    """0.5 * (masked L1 + Chamfer distance); ``spatial`` and ``group`` as
    :func:`masked_chamfer_loss`'s."""
    mask = mask.float()
    l1 = masked_l1_term(pred, target, mask, spatial=spatial, group=group)
    cd = masked_chamfer_loss(pred, target, mask, points,
                             norm_type=norm_type, spatial=spatial,
                             group=group)
    return 0.5 * (l1 + cd)


def masked_adaptive_l1_chamfer_loss(pred, target, mask, points,
                                    *, converging_to: str = "chamfer",
                                    spatial: bool = False, group=None
                                    ) -> torch.Tensor:
    """``l1 + exp(-l1) * cd`` (converging to the Chamfer distance) or
    ``cd + exp(-cd) * l1`` (converging to L1), with the L1-norm Chamfer
    distance so that the two terms are comparable.  Not linear in the
    batch: inside a process group both terms are summed over the ranks
    first, and each rank returns its share of the global loss.
    ``spatial`` and ``group`` as :func:`masked_chamfer_loss`'s."""
    if converging_to not in ("chamfer", "L1"):
        raise ValueError(f"Limit of loss {converging_to} not implemented")
    mask = mask.float()
    l1 = all_reduce_sum(masked_l1_term(pred, target, mask, spatial=spatial,
                                       group=group))
    cd = all_reduce_sum(masked_chamfer_loss(pred, target, mask, points,
                                            norm_type="L1", spatial=spatial,
                                            group=group))
    if converging_to == "chamfer":
        return replicated_share(l1 + torch.exp(-l1) * cd)
    return replicated_share(cd + torch.exp(-cd) * l1)

"""Loss selection by config name.

Counterpart of ``deep3dpointclouddenoising_tpu/losses/build.py:29-88``:

* :func:`get_offset_regression_loss`: ``loss(pred, target, mask,
  points=None) -> scalar`` for the offset head;
* :func:`get_complete_denoising_loss`: ``loss(raw_pred, offsets, labels,
  mask) -> scalar`` for the full-cleaning head (three offset channels and
  an outlierness channel).
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from .chamfer import (masked_adaptive_l1_chamfer_loss,
                      masked_chamfer_l1_loss, masked_chamfer_loss,
                      masked_l1_term)
from .masked import (masked_binary_cross_entropy, masked_l1_loss,
                     masked_offset_loss, masked_outlier_loss)

LossFn = Callable[..., torch.Tensor]


def get_offset_regression_loss(name: str, spatial: bool = False,
                               group=None) -> LossFn:
    """loss(pred, target, mask, points) -> scalar.  With ``spatial`` (the
    point-sharded model), ``pred`` is this rank's point rows (in
    ``group``, every rank for ``None``) of the clouds whose whole
    ``target``, ``mask`` and ``points`` the loss is given."""
    sharding = dict(spatial=spatial, group=group) if spatial else {}
    if name == "L1":
        return lambda pred, target, mask, points=None: \
            masked_l1_term(pred, target, mask, **sharding)
    if name == "chamfer_L1":
        return partial(masked_chamfer_l1_loss, **sharding)
    if name == "chamfer":
        return partial(masked_chamfer_loss, **sharding)
    if name == "chamfer_sparse":
        return partial(masked_chamfer_loss, norm_type="L1", **sharding)
    if name == "l1_chamfer_sparse":
        return partial(masked_chamfer_l1_loss, norm_type="L1", **sharding)
    if name == "l1_chamfer_adaptive_to_chamfer":
        return partial(masked_adaptive_l1_chamfer_loss,
                       converging_to="chamfer", **sharding)
    if name == "l1_chamfer_adaptive_to_l1":
        return partial(masked_adaptive_l1_chamfer_loss, converging_to="L1",
                       **sharding)
    raise ValueError(f"The loss {name} is not implemented")


def get_complete_denoising_loss(name: str, in_radius: float) -> LossFn:
    """The full-cleaning loss over a (B, N, 4) head output: tanh of the
    first three channels are the offsets, the sigmoid of the fourth
    (its logit clipped to +-30) the outlier probability.

    loss(raw_pred, offsets (B, N, 3), labels (B, N), mask (B, N)) =
    offset loss + outlier loss * in_radius, by ``name``:

    * ``L1_classification``: masked L1 of the offsets; the cross-entropy
      over every slot, padding included;
    * ``Weighted_L1_classification``: the same, with the L1 masked by
      ``max(mask, p >= 0.5)``, so a padding slot predicted as an outlier
      counts in the L1 mean; that mask carries no gradient;
    * ``double_weight``: the L1 weighted by 1/||offset|| and the
      cross-entropy by ||offset||, both masked.
    """
    if name not in ("L1_classification", "Weighted_L1_classification",
                    "double_weight"):
        raise ValueError(f"Loss {name} not implemented.")

    def loss(raw_pred, offsets, outlier_labels, mask):
        pred_offsets = torch.tanh(raw_pred[..., :3])
        logit = torch.clamp(raw_pred[..., 3], -30.0, 30.0)
        prob = 1.0 / (1.0 + torch.exp(-logit))
        if name == "double_weight":
            lo = masked_offset_loss(pred_offsets, offsets, mask)
            lc = masked_outlier_loss(prob, outlier_labels, offsets, mask)
        else:
            if name == "Weighted_L1_classification":
                mask = torch.maximum(
                    mask, (prob.detach() >= 0.5).to(mask.dtype))
            lo = masked_l1_loss(pred_offsets, offsets, mask)
            lc = masked_binary_cross_entropy(prob, outlier_labels,
                                             torch.ones_like(prob))
        return lo + lc * in_radius

    return loss

"""Masked pointwise losses and the shape classification losses.

Counterpart of ``deep3dpointclouddenoising_tpu/losses/masked.py``:
functions over (B, N, ...) tensors with float {0,1} masks, and the
label-smoothed cross-entropy of the shape classifier and the part
segmentation's cross-entropy per shape class (:66, :77).  The binary
losses take probabilities and clip them to ``[eps, 1 - eps]`` before the
log, as the JAX package does (``F.binary_cross_entropy`` clamps the log at
-100 instead); the segmentation loss takes logits.  Inside a process group
each loss is this rank's share of the global batch's loss
(``parallel/dist.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..parallel.dist import global_sum


def _masked_mean(per_point: torch.Tensor, mask: torch.Tensor
                 ) -> torch.Tensor:
    """sum(x * mask) / sum(mask) over all of (B, N); inside a process
    group, this rank's share: its own sum(x * mask) over the sum of every
    rank's masks, so the shares sum to the mean over the global batch."""
    mask = mask.to(per_point.dtype)
    return torch.sum(per_point * mask) / torch.clamp(
        global_sum(torch.sum(mask)), min=1.0)


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Per-point mean |pred - target| over coordinates, masked mean over
    points."""
    per_point = torch.mean(torch.abs(pred - target), dim=-1)
    return _masked_mean(per_point, mask)


def masked_offset_loss(pred: torch.Tensor, target: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """L1 weighted by 1/||target|| clipped to [1e-6, 2]: a zero target
    weighs 1/0 = inf, clipped to 2."""
    w = 1.0 / torch.linalg.vector_norm(target, dim=-1, keepdim=True)
    w = torch.clamp(w, 1e-6, 2.0)
    per_point = torch.mean(torch.abs(pred - target) * w, dim=-1)
    return _masked_mean(per_point, mask)


def _bce(prob: torch.Tensor, target: torch.Tensor, eps: float
         ) -> torch.Tensor:
    # jnp.clip's gradient: half at a probability exactly on a bound (as
    # torch.maximum and torch.minimum split it), where torch.clamp passes
    # all of it
    lo, hi = (torch.tensor(v, dtype=prob.dtype, device=prob.device)
              for v in (eps, 1.0 - eps))
    p = torch.minimum(torch.maximum(prob, lo), hi)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def masked_binary_cross_entropy(prob: torch.Tensor, target: torch.Tensor,
                                mask: torch.Tensor, eps: float = 1e-7
                                ) -> torch.Tensor:
    """Binary cross-entropy of probabilities, masked mean over points."""
    return _masked_mean(_bce(prob, target, eps), mask)


def masked_outlier_loss(prob: torch.Tensor, target: torch.Tensor,
                        true_offsets: torch.Tensor, mask: torch.Tensor,
                        eps: float = 1e-7) -> torch.Tensor:
    """Binary cross-entropy weighted by the true offset's length, masked
    mean over points."""
    per = _bce(prob, target, eps) * torch.linalg.vector_norm(
        true_offsets, dim=-1)
    return _masked_mean(per, mask)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Per-point softmax cross-entropy of (B, N, C) logits against (B, N)
    integer labels, masked mean over points."""
    logp = torch.log_softmax(logits, dim=-1)
    per = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _masked_mean(per, mask)


def _batch_share(total: torch.Tensor, batch: int) -> torch.Tensor:
    """``total`` over the batch size; inside a process group over every
    rank's batch, so the ranks' shares sum to the global batch's mean."""
    return total / global_sum(total.new_tensor(float(batch)))


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing_ratio: float = 0.2
                                  ) -> torch.Tensor:
    """Cross-entropy of (B, C) logits against (B,) integer labels smoothed
    to ``1 - ratio`` on the label and ``ratio / (C - 1)`` on every other
    class, the mean over the batch."""
    n_class = logits.shape[-1]
    one_hot = torch.nn.functional.one_hot(labels.long(), n_class).to(
        logits.dtype)
    soft = one_hot * (1.0 - smoothing_ratio) \
        + (1.0 - one_hot) * smoothing_ratio / (n_class - 1)
    logp = torch.log_softmax(logits, dim=-1)
    return _batch_share(torch.sum(-torch.sum(soft * logp, dim=-1)),
                        logits.shape[0])


def multi_shape_cross_entropy(logits_all_shapes: Sequence[torch.Tensor],
                              point_labels: torch.Tensor,
                              shape_labels: torch.Tensor) -> torch.Tensor:
    """The part segmentation's loss: for each cloud, the mean over its
    points of the softmax cross-entropy of the logits of its own shape
    class (``logits_all_shapes[shape_labels[b]]``, each (B, N, P_i))
    against (B, N) integer part labels; the mean over the batch.  A
    cloud's labels may pass another class's part count: they are clamped
    into it there, and that class's term of the cloud is dropped."""
    total = logits_all_shapes[0].new_zeros(())
    labels = point_labels.long()[..., None]
    for sl, logits in enumerate(logits_all_shapes):
        logp = torch.log_softmax(logits, dim=-1)
        idx = labels.clamp(max=logits.shape[-1] - 1)
        per_item = torch.mean(-torch.gather(logp, -1, idx)[..., 0], dim=-1)
        total = total + torch.sum(torch.where(shape_labels == sl, per_item,
                                              torch.zeros_like(per_item)))
    return _batch_share(total, shape_labels.shape[0])

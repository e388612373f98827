"""Masked pointwise losses.

Counterpart of ``deep3dpointclouddenoising_tpu/losses/masked.py:12-63``:
functions over (B, N, ...) tensors with float {0,1} masks.  The binary
losses take probabilities and clip them to ``[eps, 1 - eps]`` before the
log, as the JAX package does (``F.binary_cross_entropy`` clamps the log at
-100 instead); the segmentation loss takes logits.  Inside a process group
each loss is this rank's share of the global batch's loss
(``parallel/dist.py``).  The shape classification losses of that module
come with their task (ROADMAP.md).
"""
from __future__ import annotations

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

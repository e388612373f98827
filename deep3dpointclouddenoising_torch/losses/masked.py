"""Masked pointwise losses.

Counterpart of ``deep3dpointclouddenoising_tpu/losses/masked.py:12-23``:
functions over (B, N, ...) tensors with float {0,1} masks.  The other
losses of that module come with the tasks that use them (ROADMAP.md).
"""
from __future__ import annotations

import torch


def _masked_mean(per_point: torch.Tensor, mask: torch.Tensor
                 ) -> torch.Tensor:
    """sum(x * mask) / sum(mask) over all of (B, N)."""
    mask = mask.to(per_point.dtype)
    return torch.sum(per_point * mask) / torch.clamp(torch.sum(mask),
                                                     min=1.0)


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Per-point mean |pred - target| over coordinates, masked mean over
    points."""
    per_point = torch.mean(torch.abs(pred - target), dim=-1)
    return _masked_mean(per_point, mask)

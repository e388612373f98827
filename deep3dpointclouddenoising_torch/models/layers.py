"""Basic building blocks in channels-last (B, N, C) layout.

Counterpart of ``deep3dpointclouddenoising_tpu/models/layers.py``.  A 1x1
convolution is a ``Linear`` over the trailing channel axis; BatchNorm takes
its statistics over (batch, points) per channel.  Submodule names follow the
Flax parameter tree (``Dense_0``, ``BatchNorm_0``) so that ``convert.py``
maps names one to one.
"""
from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

# jax.nn.initializers.he_normal is variance scaling over a normal truncated
# at two standard deviations; this constant restores the variance lost to
# the truncation
_TRUNC_STD = 0.87962566103423978


def he_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class ChannelsLastBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of a (..., C) tensor, eps 1e-5.

    ``momentum`` is torch's (the weight of the new batch statistic), which
    is one minus Flax's."""

    def __init__(self, channels: int, momentum: float = 0.1):
        super().__init__(channels, eps=1e-5, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        return super().forward(x.reshape(-1, shape[-1])).reshape(shape)


class ConvBN(nn.Module):
    """1x1 conv (Linear, no bias) + BatchNorm, optional ReLU."""

    def __init__(self, in_features: int, features: int,
                 bn_momentum: float = 0.1, relu: bool = True):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features, bias=False)
        he_normal_(self.Dense_0.weight, in_features)
        self.BatchNorm_0 = ChannelsLastBatchNorm(features, bn_momentum)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Dense_0(x))
        return F.relu(x) if self.relu else x


class BNReLU(nn.Module):
    def __init__(self, features: int, bn_momentum: float = 0.1):
        super().__init__()
        self.BatchNorm_0 = ChannelsLastBatchNorm(features, bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(x))

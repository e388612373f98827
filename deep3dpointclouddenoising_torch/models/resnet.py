"""KPConv-style ResNet encoder over a precomputed geometry pyramid.

Counterpart of ``deep3dpointclouddenoising_tpu/models/resnet.py``: a stem
at width/2, then strided stages that double width, radius and voxel size.
Blocks are named ``Bottleneck_N`` in creation order, as in the Flax tree.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn
import torch.nn.functional as F

from ..config import Config
from ..ops import group_features
from .layers import ConvBN
from .local_aggregation import LocalAggregation
from .pyramid import Neighborhood, Pyramid


def masked_max_pool(features: torch.Tensor, nbr: Neighborhood
                    ) -> torch.Tensor:
    """Strided max-pool: fine features gathered at the coarse queries'
    neighbours, max over the neighbourhood (padding slots cycle real
    neighbours, so no mask is needed)."""
    return group_features(features, nbr.idx).amax(dim=2)


class Bottleneck(nn.Module):
    """Residual bottleneck: conv1 (1x1, C_out/ratio) -> local aggregation ->
    conv2 (1x1, C_out) + shortcut.  The strided variant max-pools the
    identity path to the coarse level."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 cfg: Config, strided: bool = False):
        super().__init__()
        mid = out_channels // int(cfg.bottleneck_ratio)
        self.strided = strided
        self.ConvBN_0 = ConvBN(in_channels, mid, cfg.bn_momentum)
        self.LocalAggregation_0 = LocalAggregation(mid, mid, radius, cfg)
        self.ConvBN_1 = ConvBN(mid, out_channels, cfg.bn_momentum,
                               relu=False)
        if in_channels != out_channels:
            self.ConvBN_2 = ConvBN(in_channels, out_channels,
                                   cfg.bn_momentum, relu=False)

    def forward(self, features: torch.Tensor, nbr: Neighborhood,
                query_mask: torch.Tensor) -> torch.Tensor:
        identity = masked_max_pool(features, nbr) if self.strided \
            else features
        x = self.ConvBN_0(features)
        x = self.LocalAggregation_0(x, nbr, query_mask)
        x = self.ConvBN_1(x)
        if hasattr(self, "ConvBN_2"):
            identity = self.ConvBN_2(identity)
        return F.relu(x + identity)


class ResNetEncoder(nn.Module):
    """Five-resolution encoder emitting the res1..res5 feature pyramid."""

    def __init__(self, cfg: Config):
        super().__init__()
        width, depth = int(cfg.width), int(cfg.depth)
        r0 = float(cfg.radius)
        in_dim = int(cfg.input_features_dim)
        self.depth = depth
        self.ConvBN_0 = ConvBN(in_dim, width // 2, cfg.bn_momentum)
        self.LocalAggregation_0 = LocalAggregation(width // 2, width // 2,
                                                   r0, cfg)
        blocks = [Bottleneck(width // 2, width, r0, cfg)]
        ch = width
        for i in range(1, len(cfg.npoints) + 1):
            blocks.append(Bottleneck(ch, ch * 2, r0 * (2.0 ** (i - 1)), cfg,
                                     strided=True))
            ch *= 2
            for _ in range(depth - 1):
                blocks.append(Bottleneck(ch, ch, r0 * (2.0 ** i), cfg))
        self.num_blocks = len(blocks)
        for n, block in enumerate(blocks):
            self.add_module(f"Bottleneck_{n}", block)

    def forward(self, pyramid: Pyramid, features: torch.Tensor
                ) -> List[torch.Tensor]:
        L0 = pyramid.levels[0]
        x = self.ConvBN_0(features)
        x = self.LocalAggregation_0(x, L0.self_nbr, L0.mask)
        blocks = iter(getattr(self, f"Bottleneck_{n}")
                      for n in range(self.num_blocks))
        x = next(blocks)(x, L0.self_nbr, L0.mask)
        outs = [x]
        for i, tr in enumerate(pyramid.transitions, start=1):
            lvl = pyramid.levels[i]
            x = next(blocks)(x, tr.pool_nbr, lvl.mask)
            for _ in range(self.depth - 1):
                x = next(blocks)(x, lvl.self_nbr, lvl.mask)
            outs.append(x)
        return outs

"""Local aggregation over precomputed neighbourhoods.

Counterpart of ``deep3dpointclouddenoising_tpu/models/local_aggregation.py``.
This slice ports PseudoGrid (KPConv); the other operators raise.  Every
PseudoGrid call goes through :func:`..ops.kpconv.kpconv_aggregate`, which on
the card is the CUDA kernel at every level, with no size threshold.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..config import Config
from ..ops.kpconv import kpconv_aggregate
from .kernel_points import create_kernel_points
from .layers import BNReLU, ConvBN
from .pyramid import Neighborhood


def _feature_mask(nbr: Neighborhood, query_mask: torch.Tensor
                  ) -> torch.Tensor:
    """(B, M, K) neighbourhood mask, all ones for padding queries."""
    return nbr.mask + (1.0 - query_mask[:, :, None])


class PseudoGrid(nn.Module):
    """KPConv-style pseudo-grid aggregation: each neighbour's feature is
    weighted by every kernel point's influence (linear, gaussian or
    constant in the distance between the neighbour's relative position and
    the kernel point) and by that kernel point's channel weights, then
    summed over neighbours and kernel points."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 cfg: Config):
        super().__init__()
        pg = cfg.pseudo_grid
        if pg.KP_influence not in ("constant", "linear", "gaussian"):
            raise ValueError(f"Unknown KP_influence {pg.KP_influence}")
        if pg.convolution_mode != "sum":
            raise NotImplementedError(
                f"convolution_mode {pg.convolution_mode} not supported")
        self.influence = pg.KP_influence
        self.extent = float(2.0 * pg.KP_extent * radius
                            / cfg.density_parameter)
        kpoints = create_kernel_points(
            1.5 * self.extent, int(pg.num_kernel_points),
            fixed=pg.fixed_kernel_points, seed=int(cfg.rng_seed))
        self.register_buffer("kpoints", torch.from_numpy(kpoints),
                             persistent=False)
        std = math.sqrt(2.0 / in_channels)
        self.kernel_weights = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(int(pg.num_kernel_points), in_channels), std=std,
            a=-2 * std, b=2 * std))
        if pg.output_conv or in_channels != out_channels:
            self.post = "ConvBN_0"
            self.ConvBN_0 = ConvBN(in_channels, out_channels,
                                   cfg.bn_momentum)
        else:
            self.post = "BNReLU_0"
            self.BNReLU_0 = BNReLU(out_channels, cfg.bn_momentum)

    def forward(self, support_features: torch.Tensor, nbr: Neighborhood,
                query_mask: torch.Tensor) -> torch.Tensor:
        out = kpconv_aggregate(
            support_features.contiguous(), nbr.idx, nbr.rel_xyz,
            _feature_mask(nbr, query_mask).contiguous(), self.kpoints,
            self.kernel_weights, self.extent, self.influence)
        return getattr(self, self.post)(out)


class LocalAggregation(nn.Module):
    """Dispatch over aggregation operators."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 cfg: Config):
        super().__init__()
        kind = cfg.local_aggregation_type
        if kind != "pseudo_grid":
            raise NotImplementedError(
                f"LocalAggregation {kind} is not ported yet; the port's "
                "queue is in ROADMAP.md")
        self.PseudoGrid_0 = PseudoGrid(in_channels, out_channels, radius,
                                       cfg)

    def forward(self, support_features: torch.Tensor, nbr: Neighborhood,
                query_mask: torch.Tensor) -> torch.Tensor:
        return self.PseudoGrid_0(support_features, nbr, query_mask)

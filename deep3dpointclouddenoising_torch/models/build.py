"""The offset-regression model.

Counterpart of ``OffsetRegressionModel`` and ``build_offset_regression``
in ``deep3dpointclouddenoising_tpu/models/build.py``: pyramid -> ResNet
encoder -> U-Net offset head, on padded ``(xyz, mask, features)`` batches.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from .heads import MultiDimHead
from .pyramid import Pyramid, build_pyramid
from .resnet import ResNetEncoder

OFFSET_REG_DIM = 3


class OffsetRegressionModel(nn.Module):
    """U-Net offset regressor: per-point (B, N, 3) displacement."""

    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.backbone != "resnet":
            raise NotImplementedError(
                f"Backbone {cfg.backbone} not implemented")
        if cfg.head != "offset_reg_head":
            raise NotImplementedError(
                f"Head {cfg.head} not implemented in OffsetRegression")
        if str(cfg.compute_dtype) != "float32":
            raise NotImplementedError(
                f"compute_dtype {cfg.compute_dtype} is not ported yet "
                "(ROADMAP.md)")
        self.cfg = cfg
        self.ResNetEncoder_0 = ResNetEncoder(cfg)
        self.MultiDimHead_0 = MultiDimHead(OFFSET_REG_DIM, cfg)

    def make_pyramid(self, xyz: torch.Tensor, mask: torch.Tensor
                     ) -> Pyramid:
        cfg = self.cfg
        return build_pyramid(
            xyz, mask, radius=float(cfg.radius),
            sample_dl=float(cfg.sampleDl), nsamples=list(cfg.nsamples),
            npoints=list(cfg.npoints), build_self=int(cfg.depth) > 1,
            build_up=True)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor,
                features: torch.Tensor) -> torch.Tensor:
        pyramid = self.make_pyramid(xyz, mask)
        feats = self.ResNetEncoder_0(pyramid, features)
        return self.MultiDimHead_0(pyramid, feats)


def build_offset_regression(cfg: Config) -> OffsetRegressionModel:
    """The offset-regression model (the loss comes with the training
    slice)."""
    return OffsetRegressionModel(cfg)

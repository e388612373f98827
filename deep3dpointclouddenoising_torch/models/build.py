"""The offset-regression, full-cleaning and scene-segmentation models and
the GAN discriminator.

Counterpart of ``OffsetRegressionModel``, ``CompleteDenoisingModel``,
``SceneSegmentationModel``, ``DiscriminatorModel`` and their builders in
``deep3dpointclouddenoising_tpu/models/build.py``: pyramid -> ResNet
encoder -> U-Net head, on padded ``(xyz, mask, features)`` batches.  The
module names follow the Flax tree, so a Flax tree of any of them converts
by ``convert.params_from_flax``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..config import Config
from .heads import DiscriminatorHead, MultiDimHead, SceneSegHead
from .pyramid import Pyramid, build_pyramid
from .resnet import ResNetEncoder

OFFSET_REG_DIM = 3
OUTLIER_DETECT_DIM = 1


class PyramidModel(nn.Module):
    """The encoder over the geometry pyramid; a subclass adds its head
    (created after the encoder, so the initialisers draw in the Flax
    tree's order) and :meth:`head`.  The initialisers draw from
    ``generator`` (the global generator when it is ``None``).
    ``build_up`` is whether the pyramid carries the decoder's 1-NN
    upsampling indices (not for a head without a decoder)."""

    build_up = True

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.backbone != "resnet":
            raise NotImplementedError(
                f"Backbone {cfg.backbone} not implemented")
        self._check_head(cfg)
        self.cfg = cfg
        self.ResNetEncoder_0 = ResNetEncoder(cfg, generator)

    def _check_head(self, cfg: Config) -> None:
        pass

    def make_pyramid(self, xyz: torch.Tensor, mask: torch.Tensor
                     ) -> Pyramid:
        cfg = self.cfg
        return build_pyramid(
            xyz, mask, radius=float(cfg.radius),
            sample_dl=float(cfg.sampleDl), nsamples=list(cfg.nsamples),
            npoints=list(cfg.npoints), build_self=int(cfg.depth) > 1,
            build_up=self.build_up)

    def head(self, pyramid: Pyramid, feats: Sequence[torch.Tensor]
             ) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor,
                features: torch.Tensor) -> torch.Tensor:
        pyramid = self.make_pyramid(xyz, mask)
        return self.head(pyramid, self.ResNetEncoder_0(pyramid, features))


class OffsetRegressionModel(PyramidModel):
    """U-Net offset regressor: per-point (B, N, 3) displacement."""

    num_out = OFFSET_REG_DIM

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator)
        self.MultiDimHead_0 = MultiDimHead(self.num_out, cfg, generator)

    def _check_head(self, cfg: Config) -> None:
        if cfg.head != "offset_reg_head":
            raise NotImplementedError(
                f"Head {cfg.head} not implemented in OffsetRegression")

    def head(self, pyramid: Pyramid, feats: Sequence[torch.Tensor]
             ) -> torch.Tensor:
        return self.MultiDimHead_0(pyramid, feats)


class CompleteDenoisingModel(OffsetRegressionModel):
    """Full cleaning: per-point (B, N, 4), three offset logits (tanh gives
    the offset) and an outlierness logit (sigmoid gives the probability).
    Like the JAX model, it reads no ``cfg.head``."""

    num_out = OFFSET_REG_DIM + OUTLIER_DETECT_DIM

    def _check_head(self, cfg: Config) -> None:
        pass


class SceneSegmentationModel(PyramidModel):
    """Per-point class logits (B, N, ``cfg.num_classes``).  Like the JAX
    model, it reads no ``cfg.head``."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator)
        self.SceneSegHead_0 = SceneSegHead(int(cfg.num_classes), cfg,
                                           generator)

    def head(self, pyramid: Pyramid, feats: Sequence[torch.Tensor]
             ) -> torch.Tensor:
        return self.SceneSegHead_0(pyramid, feats)


class DiscriminatorModel(PyramidModel):
    """The GAN discriminator: (B, 1) probabilities that each cloud is clean,
    from the encoder's deepest features (:class:`heads.DiscriminatorHead`).
    Like the JAX model, it reads no ``cfg.head`` and builds no upsampling
    indices.  In train mode its Dropouts draw from ``generator``, or take
    ``keep_masks`` (:class:`heads.PooledMLPHead`)."""

    build_up = False

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator)
        self.DiscriminatorHead_0 = DiscriminatorHead(cfg, generator)

    def head(self, pyramid: Pyramid, feats: Sequence[torch.Tensor],
             generator: Optional[torch.Generator] = None,
             keep_masks: Optional[List[torch.Tensor]] = None
             ) -> torch.Tensor:
        return self.DiscriminatorHead_0(pyramid, feats, generator,
                                        keep_masks)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor,
                features: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                keep_masks: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
        pyramid = self.make_pyramid(xyz, mask)
        return self.head(pyramid, self.ResNetEncoder_0(pyramid, features),
                         generator, keep_masks)


def build_offset_regression(cfg: Config,
                            generator: Optional[torch.Generator] = None
                            ) -> OffsetRegressionModel:
    """The offset-regression model; its loss is
    ``losses.build.get_offset_regression_loss(cfg.loss)``."""
    return OffsetRegressionModel(cfg, generator)


def build_complete_denoising(cfg: Config,
                             generator: Optional[torch.Generator] = None
                             ) -> CompleteDenoisingModel:
    """The full-cleaning model; its loss is
    ``losses.build.get_complete_denoising_loss(cfg.loss, cfg.in_radius)``."""
    return CompleteDenoisingModel(cfg, generator)


def build_scene_segmentation(cfg: Config,
                             generator: Optional[torch.Generator] = None
                             ) -> SceneSegmentationModel:
    """The scene-segmentation model; its loss is
    ``losses.masked.masked_cross_entropy``."""
    return SceneSegmentationModel(cfg, generator)


def build_discriminator(cfg: Config,
                        generator: Optional[torch.Generator] = None
                        ) -> DiscriminatorModel:
    """The GAN discriminator; its loss is
    ``losses.masked.masked_binary_cross_entropy`` with an all-ones mask."""
    return DiscriminatorModel(cfg, generator)

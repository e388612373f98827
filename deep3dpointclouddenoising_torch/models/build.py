"""The offset-regression, full-cleaning, scene-segmentation, shape
classification and part-segmentation models and the GAN discriminator.

Counterpart of ``OffsetRegressionModel``, ``CompleteDenoisingModel``,
``SceneSegmentationModel``, ``ClassificationModel``,
``MultiPartSegmentationModel``, ``DiscriminatorModel`` and their builders
in ``deep3dpointclouddenoising_tpu/models/build.py``: pyramid -> ResNet
encoder -> U-Net head, on padded ``(xyz, mask, features)`` batches.  The
module names follow the Flax tree, so a Flax tree of any of them converts
by ``convert.params_from_flax``.

A model whose ``spatial`` is set (``parallel.spatial.build_spatial_model``)
builds the point-sharded pyramid (each rank's query rows of every level,
``parallel.dist.point_rows``), takes this rank's rows of the input
features and returns this rank's rows of its output; its parameters and
buffers are those of the plain model.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..config import Config
from ..parallel.dist import point_rows
from ..parallel.spatial import point_sharded_pyramid
from .heads import (ClassifierHead, DiscriminatorHead, MultiDimHead,
                    MultiPartSegHead, SceneSegHead)
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
    spatial = False
    # the spatial model's points group (None: every rank)
    points_group = None

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
        build = functools.partial(point_sharded_pyramid,
                                  group=self.points_group) \
            if self.spatial else build_pyramid
        return build(
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
        if self.spatial:
            features = features[:, point_rows(features.shape[1],
                                              group=self.points_group)]
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


class PooledHeadModel(PyramidModel):
    """A model whose head pools the encoder's deepest features over each
    cloud (the classifier and the discriminator): it builds no upsampling
    indices, and in train mode its head's Dropouts draw from
    ``generator``, or take ``keep_masks`` (:class:`heads.PooledMLPHead`)."""

    build_up = False

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor,
                features: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                keep_masks: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
        pyramid = self.make_pyramid(xyz, mask)
        return self.head(pyramid, self.ResNetEncoder_0(pyramid, features),
                         generator, keep_masks)


class ClassificationModel(PooledHeadModel):
    """Shape classification: (B, ``cfg.num_classes``) logits
    (:class:`heads.ClassifierHead`).  Like the JAX model, it reads no
    ``cfg.head``."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator)
        self.ClassifierHead_0 = ClassifierHead(int(cfg.num_classes), cfg,
                                               generator)

    def head(self, pyramid: Pyramid, feats: Sequence[torch.Tensor],
             generator: Optional[torch.Generator] = None,
             keep_masks: Optional[List[torch.Tensor]] = None
             ) -> torch.Tensor:
        return self.ClassifierHead_0(pyramid, feats, generator, keep_masks)


class MultiPartSegmentationModel(PyramidModel):
    """Part segmentation: for each of the ``cfg.num_classes`` shape
    classes, per-point logits over its ``cfg.num_parts[i]`` parts, a list
    of (B, N, num_parts[i]) (:class:`heads.MultiPartSegHead`).  Like the
    JAX model, it reads no ``cfg.head``."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator)
        self.MultiPartSegHead_0 = MultiPartSegHead(
            int(cfg.num_classes), list(cfg.num_parts), cfg, generator)

    def head(self, pyramid: Pyramid, feats: Sequence[torch.Tensor]
             ) -> List[torch.Tensor]:
        return self.MultiPartSegHead_0(pyramid, feats)


class DiscriminatorModel(PooledHeadModel):
    """The GAN discriminator: (B, 1) probabilities that each cloud is clean,
    from the encoder's deepest features (:class:`heads.DiscriminatorHead`).
    Like the JAX model, it reads no ``cfg.head``."""

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


def build_classification(cfg: Config,
                         generator: Optional[torch.Generator] = None
                         ) -> ClassificationModel:
    """The shape classifier; its loss is
    ``losses.masked.label_smoothing_cross_entropy``."""
    return ClassificationModel(cfg, generator)


def build_multi_part_segmentation(cfg: Config,
                                  generator: Optional[torch.Generator] = None
                                  ) -> MultiPartSegmentationModel:
    """The part-segmentation model; its loss is
    ``losses.masked.multi_shape_cross_entropy``."""
    return MultiPartSegmentationModel(cfg, generator)


def build_discriminator(cfg: Config,
                        generator: Optional[torch.Generator] = None
                        ) -> DiscriminatorModel:
    """The GAN discriminator; its loss is
    ``losses.masked.masked_binary_cross_entropy`` with an all-ones mask."""
    return DiscriminatorModel(cfg, generator)


def build_offset_regression_PCN(cfg: Config,
                                generator: Optional[torch.Generator] = None
                                ):
    """The PointCleanNet baseline: a ``ResPCPNet`` regressing one offset
    per patch (its loss and the rotation back through the point STN are
    ``train.pcn.PCNTrainer``'s)."""
    from .pcpnet import ResPCPNet
    return ResPCPNet(output_dim=OFFSET_REG_DIM, use_feat_stn=True,
                     sym_op="max", generator=generator)

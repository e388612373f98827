"""Model library: KPConv-style U-Net backbone, the offset head, the
full-cleaning head, the scene-segmentation head and the GAN
discriminator."""
from .build import (CompleteDenoisingModel, DiscriminatorModel,
                    OffsetRegressionModel, SceneSegmentationModel,
                    build_complete_denoising, build_discriminator,
                    build_offset_regression, build_scene_segmentation)

__all__ = ["CompleteDenoisingModel", "DiscriminatorModel",
           "OffsetRegressionModel", "SceneSegmentationModel",
           "build_complete_denoising", "build_discriminator",
           "build_offset_regression", "build_scene_segmentation"]

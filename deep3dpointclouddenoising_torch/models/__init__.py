"""Model library: KPConv-style U-Net backbone, the offset head, the
full-cleaning head, the scene-segmentation head, the shape classifier, the
part-segmentation head, the GAN discriminator and the PointCleanNet
baseline (``pcpnet``)."""
from .build import (ClassificationModel, CompleteDenoisingModel,
                    DiscriminatorModel, MultiPartSegmentationModel,
                    OffsetRegressionModel, SceneSegmentationModel,
                    build_classification, build_complete_denoising,
                    build_discriminator, build_multi_part_segmentation,
                    build_offset_regression, build_offset_regression_PCN,
                    build_scene_segmentation)

__all__ = ["ClassificationModel", "CompleteDenoisingModel",
           "DiscriminatorModel", "MultiPartSegmentationModel",
           "OffsetRegressionModel", "SceneSegmentationModel",
           "build_classification", "build_complete_denoising",
           "build_discriminator", "build_multi_part_segmentation",
           "build_offset_regression", "build_offset_regression_PCN",
           "build_scene_segmentation"]

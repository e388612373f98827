"""Model library: KPConv-style U-Net backbone, the offset head, the
full-cleaning head and the scene-segmentation head."""
from .build import (CompleteDenoisingModel, OffsetRegressionModel,
                    SceneSegmentationModel, build_complete_denoising,
                    build_offset_regression, build_scene_segmentation)

__all__ = ["CompleteDenoisingModel", "OffsetRegressionModel",
           "SceneSegmentationModel", "build_complete_denoising",
           "build_offset_regression", "build_scene_segmentation"]

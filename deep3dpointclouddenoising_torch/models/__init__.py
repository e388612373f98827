"""Model library: KPConv-style U-Net backbone, the offset head and the
full-cleaning head."""
from .build import (CompleteDenoisingModel, OffsetRegressionModel,
                    build_complete_denoising, build_offset_regression)

__all__ = ["CompleteDenoisingModel", "OffsetRegressionModel",
           "build_complete_denoising", "build_offset_regression"]

"""Model library: KPConv-style U-Net backbone and the offset head."""
from .build import OffsetRegressionModel, build_offset_regression

__all__ = ["OffsetRegressionModel", "build_offset_regression"]

"""Fixed-capacity, mask-aware point ops and the KPConv aggregation."""
from .neighbors import (
    gather_rows,
    group_features,
    group_xyz,
    masked_nearest_query,
    masked_ordered_ball_query,
)
from .subsample import grid_subsample_numpy, masked_grid_subsampling

__all__ = [
    "gather_rows",
    "group_features",
    "group_xyz",
    "masked_nearest_query",
    "masked_ordered_ball_query",
    "grid_subsample_numpy",
    "masked_grid_subsampling",
]

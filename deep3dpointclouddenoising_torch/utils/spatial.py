"""Spatial helpers of the data pipeline (numpy and scipy).

Counterpart of the numpy/scipy halves of
``deep3dpointclouddenoising_tpu/utils/native.py``: :func:`grid_subsample`
and :class:`GridIndex` on a ``cKDTree``.  The port uses no native host
library.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from ..ops.subsample import grid_subsample_numpy

grid_subsample = grid_subsample_numpy


class GridIndex:
    """Distance-sorted radius queries and 1-NN over one cloud."""

    def __init__(self, points: np.ndarray):
        self._pts = np.ascontiguousarray(points, dtype=np.float32)
        self._tree = cKDTree(self._pts)

    def query_radius_sorted(self, center: np.ndarray, radius: float
                            ) -> np.ndarray:
        """Indices of points within ``radius`` of ``center``, by ascending
        distance (ties by index)."""
        center = np.ascontiguousarray(center, dtype=np.float32).ravel()
        inds = np.asarray(self._tree.query_ball_point(center, r=radius),
                          dtype=np.int64)
        d = np.linalg.norm(self._pts[inds] - center, axis=1)
        return inds[np.lexsort((inds, d))]

    def nearest(self, center: np.ndarray) -> int:
        center = np.ascontiguousarray(center, dtype=np.float32).ravel()
        _, idx = self._tree.query(center, k=1)
        return int(idx)

    def nearest_many(self, centers: np.ndarray) -> np.ndarray:
        """(Q,) int64: :meth:`nearest` of each of the (Q, 3) ``centers``,
        in one tree query."""
        centers = np.ascontiguousarray(centers, dtype=np.float32)
        _, idx = self._tree.query(centers.reshape(-1, 3), k=1)
        return np.asarray(idx, np.int64)

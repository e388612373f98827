"""Stand-in scans in the EDF PLY schema.

The repository holds no EDF or PointCleanNet scans.  :func:`make_scans`
copies ``make_scans`` of ``scripts/run_custom_sweep.py`` (same generator,
seed and draws, same fields): ellipsoid shells with uniform-box outliers
(``GT == 2`` marks an outlier), normals pointing away from the origin,
and intensities drawn bright for the shell and dim for the outliers.  At
``diameter=10`` the scans are that script's bit for bit; another diameter
scales the shells and the box, so a configuration whose ``derive_geometry``
assumes a shape diameter of 1 (``dataset: PCN``, in_radius 0.05) reads
scans at its own scale.  ``corner`` cuts a scan to the points whose
coordinates are all at least ``corner * diameter``: a section of the shell
and of the box at the full scan's point density.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .meshio import write_ply


def make_scans(scan_dir: str, n_scans: int = 14, n: int = 24000,
               outlier_frac: float = 0.1, seed: int = 0,
               diameter: float = 10.0,
               write: Optional[Sequence[int]] = None,
               cut: Sequence[int] = (),
               corner: Sequence[float] = (0.0, 0.0, 0.0)) -> None:
    """Draw ``n_scans`` scans of ``n`` points in turn from one generator
    and write ``pointcloud_NN.ply`` for those in ``write`` (default all),
    the scans in ``cut`` cut at ``corner``."""
    rng = np.random.default_rng(seed)
    s = diameter / 10.0
    os.makedirs(scan_dir, exist_ok=True)
    for i in range(n_scans):
        n_out = int(n * outlier_frac)
        axes = rng.uniform(3.5, 5.0, 3)
        u = rng.normal(size=(n - n_out, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        surface = u * (axes * s if s != 1.0 else axes)
        outliers = rng.uniform(-6.0 * s, 6.0 * s, size=(n_out, 3))
        pts = np.concatenate([surface, outliers]).astype(np.float32)
        gt = np.concatenate([np.zeros(n - n_out), np.full(n_out, 2.0)])
        normals = pts / np.maximum(
            np.linalg.norm(pts, axis=1, keepdims=True), 1e-9)
        inten = np.concatenate([
            rng.normal(180.0, 30.0, n - n_out),
            rng.normal(80.0, 40.0, n_out)]).clip(0, 255).astype(np.float32)
        order = rng.permutation(n)
        if write is not None and i not in write:
            continue
        arrays = [pts[order], gt[order].astype(np.float32),
                  normals[order].astype(np.float32), inten[order]]
        if i in cut:
            keep = (arrays[0] >= np.asarray(corner, np.float32)
                    * diameter).all(axis=1)
            arrays = [a[keep] for a in arrays]
        write_ply(os.path.join(scan_dir, f"pointcloud_{i:02d}.ply"),
                  arrays, ["vertex", "GT", "normal", "intensity"])

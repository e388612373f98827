"""Device-resident clouds for voting inference.

Counterpart of the part of
``deep3dpointclouddenoising_tpu/data/device_sampler.py`` that voting needs
(``DeviceSampler.cloud_data``): every cloud of a dataset padded to the
largest one, ``(n_clouds, max_points, 3)`` points at ``PAD_COORD`` past a
cloud's end, and the Fourier projection when the dataset makes Fourier
features, uploaded to the card once.  Patches are then gathered there by
index.  Sampling and augmenting training patches on the card is not ported yet.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

PAD_COORD = 1.0e9  # padded cloud rows lie "at infinity"


def cloud_data(dataset, device) -> Dict[str, torch.Tensor]:
    """The padded cloud tensors of ``dataset``, uploaded to ``device``."""
    shapes = dataset.shapes
    if not shapes:
        raise ValueError("dataset has no shapes")
    max_n = max(len(s.points) for s in shapes)
    n = len(shapes)
    pts = np.full((n, max_n, 3), PAD_COORD, np.float32)
    for i, s in enumerate(shapes):
        pts[i, :len(s.points)] = s.points
    data = {"points": pts}
    if getattr(dataset, "fourier_features", False):
        data["fourier_B"] = np.asarray(dataset.fourier_B, np.float64)
    return {k: torch.from_numpy(v).to(device) for k, v in data.items()}

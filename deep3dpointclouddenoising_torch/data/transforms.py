"""Point-cloud augmentations of the training split and of voting rounds
(numpy, host side).

A copy of the training transforms of
``deep3dpointclouddenoising_tpu/data/transforms.py:21-130`` and of its batch
transforms (:132-177): each takes a (N, 3) float32 array, or a (B, N, 3)
batch, and a ``numpy.random.Generator`` and draws from it in the same
order, so the same generator gives the same augmented patch.  The offset
dataset stacks [points; offsets] before augmenting, so rotations turn both
and the jitter perturbs both.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def angle_axis(angle: float, axis: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix around ``axis`` by ``angle``."""
    u = np.asarray(axis, dtype=np.float64)
    u = u / np.linalg.norm(u)
    c, s = np.cos(angle), np.sin(angle)
    cross = np.array([[0.0, -u[2], u[1]],
                      [u[2], 0.0, -u[0]],
                      [-u[1], u[0], 0.0]])
    return (c * np.eye(3) + s * cross
            + (1.0 - c) * np.outer(u, u)).astype(np.float32)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, points: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            points = t(points, rng)
        return points


class PointcloudRandomRotate:
    """Random Euler rotation Rz @ Ry @ Rx with per-axis angle ranges."""

    def __init__(self, x_range=np.pi, y_range=np.pi, z_range=np.pi):
        self.x_range, self.y_range, self.z_range = x_range, y_range, z_range

    def __call__(self, points: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        ax = rng.uniform(-self.x_range, self.x_range)
        ay = rng.uniform(-self.y_range, self.y_range)
        az = rng.uniform(-self.z_range, self.z_range)
        rot = angle_axis(az, np.array([0.0, 0.0, 1.0])) \
            @ angle_axis(ay, np.array([0.0, 1.0, 0.0])) \
            @ angle_axis(ax, np.array([1.0, 0.0, 0.0]))
        return points @ rot.T


class PointcloudScaleAndJitter:
    """Anisotropic scale (optionally with random axis symmetries) and
    clipped gaussian jitter."""

    def __init__(self, scale_low=2. / 3., scale_high=3. / 2., std=0.01,
                 clip=0.05, augment_symmetries=(0, 0, 0)):
        self.scale_low, self.scale_high = scale_low, scale_high
        self.std, self.clip = std, clip
        self.augment_symmetries = np.asarray(augment_symmetries,
                                             dtype=np.float64)

    def __call__(self, points: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        scale = rng.uniform(self.scale_low, self.scale_high, size=3)
        sym = np.round(rng.uniform(0, 1, size=3)) * 2 - 1
        sym = sym * self.augment_symmetries + (1 - self.augment_symmetries)
        scale = scale * sym
        jitter = np.clip(rng.normal(scale=self.std, size=points.shape),
                         -self.clip, self.clip)
        return (points * scale + jitter).astype(np.float32)


def build_train_transforms(cfg) -> Compose:
    """Training augmentation stack: random rotation always, scale and
    jitter when ``cfg.jitter``."""
    ts: List = [PointcloudRandomRotate(cfg.x_angle_range, cfg.y_angle_range,
                                       cfg.z_angle_range)]
    if cfg.jitter:
        ts.append(PointcloudScaleAndJitter(
            scale_low=cfg.scale_low, scale_high=cfg.scale_high,
            std=cfg.noise_std, clip=cfg.noise_clip,
            augment_symmetries=cfg.augment_symmetries))
    return Compose(ts)


class BatchPointcloudRandomRotate:
    """A random Euler rotation per item of a (B, N, 3+) batch, x then y
    then z; channels 3:6, when present, turn too (normals)."""

    def __init__(self, x_range=np.pi, y_range=np.pi, z_range=np.pi):
        self.ranges = (x_range, y_range, z_range)

    def __call__(self, pc: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        out = np.array(pc, copy=True)
        axes = np.eye(3)
        for i in range(len(out)):
            rot = np.eye(3)
            for ax in range(3):
                a = rng.uniform(-self.ranges[ax], self.ranges[ax])
                rot = angle_axis(a, axes[ax]) @ rot
            out[i, :, :3] = out[i, :, :3] @ rot.T
            if out.shape[2] > 3:
                out[i, :, 3:6] = out[i, :, 3:6] @ rot.T
        return out


class BatchPointcloudScaleAndJitter:
    """Per item of a (B, N, 3+) batch, an anisotropic scale (optionally
    with random axis symmetries) and a clipped gaussian jitter of the
    coordinates."""

    def __init__(self, scale_low=2. / 3., scale_high=3. / 2., std=0.01,
                 clip=0.05, augment_symmetries=(0, 0, 0)):
        self.scale_low, self.scale_high = scale_low, scale_high
        self.std, self.clip = std, clip
        self.augment_symmetries = np.asarray(augment_symmetries)

    def __call__(self, pc: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        out = np.array(pc, copy=True)
        for i in range(len(out)):
            scale = rng.uniform(self.scale_low, self.scale_high, 3)
            sym = np.round(rng.uniform(size=3)) * 2 - 1
            sym = sym * self.augment_symmetries \
                + (1 - self.augment_symmetries)
            scale = scale * sym
            jitter = np.clip(rng.normal(scale=self.std,
                                        size=(out.shape[1], 3)),
                             -self.clip, self.clip)
            out[i, :, :3] = out[i, :, :3] * scale + jitter
        return out

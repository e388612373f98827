"""Kernel-point disposition for the pseudo-grid (KPConv) operator.

A copy of ``deep3dpointclouddenoising_tpu/models/kernel_points.py``: kernel
points repel each other inside a sphere (1/r potential) while being drawn to
the centre (quadratic potential), point 0 optionally pinned at the centre.
The numpy arithmetic and the seeded generator are the same, so the same
arguments give the same array.  The optional on-disk cache of the JAX
package is left out.
"""
from __future__ import annotations

import functools

import numpy as np


def _optimize_kernel_points(num_points: int, num_kernels: int, dimension: int,
                            fixed: str, rng: np.random.Generator,
                            ratio: float = 1.0):
    """Gradient-descent the repulsive/attractive potential.

    Returns (kernels [num_kernels, num_points, dim], final max-grad norms).
    """
    radius0 = 1.0
    lr = 1e-2
    lr_decay = 0.9995
    thresh = 1e-5
    clip = 0.05 * radius0

    # rejection-sample initial points inside the sphere of radius r0/sqrt(2)
    pts = np.zeros((0, dimension))
    while pts.shape[0] < num_kernels * num_points:
        cand = rng.random((num_kernels * num_points, dimension)) * 2 - radius0
        keep = np.sum(cand ** 2, axis=1) < 0.5 * radius0 ** 2
        pts = np.vstack([pts, cand[keep]])
    kp = pts[: num_kernels * num_points].reshape(num_kernels, num_points, -1)

    if fixed == "center":
        kp[:, 0, :] = 0.0
    elif fixed == "verticals":
        kp[:, :3, :] = 0.0
        kp[:, 1, -1] += 2 * radius0 / 3
        kp[:, 2, -1] -= 2 * radius0 / 3

    prev_norms = np.zeros((num_kernels, num_points))
    final_norms = np.zeros(num_kernels)
    for _ in range(10000):
        diff = kp[:, :, None, :] - kp[:, None, :, :]
        sq = np.sum(diff ** 2, axis=-1)
        # repulsion: d/dx sum_j 1/|x-xj|  (~ (x-xj)/|x-xj|^3)
        rep = np.sum(diff / (sq[..., None] ** 1.5 + 1e-6), axis=2)
        grad = rep + 10.0 * kp  # + attraction to center
        if fixed == "verticals":
            grad[:, 1:3, :-1] = 0.0

        norms = np.sqrt(np.sum(grad ** 2, axis=-1))
        final_norms = np.max(norms, axis=1)
        moving = norms[:, 1:] if fixed == "center" else (
            norms[:, 3:] if fixed == "verticals" else norms)
        prev_moving = prev_norms[:, 1:] if fixed == "center" else (
            prev_norms[:, 3:] if fixed == "verticals" else prev_norms)
        if np.max(np.abs(prev_moving - moving)) < thresh:
            break
        prev_norms = norms

        step = np.minimum(lr * norms, clip)
        if fixed in ("center", "verticals"):
            step[:, 0] = 0.0
        kp -= step[..., None] * grad / (norms[..., None] + 1e-6)
        lr *= lr_decay

    r = np.sqrt(np.sum(kp ** 2, axis=-1))
    kp *= ratio / np.mean(r[:, 1:])
    return kp, final_norms


@functools.lru_cache(maxsize=16)
def _best_disposition(num_kpoints: int, dimension: int, fixed: str,
                      seed: int):
    """The optimized unit disposition, and the generator's state after it.

    It does not depend on the radius, so one optimization (seconds) serves
    every level of a model; the rest of :func:`create_kernel_points` goes
    on from the saved state and draws what the JAX package draws."""
    rng = np.random.default_rng(seed + num_kpoints * 131)
    num_tries = 20  # the original KPConv uses 100; 20 converges the same
    kernels, grad_norms = _optimize_kernel_points(
        num_kpoints, num_tries, dimension, fixed, rng)
    return kernels[int(np.argmin(grad_norms))], rng.bit_generator.state


@functools.lru_cache(maxsize=64)
def create_kernel_points(radius: float, num_kpoints: int = 15,
                         dimension: int = 3, fixed: str = "center",
                         seed: int = 0) -> np.ndarray:
    """Deterministic kernel-point disposition, scaled to ``radius``:
    optimize several candidate dispositions, keep the most converged, apply
    a random (seeded) SO(3) rotation and 1% jitter, scale by radius."""
    best, state = _best_disposition(num_kpoints, dimension, fixed, seed)
    rng = np.random.default_rng()
    rng.bit_generator.state = state

    if dimension == 3 and fixed != "verticals":
        # random orthonormal frame (seeded)
        while True:
            u = rng.random(3) * 2 - 1
            v = rng.random(3) * 2 - 1
            u /= np.linalg.norm(u) + 1e-9
            v /= np.linalg.norm(v) + 1e-9
            if abs(np.dot(u, v)) <= 0.99:
                break
        v -= np.dot(u, v) * u
        v /= np.linalg.norm(v) + 1e-9
        w = np.cross(u, v)
        rot = np.stack([u, v, w], axis=-1)
        best = radius * best @ rot
        best = best + rng.normal(scale=radius * 0.01, size=best.shape)
        if fixed == "center":
            best[0] = 0.0  # keep the pinned center exact
    else:
        best = radius * best
    return best.astype(np.float32)

"""Device-resident clouds and patch sampling on the card.

Counterpart of ``deep3dpointclouddenoising_tpu/data/device_sampler.py``.
:func:`cloud_data` uploads every cloud of a dataset once, padded to the
largest one (``(n_clouds, max_points, 3)`` points at ``PAD_COORD`` past a
cloud's end), with its offsets and labels and, when the dataset makes
Fourier features, the Fourier projection; voting gathers patches from it
by index.

:class:`DeviceSampler` cuts and augments training patches there, batched
over B, with the semantics of ``OffsetDataset.get``:

* the ``num_points`` nearest cloud points of the picked centre (float32
  squared distances by subtraction; the centre itself wins slot 0 by
  ``d2[centre] = -1``), of which those within ``in_radius`` are real;
* the centre in slot 0, the other reals in a random order after it
  (reals take the prefix), pads cycling random real neighbours with mask
  0;
* augmentation of points and offsets together: a random Euler rotation
  Rz @ Ry @ Rx, with ``cfg.jitter`` an anisotropic scale with random axis
  symmetries and a clipped Gaussian jitter of both;
* features the patch's points, or their Fourier features (in float64,
  as the host computes them), then ``norm_factor`` divides points,
  offsets and features.

Every random draw of a batch comes through one seam, a
:class:`SamplerDraws` from ``draws(cur)``: the permutation keys, the pad
picks in ``[0, cur)`` (``cur``: each patch's real count), the angles, the
scale, the symmetry flips and the jitter noise.  :func:`torch_draws` fills
it from a ``torch.Generator`` on the card; the tests fill it with the JAX
package's draws.  The JAX package's host pads an underfilled PCN patch
with cloud point 0; like its device sampler, this one cycles real
neighbours.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device

PAD_COORD = 1.0e9  # padded cloud rows lie "at infinity"
SAMPLE_STREAM = 2  # the sampler's stream of (seed, step) generators


def cloud_data(dataset, device, with_targets: bool = False
               ) -> Dict[str, torch.Tensor]:
    """The padded cloud tensors of ``dataset`` on ``device``: ``points``,
    with ``with_targets`` also ``offsets`` and ``labels`` (zero past a
    cloud's end), and ``fourier_B`` (float64) for Fourier features."""
    shapes = dataset.shapes
    if not shapes:
        raise ValueError("dataset has no shapes")
    max_n = max(len(s.points) for s in shapes)
    n = len(shapes)
    pts = np.full((n, max_n, 3), PAD_COORD, np.float32)
    offs = np.zeros((n, max_n, 3), np.float32)
    labels = np.zeros((n, max_n), np.int32)
    for i, s in enumerate(shapes):
        pts[i, :len(s.points)] = s.points
        if with_targets:
            offs[i, :len(s.points)] = s.offsets
            labels[i, :len(s.points)] = s.labels
    data = {"points": pts}
    if with_targets:
        data.update(offsets=offs, labels=labels)
    if getattr(dataset, "fourier_features", False):
        data["fourier_B"] = np.asarray(dataset.fourier_B, np.float64)
    return {k: torch.from_numpy(v).to(device) for k, v in data.items()}


@dataclasses.dataclass
class SamplerDraws:
    """The random draws of one batch of B patches of N slots:
    ``perm_keys`` (B, N-1) uniforms in [0, 1) that order the reals after
    the centre, ``pad_picks`` (B, N-1) integers in [0, cur) (the real slot
    each pad repeats), and for augmentation ``angles`` (B, 3) about x, y, z
    in their ranges, ``scale`` (B, 3) in [scale_low, scale_high),
    ``sym_u`` (B, 3) uniforms whose rounding picks each axis's sign, and
    ``noise_points`` / ``noise_offsets`` (B, N, 3) standard normals of the
    jitter."""
    perm_keys: torch.Tensor
    pad_picks: torch.Tensor
    angles: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None
    sym_u: Optional[torch.Tensor] = None
    noise_points: Optional[torch.Tensor] = None
    noise_offsets: Optional[torch.Tensor] = None


def torch_draws(sampler: "DeviceSampler", generator: torch.Generator,
                batch: int, augment: bool = True
                ) -> Callable[[torch.Tensor], SamplerDraws]:
    """The seam filled from ``generator`` (on the sampler's device), in a
    fixed order: permutation keys, pad picks, then the angles, scale,
    symmetry and jitter draws when ``augment``."""
    N, dev = sampler.num_points, sampler.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def draws(cur: torch.Tensor) -> SamplerDraws:
        perm = rand(batch, N - 1)
        picks = torch.minimum(
            (rand(batch, N - 1) * cur[:, None]).long(), cur[:, None] - 1)
        if not augment:
            return SamplerDraws(perm, picks)
        ranges = torch.tensor(sampler.angle_ranges, device=dev)
        angles = (rand(batch, 3) * 2.0 - 1.0) * ranges
        scale = sampler.scale_low + rand(batch, 3) * (
            sampler.scale_high - sampler.scale_low)
        sym_u = rand(batch, 3)
        noise = torch.randn((2, batch, N, 3), generator=generator,
                            device=dev)
        return SamplerDraws(perm, picks, angles, scale, sym_u, noise[0],
                            noise[1])

    return draws


def sample_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of training step ``step``'s draws, on ``device``,
    seeded by (``seed``, ``step``), so a resumed run draws what an
    unbroken one draws."""
    state = np.random.SeedSequence((int(seed), int(step), SAMPLE_STREAM))
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1)[0]))


def _axis_rotation(angle: torch.Tensor, axis: int) -> torch.Tensor:
    """(B,) angles -> (B, 3, 3) rotations about a coordinate axis, as
    ``c I + s [u]x + (1 - c) u u^T``."""
    c, s = torch.cos(angle), torch.sin(angle)
    u = torch.zeros(3, dtype=angle.dtype, device=angle.device)
    u[axis] = 1.0
    cross = torch.zeros(3, 3, dtype=angle.dtype, device=angle.device)
    cross[0, 1], cross[0, 2], cross[1, 2] = -u[2], u[1], -u[0]
    cross[1, 0], cross[2, 0], cross[2, 1] = u[2], -u[1], u[0]
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    return (c[:, None, None] * eye + s[:, None, None] * cross
            + (1.0 - c)[:, None, None] * torch.outer(u, u))


class DeviceSampler:
    """A dataset's clouds on ``device`` and the batched patch sampler.

    ``dataset`` is an ``OffsetDataset``; ``cfg`` gives ``num_points``,
    ``in_radius``, the augmentation (``build_train_transforms``' keys)
    and ``norm``.  The (epoch, step) centre table stays the dataset's
    (:meth:`centers`)."""

    def __init__(self, dataset, cfg, device=None):
        self.device = resolve_device(device)
        self.num_points = int(cfg.num_points)
        self.in_radius = float(cfg.in_radius)
        self.angle_ranges = (float(cfg.x_angle_range),
                             float(cfg.y_angle_range),
                             float(cfg.z_angle_range))
        self.jitter = bool(cfg.jitter)
        self.scale_low = float(cfg.scale_low)
        self.scale_high = float(cfg.scale_high)
        self.noise_std = float(cfg.noise_std)
        self.noise_clip = float(cfg.noise_clip)
        self.augment_symmetries = tuple(float(s)
                                        for s in cfg.augment_symmetries)
        self.norm_factor = self.in_radius / 100.0 if cfg.norm else None
        self.data = cloud_data(dataset, self.device, with_targets=True)
        if self.data["points"].shape[1] < self.num_points:
            raise ValueError(f"the largest cloud has fewer than "
                             f"{self.num_points} points")
        self.point_inds = np.asarray(dataset.point_inds, np.int64)
        self.cloud_inds = np.asarray(dataset.cloud_inds, np.int64)
        self.num_steps = int(dataset.num_steps)

    def centers(self, epoch: int, batch_size: int, drop_last: bool = True
                ) -> np.ndarray:
        """(steps, B, 2) int64 [cloud, point] of ``epoch``'s slice of the
        dataset's centre table, indexed as ``OffsetDataset.get`` indexes
        it."""
        total = len(self.point_inds)
        steps = self.num_steps // batch_size if drop_last \
            else -(-self.num_steps // batch_size)
        idx = (np.arange(steps * batch_size) + epoch * self.num_steps) \
            % total
        out = np.stack([self.cloud_inds[idx], self.point_inds[idx]], -1)
        return out.reshape(steps, batch_size, 2)

    def _augment(self, points, offsets, d: SamplerDraws):
        rot = _axis_rotation(d.angles[:, 2], 2) \
            @ _axis_rotation(d.angles[:, 1], 1) \
            @ _axis_rotation(d.angles[:, 0], 0)
        points = points @ rot.transpose(1, 2)
        offsets = offsets @ rot.transpose(1, 2)
        if self.jitter:
            aug = torch.tensor(self.augment_symmetries, device=self.device)
            sym = torch.round(d.sym_u) * 2.0 - 1.0
            scale = (d.scale * (sym * aug + (1.0 - aug)))[:, None, :]
            clip = self.noise_clip
            points = points * scale + torch.clamp(
                d.noise_points * self.noise_std, -clip, clip)
            offsets = offsets * scale + torch.clamp(
                d.noise_offsets * self.noise_std, -clip, clip)
        return points, offsets

    def sample(self, centers, draws: Callable[[torch.Tensor], SamplerDraws],
               augment: bool = True) -> Dict[str, torch.Tensor]:
        """The batch of patches around ``centers`` (B, 2) [cloud, point]:
        ``points``, ``mask``, ``features``, ``labels``, ``offsets``,
        ``cloud_ind`` and ``input_inds``, on the card; ``draws`` is the
        seam (:func:`torch_draws`)."""
        data, N = self.data, self.num_points
        centers = torch.as_tensor(centers, device=self.device).long()
        ci, pi = centers[:, 0], centers[:, 1]
        B = centers.shape[0]
        rows = torch.arange(B, device=self.device)
        pick = data["points"][ci, pi]
        diff = data["points"][ci] - pick[:, None, :]
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]
        d2[rows, pi] = -1.0  # the designated centre wins slot 0
        neg, idx = torch.topk(-d2, N, dim=1)  # nearest first
        r2 = torch.tensor(self.in_radius ** 2, dtype=torch.float32,
                          device=self.device)
        is_real = -neg <= r2
        cur = is_real.sum(dim=1)
        d = draws(cur)
        keys = d.perm_keys + torch.where(is_real[:, 1:], 0.0, 2.0)
        order = torch.argsort(keys, dim=1, stable=True) + 1
        slot = torch.arange(1, N, device=self.device)
        src = torch.where(slot[None, :] < cur[:, None], order, d.pad_picks)
        src = torch.cat([torch.zeros_like(src[:, :1]), src], dim=1)
        inds = torch.gather(idx, 1, src)
        mask = (torch.arange(N, device=self.device)[None, :]
                < cur[:, None]).float()
        points = data["points"][ci[:, None], inds] - pick[:, None, :]
        offsets = data["offsets"][ci[:, None], inds]
        labels = data["labels"][ci[:, None], inds]
        if augment:
            points, offsets = self._augment(points, offsets, d)
        fourier_b = data.get("fourier_B")
        if fourier_b is not None:
            proj = (2.0 * np.pi * points).double() @ fourier_b.T
            feats = torch.cat([proj.sin(), proj.cos()], -1).float()
        else:
            feats = points
        if self.norm_factor:  # after the features, as the host loop does
            points = points / self.norm_factor
            offsets = offsets / self.norm_factor
            feats = feats / self.norm_factor
        return {"points": points, "mask": mask, "features": feats,
                "labels": labels, "offsets": offsets, "cloud_ind": ci,
                "input_inds": inds}

"""Offset-regression dataset: shapes -> noisy clouds with ground-truth
offsets, cut into patches.

Counterpart of ``deep3dpointclouddenoising_tpu/data/offset_dataset.py``
(its numpy path), with the same draws from the same generators, so the same
seed gives the same noisy clouds and the same patches:

* :func:`process_off_file` normalizes a mesh, samples its surface evenly,
  draws uniform-box outliers, shuffles, adds noise and computes the
  offsets = closest surface point - noisy position;
* training and validation splits draw a table of patch centres for all
  epochs up front, half outliers and half inliers interleaved when the
  clouds have outliers (``_sample_class``, ``_interleave``); test splits
  take the cloud points nearest to a voxel-grid subsampling of the cloud,
  so the patches cover it;
* :meth:`OffsetDataset.get` takes the radius patch sorted by distance,
  pads or truncates it to ``num_points`` with a mask, swaps the centre into
  slot 0, recentres it and, for training, augments points and offsets
  together; features are the patch's xyz (or its Fourier features).

``architecture="PCN"`` (the PointCleanNet baseline) makes every cloud
point a patch centre in a test split, pads an underfilled patch with
cloud point 0 in distance order (no shuffle) and gives ``points``,
``center_ind`` (0), ``cloud_ind``, ``input_inds`` and ``offsets``: the
centre's (3,) offset in a test split, all (N, 3) otherwise.

``self.rng`` is consumed in a fixed order (the Fourier matrix, then each
shape's noise, then the patch table), which decides every patch.
Processed shapes are cached as ``.npz`` under ``<data_root>/processed_torch``
with the generator's state before and after the shape's draws; a cache hit
from the same state moves ``self.rng`` on to the state after, as the
processing would have, so the patch table does not depend on whether the
cache was warm (the JAX package's draws skip cached shapes, so a run that
processed its shapes and a later run of the same command, a resumed one,
drew different patches).
The JAX package's fused native patch assembly has a random stream of its own;
the port follows the numpy path, which is that package's oracle.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.spatial import GridIndex, grid_subsample
from .meshio import TriMesh, closest_point_on_mesh, load_off, \
    sample_surface_even

logger = logging.getLogger("d3pcd_torch")

NOISE_CLIP = 3.0 / 100.0  # noise is clipped to 3% of the diagonal
DIVERSE_LEVELS = (0.0, 0.25, 0.5, 1.0, 1.5, 2.5)  # percent
MARGIN = 0.1  # outlier box margin around the normalized shape


def fourier_input_mapping(x: np.ndarray, B: np.ndarray) -> np.ndarray:
    proj = (2.0 * np.pi * x) @ B.T
    return np.concatenate([np.sin(proj), np.cos(proj)], axis=-1)


@dataclasses.dataclass
class ShapeData:
    mesh: TriMesh
    points: np.ndarray    # (P, 3) noisy positions
    labels: np.ndarray    # (P,) int32: 1 = outlier
    offsets: np.ndarray   # (P, 3) GT offsets (denoised = noisy + offset)

    def save(self, path: str, rng_states=None) -> None:
        """Write the shape, and ``rng_states`` (the generator's states
        before and after its draws) where given."""
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        extra = {} if rng_states is None \
            else {"rng_states": np.array(json.dumps(rng_states))}
        np.savez(tmp, vertices=self.mesh.vertices, faces=self.mesh.faces,
                 points=self.points, labels=self.labels,
                 offsets=self.offsets, **extra)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ShapeData":
        with np.load(path) as z:
            return cls(mesh=TriMesh(z["vertices"], z["faces"]),
                       points=z["points"], labels=z["labels"],
                       offsets=z["offsets"])

    @staticmethod
    def load_rng_states(path: str):
        """The (before, after) generator states saved with the shape, or
        ``None``."""
        with np.load(path) as z:
            return json.loads(str(z["rng_states"])) \
                if "rng_states" in z.files else None


def _add_noise(pos: np.ndarray, gt: np.ndarray, noise_type: str,
               noise_level: float, rng: np.random.Generator,
               levels: Optional[Sequence[float]] = None) -> np.ndarray:
    """Noise for the inliers; 'diverse' mixes the sigmas of ``levels``
    (percent; default ``DIVERSE_LEVELS``) over the points."""
    inlier = gt == 0
    n_in = int(inlier.sum())
    if n_in == 0:
        return pos
    if noise_type == "diverse":
        levels = list(levels or DIVERSE_LEVELS)
        per_bin = n_in // len(levels)
        noises = []
        used = 0
        for i, lvl in enumerate(levels):
            cnt = n_in - used if i == len(levels) - 1 else per_bin
            used += cnt
            lvl = lvl / 100.0
            noises.append(lvl * rng.standard_normal((cnt, 3))
                          if lvl > 0 else np.zeros((cnt, 3)))
        noise = np.clip(np.concatenate(noises), -NOISE_CLIP, NOISE_CLIP)
        rng.shuffle(noise)
    elif noise_level <= 0:
        noise = np.zeros((n_in, 3))
    elif noise_type == "gaussian":
        noise = np.clip(noise_level * rng.standard_normal((n_in, 3)),
                        -NOISE_CLIP, NOISE_CLIP)
    elif noise_type == "white":
        noise = np.clip(noise_level * rng.random((n_in, 3)),
                        -NOISE_CLIP, NOISE_CLIP)
    else:
        raise ValueError(f"Unknown noise type {noise_type}")
    out = pos.copy()
    out[inlier] += noise
    return out


def process_off_file(filepath: str, num_points_per_shape: int,
                     outlier_proportion: float, noise_type: str,
                     noise_level: float, rng: np.random.Generator,
                     mesh: Optional[TriMesh] = None,
                     levels: Optional[Sequence[float]] = None) -> ShapeData:
    """One shape's noisy cloud and ground-truth offsets; ``levels`` as in
    :func:`_add_noise`."""
    n_out = int(num_points_per_shape * outlier_proportion)
    n_in = num_points_per_shape - n_out

    shape = (mesh or load_off(filepath)).copy()
    shape.vertices = shape.vertices - shape.vertices.mean(axis=0)
    diagonal = np.linalg.norm(shape.vertices.max(0) - shape.vertices.min(0))
    shape.vertices = shape.vertices / diagonal

    in_pos, _ = sample_surface_even(shape, n_in, rng)
    in_mean = in_pos.mean(0)
    amplitude = in_pos.max() - in_pos.min()
    in_pos = (1.0 - MARGIN) * (in_pos - in_mean) / amplitude
    shape.vertices = (1.0 - MARGIN) * (shape.vertices - in_mean) / amplitude

    low = in_pos.min(0) - MARGIN
    high = in_pos.max(0) + MARGIN
    out_pos = rng.uniform(low=low, high=high, size=(n_out, 3))

    pos = np.concatenate([in_pos, out_pos], axis=0)
    mean_pos = pos.mean(0)
    pos -= mean_pos
    shape.vertices = shape.vertices - mean_pos
    gt = np.concatenate([np.zeros(n_in), np.ones(n_out)])

    order = rng.permutation(num_points_per_shape)
    pos, gt = pos[order], gt[order]

    noisy = _add_noise(pos, gt, noise_type, noise_level, rng, levels=levels)
    closest, _ = closest_point_on_mesh(shape, noisy)
    offsets = closest - noisy

    if noise_type == "diverse":
        # labels become "offset larger than the largest sigma"
        max_lvl = max(levels or DIVERSE_LEVELS)
        gt = (np.linalg.norm(offsets, axis=1) > max_lvl / 100.0) \
            .astype(np.int32)

    return ShapeData(mesh=shape, points=noisy.astype(np.float32),
                     labels=gt.astype(np.int32),
                     offsets=offsets.astype(np.float32))


def _interleave(a_pts, a_clouds, b_pts, b_clouds):
    pts = np.empty(len(a_pts) + len(b_pts), dtype=np.int64)
    clouds = np.empty_like(pts)
    pts[0::2], pts[1::2] = a_pts, b_pts
    clouds[0::2], clouds[1::2] = a_clouds, b_clouds
    return pts, clouds


def _sample_class(labels_per_cloud: Sequence[np.ndarray], class_id: int,
                  count: int, rng: np.random.Generator):
    """``count`` (point, cloud) index pairs of one class across the clouds,
    shuffled, padded by repetition when the class has fewer points."""
    pts = np.concatenate([np.nonzero(l == class_id)[0]
                          for l in labels_per_cloud])
    clouds = np.concatenate([np.full((l == class_id).sum(), i)
                             for i, l in enumerate(labels_per_cloud)])
    perm = rng.permutation(len(pts))
    pts, clouds = pts[perm], clouds[perm]
    if len(pts) >= count:
        return pts[:count], clouds[:count]
    extra = rng.integers(0, len(pts), count - len(pts))
    return (np.concatenate([pts, pts[extra]]),
            np.concatenate([clouds, clouds[extra]]))


class OffsetDataset:
    """Patches over ``<data_root>/<split>/*.off``: ``num_epochs *
    num_steps`` sampled centres for ``train`` and ``val``, covering
    centres for ``test`` and ``qualitative_test``."""

    def __init__(self, data_root: str, split: str = "qualitative_test", *,
                 in_radius: float = 2.0, num_points: int = 500,
                 num_steps: int = 2000, num_epochs: int = 1,
                 noise_type: str = "gaussian", noise_level: float = 5e-3,
                 num_points_per_shape: int = 140000,
                 outlier_proportion: float = 0.0, transforms=None,
                 architecture: str = "U-Net",
                 sample_dl_patches: Optional[float] = None,
                 fourier_features: bool = False,
                 subsampling_parameter: float = 0.0, seed: int = 0,
                 shapes: Optional[Dict[str, TriMesh]] = None,
                 diverse_levels: Optional[Sequence[float]] = None):
        if "test" not in split and num_steps * num_epochs % 2:
            raise ValueError("the balanced inlier/outlier interleave needs "
                             "an even num_steps * num_epochs")
        self.split = split
        self.in_radius = in_radius
        self.num_points = num_points
        self.num_steps = num_steps
        self.num_epochs = num_epochs
        self.transforms = transforms
        self.architecture = architecture
        self.fourier_features = fourier_features
        self.subsampling_parameter = subsampling_parameter
        self.epoch = 0
        self.rng = np.random.default_rng(seed)
        self._sample_seed = int(seed)
        self.fourier_B = self.rng.normal(0.0, 12.0, size=(32, 3))
        if sample_dl_patches is None:
            sample_dl_patches = in_radius

        self.data_root = data_root
        self.cache_dir = os.path.join(data_root, "processed_torch")
        os.makedirs(self.cache_dir, exist_ok=True)

        names = sorted(
            os.path.join(split, os.path.basename(f)[:-4])
            for f in glob.glob(os.path.join(data_root, split, "*.off")))
        if shapes is not None:  # injected meshes (tests, synthetic data)
            names = sorted(shapes)
        if not names:
            raise FileNotFoundError(
                f"no .off shapes under {data_root}/{split}")
        self.cloud_names = names

        # diverse_levels (percent) overrides the sigma set of both diverse
        # regimes: diverse_stable replicates the shapes per level, diverse
        # mixes the levels over each cloud's points
        self.diverse_levels = list(diverse_levels) if diverse_levels \
            else None
        levels = list(self.diverse_levels or DIVERSE_LEVELS) \
            if noise_type == "diverse_stable" else [noise_level]
        self.shapes: List[ShapeData] = []
        for lvl in levels:
            for name in names:
                ntype = "gaussian" if noise_type == "diverse_stable" \
                    else noise_type
                lvl_val = lvl / 100.0 if noise_type == "diverse_stable" \
                    else lvl
                self.shapes.append(self._load_or_process(
                    name, ntype, lvl_val, num_points_per_shape,
                    outlier_proportion,
                    mesh=None if shapes is None else shapes[name]))
                logger.info(f"{split}: shape {len(self.shapes)}"
                            f"/{len(levels) * len(names)}")
        self.indexes = [GridIndex(s.points) for s in self.shapes]
        self._build_patch_table(sample_dl_patches)

    def _load_or_process(self, name, noise_type, noise_level, npts, outprop,
                         mesh=None) -> ShapeData:
        # a custom sigma mix is baked into the cloud: its own cache entry
        lvl_tag = "" if not (self.diverse_levels and noise_type == "diverse") \
            else "_lv" + "-".join(f"{l:g}" for l in self.diverse_levels)
        tag = (f"{name.replace(os.sep, '_')}_{noise_type}_{noise_level:.2e}"
               f"_{npts:06d}_{outprop:.2f}{lvl_tag}.npz")
        cache = os.path.join(self.cache_dir, tag)
        before = self.rng.bit_generator.state
        if os.path.exists(cache):
            states = ShapeData.load_rng_states(cache)
            if states is not None and states[0] == before:
                self.rng.bit_generator.state = states[1]
            return ShapeData.load(cache)
        data = process_off_file(
            os.path.join(self.data_root, name + ".off"), npts, outprop,
            noise_type, noise_level, rng=self.rng, mesh=mesh,
            levels=self.diverse_levels)
        data.save(cache, rng_states=[before, self.rng.bit_generator.state])
        return data

    def _build_patch_table(self, sample_dl_patches: float) -> None:
        if "test" not in self.split:
            labels = [s.labels for s in self.shapes]
            total = self.num_epochs * self.num_steps
            if any((l == 1).any() for l in labels):
                n_out = total // 2
                o_pts, o_clouds = _sample_class(labels, 1, n_out, self.rng)
                i_pts, i_clouds = _sample_class(labels, 0, total - n_out,
                                                self.rng)
                self.point_inds, self.cloud_inds = _interleave(
                    o_pts, o_clouds, i_pts, i_clouds)
            else:
                self.point_inds, self.cloud_inds = _sample_class(
                    labels, 0, total, self.rng)
            # centre jitter of scale 2 * subsampling_parameter (0 in the
            # reference runs)
            self.center_noise = self.rng.normal(
                scale=2.0 * self.subsampling_parameter,
                size=(len(self.point_inds), 3)) \
                if self.subsampling_parameter > 0 \
                else np.zeros((len(self.point_inds), 3))
            return
        pts_ls, cloud_ls = [], []
        for i, s in enumerate(self.shapes):
            if self.architecture == "PCN":  # a patch per cloud point
                inds = np.arange(len(s.points))
            else:
                sub = grid_subsample(s.points, sample_dl_patches)
                inds = np.array([self.indexes[i].nearest(c) for c in sub])
            pts_ls.append(inds.ravel())
            cloud_ls.append(np.full(len(pts_ls[-1]), i))
        self.point_inds = np.concatenate(pts_ls)
        self.cloud_inds = np.concatenate(cloud_ls)
        self.num_steps = len(self.point_inds)
        self.center_noise = np.zeros((len(self.point_inds), 3))

    def __len__(self) -> int:
        return self.num_steps

    def get(self, idx: int, epoch: Optional[int] = None
            ) -> Dict[str, np.ndarray]:
        """Patch ``idx`` of ``epoch``'s slice of the centre table (default
        ``self.epoch``), with a generator seeded by its table index."""
        epoch = self.epoch if epoch is None else epoch
        index = (idx + epoch * self.num_steps) % len(self.point_inds)
        cloud_ind = int(self.cloud_inds[index])
        point_ind = int(self.point_inds[index])
        shape = self.shapes[cloud_ind]
        rng = np.random.default_rng((self._sample_seed, index))
        pick = shape.points[point_ind].reshape(1, 3) \
            + self.center_noise[index].astype(np.float32)
        spatial_index = self.indexes[cloud_ind]

        # sorted-by-distance radius query, retried at twice the radius
        query_inds = spatial_index.query_radius_sorted(pick[0],
                                                       self.in_radius)
        if len(query_inds) == 0:
            query_inds = spatial_index.query_radius_sorted(
                pick[0], 2 * self.in_radius)
        cur = len(query_inds)
        if self.num_points < cur:
            keep = query_inds[: self.num_points]
            input_inds = keep[rng.permutation(self.num_points)]
            mask = np.ones(self.num_points, np.float32)
        else:
            if self.architecture == "PCN":  # pads: cloud point 0
                input_inds = np.concatenate([query_inds, np.zeros(
                    self.num_points - cur, np.int64)])
            else:
                query_inds = query_inds[rng.permutation(cur)]
                pad = rng.integers(0, cur, self.num_points - cur)
                input_inds = np.concatenate([query_inds, query_inds[pad]])
            mask = np.zeros(self.num_points, np.float32)
            mask[:cur] = 1.0

        # swap the true centre into slot 0
        where = np.nonzero(input_inds == point_ind)[0]
        ci = int(where[0]) if len(where) \
            else int(np.nonzero(input_inds == query_inds[0])[0][0])
        input_inds[0], input_inds[ci] = input_inds[ci], input_inds[0]

        points = shape.points[input_inds] - pick
        offsets = shape.offsets[input_inds]
        if self.transforms is not None:
            stack = self.transforms(np.concatenate([points, offsets]), rng)
            points = stack[: self.num_points]
            offsets = stack[self.num_points:]
        if self.architecture == "PCN":
            return {"points": points.astype(np.float32),
                    "center_ind": np.int64(0),
                    "cloud_ind": np.int64(cloud_ind),
                    "input_inds": input_inds.astype(np.int64),
                    "offsets": (offsets[0] if "test" in self.split
                                else offsets).astype(np.float32)}
        feats = fourier_input_mapping(points, self.fourier_B) \
            if self.fourier_features else points
        return {
            "points": points.astype(np.float32),
            "mask": mask,
            "features": feats.astype(np.float32),
            "labels": shape.labels[input_inds].astype(np.int32),
            "offsets": offsets.astype(np.float32),
            "cloud_ind": np.int64(cloud_ind),
            "input_inds": input_inds.astype(np.int64),
        }

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.get(idx)

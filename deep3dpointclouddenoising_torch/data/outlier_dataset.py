"""Outlier-segmentation dataset: labelled scans -> radius patches.

Counterpart of ``deep3dpointclouddenoising_tpu/data/outlier_dataset.py``
(its numpy path, ``native_patches=False``), with the same draws from the
same generators, so the same seed gives the same patches:

* EDF scans (``pointcloud_NN.ply`` with ``GT``, normal and intensity
  fields; ``GT == 2`` marks an outlier) in the splits ``EDFM``, ``EDFS``
  and the K-fold ``EDFS{K}f{i}``, and the PCN outlier layout (file lists
  ``outliers_TRAIN_W_NOR/trainingset.txt`` and ``validationset.txt``,
  ``outliers_TEST_W_NOR/testset.txt``; ``GT == 1`` marks an outlier);
* Katz hidden-point-removal visibility features (:func:`compute_katz`),
  left-padded with ones to a multiple of three channels;
* an optional voxel pre-subsampling of each cloud at
  ``subsampling_parameter``, each full-cloud point projected onto its
  nearest sub-cloud point (the projection and the density);
* training and validation centres half outliers and half inliers,
  interleaved (``offset_dataset._sample_class``), jittered by a normal of
  scale ``2 * subsampling_parameter``; test centres the sub-cloud points
  nearest to a voxel grid of ``0.25 * min(in_radius, 2)``, so the patches
  cover every cloud;
* :meth:`OutlierSegmentationDataset.get`: the radius patch sorted by
  distance, truncated or padded to ``num_points`` with a mask, shuffled
  (no centre swap), recentred and transformed.

``self.rng`` draws the patch table, then the centre jitter; each patch
draws from ``np.random.default_rng((seed, index))``.  Scans and Katz
columns are cached under ``<data_root>/processed_torch``.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.spatial import GridIndex, grid_subsample
from .meshio import read_ply
from .offset_dataset import _interleave, _sample_class

logger = logging.getLogger("d3pcd_torch")

EDF_SMALL = [f"pointcloud_{i:02d}" for i in range(14)]
EDF_TEST_EXT = [f"test_pointcloud_{i}" for i in range(13, 21)]


def hpr_visible_indices(pos: np.ndarray, parameter: float,
                        ktype: str = "std") -> np.ndarray:
    """Katz et al.'s hidden-point removal: the indices of the points
    visible from the origin, the vertices of the convex hull of the
    inverted cloud and the origin.  ``std``: spherical inversion with
    radius ``max|p| * 10**parameter``; ``exp``: ``dir * (|p| /
    max|p|)**parameter``."""
    from scipy.spatial import ConvexHull
    norm = np.linalg.norm(pos, axis=1, keepdims=True)
    norm = np.maximum(norm, 1e-12)
    direction = pos / norm
    if ktype == "std":
        R = norm.max() * 10.0 ** parameter
        pos_hat = pos + 2.0 * (R - norm) * direction
    elif ktype == "exp":
        pos_hat = direction * (norm / norm.max()) ** parameter
    else:
        raise ValueError(f"Unknown katz type {ktype}")
    pos_hat = np.concatenate([pos_hat, np.zeros((1, 3))], axis=0)
    visible = ConvexHull(pos_hat).vertices
    return visible[visible != len(pos)]  # drop the origin


def compute_katz(pos: np.ndarray, parameters: Sequence[float],
                 ktype: str = "std") -> np.ndarray:
    """(N, len(parameters)) float32: 1 where a point is hidden, 0 where it
    is visible, for each parameter."""
    cols = []
    for parameter in parameters:
        col = np.ones((len(pos), 1), np.float32)
        col[hpr_visible_indices(pos, parameter, ktype)] = 0.0
        cols.append(col)
    return np.concatenate(cols, axis=1)


def pad_features_to_3(features: np.ndarray) -> np.ndarray:
    """Left-pad the feature columns with ones to a multiple of 3."""
    dim = features.shape[1]
    rem = abs(3 - dim % 3) % 3
    if rem:
        ones = np.ones((len(features), rem), np.float32)
        features = np.concatenate([ones, features], axis=1)
    return features


def _kfold_splits(items: Sequence[str], num_folds: int):
    """Contiguous K-fold (train, test) index lists: the first ``n % k``
    folds hold ``n // k + 1`` items, the others ``n // k``."""
    n = len(items)
    sizes = [n // num_folds + (1 if i < n % num_folds else 0)
             for i in range(num_folds)]
    folds = []
    start = 0
    for s in sizes:
        test_idx = list(range(start, start + s))
        train_idx = [i for i in range(n) if i not in test_idx]
        folds.append((train_idx, test_idx))
        start += s
    return folds


def _read_file_list(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def _load_scan(path: str, dataset_type: str):
    """``(points, intensity, normals, labels)`` of one PLY scan."""
    ply = read_ply(path)
    points = ply["vertex"]
    if "normal" in ply:
        normals = ply["normal"]
    elif "nx" in ply:
        normals = np.stack([ply["nx"], ply["ny"], ply["nz"]], axis=1)
    elif "normal_0" in ply:
        normals = np.stack([ply["normal_0"], ply["normal_1"],
                            ply["normal_2"]], axis=1)
    else:
        normals = np.zeros_like(points)
    intensity = (ply.get("intensity", np.zeros(len(points)))
                 / 255.0).astype(np.float32).reshape(-1, 1)
    gt = np.asarray(ply["GT"]).squeeze()
    outlier = 1 if dataset_type == "PCN" else 2
    labels = (gt == outlier).astype(np.int32)
    return points, intensity, normals, labels


class OutlierSegmentationDataset:
    """Radius patches over labelled scans: ``num_epochs * num_steps``
    sampled centres for ``train`` and ``val``, covering centres for a
    split whose name holds ``test``."""

    def __init__(self, data_root: str, split: str = "train", *,
                 dataset_type: str = "EDFS",
                 input_features: Sequence[str] = (),
                 katz_params: Sequence[float] = (),
                 katz_type: str = "std",
                 subsampling_parameter: float = 0.0,
                 in_radius: float = 2.0, num_points: int = 15000,
                 num_steps: int = 500, num_epochs: int = 1,
                 feature_drop: float = 0.0, transforms=None,
                 debug: bool = False, seed: int = 0):
        self.split = split
        self.dataset_type = dataset_type
        self.input_features = list(input_features)
        self.katz_params = list(katz_params)
        self.katz_type = katz_type
        self.subsampling_parameter = subsampling_parameter
        self.in_radius = in_radius
        self.num_points = num_points
        self.num_steps = num_steps
        self.num_epochs = num_epochs
        self.feature_drop = feature_drop
        self.transforms = transforms
        self.epoch = 0
        self.rng = np.random.default_rng(seed)
        self._sample_seed = 0 if seed is None else int(seed)
        self.label_to_names = {0: "inlier", 1: "outlier"}

        dim = 0
        for f in self.input_features:
            if f == "normal":
                dim += 3
            if "katz" in f:
                dim += len(self.katz_params)
            if f == "intensity":
                dim += 1
        self.raw_features_dim = dim if dim > 0 else 3
        self.input_features_dim = (self.raw_features_dim
                                   + abs(3 - self.raw_features_dim % 3) % 3)

        self.data_root = data_root
        self.cache_dir = os.path.join(data_root, "processed_torch")
        os.makedirs(self.cache_dir, exist_ok=True)
        self.cloud_names = self._resolve_split(split, debug)

        self.clouds_points: List[np.ndarray] = []
        self.clouds_features: List[np.ndarray] = []
        self.clouds_labels: List[np.ndarray] = []
        self.sub_points: List[np.ndarray] = []
        self.sub_features: List[np.ndarray] = []
        self.sub_labels: List[np.ndarray] = []
        self.sub_density: List[np.ndarray] = []
        self.sub_indexes: List[GridIndex] = []
        self.projections: List[np.ndarray] = []
        for i, name in enumerate(self.cloud_names):
            self._load_cloud(name)
            logger.info(f"{split}: cloud {i + 1}/{len(self.cloud_names)} "
                        f"({name}) loaded")
        self._build_patch_table()

    def _resolve_split(self, split: str, debug: bool) -> List[str]:
        t = self.dataset_type
        if t == "EDFM":
            train, val, test = (EDF_SMALL[:11], EDF_SMALL[11:], EDF_TEST_EXT)
        elif t == "EDFS":
            train, val, test = (EDF_SMALL[:9], EDF_SMALL[9:11],
                                EDF_SMALL[11:])
        elif t.startswith("EDFS") and "f" in t:
            num_folds, fold_id = (int(x) for x in t[4:].split("f"))
            folds = _kfold_splits(EDF_SMALL[:-1], num_folds)
            train_idx, test_idx = folds[fold_id]
            # the first two train scans validate; the last ("difficult")
            # scan always trains
            train = [EDF_SMALL[i] for i in train_idx[2:]] + [EDF_SMALL[-1]]
            val = [EDF_SMALL[i] for i in train_idx[:2]]
            test = [EDF_SMALL[i] for i in test_idx]
        elif t == "PCN":
            train_dir = os.path.join(self.data_root, "outliers_TRAIN_W_NOR")
            test_dir = os.path.join(self.data_root, "outliers_TEST_W_NOR")
            train = [os.path.join("outliers_TRAIN_W_NOR", n) for n in
                     _read_file_list(os.path.join(train_dir,
                                                  "trainingset.txt"))]
            val = [os.path.join("outliers_TRAIN_W_NOR", n) for n in
                   _read_file_list(os.path.join(train_dir,
                                                "validationset.txt"))]
            test = [os.path.join("outliers_TEST_W_NOR", n) for n in
                    _read_file_list(os.path.join(test_dir, "testset.txt"))]
        else:
            raise ValueError(f"Unknown dataset type {t}")
        names = {"train": train, "val": val, "test": test}.get(split,
                                                               val + train)
        return names[:2] if debug else names

    def _load_cloud(self, name: str) -> None:
        tag = name.replace(os.sep, "_")
        cache = os.path.join(self.cache_dir, f"{tag}.npz")
        if os.path.exists(cache):
            with np.load(cache) as z:
                points, intensity, normals, labels = (
                    z["points"], z["intensity"], z["normals"], z["labels"])
        else:
            points, intensity, normals, labels = _load_scan(
                os.path.join(self.data_root, name + ".ply"),
                self.dataset_type)
            tmp = f"{cache}.{os.getpid()}.tmp.npz"
            np.savez(tmp, points=points, intensity=intensity,
                     normals=normals, labels=labels)
            os.replace(tmp, cache)

        feats = self._features_for(name, points, intensity, normals)
        points = np.ascontiguousarray(points, np.float32)
        self.clouds_points.append(points)
        self.clouds_features.append(feats)
        self.clouds_labels.append(labels)

        if self.subsampling_parameter > 0:
            sp, sf, sl = grid_subsample(points, self.subsampling_parameter,
                                        features=feats, labels=labels)
        else:
            sp, sf, sl = points, feats, labels
        sl = np.asarray(sl).squeeze()
        index = GridIndex(sp)
        # each full-cloud point's nearest sub-cloud point; the density is
        # how many points project onto each sub-cloud point
        cluster = index.nearest_many(points) if len(sp) != len(points) \
            else np.arange(len(points))
        counts = np.zeros(len(sp), np.float32)
        np.add.at(counts, cluster, 1.0)

        self.sub_points.append(np.ascontiguousarray(sp, np.float32))
        self.sub_features.append(np.asarray(sf, np.float32))
        self.sub_labels.append(sl.astype(np.int32))
        self.sub_density.append(counts / max(counts.max(), 1.0))
        self.sub_indexes.append(index)
        # proj[j]: the segmentation slot of full-cloud point j, the identity
        # for PCN (labels are not subsampled there)
        self.projections.append(
            np.arange(len(points), dtype=np.int64)
            if self.dataset_type == "PCN" else cluster.astype(np.int64))

    def _features_for(self, name, points, intensity, normals) -> np.ndarray:
        if not self.input_features:
            return np.ones((len(points), 3), np.float32)
        cols = []
        for f in self.input_features:
            if f == "intensity":
                cols.append(intensity.reshape(-1, 1))
            elif f == "normal":
                cols.append(normals)
            elif "katz" in f:
                cols.append(self._katz_for(name, points))
        return np.concatenate(cols, axis=1).astype(np.float32)

    def _katz_for(self, name: str, points: np.ndarray) -> np.ndarray:
        tag = name.replace(os.sep, "_")
        katz_dir = os.path.join(self.cache_dir, "katz_values")
        os.makedirs(katz_dir, exist_ok=True)
        cols = []
        for p in self.katz_params:
            cache = os.path.join(
                katz_dir, f"{self.katz_type}Ktz{p:.3f}_{tag}.npy")
            if os.path.exists(cache):
                cols.append(np.load(cache))
            else:
                k = compute_katz(points, [p], self.katz_type)
                np.save(cache, k)
                cols.append(k)
        return np.concatenate(cols, axis=1)

    def _build_patch_table(self) -> None:
        total = self.num_epochs * self.num_steps
        if "test" not in self.split:
            if any((l == 1).any() for l in self.sub_labels):
                n_out = total // 2
                o_pts, o_clouds = _sample_class(self.sub_labels, 1, n_out,
                                                self.rng)
                i_pts, i_clouds = _sample_class(self.sub_labels, 0,
                                                total - n_out, self.rng)
                self.point_inds, self.cloud_inds = _interleave(
                    o_pts, o_clouds, i_pts, i_clouds)
            else:
                self.point_inds, self.cloud_inds = _sample_class(
                    self.sub_labels, 0, total, self.rng)
            self.center_noise = self.rng.normal(
                scale=2.0 * self.subsampling_parameter, size=(total, 3)) \
                if self.subsampling_parameter > 0 else np.zeros((total, 3))
            return
        dl = 0.25 * min(self.in_radius, 2.0)
        pts_ls, cloud_ls = [], []
        for i, (sp, index) in enumerate(zip(self.sub_points,
                                            self.sub_indexes)):
            inds = index.nearest_many(grid_subsample(sp, dl))
            pts_ls.append(inds)
            cloud_ls.append(np.full(len(inds), i, np.int64))
        self.point_inds = np.concatenate(pts_ls)
        self.cloud_inds = np.concatenate(cloud_ls)
        self.num_steps = len(self.point_inds)
        self.center_noise = np.zeros((len(self.point_inds), 3))

    def __len__(self) -> int:
        return self.num_steps

    def get(self, idx: int, epoch: Optional[int] = None
            ) -> Dict[str, np.ndarray]:
        """Patch ``idx`` of ``epoch``'s slice of the centre table (default
        ``self.epoch``): ``points`` (recentred), ``mask``, ``features``,
        ``labels`` (int32), ``cloud_ind`` and ``input_inds`` (int64, the
        sub-cloud points of the slots)."""
        epoch = self.epoch if epoch is None else epoch
        index = (idx + epoch * self.num_steps) % len(self.point_inds)
        cloud_ind = int(self.cloud_inds[index])
        point_ind = int(self.point_inds[index])
        sp = self.sub_points[cloud_ind]
        gi = self.sub_indexes[cloud_ind]
        rng = np.random.default_rng((self._sample_seed, index))
        pick = sp[point_ind].reshape(1, 3) \
            + self.center_noise[index].astype(np.float32)

        # sorted-by-distance radius query, retried at twice the radius
        query_inds = gi.query_radius_sorted(pick[0], self.in_radius)
        if len(query_inds) == 0:
            query_inds = gi.query_radius_sorted(pick[0], 2 * self.in_radius)
        cur = len(query_inds)
        if self.num_points < cur:
            keep = query_inds[: self.num_points]
            input_inds = keep[rng.permutation(self.num_points)]
            mask = np.ones(self.num_points, np.float32)
        else:
            query_inds = query_inds[rng.permutation(cur)]
            pad = rng.integers(0, cur, self.num_points - cur)
            input_inds = np.concatenate([query_inds, query_inds[pad]])
            mask = np.zeros(self.num_points, np.float32)
            mask[:cur] = 1.0

        points = sp[input_inds] - pick
        feats = self.sub_features[cloud_ind][input_inds]
        if self.feature_drop > 0 and rng.random() < self.feature_drop:
            feats = np.zeros_like(feats)
        feats = pad_features_to_3(feats)
        if self.transforms is not None:
            points = self.transforms(points, rng)
        return {
            "points": points.astype(np.float32),
            "mask": mask,
            "features": feats.astype(np.float32),
            "labels": self.sub_labels[cloud_ind][input_inds].astype(
                np.int32),
            "cloud_ind": np.int64(cloud_ind),
            "input_inds": input_inds.astype(np.int64),
        }

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.get(idx)

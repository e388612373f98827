"""Offline evaluation: Chamfer-ratio tables, the noise and outlier ratios,
a train-free estimate of a cloud's noise sigma, and the voting evaluation
of outlier segmentation.

Counterpart of ``deep3dpointclouddenoising_tpu/evaluate.py``, with the
same arithmetic:

* :func:`chamfer_ratio_table`: per shape CD(clean, denoised) /
  CD(clean, noisy) and the absolute CDs, and their mean;
* :func:`performance_table`: the noise ratio (mean distance to the nearest
  clean point) and the outlier ratio (the share farther than a threshold);
* :func:`estimate_noise_sigma`: the local-plane residual that routes a
  cloud to the low-noise or the high-noise checkpoint in ``infer``;
* :func:`evaluate_outlier_segmentation`: class probabilities of covering
  patches voted onto each (sub-)cloud, projected onto the full clouds,
  and the confusion metrics.

Nearest-neighbour distances come from a host KD-tree, or with ``device``
from :func:`_nn_dists_device`, a chunked brute force in torch on the
card.
"""
from __future__ import annotations

import glob
import os
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from scipy.spatial import cKDTree

from .data.loader import BatchLoader
from .data.meshio import read_ply, write_ply
from .data.transforms import (BatchPointcloudRandomRotate,
                              BatchPointcloudScaleAndJitter)
from .utils.device import resolve_device
from .utils.metrics import confusion_matrix, metrics_from_confusion
from .utils.spatial import GridIndex

DeviceArg = Union[bool, str, torch.device, None]


def _nn_dists(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Euclidean distance from each x point to its nearest y point, by a
    host KD-tree."""
    return cKDTree(np.asarray(y)).query(np.asarray(x), workers=-1)[0]


def _nn_dists_device(x: np.ndarray, y: np.ndarray, chunk: int = 2048,
                     device=None) -> np.ndarray:
    """Nearest-neighbour distances by brute force in torch on ``device``
    (default: the card; raises without one).

    Per chunk of ``chunk`` queries, the squared distances to every y point
    are summed coordinate by coordinate in the difference form
    ``sum_d (x_d - y_d)^2``, in float32 elementwise arithmetic: no matrix
    product, so no TF32 setting can reach them, and no cancellation of
    ``|x|^2 + |y|^2 - 2 x.y`` between near-duplicate points.  The argmin
    picks the neighbour and the distance is recomputed from it as the norm
    of the difference, as the JAX package does.  Returns float32.
    """
    device = resolve_device(device)
    xs = torch.as_tensor(np.asarray(x, np.float32)).to(device)
    ys = torch.as_tensor(np.asarray(y, np.float32)).to(device)
    out = []
    with torch.inference_mode():
        for i in range(0, len(xs), chunk):
            xc = xs[i:i + chunk]
            d2 = (xc[:, 0:1] - ys[:, 0]).square_()
            for k in (1, 2):
                d2.add_((xc[:, k:k + 1] - ys[:, k]).square_())
            nn = ys[d2.argmin(dim=1)]
            out.append(torch.linalg.vector_norm(xc - nn, dim=-1))
        dists = torch.cat(out) if out else xs.new_zeros(0)
        return dists.cpu().numpy()


def _nn_fn(device: DeviceArg):
    """The NN-distance function for ``device``: False or None -> the host
    KD-tree; True -> torch on the card; a device -> torch on it."""
    if device is None or device is False:
        return _nn_dists
    dev = None if device is True else device
    return lambda a, b: _nn_dists_device(a, b, device=dev)


def _cd(a: np.ndarray, b: np.ndarray, device: DeviceArg = False) -> float:
    """Symmetric L2 (squared) Chamfer distance."""
    nn = _nn_fn(device)
    da = nn(a, b)
    db = nn(b, a)
    return float((da ** 2).mean() + (db ** 2).mean())


def chamfer_ratio_table(clean: Sequence[np.ndarray],
                        noisy: Sequence[np.ndarray],
                        denoised: Sequence[np.ndarray],
                        names: Optional[Sequence[str]] = None,
                        device: DeviceArg = False
                        ) -> Dict[str, Dict[str, float]]:
    """Per-shape CD ratios and a 'mean' row; a ratio below 1 means the
    model improved the cloud.  ``device`` as in :func:`_nn_fn`."""
    names = list(names) if names is not None else [
        f"shape_{i}" for i in range(len(clean))]
    table: Dict[str, Dict[str, float]] = {}
    ratios, absolutes = [], []
    for name, c, n, d in zip(names, clean, noisy, denoised):
        cd_dn = _cd(c, d, device=device)
        cd_ns = _cd(c, n, device=device)
        ratio = cd_dn / max(cd_ns, 1e-12)
        table[name] = {"cd_denoised": cd_dn, "cd_noisy": cd_ns,
                       "ratio": ratio}
        ratios.append(ratio)
        absolutes.append(cd_dn)
    table["mean"] = {"cd_denoised": float(np.mean(absolutes)),
                     "cd_noisy": float(np.mean(
                         [t["cd_noisy"] for k, t in table.items()
                          if k != "mean"])),
                     "ratio": float(np.mean(ratios))}
    return table


def estimate_noise_sigma(points: np.ndarray, k: int = 16,
                         sample: int = 4096, seed: int = 0) -> float:
    """Train-free estimate of a cloud's gaussian noise sigma.

    For a random sample of points, the ``k`` nearest neighbours are
    centred and the square root of their covariance's smallest eigenvalue
    is the out-of-plane residual; the median over the sample estimates
    sigma on a locally flat surface (curvature adds a small bias).
    """
    pts = np.asarray(points, np.float64)
    if len(pts) <= k:
        return 0.0
    rng = np.random.default_rng(seed)
    take = pts if len(pts) <= sample else \
        pts[rng.choice(len(pts), sample, replace=False)]
    _, idx = cKDTree(pts).query(take, k=k, workers=-1)
    nbr = pts[idx]
    nbr = nbr - nbr.mean(axis=1, keepdims=True)
    cov = np.einsum("ski,skj->sij", nbr, nbr) / k
    lam = np.linalg.eigvalsh(cov)  # ascending per row
    return float(np.median(np.sqrt(np.maximum(lam[:, 0], 0.0))))


def performance_table(clean: Sequence[np.ndarray],
                      clouds: Sequence[np.ndarray],
                      outlier_threshold: float = 0.05,
                      names: Optional[Sequence[str]] = None
                      ) -> Dict[str, Dict[str, float]]:
    """Noise ratio and outlier ratio per cloud against its clean cloud."""
    names = list(names) if names is not None else [
        f"shape_{i}" for i in range(len(clean))]
    table: Dict[str, Dict[str, float]] = {}
    for name, c, x in zip(names, clean, clouds):
        d = _nn_dists(x, c)
        table[name] = {
            "noise_ratio": float(d.mean()),
            "outlier_ratio": float((d > outlier_threshold).mean()),
        }
    vals = [t for k, t in table.items() if k != "mean"]
    table["mean"] = {
        "noise_ratio": float(np.mean([t["noise_ratio"] for t in vals])),
        "outlier_ratio": float(np.mean([t["outlier_ratio"] for t in vals])),
    }
    return table


def format_cd_table(table: Dict[str, Dict[str, float]]) -> str:
    lines = [f"{'shape':<40}{'CD(denoised)':>15}{'CD(noisy)':>15}"
             f"{'ratio':>10}"]
    for name, row in table.items():
        lines.append(f"{name:<40}{row['cd_denoised']:>15.6g}"
                     f"{row['cd_noisy']:>15.6g}{row['ratio']:>10.4f}")
    return "\n".join(lines)


def format_performance_table(table: Dict[str, Dict[str, float]]) -> str:
    lines = [f"{'shape':<40}{'noise_ratio':>15}{'outlier_ratio':>15}"]
    for name, row in table.items():
        lines.append(f"{name:<40}{row['noise_ratio']:>15.6g}"
                     f"{row['outlier_ratio']:>15.4f}")
    return "\n".join(lines)


def read_ply_tree(in_dir: str, subdirs: Sequence[str]
                  ) -> Tuple[List[str], Dict[str, List[np.ndarray]]]:
    """The clouds of a ``clean/`` + ``subdirs`` PLY tree, as ``infer``
    writes it: the names of ``clean/*.ply`` in sorted order, and for
    ``clean`` and each of ``subdirs`` the clouds of those names."""
    names: List[str] = []
    clouds: Dict[str, List[np.ndarray]] = {s: [] for s in ("clean",
                                                          *subdirs)}
    for f in sorted(glob.glob(os.path.join(in_dir, "clean", "*.ply"))):
        base = os.path.basename(f)
        names.append(base[:-4])
        for sub in clouds:
            clouds[sub].append(read_ply(os.path.join(in_dir, sub,
                                                     base))["vertex"])
    return names, clouds


def _add_seg_votes(in_flight: deque, vote_sum, vote_cnt) -> None:
    """Wait for the oldest in-flight probabilities and add them to the
    votes of the batch's real slots."""
    probs, batch = in_flight.popleft()
    probs = probs.cpu().numpy()
    masks = batch["mask"] > 0
    for i in range(len(probs)):
        c = int(batch["cloud_ind"][i])
        inds = batch["input_inds"][i][masks[i]]
        vote_sum[c][inds] += probs[i][masks[i]]
        vote_cnt[c][inds] += 1


def evaluate_outlier_segmentation(predict_fn: Callable, dataset, *,
                                  batch_size: int = 8,
                                  num_votes: int = 1,
                                  vote_transform=None,
                                  seed: int = 0,
                                  write_dir: Optional[str] = None
                                  ) -> Dict[str, float]:
    """Voting evaluation of an outlier-segmentation model over whole
    clouds.

    ``predict_fn(batch)`` gives the (B, N, 2) logits of a batch of
    ``dataset`` (an ``OutlierSegmentationDataset`` of a test split, whose
    patches cover every cloud) as a tensor; their softmax, on its device,
    votes in float64 on the host onto each patch's sub-cloud points, and
    each point's mean decides its class.  A point no patch voted on takes
    the class of its nearest voted point.  The classes project onto the
    full clouds (``dataset.projections``) and are counted against the
    labels.  Rounds past the first transform each batch's points by
    ``vote_transform(points, rng)`` (default: a random rotation about z,
    then ``BatchPointcloudScaleAndJitter``), ``rng`` one generator seeded
    with ``seed`` and drawn in batch order.  With ``write_dir``, each
    cloud's ``<name>_eval.ply`` holds its points, the outlier
    probability, the class and the label.  Up to two batches stay in
    flight.  Returns ``utils.metrics.metrics_from_confusion``'s dict."""
    num_classes = 2
    vote_sum = [np.zeros((len(p), num_classes), np.float64)
                for p in dataset.sub_points]
    vote_cnt = [np.zeros(len(p), np.int64) for p in dataset.sub_points]
    if vote_transform is None and num_votes > 1:
        rotate = BatchPointcloudRandomRotate(0.0, 0.0, np.pi)
        jitter = BatchPointcloudScaleAndJitter()

        def vote_transform(pts, rng):
            return jitter(rotate(pts, rng), rng)

    rng = np.random.default_rng(seed)
    loader = BatchLoader(dataset, batch_size, drop_last=False)
    in_flight: deque = deque()
    for vote in range(num_votes):
        for batch in loader.epoch_iter(0):
            if vote > 0:
                batch = dict(batch,
                             points=vote_transform(batch["points"], rng))
            in_flight.append((torch.softmax(predict_fn(batch), dim=-1),
                              batch))
            while len(in_flight) > 2:
                _add_seg_votes(in_flight, vote_sum, vote_cnt)
    while in_flight:
        _add_seg_votes(in_flight, vote_sum, vote_cnt)

    conf = np.zeros((num_classes, num_classes), np.int64)
    for c, points in enumerate(dataset.clouds_points):
        probs = vote_sum[c] / np.maximum(vote_cnt[c], 1)[:, None]
        preds = probs.argmax(axis=1)
        unvoted = vote_cnt[c] == 0
        if unvoted.any() and (~unvoted).any():
            sub = dataset.sub_points[c]
            nearest = GridIndex(sub[~unvoted]).nearest_many(sub[unvoted])
            preds[unvoted] = preds[~unvoted][nearest]
        full_preds = preds[dataset.projections[c]]
        labels = np.asarray(dataset.clouds_labels[c]).squeeze()
        conf += confusion_matrix(labels, full_preds, num_classes)
        if write_dir is not None:
            os.makedirs(write_dir, exist_ok=True)
            name = dataset.cloud_names[c].replace(os.sep, "_")
            full_probs = probs[dataset.projections[c]][:, 1]
            write_ply(os.path.join(write_dir, f"{name}_eval.ply"),
                      [points, full_probs.astype(np.float32),
                       full_preds.astype(np.float32),
                       labels.astype(np.float32)],
                      ["vertex", "proba", "pred", "GT"])
    return metrics_from_confusion(conf)

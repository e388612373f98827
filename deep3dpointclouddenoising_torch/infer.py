"""Full-shape denoising with overlapping-patch vote averaging.

Counterpart of the voting path of ``deep3dpointclouddenoising_tpu/infer.py``
and of ``scripts/infer.py``: cover each test shape with grid-subsampled
patch centres, run the offset U-Net per batch of patches, accumulate each
point's offset votes (``sums[inds] += pred; counts[inds] += 1``), divide
once at the end, and write the denoised cloud = noisy + mean offset.

Run it as::

    python -m deep3dpointclouddenoising_torch.infer \\
        --config_file cfgs/l1.yaml --data_root D --out_dir O \\
        [--checkpoint ckpt.pt] [--num_votes N] [--device cuda]

The repository holds no trained checkpoint: without ``--checkpoint`` the
model's weights are initialised from ``--seed``.
"""
from __future__ import annotations

import argparse
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .config import Config, load_config
from .data.loader import BatchLoader
from .data.meshio import write_ply
from .data.offset_dataset import OffsetDataset, fourier_input_mapping
from .models import build_offset_regression
from .utils.checkpoint import load_model_state
from .utils.device import resolve_device


def make_predict_fn(model: torch.nn.Module,
                    norm_factor: Optional[float] = None
                    ) -> Callable[[Dict[str, np.ndarray]], torch.Tensor]:
    """Full-batch predictor on the model's device, in eval mode.

    ``norm_factor``: for checkpoints trained with ``cfg.norm`` (inputs and
    targets divided by in_radius/100), patch inputs are scaled down and the
    predicted offsets back up.  The returned tensor stays on the device, so
    the caller decides when to wait for it.
    """
    model.eval()
    device = next(model.parameters()).device

    def predict(batch: Dict[str, np.ndarray]) -> torch.Tensor:
        with torch.inference_mode():
            points, mask, features = (
                torch.from_numpy(np.ascontiguousarray(batch[k])).to(
                    device, non_blocking=True)
                for k in ("points", "mask", "features"))
            if norm_factor:
                points = points / norm_factor
                features = features / norm_factor
            out = model(points, mask, features)
            return out * norm_factor if norm_factor else out

    return predict


def _drain_one(in_flight: deque, sums, counts) -> None:
    """Wait for the oldest in-flight prediction and add its votes; offset
    channels of a rotated round are rotated back first."""
    pred, batch, rot = in_flight.popleft()
    pred = pred.cpu().numpy() if isinstance(pred, torch.Tensor) \
        else np.asarray(pred)
    if rot is not None:
        pred = pred.copy()
        pred[..., :3] = np.einsum("bni,bji->bnj", pred[..., :3], rot)
    masks = batch["mask"] > 0
    for b in range(pred.shape[0]):
        ci = int(batch["cloud_ind"][b])
        inds = batch["input_inds"][b][masks[b]]
        sums[ci][inds] += pred[b][masks[b]]
        counts[ci][inds] += 1.0


def _rotated_batch(batch, dataset, rng):
    """Random z-rotation of one batch for an augmentation vote round.

    Features must describe the rotated geometry: xyz features are the
    rotated points, Fourier features are recomputed from them; any other
    feature kind cannot be re-derived and raises.
    """
    theta = rng.uniform(0, 2 * np.pi, size=len(batch["points"]))
    c, s_ = np.cos(theta), np.sin(theta)
    rot = np.zeros((len(theta), 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 1] = c, -s_
    rot[:, 1, 0], rot[:, 1, 1] = s_, c
    rot[:, 2, 2] = 1.0
    pts = np.einsum("bni,bij->bnj", batch["points"], rot)
    feats = batch["features"]
    if feats.shape[-1] == 3:
        feats = pts.copy()
    elif getattr(dataset, "fourier_features", False):
        feats = fourier_input_mapping(
            pts, dataset.fourier_B).astype(feats.dtype)
    else:
        raise NotImplementedError(
            f"num_votes > 1 with {feats.shape[-1]}-dim non-Fourier "
            "features: cannot recompute features for the rotated patch")
    return dict(batch, points=pts, features=feats), rot


def _prepared_batches(loader, dataset, num_votes: int):
    """Yield (batch, rot) for every vote round (rot is None in round 0);
    the rotations are drawn from a generator seeded with 0."""
    rng = np.random.default_rng(0)
    for vote in range(num_votes):
        for batch in loader:
            if vote > 0:
                yield _rotated_batch(batch, dataset, rng)
            else:
                yield batch, None


def predict_offsets_voting(predict_fn, dataset: OffsetDataset,
                           batch_size: int = 16, num_votes: int = 1
                           ) -> List[np.ndarray]:
    """Per-cloud vote-averaged offsets (P_cloud, 3).

    Rounds past the first rotate each patch by a random z-angle, predict,
    and rotate the offsets back before they vote.  Up to two predictions
    stay in flight, so the host prepares the next batch while the card
    computes.
    """
    sums = [np.zeros((len(s.points), 3), np.float64)
            for s in dataset.shapes]
    counts = [np.zeros((len(s.points), 1), np.float64)
              for s in dataset.shapes]
    loader = BatchLoader(dataset, batch_size)
    in_flight: deque = deque()
    for batch, rot in _prepared_batches(loader, dataset, num_votes):
        in_flight.append((predict_fn(batch), batch, rot))
        while len(in_flight) > 2:
            _drain_one(in_flight, sums, counts)
    while in_flight:
        _drain_one(in_flight, sums, counts)
    return [(s / np.maximum(c, 1.0)).astype(np.float32)
            for s, c in zip(sums, counts)]


def denoise_clouds(predict_fn, dataset: OffsetDataset,
                   batch_size: int = 16, num_votes: int = 1
                   ) -> List[Dict[str, np.ndarray]]:
    """Per cloud: noisy, denoised, the averaged offsets, the labels and the
    ground-truth offsets."""
    offsets = predict_offsets_voting(predict_fn, dataset, batch_size,
                                     num_votes)
    return [{"noisy": shape.points, "offsets": off,
             "denoised": shape.points + off, "labels": shape.labels,
             "gt_offsets": shape.offsets}
            for shape, off in zip(dataset.shapes, offsets)]


def make_dataset(cfg: Config, data_root: str,
                 split: str = "qualitative_test") -> OffsetDataset:
    return OffsetDataset(
        data_root, split, in_radius=cfg.in_radius,
        num_points=cfg.num_points, noise_type=cfg.noise_type,
        noise_level=cfg.noise_level,
        num_points_per_shape=cfg.num_points_per_shape,
        outlier_proportion=cfg.outlier_percentage,
        fourier_features=bool(cfg.fourier_features),
        sample_dl_patches=cfg.sample_Dl_patches, seed=cfg.rng_seed)


def load_model(cfg: Config, device, checkpoint: Optional[str] = None,
               seed: int = 0) -> torch.nn.Module:
    """The offset model in eval mode on ``device``: weights from a
    checkpoint (a training checkpoint or a saved ``state_dict``), else
    initialised by a generator seeded with ``seed``."""
    model = build_offset_regression(
        cfg, generator=torch.Generator().manual_seed(seed))
    if checkpoint:
        model.load_state_dict(load_model_state(checkpoint))
    return model.to(device).eval()


def write_results(out_dir: str, dataset: OffsetDataset,
                  results: List[Dict[str, np.ndarray]]) -> None:
    """noisy/, denoised/ and clean/ PLY trees."""
    for sub in ("noisy", "denoised", "clean"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    for name, shape, res in zip(dataset.cloud_names, dataset.shapes,
                                results):
        base = os.path.basename(name)
        write_ply(os.path.join(out_dir, "noisy", base + ".ply"),
                  [res["noisy"], res["labels"].astype(np.float32)],
                  ["vertex", "gt_outlier"])
        write_ply(os.path.join(out_dir, "denoised", base + ".ply"),
                  [res["denoised"]], ["vertex"])
        write_ply(os.path.join(out_dir, "clean", base + ".ply"),
                  [shape.points + shape.offsets], ["vertex"])


def run(config_file: str, data_root: str, out_dir: str,
        checkpoint: Optional[str] = None, num_votes: int = 1, seed: int = 0,
        device=None):
    """The command line's work: denoise every ``qualitative_test`` shape
    under ``data_root`` and write the PLY trees.  Returns the dataset, the
    per-cloud results and the seconds the voting took."""
    device = resolve_device(device)
    cfg = load_config(config_file)
    dataset = make_dataset(cfg, data_root)
    model = load_model(cfg, device, checkpoint, seed)
    print(f"weights: {checkpoint}" if checkpoint else
          f"weights: no checkpoint, initialised from --seed {seed}")
    norm_factor = float(cfg.in_radius) / 100.0 if cfg.norm else None
    predict = make_predict_fn(model, norm_factor=norm_factor)
    t0 = time.perf_counter()
    results = denoise_clouds(predict, dataset, batch_size=int(cfg.batch_size),
                             num_votes=num_votes)
    seconds = time.perf_counter() - t0
    write_results(out_dir, dataset, results)
    return dataset, results, seconds


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(
        "python -m deep3dpointclouddenoising_torch.infer",
        description="Denoise every qualitative_test shape by patch voting "
                    "and write noisy/denoised/clean PLY trees.")
    p.add_argument("--config_file", required=True)
    p.add_argument("--data_root", required=True)
    p.add_argument("--out_dir", default="inference_out")
    p.add_argument("--checkpoint", default=None,
                   help="torch state_dict; without it the weights are "
                        "initialised from --seed")
    p.add_argument("--num_votes", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dataset, results, seconds = run(
        args.config_file, args.data_root, args.out_dir, args.checkpoint,
        args.num_votes, args.seed, args.device)
    n_points = sum(len(s.points) for s in dataset.shapes)
    print(f"denoised {len(results)} clouds ({n_points} points, "
          f"{len(dataset)} patches, {args.num_votes} vote rounds) in "
          f"{seconds:.3f} s; wrote {args.out_dir}")


if __name__ == "__main__":
    main()

"""Full-shape denoising with overlapping-patch vote averaging.

Counterpart of the voting paths of ``deep3dpointclouddenoising_tpu/infer.py``
and of ``scripts/infer.py``: cover each test shape with grid-subsampled
patch centres, run the offset U-Net per batch of patches, accumulate each
point's offset votes (``sums[inds] += pred; counts[inds] += 1``), divide
once at the end, and write the denoised cloud = noisy + mean offset.

Two voting paths give the same offsets:

* host voting (:func:`predict_offsets_voting`): the host assembles each
  batch of patches, the card predicts, the host adds the votes;
* device voting (:func:`predict_offsets_voting_device`, ``--device_voting``):
  the clouds are uploaded once, patches are gathered on the card from the
  host's patch-index tables (the same ``BatchLoader`` over the same
  dataset, so the patch sets are identical), and the votes are summed on
  the card into per-cloud float64 sums and counts by ``index_add_``, with
  one copy back at the end.  The JAX package sums the votes by a sort and
  a prefix sum because scatters serialise on the TPU; ``index_add_`` is
  the direct form here.  It adds in float64 by atomics, whose order varies
  from run to run: that moves a sum by a few float64 ulps, far below a
  float32 offset's resolution, so the offsets equal the host path's
  float64 sums divided and rounded to float32 but where a sum sits on a
  float32 rounding boundary.

Vote rounds past the first rotate each patch about z by an angle drawn on
the host from one generator seeded with 0, in the same order on both
paths (the JAX device path draws them on the device), and rotate the
offsets back before they vote.  Both rotations are computed in float64,
where each coordinate is one rounding of an exact sum of two exact
products whatever the order or fused multiply-adds, so host and card
agree bitwise; the rotated points are then rounded to float32.

Routing (``--checkpoint_low``): each cloud's noise sigma is estimated
train-free (``evaluate.estimate_noise_sigma``); clouds below
``--route_sigma`` take the low-noise checkpoint's predictions, the others
the main checkpoint's.  A batch runs only the models its clouds are
routed to.  Run it as::

    python -m deep3dpointclouddenoising_torch.infer \\
        --config_file cfgs/synthetic_quality.yaml --data_root D \\
        --out_dir O [--checkpoint L/<experiment>/current.pt] \\
        [--checkpoint_low auto|none|PATH] [--route_sigma 0.002] \\
        [--noise_type gaussian] [--noise_level 0.005] [--num_votes N] \\
        [--device_voting] [--device cuda]

The repository holds no trained checkpoint: without ``--checkpoint`` the
model's weights are initialised from ``--seed`` (and nothing is routed).
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
from .data.device_sampler import cloud_data
from .data.loader import BatchLoader
from .data.meshio import write_ply
from .data.offset_dataset import OffsetDataset, fourier_input_mapping
from .evaluate import estimate_noise_sigma
from .models import build_offset_regression
from .utils.checkpoint import load_model_state
from .utils.device import resolve_device


def _on(device, x) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device,
                                                        non_blocking=True)


def make_predict_fn(model: torch.nn.Module,
                    norm_factor: Optional[float] = None
                    ) -> Callable[[Dict[str, np.ndarray]], torch.Tensor]:
    """Full-batch predictor on the model's device, in eval mode; the
    batch's arrays may be numpy arrays or tensors.

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
                _on(device, batch[k]) for k in ("points", "mask",
                                                "features"))
            if norm_factor:
                points = points / norm_factor
                features = features / norm_factor
            out = model(points, mask, features)
            return out * norm_factor if norm_factor else out

    return predict


def make_routed_predict_fn(predict_hi, predict_lo, route_low):
    """Per-cloud checkpoint routing inside one voting run: each patch
    takes the prediction of ``predict_lo`` where ``route_low`` (one bool
    per cloud) routes its cloud low, else of ``predict_hi``.  A batch
    whose patches all route one way runs that predictor alone; a mixed
    batch runs both and selects per patch on the device.  The batch's
    ``cloud_ind`` is read on the host."""
    route_low = np.asarray(route_low, bool)

    def predict(batch):
        sel = route_low[np.asarray(batch["cloud_ind"], np.int64)]
        if sel.all():
            return predict_lo(batch)
        if not sel.any():
            return predict_hi(batch)
        hi, lo = predict_hi(batch), predict_lo(batch)
        return torch.where(torch.from_numpy(sel).to(hi.device)[:, None, None],
                           lo, hi)

    return predict


def _z_rotations(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 3, 3) float32 rotations about z by angles uniform in [0, 2 pi)."""
    theta = rng.uniform(0, 2 * np.pi, size=n)
    c, s_ = np.cos(theta), np.sin(theta)
    rot = np.zeros((n, 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 1] = c, -s_
    rot[:, 1, 0], rot[:, 1, 1] = s_, c
    rot[:, 2, 2] = 1.0
    return rot


def _rotate(x, rot, back: bool = False):
    """float64 ``x @ rot`` per patch (``x @ rot^T`` with ``back``), for
    numpy arrays or tensors: x (B, N, 3), rot (B, 3, 3) float32.  Each
    output is one rounding of a sum of two exact products, so any
    order of the sum gives the same bits."""
    spec = "bni,bji->bnj" if back else "bni,bij->bnj"
    if isinstance(x, torch.Tensor):
        return torch.einsum(spec, x.double(), rot.double())
    return np.einsum(spec, np.asarray(x, np.float64),
                     np.asarray(rot, np.float64))


def _drain_one(in_flight: deque, sums, counts) -> None:
    """Wait for the oldest in-flight prediction and add its votes; offset
    channels of a rotated round are rotated back first."""
    pred, batch, rot = in_flight.popleft()
    pred = pred.cpu().numpy() if isinstance(pred, torch.Tensor) \
        else np.asarray(pred)
    if rot is not None:
        pred = pred.astype(np.float64)
        pred[..., :3] = _rotate(pred[..., :3], rot, back=True)
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
    rot = _z_rotations(rng, len(batch["points"]))
    pts = _rotate(batch["points"], rot).astype(np.float32)
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


def _results(dataset: OffsetDataset, offsets: List[np.ndarray]
             ) -> List[Dict[str, np.ndarray]]:
    return [{"noisy": shape.points, "offsets": off,
             "denoised": shape.points + off, "labels": shape.labels,
             "gt_offsets": shape.offsets}
            for shape, off in zip(dataset.shapes, offsets)]


def denoise_clouds(predict_fn, dataset: OffsetDataset,
                   batch_size: int = 16, num_votes: int = 1
                   ) -> List[Dict[str, np.ndarray]]:
    """Per cloud: noisy, denoised, the averaged offsets, the labels and the
    ground-truth offsets."""
    return _results(dataset, predict_offsets_voting(
        predict_fn, dataset, batch_size, num_votes))


def _patch_tables(dataset: OffsetDataset, batch_size: int):
    """The host path's patches as index tables, from the same loader:
    (input_inds (P, N) int64, real-slot counts (P,), cloud ids (P,),
    centres (P, 3) float32).  A test-split mask is a prefix of real slots
    (pads follow them; the centre swap exchanges two real slots), so its
    count gives it back; the centre is the point the dataset centred the
    patch on, with the same float32 arithmetic."""
    inds, cnts, cis = [], [], []
    for batch in BatchLoader(dataset, batch_size):
        inds.append(batch["input_inds"])
        cnts.append((batch["mask"] > 0).sum(-1))
        cis.append(batch["cloud_ind"])
    inds, cnts, cis = (np.concatenate(a) for a in (inds, cnts, cis))
    index = (np.arange(len(inds)) + dataset.epoch * dataset.num_steps) \
        % len(dataset.point_inds)
    pts = np.stack([dataset.shapes[c].points[p] for c, p in zip(
        dataset.cloud_inds[index], dataset.point_inds[index])])
    centres = pts + dataset.center_noise[index].astype(np.float32)
    return inds, cnts, cis, centres


def predict_offsets_voting_device(predict_fn, dataset: OffsetDataset,
                                  batch_size: int = 16, num_votes: int = 1,
                                  device=None) -> List[np.ndarray]:
    """Per-cloud vote-averaged offsets, voted on ``device`` (default: the
    card; raises without one).

    The clouds and the patch tables are uploaded once.  Each batch (the
    host path's batches, the ragged last one included) is gathered on the
    device, rotated in rounds past the first by angles drawn on the host
    in the host path's order, predicted by ``predict_fn`` (which gets
    device tensors and the batch's ``cloud_ind`` as a host array), rotated
    back and added into float64 sums and counts by ``index_add_``; a
    padding slot adds a vote of weight 0.  One copy back at the end.
    """
    device = resolve_device(device)
    data = cloud_data(dataset, device)
    n_clouds, max_n = data["points"].shape[:2]
    inds_h, cnts_h, cis_h, centres_h = _patch_tables(dataset, batch_size)
    inds, cnts, cis, centres = (_on(device, a) for a in (
        inds_h, cnts_h, cis_h, centres_h))
    n, N = inds.shape
    slots = torch.arange(N, device=device)
    sums = torch.zeros((n_clouds * max_n, 3), dtype=torch.float64,
                       device=device)
    counts = torch.zeros(n_clouds * max_n, dtype=torch.float64,
                         device=device)
    fourier_b = data.get("fourier_B")
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for vote in range(num_votes):
            for s in range(0, n, batch_size):
                e = min(s + batch_size, n)
                pi, ci = inds[s:e], cis[s:e]
                pts = data["points"][ci[:, None], pi] - centres[s:e, None]
                mask = (slots[None, :] < cnts[s:e, None]).float()
                rot = None
                if vote > 0:
                    rot = _on(device, _z_rotations(rng, e - s))
                    pts = _rotate(pts, rot).float()
                if fourier_b is not None:
                    proj = (2.0 * np.pi * pts).double() @ fourier_b.T
                    feats = torch.cat([proj.sin(), proj.cos()], -1).float()
                else:
                    feats = pts
                pred = predict_fn({"points": pts, "mask": mask,
                                   "features": feats,
                                   "cloud_ind": cis_h[s:e]})[..., :3]
                pred = _rotate(pred, rot, back=True) if rot is not None \
                    else pred.double()
                keys = (ci[:, None] * max_n + pi).reshape(-1)
                w = mask.double().reshape(-1)
                sums.index_add_(0, keys, pred.reshape(-1, 3) * w[:, None])
                counts.index_add_(0, keys, w)
    sums = sums.reshape(n_clouds, max_n, 3).cpu().numpy()
    counts = counts.reshape(n_clouds, max_n, 1).cpu().numpy()
    return [(sums[i, :len(sh.points)]
             / np.maximum(counts[i, :len(sh.points)], 1.0)).astype(np.float32)
            for i, sh in enumerate(dataset.shapes)]


def denoise_clouds_device(predict_fn, dataset: OffsetDataset,
                          batch_size: int = 16, num_votes: int = 1,
                          device=None) -> List[Dict[str, np.ndarray]]:
    """:func:`denoise_clouds` through the device voting path."""
    return _results(dataset, predict_offsets_voting_device(
        predict_fn, dataset, batch_size, num_votes, device))


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


def _auto_low_checkpoint(checkpoint: str) -> Optional[str]:
    """The low-noise specialist beside the main checkpoint:
    ``<log>/<experiment>/<leaf>`` -> the same leaf in the first of
    ``<experiment>_stable``, ``<experiment>_stable_low`` and, for an
    experiment named ``*_diverse``, ``*_stable_low``; None without one."""
    path = os.path.abspath(checkpoint)
    exp_dir, leaf = os.path.split(path)
    root, exp = os.path.split(exp_dir)
    if not exp:
        return None
    candidates = [exp + "_stable", exp + "_stable_low"]
    if exp.endswith("_diverse"):
        candidates.append(exp[: -len("_diverse")] + "_stable_low")
    for cand in candidates:
        p = os.path.join(root, cand, leaf)
        if os.path.isdir(p) or os.path.isfile(p):
            return p
    return None


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
        device=None, noise_type: Optional[str] = None,
        noise_level: Optional[float] = None,
        checkpoint_low: Optional[str] = "auto", route_sigma: float = 0.002,
        device_voting: bool = False) -> Dict:
    """The command line's work: denoise every ``qualitative_test`` shape
    under ``data_root`` and write the PLY trees.

    ``noise_type`` / ``noise_level`` override the config's eval noise.
    ``checkpoint_low``: a low-noise checkpoint, ``"auto"`` (the sibling
    that :func:`_auto_low_checkpoint` finds, if any) or None / ``"none"``.
    Returns a summary: the dataset, the per-cloud results, the seconds the
    voting took, the low checkpoint, and per cloud the estimated sigma and
    whether it routed low (empty without routing)."""
    device = resolve_device(device)
    cfg = load_config(config_file)
    if noise_type is not None:
        cfg.noise_type = noise_type
    if noise_level is not None:
        cfg.noise_level = noise_level
    dataset = make_dataset(cfg, data_root)
    model = load_model(cfg, device, checkpoint, seed)
    print(f"weights: {checkpoint}" if checkpoint else
          f"weights: no checkpoint, initialised from --seed {seed}")
    norm_factor = float(cfg.in_radius) / 100.0 if cfg.norm else None
    predict = make_predict_fn(model, norm_factor=norm_factor)
    if checkpoint_low == "auto":
        checkpoint_low = _auto_low_checkpoint(checkpoint) \
            if checkpoint else None
        if checkpoint_low:
            print(f"routing: auto-discovered low-noise checkpoint "
                  f"{checkpoint_low}")
    elif checkpoint_low in ("none", ""):
        checkpoint_low = None
    sigmas, route_low = [], []
    if checkpoint_low:
        sigmas = [estimate_noise_sigma(sh.points) for sh in dataset.shapes]
        route_low = [sg < route_sigma for sg in sigmas]
        for name, sg, lo in zip(dataset.cloud_names, sigmas, route_low):
            print(f"route {os.path.basename(name)}: est sigma {sg:.2e} -> "
                  f"{'LOW' if lo else 'HIGH'}-noise checkpoint")
        predict_lo = make_predict_fn(
            load_model(cfg, device, checkpoint_low), norm_factor=norm_factor)
        predict = make_routed_predict_fn(predict, predict_lo, route_low)
    t0 = time.perf_counter()
    if device_voting:
        results = denoise_clouds_device(predict, dataset,
                                        int(cfg.batch_size), num_votes,
                                        device)
    else:
        results = denoise_clouds(predict, dataset, int(cfg.batch_size),
                                 num_votes)
    seconds = time.perf_counter() - t0
    write_results(out_dir, dataset, results)
    return {"dataset": dataset, "results": results, "seconds": seconds,
            "checkpoint_low": checkpoint_low, "sigmas": sigmas,
            "route_low": route_low}


def main(argv: Optional[List[str]] = None) -> Dict:
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
    p.add_argument("--checkpoint_low", default="auto",
                   help="low-noise checkpoint for clouds whose estimated "
                        "noise sigma is below --route_sigma; 'auto' looks "
                        "for a sibling experiment directory of "
                        "--checkpoint named *_stable or *_stable_low "
                        "(*_diverse -> *_stable_low) holding the same "
                        "file; 'none' turns routing off")
    p.add_argument("--route_sigma", type=float, default=0.002,
                   help="routing threshold (absolute sigma, bounding-box "
                        "diagonal = 1)")
    p.add_argument("--noise_type", default=None,
                   help="override the config's eval noise type (e.g. "
                        "gaussian for a diverse-trained checkpoint)")
    p.add_argument("--noise_level", type=float, default=None,
                   help="override the config's eval noise sigma (fraction "
                        "of the bounding-box diagonal)")
    p.add_argument("--num_votes", type=int, default=1)
    p.add_argument("--device_voting", action="store_true",
                   help="gather patches and sum the votes on the device")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    summary = run(
        args.config_file, args.data_root, args.out_dir, args.checkpoint,
        args.num_votes, args.seed, args.device, args.noise_type,
        args.noise_level, args.checkpoint_low, args.route_sigma,
        args.device_voting)
    dataset, seconds = summary["dataset"], summary["seconds"]
    n_points = sum(len(s.points) for s in dataset.shapes)
    print(f"denoised {len(summary['results'])} clouds ({n_points} points, "
          f"{len(dataset)} patches, {args.num_votes} vote rounds, "
          f"{'device' if args.device_voting else 'host'} voting) in "
          f"{seconds:.3f} s = {n_points / seconds:.1f} points/s; wrote "
          f"{args.out_dir}")
    return summary


if __name__ == "__main__":
    main()

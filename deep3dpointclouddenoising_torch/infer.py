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

Full cleaning (``--full_cleaning``, :func:`clean_clouds`,
:func:`clean_clouds_device`): the four-output model's first three
channels pass through tanh in float32 where the model's output lies, on
the card, before they are rotated back and vote, so the votes average
physical offsets (tanh commutes neither with the rotation nor with the
mean); the fourth channel, the outlierness logit, votes raw.  The
averaged logit's sigmoid, in float32 on the host, is each point's outlier
probability; points at or above ``OUTLIER_THRESHOLD`` (0.5) are dropped
and the others denoised.  A checkpoint trained with ``cfg.norm`` predicts
``tanh(raw) = offset / f``, so the physical offset is ``f * tanh(raw)``
and the predictor leaves the outputs unscaled (``scale_outputs=False``).

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
        [--device_voting] [--full_cleaning | --pcn] [--device cuda]

The PointCleanNet baseline (``--pcn``, :func:`denoise_clouds_pcn`,
:func:`denoise_clouds_pcn_device`): one patch per cloud point (the PCN
``OffsetDataset``), the ``ResPCPNet`` predicting the centre's offset alone,
rotated back through its point STN and written to that point; losses
other than ``L1`` see the patch divided by ``in_radius`` and the offset
multiplied back.  The host path assembles each patch on the host (an
underfilled patch padded with cloud point 0); ``--pcn --device_voting``
cuts the patches on the card from the uploaded clouds
(``data.device_sampler``, pads cycling real neighbours) and writes the
predictions into one offsets tensor there, copied back once.  No routing.

Whole-cloud denoising (``--spatial``, :func:`denoise_clouds_spatial`, the
JAX package's ``denoise_clouds_spatial`` and ``scripts/infer.py``
``--spatial``): each cloud, zero-padded to a multiple of 2048 points, goes
through ONE U-Net forward of the point-sharded spatial model
(``parallel/spatial.py``), at the trained patch scale's geometry with the
subsample capacities grown with the cloud (n/4, n/16, n/32, n/128).  Each
point gets one prediction from the whole shape's context in place of an
average over patches.  Every aggregation operator is served (a CAA model
only at the slot counts it was built for).  Offset regression only, and
neither routing nor ``--device_voting``.  It runs in one process, or split over torchrun's
ranks with ``--multihost [--dist_backend nccl|gloo]``; then the
coordinator alone writes the PLY trees and prints the result line::

    torchrun --nproc_per_node=2 -m deep3dpointclouddenoising_torch.infer \
        --spatial --multihost --config_file C --data_root D --out_dir O \
        --checkpoint P [--dist_backend gloo --device cuda:0]

The repository holds no trained checkpoint: without ``--checkpoint`` the
model's weights are initialised from ``--seed`` (and nothing is routed).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .config import Config, load_config
from .data.device_sampler import DeviceSampler, cloud_data, torch_draws
from .data.loader import BatchLoader
from .data.meshio import write_ply
from .data.offset_dataset import OffsetDataset, fourier_input_mapping
from .evaluate import estimate_noise_sigma
from .models import (build_complete_denoising, build_offset_regression,
                     build_offset_regression_PCN)
from .parallel.dist import (coordinator_first, distributed_run,
                            is_coordinator, local_device)
from .parallel.spatial import build_spatial_forward, gather_points
from .train.pcn import rotate_back
from .utils.checkpoint import load_model_state
from .utils.device import resolve_device

# full cleaning drops a point whose voted outlier probability reaches this
OUTLIER_THRESHOLD = 0.5


def _on(device, x) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device,
                                                        non_blocking=True)


def make_predict_fn(model: torch.nn.Module,
                    norm_factor: Optional[float] = None,
                    scale_outputs: bool = True
                    ) -> Callable[[Dict[str, np.ndarray]], torch.Tensor]:
    """Full-batch predictor on the model's device, in eval mode; the
    batch's arrays may be numpy arrays or tensors.

    ``norm_factor``: for checkpoints trained with ``cfg.norm`` (inputs and
    targets divided by in_radius/100), patch inputs are scaled down and,
    with ``scale_outputs``, the offset channels ``[..., :3]`` back up; a
    fourth (outlierness) channel is never scaled.  Full cleaning passes
    ``scale_outputs=False``: its offsets are ``f * tanh(raw)``, not
    ``tanh(f * raw)``.  The returned tensor stays on the device, so the
    caller decides when to wait for it.
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
            if norm_factor and scale_outputs:
                out[..., :3] *= norm_factor
            return out

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


def _tanh_offsets(pred):
    """tanh of the three offset channels in float32 where ``pred`` lies
    (a tensor on its device, or a numpy array), the other channels
    unchanged."""
    if isinstance(pred, torch.Tensor):
        return torch.cat([torch.tanh(pred[..., :3]), pred[..., 3:]], dim=-1)
    pred = np.array(pred)
    pred[..., :3] = np.tanh(pred[..., :3])
    return pred


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
                           batch_size: int = 16, num_votes: int = 1,
                           num_outputs: int = 3, tanh_offsets: bool = False
                           ) -> List[np.ndarray]:
    """Per-cloud vote-averaged predictions (P_cloud, num_outputs).

    Rounds past the first rotate each patch by a random z-angle, predict,
    and rotate the offset channels back before they vote; with
    ``tanh_offsets`` (full cleaning) the offset channels pass through tanh
    first (:func:`_tanh_offsets`).  Up to two predictions stay in flight,
    so the host prepares the next batch while the card computes.
    """
    sums = [np.zeros((len(s.points), num_outputs), np.float64)
            for s in dataset.shapes]
    counts = [np.zeros((len(s.points), 1), np.float64)
              for s in dataset.shapes]
    loader = BatchLoader(dataset, batch_size)
    in_flight: deque = deque()
    for batch, rot in _prepared_batches(loader, dataset, num_votes):
        pred = predict_fn(batch)
        if tanh_offsets:
            pred = _tanh_offsets(pred)
        in_flight.append((pred, batch, rot))
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
                                  device=None, num_outputs: int = 3,
                                  tanh_offsets: bool = False
                                  ) -> List[np.ndarray]:
    """Per-cloud vote-averaged predictions (P_cloud, num_outputs), voted
    on ``device`` (default: the card; raises without one).

    The clouds and the patch tables are uploaded once.  Each batch (the
    host path's batches, the ragged last one included) is gathered on the
    device, rotated in rounds past the first by angles drawn on the host
    in the host path's order, predicted by ``predict_fn`` (which gets
    device tensors and the batch's ``cloud_ind`` as a host array), rotated
    back and added into float64 sums and counts by ``index_add_``; a
    padding slot adds a vote of weight 0.  One copy back at the end.
    ``tanh_offsets`` applies tanh to the offset channels before the
    rotation back, as the host path does.
    """
    device = resolve_device(device)
    data = cloud_data(dataset, device)
    n_clouds, max_n = data["points"].shape[:2]
    inds_h, cnts_h, cis_h, centres_h = _patch_tables(dataset, batch_size)
    inds, cnts, cis, centres = (_on(device, a) for a in (
        inds_h, cnts_h, cis_h, centres_h))
    n, N = inds.shape
    slots = torch.arange(N, device=device)
    sums = torch.zeros((n_clouds * max_n, num_outputs), dtype=torch.float64,
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
                                   "cloud_ind": cis_h[s:e]})
                if tanh_offsets:
                    pred = _tanh_offsets(pred)
                pred = pred.double()
                if rot is not None:
                    pred = torch.cat([_rotate(pred[..., :3], rot, back=True),
                                      pred[..., 3:]], dim=-1)
                keys = (ci[:, None] * max_n + pi).reshape(-1)
                w = mask.double().reshape(-1)
                sums.index_add_(0, keys,
                                pred.reshape(-1, num_outputs) * w[:, None])
                counts.index_add_(0, keys, w)
    sums = sums.reshape(n_clouds, max_n, num_outputs).cpu().numpy()
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


def spatial_config(cfg: Config, n_pad: int) -> Config:
    """``cfg`` for a whole cloud of ``n_pad`` slots: ``num_points`` the
    padded size and the subsample capacities n/4, n/16, n/32, n/128 (the
    reference's schedule); the geometry (radius, grid step, neighbour
    counts) stays at the trained patch scale."""
    out = copy.deepcopy(cfg)
    out.num_points = n_pad
    out.npoints = [max(n_pad // d, 1) for d in (4, 16, 32, 128)]
    return out


def _check_slot_counts(model: torch.nn.Module,
                       state_dict: Dict[str, torch.Tensor], n_pad: int
                       ) -> None:
    """Refuse weights whose shapes follow another slot count than the
    spatial model's for ``n_pad`` slots: CAA's point-axis Dense layers
    take the slot counts they were built for (JAX fails on the same
    mismatch with a shape error)."""
    mine = model.state_dict()
    odd = [k for k, v in state_dict.items()
           if k in mine and tuple(v.shape) != tuple(mine[k].shape)]
    if odd:
        raise ValueError(
            f"a cloud of {n_pad} slots needs the spatial model's "
            f"{tuple(mine[odd[0]].shape)} for {odd[0]}, and the weights "
            f"hold {tuple(state_dict[odd[0]].shape)} ({len(odd)} such "
            "tensors): a CAA model takes only the slot counts it was "
            "built for")


def denoise_clouds_spatial(state_dict: Dict[str, torch.Tensor], cfg: Config,
                           dataset: OffsetDataset, device=None,
                           size_bucket: int = 2048
                           ) -> List[Dict[str, np.ndarray]]:
    """Whole-cloud denoising in ONE point-sharded forward per cloud
    (JAX ``denoise_clouds_spatial``, ``infer.py:773-829``).

    Each cloud is zero-padded (mask 0) to a multiple of ``size_bucket``
    and goes through the offset model of :func:`spatial_config` with the
    weights ``state_dict`` (any patch-trained checkpoint's); inside a
    process group each rank computes its point rows and every rank gets
    the whole prediction.  A ``cfg.norm`` checkpoint sees the cloud over
    ``f = in_radius / 100`` and its offsets times ``f``.  One model per
    padded size, kept for the clouds after.  Returns :func:`denoise_clouds`'s
    per-cloud results."""
    f = float(cfg.in_radius) / 100.0 if cfg.norm else None
    forwards: Dict[int, Callable] = {}
    offsets = []
    for shape in dataset.shapes:
        n = len(shape.points)
        n_pad = -(-n // size_bucket) * size_bucket
        if n_pad not in forwards:
            model, forwards[n_pad] = build_spatial_forward(
                spatial_config(cfg, n_pad), "offset_regression", device)
            _check_slot_counts(model, state_dict, n_pad)
            model.load_state_dict(state_dict)
        pts = np.zeros((1, n_pad, 3), np.float32)
        pts[0, :n] = shape.points / f if f else shape.points
        mask = np.zeros((1, n_pad), np.float32)
        mask[0, :n] = 1.0
        rows = forwards[n_pad](pts, mask, pts.copy())
        pred = gather_points(rows, n_pad)[0, :n].cpu().numpy()
        offsets.append(pred * f if f else pred)
    return _results(dataset, offsets)


def _cleaned(dataset: OffsetDataset, raw: List[np.ndarray],
             norm_factor: Optional[float]) -> List[Dict[str, np.ndarray]]:
    """Per cloud, from the vote-averaged (P, 4) predictions: the offsets
    (times ``norm_factor`` when set), the outlier probability (the
    sigmoid of the averaged logit, float32), ``keep`` = probability below
    ``OUTLIER_THRESHOLD``, the kept points denoised, the noisy cloud and
    its labels."""
    results = []
    for shape, pred in zip(dataset.shapes, raw):
        off = pred[:, :3].copy()
        if norm_factor:
            off = off * norm_factor
        outlier_prob = 1.0 / (1.0 + np.exp(-pred[:, 3]))
        keep = outlier_prob < OUTLIER_THRESHOLD
        results.append({"noisy": shape.points, "offsets": off,
                        "outlier_prob": outlier_prob, "keep": keep,
                        "denoised": (shape.points + off)[keep],
                        "labels": shape.labels})
    return results


def clean_clouds(predict_fn, dataset: OffsetDataset, batch_size: int = 16,
                 norm_factor: Optional[float] = None, num_votes: int = 1
                 ) -> List[Dict[str, np.ndarray]]:
    """Full-cleaning inference by host voting: points predicted as
    outliers are dropped, the others denoised (:func:`_cleaned`).
    ``predict_fn`` gives the raw (B, N, 4) outputs (``scale_outputs``
    off)."""
    return _cleaned(dataset, predict_offsets_voting(
        predict_fn, dataset, batch_size, num_votes, num_outputs=4,
        tanh_offsets=True), norm_factor)


def clean_clouds_device(predict_fn, dataset: OffsetDataset,
                        batch_size: int = 16,
                        norm_factor: Optional[float] = None,
                        num_votes: int = 1, device=None
                        ) -> List[Dict[str, np.ndarray]]:
    """:func:`clean_clouds` through the device voting path."""
    return _cleaned(dataset, predict_offsets_voting_device(
        predict_fn, dataset, batch_size, num_votes, device, num_outputs=4,
        tanh_offsets=True), norm_factor)


def make_dataset(cfg: Config, data_root: str,
                 split: str = "qualitative_test",
                 architecture: str = "U-Net") -> OffsetDataset:
    return OffsetDataset(
        data_root, split, in_radius=cfg.in_radius,
        num_points=cfg.num_points, noise_type=cfg.noise_type,
        noise_level=cfg.noise_level,
        num_points_per_shape=cfg.num_points_per_shape,
        outlier_proportion=cfg.outlier_percentage,
        architecture=architecture,
        fourier_features=bool(cfg.fourier_features),
        sample_dl_patches=cfg.sample_Dl_patches, seed=cfg.rng_seed)


def pcn_scale(cfg: Config) -> float:
    """What a PCN patch is divided by before the network and its offset
    multiplied by after it: ``in_radius`` for losses other than ``L1``."""
    return float(cfg.in_radius) if cfg.loss != "L1" else 1.0


def make_pcn_predict_fn(model: torch.nn.Module, scale: float = 1.0
                        ) -> Callable[[np.ndarray], torch.Tensor]:
    """``points (B, N, 3) -> offsets (B, 3)`` of the patch centres on the
    model's device, in eval mode, rotated back through the point STN;
    the patch is divided by ``scale`` and the offset multiplied by it.
    The tensor stays on the device."""
    model.eval()
    device = next(model.parameters()).device

    def predict(points) -> torch.Tensor:
        with torch.inference_mode():
            pts = _on(device, points)
            pred, trans, _ = model(pts / scale if scale != 1.0 else pts)
            return rotate_back(pred, trans) * scale

    return predict


def denoise_clouds_pcn(predict_fn, dataset: OffsetDataset,
                       batch_size: int = 64) -> List[Dict[str, np.ndarray]]:
    """PointCleanNet-baseline denoising on the host path: one patch per
    cloud point (a PCN ``OffsetDataset`` of a test split), each centre's
    predicted offset written to that point.  ``predict_fn`` maps the
    batch's points (B, N, 3) to (B, 3) offsets (:func:`make_pcn_predict_fn`);
    up to two predictions stay in flight."""
    offsets = [np.zeros((len(s.points), 3), np.float32)
               for s in dataset.shapes]

    def scatter(pred, batch):
        pred = pred.cpu().numpy() if isinstance(pred, torch.Tensor) \
            else np.asarray(pred)
        for b in range(len(pred)):
            offsets[int(batch["cloud_ind"][b])][
                int(batch["input_inds"][b][0])] = pred[b]

    in_flight: deque = deque()
    for batch in BatchLoader(dataset, batch_size):
        in_flight.append((predict_fn(batch["points"]), batch))
        while len(in_flight) > 2:
            scatter(*in_flight.popleft())
    while in_flight:
        scatter(*in_flight.popleft())
    return _results(dataset, offsets)


def denoise_clouds_pcn_device(model: torch.nn.Module, cfg: Config,
                              dataset: OffsetDataset, batch_size: int = 64,
                              device=None) -> List[Dict[str, np.ndarray]]:
    """:func:`denoise_clouds_pcn` with the patches cut on ``device``
    (default: the card; raises without one): the clouds are uploaded once,
    each batch of the (cloud, point) table is sampled there
    (``DeviceSampler.sample`` without augmentation, its draws from one
    generator seeded with 0), predicted by ``model`` and written into one
    offsets tensor on the device; one copy back at the end.  Each result
    also holds ``patch_reals``: the real points of each point's patch."""
    device = resolve_device(device)
    sampler = DeviceSampler(dataset, cfg, device)
    table = torch.from_numpy(np.stack(
        [sampler.cloud_inds, sampler.point_inds], -1)).to(device)
    n_clouds, max_n = sampler.data["points"].shape[:2]
    out = torch.zeros((n_clouds, max_n, 3), device=device)
    reals = torch.zeros((n_clouds, max_n), dtype=torch.int32, device=device)
    scale = pcn_scale(cfg)
    generator = torch.Generator(device=device).manual_seed(0)
    model.eval()
    with torch.inference_mode():
        for s in range(0, len(table), batch_size):
            c = table[s:s + batch_size]
            batch = sampler.sample(c, torch_draws(
                sampler, generator, len(c), augment=False), augment=False)
            pts = batch["points"]
            pred, trans, _ = model(pts / scale if scale != 1.0 else pts)
            out[c[:, 0], c[:, 1]] = rotate_back(pred, trans) * scale
            reals[c[:, 0], c[:, 1]] = batch["mask"].sum(1).int()
    out, reals = out.cpu().numpy(), reals.cpu().numpy()
    results = _results(dataset, [out[i, :len(sh.points)]
                                 for i, sh in enumerate(dataset.shapes)])
    for i, (res, sh) in enumerate(zip(results, dataset.shapes)):
        res["patch_reals"] = reals[i, :len(sh.points)]
    return results


def load_model(cfg: Config, device, checkpoint: Optional[str] = None,
               seed: int = 0, full_cleaning: bool = False, pcn: bool = False
               ) -> torch.nn.Module:
    """The offset model (the full-cleaning model with ``full_cleaning``,
    the PCN baseline with ``pcn``) in eval mode on ``device``: weights
    from a checkpoint (a training checkpoint or a saved ``state_dict``),
    else initialised by a generator seeded with ``seed``."""
    build = build_offset_regression_PCN if pcn \
        else build_complete_denoising if full_cleaning \
        else build_offset_regression
    model = build(cfg, generator=torch.Generator().manual_seed(seed))
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
    """noisy/ (with ``gt_outlier``), denoised/ (the kept points only,
    after full cleaning) and clean/ PLY trees."""
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
        device_voting: bool = False, full_cleaning: bool = False,
        pcn: bool = False, spatial: bool = False) -> Dict:
    """The command line's work: denoise every ``qualitative_test`` shape
    under ``data_root`` and write the PLY trees.

    ``noise_type`` / ``noise_level`` override the config's eval noise.
    ``checkpoint_low``: a low-noise checkpoint, ``"auto"`` (the sibling
    that :func:`_auto_low_checkpoint` finds, if any) or None / ``"none"``.
    ``full_cleaning``: the four-output model, :func:`clean_clouds` (or
    :func:`clean_clouds_device`), outputs left unscaled by the predictor.
    ``pcn``: the PointCleanNet baseline (:func:`denoise_clouds_pcn`, or
    :func:`denoise_clouds_pcn_device`), no routing.
    ``spatial``: :func:`denoise_clouds_spatial`, offset regression only,
    no routing; inside a process group the coordinator alone writes.
    Returns a summary: the dataset, the per-cloud results, the seconds the
    voting took, the low checkpoint, and per cloud the estimated sigma and
    whether it routed low (empty without routing)."""
    device = resolve_device(device)
    if spatial and (device_voting or full_cleaning or pcn):
        raise ValueError("--spatial denoises by offset regression in one "
                         "forward per cloud: not with --device_voting, "
                         "--full_cleaning or --pcn")
    cfg = load_config(config_file)
    if noise_type is not None:
        cfg.noise_type = noise_type
    if noise_level is not None:
        cfg.noise_level = noise_level
    dataset = coordinator_first(lambda: make_dataset(
        cfg, data_root, architecture="PCN" if pcn else "U-Net"), "dataset")
    print(f"weights: {checkpoint}" if checkpoint else
          f"weights: no checkpoint, initialised from --seed {seed}")
    batch_size = int(cfg.batch_size)
    if spatial:
        if checkpoint_low == "auto":
            checkpoint_low = _auto_low_checkpoint(checkpoint) \
                if checkpoint else None
        if checkpoint_low not in (None, "none", ""):
            raise ValueError("--checkpoint_low routes the voting paths "
                             "only, not --spatial")
        state = load_model(cfg, device, checkpoint, seed).state_dict()
        t0 = time.perf_counter()
        results = denoise_clouds_spatial(state, cfg, dataset, device)
        seconds = time.perf_counter() - t0
        if is_coordinator():
            write_results(out_dir, dataset, results)
        return {"dataset": dataset, "results": results, "seconds": seconds,
                "checkpoint_low": None, "sigmas": [], "route_low": []}
    if pcn:
        model = load_model(cfg, device, checkpoint, seed, pcn=True)
        t0 = time.perf_counter()
        if device_voting:
            results = denoise_clouds_pcn_device(model, cfg, dataset,
                                                batch_size, device)
        else:
            results = denoise_clouds_pcn(
                make_pcn_predict_fn(model, pcn_scale(cfg)), dataset,
                batch_size)
        seconds = time.perf_counter() - t0
        write_results(out_dir, dataset, results)
        return {"dataset": dataset, "results": results, "seconds": seconds,
                "checkpoint_low": None, "sigmas": [], "route_low": []}
    model = load_model(cfg, device, checkpoint, seed, full_cleaning)
    norm_factor = float(cfg.in_radius) / 100.0 if cfg.norm else None
    scale_outputs = not full_cleaning
    predict = make_predict_fn(model, norm_factor, scale_outputs)
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
            load_model(cfg, device, checkpoint_low,
                       full_cleaning=full_cleaning), norm_factor,
            scale_outputs)
        predict = make_routed_predict_fn(predict, predict_lo, route_low)
    t0 = time.perf_counter()
    if full_cleaning and device_voting:
        results = clean_clouds_device(predict, dataset, batch_size,
                                      norm_factor=norm_factor,
                                      num_votes=num_votes, device=device)
    elif full_cleaning:
        results = clean_clouds(predict, dataset, batch_size,
                               norm_factor=norm_factor, num_votes=num_votes)
    elif device_voting:
        results = denoise_clouds_device(predict, dataset, batch_size,
                                        num_votes, device)
    else:
        results = denoise_clouds(predict, dataset, batch_size, num_votes)
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
    p.add_argument("--full_cleaning", action="store_true",
                   help="the four-output model: drop the points predicted "
                        "as outliers and denoise the others")
    p.add_argument("--pcn", action="store_true",
                   help="the PointCleanNet baseline: one patch per cloud "
                        "point, the ResPCPNet predicting its centre's "
                        "offset (with --device_voting the patches are cut "
                        "on the device)")
    p.add_argument("--spatial", action="store_true",
                   help="denoise each whole cloud in one forward with its "
                        "point axis split over the ranks (one rank "
                        "without --multihost) in place of patch voting; "
                        "offset regression only")
    p.add_argument("--multihost", action="store_true",
                   help="with --spatial: join torchrun's process group "
                        "(one process per card) and split each cloud's "
                        "points over its ranks")
    p.add_argument("--dist_backend", choices=("nccl", "gloo"),
                   help="the process group's backend (default: nccl for "
                        "cuda, gloo for cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.spatial and (args.device_voting or args.full_cleaning
                         or args.pcn):
        p.error("--spatial is offset regression in one forward per cloud: "
                "not with --device_voting, --full_cleaning or --pcn")
    if args.multihost and not args.spatial:
        p.error("--multihost splits a cloud's points over the ranks: "
                "with --spatial only")
    with distributed_run(args.device, args.dist_backend) \
            if args.multihost else contextlib.nullcontext():
        summary = run(
            args.config_file, args.data_root, args.out_dir,
            args.checkpoint, args.num_votes, args.seed,
            local_device(args.device), args.noise_type, args.noise_level,
            args.checkpoint_low, args.route_sigma, args.device_voting,
            args.full_cleaning, args.pcn, args.spatial)
        coordinator = is_coordinator()
    if not coordinator:
        return summary
    dataset, seconds = summary["dataset"], summary["seconds"]
    n_points = sum(len(s.points) for s in dataset.shapes)
    how = "one spatial forward per cloud" if args.spatial else (
        f"{len(dataset)} patches, {args.num_votes} vote rounds, "
        f"{'device' if args.device_voting else 'host'} voting")
    print(f"denoised {len(summary['results'])} clouds ({n_points} points, "
          f"{how}) in {seconds:.3f} s = {n_points / seconds:.1f} points/s; "
          f"wrote {args.out_dir}")
    if args.full_cleaning:
        removed = sum(int((~r["keep"]).sum()) for r in summary["results"])
        print(f"full cleaning removed {removed} of {n_points} points as "
              "outliers")
    return summary


if __name__ == "__main__":
    main()

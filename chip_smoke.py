#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run it from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It imports the port, torch, numpy and scipy only, and goes through ten
phases, each printed with its wall time:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: every kernel under ``deep3dpointclouddenoising_torch/csrc``, one
   ``nvcc`` each, all started together;
3. kernel vs plain: the KPConv kernel against its plain PyTorch version at
   the ten shapes of one flagship forward (``cfgs/l1.yaml``, B=16), with
   masked slots, a padded query row and M not a multiple of the tile;
   rtol 2e-4 / atol 2e-5; the wrapper's time (CUDA events) and the
   kernel's device time per call (torch.profiler) beside the bound;
4. whole model: ``cfgs/l1.yaml`` at width 144, depth 2, B=16, N=500, with
   seeded weights whose final Dense and BatchNorm running stats are O(1),
   kernel path against plain path on one pyramid, each output element
   within the larger of rtol 5e-4 / atol 5e-5 and three times its own
   float32 noise (the plain path against the plain path in float64;
   ``utils/grad_check.check_forward``), the element nearest its limit
   printed;
5. serving (the inference path): an icosphere and a torus as a
   ``qualitative_test`` split, denoised by the inference entry point at
   full width; every output finite and the kernel launched 10 times per
   batch;
6. backward kernel vs plain: the KPConv backward kernel against its plain
   version at the ten flagship shapes (and every influence at the stem
   shape), d_features and d_kernel_weights at rtol 3e-4 and an atol of
   1e-5 of the largest gradient, for the training path's variant and for
   the variant that also returns d_rel (held the same way); the training
   path's d_features and d_kernel_weights bitwise equal between two calls;
   times beside the bound over the live edges (float32, and at the 3xTF32
   rate); then the ten calls on a real pyramid's neighbourhoods (the
   batch of phase 7), each held the same way, with its live edges and
   in-degrees;
7. whole-model gradients: l1.yaml at width 144, B=16, one batch in train
   mode under the masked L1 loss; every parameter's gradient through the
   backward kernel against the plain backward on the same forward graph,
   and the kernel path against the plain path, each tensor within three
   times its own float32 noise (its plain gradient against the float64
   plain path), with a floor (``utils/grad_check.py`` says why); 10
   forward and 10 backward launches;
8. training (this slice's path): the training entry point at full width,
   B=16, N=500, two epochs of 20 steps on an icosphere and a torus as
   ``train`` and ``val`` splits; every loss finite, parameters and
   BatchNorm running stats changed, 10 forward and 10 backward launches per
   step, and the checkpoint reloads through ``infer.load_model``; then a
   profiler window over five more steps;
9. deployment (this slice's path): the synthetic shape tree written by
   ``make_synthetic_dataset``; two short trainings through the train entry
   point at width 144 with one ``--log_dir``,
   ``cfgs/synthetic_quality_diverse.yaml`` and
   ``cfgs/synthetic_quality_stable_low.yaml`` (``diverse_levels``), each
   DEPLOY_STEPS steps on clouds of DEPLOY_TRAIN_POINTS points; then the
   inference entry point on two held-out shapes (DEPLOY_SHAPES) of 140,000
   points at gaussian sigma 0.1% and 0.5% with the diverse checkpoint and
   ``--checkpoint_low auto``: the ``_stable_low`` sibling is found, every
   cloud routes LOW at 0.1% and HIGH at 0.5%, the forward kernel runs 10
   times for each model a batch is routed to, and each level runs with
   host voting and with ``--device_voting``, whose offsets agree per point
   within rtol 1e-5 / atol 1e-6 (and once more at ``--num_votes 2``);
   ``compute_cd`` on every output tree with and without ``--device``, the
   two tables within rtol 1e-5 per entry, and ``measure_performance`` once.
   The weights are barely trained, so no CD ratio is held to a value.
10. cleaning (this slice's path), on phase 9's shape tree: the
   full-cleaning train entry point on ``cfgs/synthetic_quality_cleaning.yaml``
   and the train entry point on ``cfgs/synthetic_quality_chamfer_l1.yaml``
   at width 144, DEPLOY_STEPS steps each on clouds of DEPLOY_TRAIN_POINTS
   points, every loss finite and 10 forward and 10 backward launches per
   step; then ``infer --full_cleaning`` on CLEANING_SHAPE alone at full
   size (140,000 points, 40% box outliers, gaussian sigma 0.5%) with host
   voting and with ``--device_voting``, one vote each, CLEANING_BATCHES
   batches and 10 forward launches per batch on each path; device offsets
   and outlier probabilities within rtol 1e-5 / atol 1e-6 of the host's,
   ``keep`` identical but for points within 1e-6 of the 0.5 threshold
   (counted); the points/s, the points removed, the removal's precision
   and recall against ``gt_outlier`` and the ``compute_cd`` tables (with
   and without ``--device``); then the Chamfer-L1 loss and its gradient
   on one real B=16, N=500 batch on the card against the same call on the
   CPU: matched indices equal but at near-ties (a squared-distance gap
   under 1e-6 of the distance, counted), the value within rtol 1e-5, the
   gradient within rtol 1e-4 / atol 1e-6 of its max-abs on the rows no
   tie touches; then a profiler window over train steps of each of the
   two models on a validation batch.  No CD ratio, precision or recall is
   held to a value.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so it does without a card.

``python3 chip_smoke.py --only-kernels`` runs phases 1-3 and 6 and prints
the two kernels' JSON records: copied into another checkout, it measures
that checkout's kernels the same way, for comparing two versions in one
call.
"""
from __future__ import annotations

import copy
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from deep3dpointclouddenoising_torch import compute_cd, infer, \
    make_synthetic_dataset, measure_performance, train_full_cleaning
from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.data.loader import BatchLoader
from deep3dpointclouddenoising_torch.data.meshio import save_off
from deep3dpointclouddenoising_torch.data.offset_dataset import OffsetDataset
from deep3dpointclouddenoising_torch.data.synthetic import (make_icosphere,
                                                            make_torus)
from deep3dpointclouddenoising_torch.losses import chamfer
from deep3dpointclouddenoising_torch.losses.build import \
    get_offset_regression_loss
from deep3dpointclouddenoising_torch.models import local_aggregation
from deep3dpointclouddenoising_torch.models.build import \
    build_offset_regression
from deep3dpointclouddenoising_torch.models.kernel_points import \
    create_kernel_points
from deep3dpointclouddenoising_torch.ops import _cuda
from deep3dpointclouddenoising_torch.ops.kpconv import (
    invert_neighbors_plain, kpconv_aggregate, kpconv_aggregate_backward,
    kpconv_aggregate_backward_plain, kpconv_aggregate_plain)
from deep3dpointclouddenoising_torch.profile_serving import \
    profile_train_steps
from deep3dpointclouddenoising_torch.train import __main__ as train_cli
from deep3dpointclouddenoising_torch.utils import grad_check

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "cfgs", "l1.yaml")
# published peaks of one H100 SXM at 700 W (NVIDIA data sheet): HBM3 bytes/s
# and float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# dense TF32 tensor-core FLOP/s (same sheet); 3xTF32 spends three of them
# on each float32 multiply-add of the neighbour contraction
PEAK_TF32_FLOP_S = 495e12
# profiler windows device_us takes before it gives up on an empty one
PROFILER_WINDOWS = 3
KERNEL_TOL = dict(rtol=2e-4, atol=2e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
# backward: the JAX package's gradient rtol; the atol is a fraction of the
# largest gradient, since d_kernel_weights sums up to 416,000 terms in
# another order than the plain einsum and d_features is added by atomics
BWD_RTOL, BWD_ATOL_FRAC = 3e-4, 1e-5
# deployment phase: the two configs trained (the second sets
# diverse_levels), steps of each, points per training and validation cloud
# (cut from 140,000), the two held-out shapes denoised (the two of the four
# with the fewest patches at 140,000 points), the eval noise levels and
# whether each routes low, and the device-vs-host vote tolerance
DEPLOY_CONFIGS = ("synthetic_quality_diverse", "synthetic_quality_stable_low")
DEPLOY_STEPS = 10
DEPLOY_TRAIN_POINTS = 20000
DEPLOY_SHAPES = ("cylinder_t", "ellipsoid_t")
DEPLOY_LEVELS = ((0.001, True), (0.005, False))
VOTE_TOL = dict(rtol=1e-5, atol=1e-6)
CD_RTOL = 1e-5
# cleaning phase: the full-cleaning and Chamfer configs trained, the shape
# cleaned (40% box outliers, gaussian sigma 0.5%), its batches of 16 at
# 140,000 points (12,078 patches), the band around the outlier threshold
# where host and device may decide apart, and the Chamfer tie and gradient
# tolerances
CLEANING_CONFIG = "synthetic_quality_cleaning"
CHAMFER_CONFIG = "synthetic_quality_chamfer_l1"
CLEANING_SHAPE = "cylinder_t"
CLEANING_LEVEL = 0.005
CLEANING_BATCHES = 755
KEEP_BAND = 1e-6
TIE_GAP = 1e-6
CHAMFER_RTOL = 1e-5
CHAMFER_GRAD_TOL = dict(rtol=1e-4, atol_frac=1e-6)
# (name, M, N, K, C, radius multiple of r0) of the ten aggregations of one
# flagship forward, B=16, P=15
FLAGSHIP_CALLS = [
    ("stem LA", 500, 500, 52, 72, 1), ("Bottleneck_0", 500, 500, 52, 72, 1),
    ("T1 strided", 125, 500, 52, 144, 1), ("L1", 125, 125, 39, 144, 2),
    ("T2 strided", 31, 125, 39, 288, 2), ("L2", 31, 31, 32, 288, 4),
    ("T3 strided", 15, 31, 32, 576, 4), ("L3", 15, 15, 26, 576, 8),
    ("T4 strided", 3, 15, 26, 1152, 8), ("L4", 3, 3, 26, 1152, 16),
]


def phase(name: str):
    """Print a phase's wall time when its block ends without raising."""
    class _Phase:
        def __enter__(self):
            print(f"== {name}", flush=True)
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None:
                print(f"== {name}: ok in "
                      f"{time.perf_counter() - self.t0:.3f} s", flush=True)
            return False
    return _Phase()


def check_close(got: torch.Tensor, want: torch.Tensor, rtol: float,
                atol: float, what: str):
    """Raise unless |got - want| <= atol + rtol |want| everywhere; return
    the max abs and max rel errors."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    diff = (got - want).abs()
    max_abs = diff.max().item()
    max_rel = (diff / want.abs().clamp(min=1e-30)).max().item()
    worst = (diff - rtol * want.abs()).max().item()
    if worst > atol:
        raise AssertionError(
            f"{what}: max abs err {max_abs:.3e}, max rel err {max_rel:.3e} "
            f"exceed rtol {rtol} / atol {atol}")
    return max_abs, max_rel


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kpconv_bound(B, M, N, K, C, P):
    """Least times (ms) for one aggregation: each input read once and the
    output written once at the HBM rate, and its float32 operations at the
    FMA rate; the bound is the larger.  Operations: 12 per (b, m, k, p) for
    the influence weight, 2 per (b, m, k, p, c) for the weighted neighbour
    sum, 2 per (b, m, p, c) for the kernel-point weights."""
    nbytes = 4 * (B * N * C + B * M * K * 5 + P * 3 + P * C + B * M * C)
    flops = 12 * B * M * K * P + 2 * B * M * K * P * C + 2 * B * M * P * C
    return nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3


def kpconv_bound_3xtf32(B, M, N, K, C, P):
    """kpconv_bound with the neighbour contraction (2 per (b, m, k, p, c))
    on the tensor cores as 3xTF32, three TF32 operations for each, and the
    influence weights and the kernel-point sum on the float32 units."""
    t_bytes, _ = kpconv_bound(B, M, N, K, C, P)
    t_ops = (3 * 2 * B * M * K * P * C / PEAK_TF32_FLOP_S
             + (12 * B * M * K * P + 2 * B * M * P * C) / PEAK_F32_FLOP_S)
    return t_bytes, t_ops * 1e3


def device_us(fn, kernel: str, iters: int, by_kernel: bool = False):
    """Device microseconds per call of the CUDA kernels whose name holds
    ``kernel`` ("" for every kernel), from torch.profiler over ``iters``
    calls of ``fn``: for each such kernel the mean over the launches the
    profiler recorded, summed over the kernels (with ``by_kernel``, also
    the means by kernel name).  The profiler does not always record every
    launch of a window (on the H100 machine it once kept 21 of 50, and
    now and then none), so the mean is over those it kept, and a window in
    which it kept none is taken again, up to PROFILER_WINDOWS times;
    raises when every window came back empty."""
    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if kernel in e.name \
                    and e.device_type == torch.autograd.DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    getattr(e, "device_time_total", 0.0))
        if by_name:
            break
    if not by_name:
        raise AssertionError(f"the profiler saw no {kernel} kernel in "
                             f"{PROFILER_WINDOWS} windows")
    means = {name: sum(us) / len(us) for name, us in by_name.items()}
    total = sum(means.values())
    return (total, means) if by_kernel else total


def kpconv_inputs(rng, B, M, N, K, C, P, radius, device):
    """Random aggregation inputs: neighbours inside the ball, about 30%
    masked slots, and the last query row padded as the model pads it (all
    indices 0, mask all ones)."""
    extent = 2.0 * radius / 5.0
    kp = create_kernel_points(1.5 * extent, P)
    idx = rng.integers(0, N, size=(B, M, K)).astype(np.int32)
    direction = rng.normal(size=(B, M, K, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    rel = direction * radius * rng.random((B, M, K, 1)) ** (1 / 3)
    mask = (rng.random((B, M, K)) > 0.3).astype(np.float32)
    idx[:, -1], mask[:, -1] = 0, 1.0
    arrays = (rng.normal(size=(B, N, C)).astype(np.float32), idx,
              rel.astype(np.float32), mask, kp,
              (rng.normal(size=(P, C)) * math.sqrt(2.0 / C)).astype(
                  np.float32))
    return [torch.from_numpy(a).to(device) for a in arrays], extent


def phase_kernels(cfg, device):
    """Kernel vs plain at the ten flagship shapes (and every influence at
    the stem shape); returns the kernel's JSON record, less launches."""
    rng = np.random.default_rng(0)
    B, P = int(cfg.batch_size), int(cfg.pseudo_grid.num_kernel_points)
    r0 = float(cfg.radius)
    rows = [(name, M, N, K, C, mult, "linear")
            for name, M, N, K, C, mult in FLAGSHIP_CALLS]
    rows += [("stem LA", 500, 500, 52, 72, 1, infl)
             for infl in ("gaussian", "constant")]
    worst_abs = 0.0
    sums = dict(ms=0.0, device_us=0.0, plain_ms=0.0, bound_ms=0.0,
                bytes=0.0, ops=0.0, bound_3xtf32=0.0)
    per_call = {}
    print("call M N K C influence | max_abs max_rel | kernel_ms device_us "
          "plain_ms bound_ms bound_by bound_3xtf32_ms")
    for name, M, N, K, C, mult, infl in rows:
        args, extent = kpconv_inputs(rng, B, M, N, K, C, P, r0 * mult,
                                     device)
        with torch.no_grad():
            got = kpconv_aggregate(*args, extent, infl)
            torch.cuda.synchronize()
            want = kpconv_aggregate_plain(*args, extent, infl)
            max_abs, max_rel = check_close(
                got, want, what=f"kpconv {name} {infl}", **KERNEL_TOL)
            ms = cuda_ms(lambda: kpconv_aggregate(*args, extent, infl), 200)
            dev_us = device_us(
                lambda: kpconv_aggregate(*args, extent, infl),
                "kpconv_fwd_kernel", 50)
            plain_ms = cuda_ms(
                lambda: kpconv_aggregate_plain(*args, extent, infl), 20)
        t_bytes, t_ops = kpconv_bound(B, M, N, K, C, P)
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        bound_tc = max(kpconv_bound_3xtf32(B, M, N, K, C, P))
        worst_abs = max(worst_abs, max_abs)
        if infl == "linear":
            per_call[name] = dev_us
            for key, v in (("ms", ms), ("device_us", dev_us),
                           ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                           ("bytes", t_bytes), ("ops", t_ops),
                           ("bound_3xtf32", bound_tc)):
                sums[key] += v
        print(f"{name} {M} {N} {K} {C} {infl} | {max_abs:.3e} "
              f"{max_rel:.3e} | {ms:.5f} {dev_us:.2f} {plain_ms:.5f} "
              f"{bound_ms:.5f} {bound_by} {bound_tc:.5f}", flush=True)
    print(f"ten flagship calls (linear), per forward: kernel {sums['ms']:.5f}"
          f" ms, device {sums['device_us'] / 1e3:.5f} ms, plain "
          f"{sums['plain_ms']:.5f} ms, bound {sums['bound_ms']:.5f} ms "
          f"(3xTF32 rate: {sums['bound_3xtf32']:.5f} ms)")
    return {
        "name": "kpconv_fwd", "route": "cuda",
        "source": "deep3dpointclouddenoising_torch/csrc/kpconv_fwd.cu",
        "replaces": "deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py:142",
        "also_replaces":
            "deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py:98",
        "max_abs_err": worst_abs, "ms": sums["ms"],
        "plain_ms": sums["plain_ms"], "bound_ms": sums["bound_ms"],
        "bound_by": "bytes" if sums["bytes"] >= sums["ops"]
        else "operations",
        "library_ms": None,
        "device_ms": sums["device_us"] / 1e3,
        "device_us_per_call": per_call,
        "bound_ms_3xtf32": sums["bound_3xtf32"],
        "timed_at": "sum over the ten calls of one l1.yaml forward, B=16; "
                    "ms: CUDA events around back-to-back wrapper calls "
                    "(host enqueue included); device_ms: torch.profiler",
        "cuda_kernels": ["kpconv_fwd_kernel"],
        "launches_are": "calls of the wrapper; each launches "
                        "kpconv_fwd_kernel once",
    }


def seeded_model(cfg, device, seed: int = 0):
    """l1.yaml model with seeded weights; the final Dense and every
    BatchNorm's running stats get O(1) values, so the output is O(1)."""
    model = build_offset_regression(cfg,
                                    torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(
                    rng.normal(size=buf.shape).astype(np.float32) * 0.5))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, size=buf.shape).astype(
                        np.float32)))
        dense = model.MultiDimHead_0.Dense_0
        dense.weight.copy_(torch.from_numpy(
            rng.normal(size=tuple(dense.weight.shape)).astype(np.float32)))
        dense.bias.copy_(torch.from_numpy(
            rng.normal(size=tuple(dense.bias.shape)).astype(np.float32)))
    return model.to(device).eval()


def patch_batch(cfg, seed: int):
    """Patch-like input: points on a noisy sphere cap of the patch radius,
    the last 50 slots of the last cloud padding, O(0.01) target offsets."""
    rng = np.random.default_rng(seed)
    B, N = int(cfg.batch_size), int(cfg.num_points)
    xyz = rng.normal(size=(B, N, 3))
    xyz = cfg.in_radius * xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    xyz = (xyz * rng.random((B, N, 1))).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[-1, -50:] = 0.0
    xyz[-1, -50:] = xyz[-1, :50]
    offsets = (rng.normal(size=(B, N, 3)) * 0.01).astype(np.float32)
    return {"points": xyz, "mask": mask, "features": xyz.copy(),
            "offsets": offsets}


def phase_model(cfg, device):
    """Whole width-144 model, kernel path against plain path on one
    pyramid, each output element within the larger of MODEL_TOL and three
    times its own float32 noise (``grad_check.check_forward``)."""
    model = seeded_model(cfg, device)
    batch = patch_batch(cfg, 1)
    xyz_t, mask_t = (torch.from_numpy(batch[k]).to(device)
                     for k in ("points", "mask"))
    with torch.inference_mode():
        pyramid = model.make_pyramid(xyz_t, mask_t)

        def head(m, feats):
            return m.MultiDimHead_0(pyramid, m.ResNetEncoder_0(pyramid,
                                                               feats))

        kpconv_aggregate.launches = 0
        got = head(model, xyz_t)
        torch.cuda.synchronize()
        if kpconv_aggregate.launches != 10:
            raise AssertionError(f"forward launched the kernel "
                                 f"{kpconv_aggregate.launches} times, not 10")
        # the plain path: the same modules with the plain version swapped
        # in for the wrapper, on the same pyramid; and the same in float64
        local_aggregation.kpconv_aggregate = kpconv_aggregate_plain
        try:
            want = head(model, xyz_t)
            want64 = head(copy.deepcopy(model).double(), xyz_t.double())
        finally:
            local_aggregation.kpconv_aggregate = kpconv_aggregate
        worst = grad_check.check_forward(got, want, want64, **MODEL_TOL)
        fixed = ((got - want).abs() - MODEL_TOL["rtol"] * want.abs()
                 > MODEL_TOL["atol"]).sum().item()
        noise = (want.double() - want64).abs().max().item()
        fwd_ms = cuda_ms(lambda: model(xyz_t, mask_t, xyz_t), 10)
    print(f"output {tuple(got.shape)}, |out| max {want.abs().max().item():.3f}"
          f"; kernel vs plain: max abs {worst['max_abs']:.3e}; nearest its "
          f"limit: output {worst['index']} = {worst['plain']:.6g}, off by "
          f"{worst['diff']:.3e} of limit {worst['limit']:.3e}; float32 "
          f"noise (plain vs float64) up to {noise:.3e}; elements over rtol "
          f"{MODEL_TOL['rtol']} / atol {MODEL_TOL['atol']} alone: {fixed}; "
          f"full forward (pyramid included) {fwd_ms:.3f} ms")


def phase_serving(cfg, device, workdir):
    """The main path: the inference entry point over a two-shape
    qualitative_test split; returns the kernel's launches in it."""
    data_root = os.path.join(workdir, "data")
    os.makedirs(os.path.join(data_root, "qualitative_test"))
    save_off(os.path.join(data_root, "qualitative_test", "sphere.off"),
             make_icosphere(4))
    save_off(os.path.join(data_root, "qualitative_test", "torus.off"),
             make_torus())
    out_dir = os.path.join(workdir, "out")
    kpconv_aggregate.launches = 0
    kpconv_aggregate_backward.launches = 0
    summary = infer.run(CONFIG, data_root, out_dir, device=device)
    launches = kpconv_aggregate.launches
    dataset, results, seconds = (summary[k] for k in ("dataset", "results",
                                                      "seconds"))
    if kpconv_aggregate_backward.launches:
        raise AssertionError("serving launched the backward kernel")
    batches = -(-len(dataset) // int(cfg.batch_size))
    for res, shape in zip(results, dataset.shapes):
        for key in ("offsets", "denoised"):
            if res[key].shape != shape.points.shape \
                    or not np.isfinite(res[key]).all():
                raise AssertionError(f"serving: bad {key} output")
    if launches != 10 * batches:
        raise AssertionError(f"serving launched the kernel {launches} "
                             f"times for {batches} batches")
    n_points = sum(len(s.points) for s in dataset.shapes)
    for sub in ("noisy", "denoised", "clean"):
        if len(os.listdir(os.path.join(out_dir, sub))) != len(results):
            raise AssertionError(f"serving: missing {sub} PLY files")
    print(f"clouds {len(results)}, points {n_points}, patches "
          f"{len(dataset)}, batches {batches}, kernel launches {launches}; "
          f"voting {seconds:.3f} s = {n_points / seconds:.1f} points/s, "
          f"{len(dataset) * int(cfg.num_points) / seconds:.1f} patch "
          f"points/s")
    return launches


def kpconv_bwd_bound(B, M, N, K, C, P, live):
    """Least times (ms) for one backward call of the training path (d_features
    and d_kernel_weights) with ``live`` live edges (mask != 0): features,
    indices, relative positions, masks, kernel points and weights and the
    upstream gradient read once, d_features and d_kernel_weights written
    once; float32 operations as the function needs them, grouped by support
    (H[b,n,p,c] = sum of w g over the edges that name n): 2 per (live edge,
    p, c) for H, 12 per (live edge, p) for the influence weights, and 2 per
    (b, n, p, c) for each of d_features = sum_p kw H and d_kernel_weights =
    sum_{b,n} feat H.  A masked edge has weight 0 and costs nothing."""
    nbytes = 4 * (2 * B * N * C + B * M * K * 5 + P * 3 + 2 * P * C
                  + B * M * C)
    flops = 2 * live * P * C + 12 * live * P + 4 * B * N * P * C
    return nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3


def kpconv_bwd_bound_3xtf32(B, M, N, K, C, P, live):
    """kpconv_bwd_bound with H's contraction on the tensor cores as 3xTF32,
    three TF32 operations for each of its 2 per (live edge, p, c), and the
    influence weights and both epilogues on the float32 units."""
    t_bytes, _ = kpconv_bwd_bound(B, M, N, K, C, P, live)
    t_ops = (3 * 2 * live * P * C / PEAK_TF32_FLOP_S
             + (12 * live * P + 4 * B * N * P * C) / PEAK_F32_FLOP_S)
    return t_bytes, t_ops * 1e3


def check_grad_close(got, want, what: str):
    """Backward kernel against plain: rtol BWD_RTOL and an atol of
    BWD_ATOL_FRAC of the largest entry; returns the max abs error."""
    scale = want.abs().max().item()
    max_abs, _ = check_close(got, want, BWD_RTOL, BWD_ATOL_FRAC * scale,
                             what)
    return max_abs


def check_reproducible(args, g, extent, infl, what: str):
    """Two calls of the training path's backward give bitwise equal
    d_features and d_kernel_weights."""
    first = kpconv_aggregate_backward(*args, g, extent, infl)
    second = kpconv_aggregate_backward(*args, g, extent, infl)
    torch.cuda.synchronize()
    for name, a, b in zip(("d_feat", "d_kw"), first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"backward {what}: {name} differs between "
                                 "two calls on the same inputs")


def pyramid_calls(cfg, device):
    """The ten aggregations' neighbourhoods of one flagship forward on a
    real pyramid (``patch_batch(cfg, 3)`` through ``make_pyramid``):
    (name, idx, rel, feature mask, radius multiple) each, the feature mask
    all ones for padding queries as the model makes it."""
    model = build_offset_regression(cfg, torch.Generator().manual_seed(0))
    model = model.to(device)
    batch = patch_batch(cfg, 3)
    xyz, mask = (torch.from_numpy(batch[k]).to(device)
                 for k in ("points", "mask"))
    with torch.no_grad():
        pyr = model.make_pyramid(xyz, mask)
    levels, trans = pyr.levels, pyr.transitions
    nbrs = [(levels[0].self_nbr, levels[0].mask)] * 2
    for i in range(1, len(levels)):
        nbrs += [(trans[i - 1].pool_nbr, levels[i].mask),
                 (levels[i].self_nbr, levels[i].mask)]
    calls = []
    for (name, M, N, K, C, mult), (nbr, qmask) in zip(FLAGSHIP_CALLS, nbrs):
        if tuple(nbr.idx.shape) != (int(cfg.batch_size), M, K):
            raise AssertionError(f"pyramid call {name}: idx "
                                 f"{tuple(nbr.idx.shape)}, expected M={M}, "
                                 f"K={K}")
        fmask = (nbr.mask + (1.0 - qmask[:, :, None])).contiguous()
        calls.append((name, M, N, K, C, mult, nbr.idx.contiguous(),
                      nbr.rel_xyz.contiguous(), fmask))
    return calls


def phase_backward(cfg, device):
    """Backward kernel vs plain at the ten flagship shapes (and every
    influence at the stem shape), bitwise reproducible at each; then the
    ten calls on a real pyramid's neighbourhoods; returns its JSON record,
    less launches."""
    rng = np.random.default_rng(2)
    B, P = int(cfg.batch_size), int(cfg.pseudo_grid.num_kernel_points)
    r0 = float(cfg.radius)
    rows = [(name, M, N, K, C, mult, "linear")
            for name, M, N, K, C, mult in FLAGSHIP_CALLS]
    rows += [("stem LA", 500, 500, 52, 72, 1, infl)
             for infl in ("gaussian", "constant")]
    worst_abs = 0.0
    sums = dict(ms=0.0, device_us=0.0, plain_ms=0.0, bound_ms=0.0,
                bytes=0.0, ops=0.0, bound_3xtf32=0.0)
    per_call, per_kernel = {}, {}
    print("call M N K C influence | d_feat, d_kw, d_rel max_abs | "
          "kernel_ms device_us plain_ms bound_ms bound_by "
          "bound_3xtf32_ms | with d_rel: kernel_ms")
    for name, M, N, K, C, mult, infl in rows:
        args, extent = kpconv_inputs(rng, B, M, N, K, C, P, r0 * mult,
                                     device)
        g = torch.from_numpy(rng.normal(size=(B, M, C)).astype(
            np.float32)).to(device)
        # the training path's variant (no d_rel), then the one with d_rel
        got = kpconv_aggregate_backward(*args, g, extent, infl)
        got_rel = kpconv_aggregate_backward(*args, g, extent, infl,
                                            need_rel=True)
        torch.cuda.synchronize()
        want = kpconv_aggregate_backward_plain(*args, g, extent, infl,
                                               need_rel=True)
        if got[2] is not None:
            raise AssertionError("backward returned d_rel unasked")
        errs = [check_grad_close(a, b, f"backward {name} {infl} {what}")
                for a, b, what in zip(got, want, ("d_feat", "d_kw"))]
        errs += [check_grad_close(a, b, f"backward {name} {infl} {what}, "
                                  "d_rel variant")
                 for a, b, what in zip(got_rel, want,
                                       ("d_feat", "d_kw", "d_rel"))]
        errs = [max(errs[0], errs[2]), max(errs[1], errs[3]), errs[4]]
        check_reproducible(args, g, extent, infl, f"{name} {infl}")
        call = lambda: kpconv_aggregate_backward(  # noqa: E731
            *args, g, extent, infl)
        ms = cuda_ms(call, 100)
        dev_us, kernels = device_us(call, "kpconv_bwd", 20, by_kernel=True)
        rel_ms = cuda_ms(lambda: kpconv_aggregate_backward(
            *args, g, extent, infl, need_rel=True), 20)
        plain_ms = cuda_ms(lambda: kpconv_aggregate_backward_plain(
            *args, g, extent, infl), 10)
        live = int((args[3] != 0).sum().item())
        t_bytes, t_ops = kpconv_bwd_bound(B, M, N, K, C, P, live)
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        bound_tc = max(kpconv_bwd_bound_3xtf32(B, M, N, K, C, P, live))
        worst_abs = max(worst_abs, *errs)
        if infl == "linear":
            per_call[name] = dev_us
            for kname, us in kernels.items():
                short = re.search(r"kpconv_bwd_\w+", kname).group(0)
                per_kernel[short] = per_kernel.get(short, 0.0) + us
            for key, v in (("ms", ms), ("device_us", dev_us),
                           ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                           ("bytes", t_bytes), ("ops", t_ops),
                           ("bound_3xtf32", bound_tc)):
                sums[key] += v
        print(f"{name} {M} {N} {K} {C} {infl} | {errs[0]:.3e} {errs[1]:.3e}"
              f" {errs[2]:.3e} (|d_kw| max {want[1].abs().max().item():.3e},"
              f" |d_rel| max {want[2].abs().max().item():.3e}) | {ms:.5f} "
              f"{dev_us:.2f} {plain_ms:.5f} {bound_ms:.5f} "
              f"{bound_by} {bound_tc:.5f} | {rel_ms:.5f}", flush=True)
    print(f"ten flagship calls (linear), per backward: kernel "
          f"{sums['ms']:.5f} ms, device {sums['device_us'] / 1e3:.5f} ms, "
          f"plain {sums['plain_ms']:.5f} ms, bound {sums['bound_ms']:.5f} ms"
          f" (3xTF32 rate: {sums['bound_3xtf32']:.5f} ms); by kernel, ms: "
          + ", ".join(f"{k} {v / 1e3:.5f}" for k, v in per_kernel.items()),
          flush=True)
    pyramid = phase_backward_pyramid(cfg, device)
    return {
        "name": "kpconv_bwd", "route": "cuda",
        "source": "deep3dpointclouddenoising_torch/csrc/kpconv_bwd.cu",
        "replaces": "deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py:361",
        "max_abs_err": worst_abs, "ms": sums["ms"],
        "plain_ms": sums["plain_ms"], "bound_ms": sums["bound_ms"],
        "bound_by": "bytes" if sums["bytes"] >= sums["ops"]
        else "operations",
        "library_ms": None,
        "device_ms": sums["device_us"] / 1e3,
        "device_us_per_call": per_call,
        "device_ms_by_kernel": {k: v / 1e3 for k, v in per_kernel.items()},
        "bound_ms_3xtf32": sums["bound_3xtf32"],
        "device_ms_pyramid": pyramid,
        "timed_at": "sum over the ten calls of one l1.yaml backward, B=16, "
                    "random neighbourhoods (device_ms_pyramid: a real "
                    "pyramid's); device_ms: torch.profiler, every "
                    "kpconv_bwd kernel of a call",
        "cuda_kernels": ["kpconv_bwd_invert", "kpconv_bwd_kernel",
                         "kpconv_bwd_reduce", "kpconv_bwd_drel"],
        "launches_are": "calls of the wrapper; on the training path each "
                        "launches kpconv_bwd_invert, kpconv_bwd_kernel and "
                        "kpconv_bwd_reduce once (the reduction only when "
                        "d_kernel_weights is needed), and ms times all "
                        "three; kpconv_bwd_drel only when d_rel is asked "
                        "for, which training does not",
    }


def phase_backward_pyramid(cfg, device):
    """The ten backward calls on a real pyramid's neighbourhoods: each
    against plain and bitwise reproducible, with its live edges, in-degree
    mean and max, and device time; returns the ten calls' device ms."""
    rng = np.random.default_rng(5)
    B, P = int(cfg.batch_size), int(cfg.pseudo_grid.num_kernel_points)
    r0 = float(cfg.radius)
    total_us = 0.0
    print("real pyramid (patch_batch(cfg, 3)): call M N K C | live edges / "
          "slots, in-degree mean max | d_feat, d_kw max_abs | device_us")
    for name, M, N, K, C, mult, idx, rel, fmask in pyramid_calls(cfg,
                                                                  device):
        extent = 2.0 * r0 * mult / 5.0
        kp = torch.from_numpy(create_kernel_points(1.5 * extent, P)).to(
            device)
        feat, kw, g = (torch.from_numpy(a.astype(np.float32)).to(device)
                       for a in (rng.normal(size=(B, N, C)),
                                 rng.normal(size=(P, C)) * math.sqrt(2.0 / C),
                                 rng.normal(size=(B, M, C))))
        args = (feat, idx, rel, fmask, kp, kw)
        got = kpconv_aggregate_backward(*args, g, extent, "linear")
        torch.cuda.synchronize()
        want = kpconv_aggregate_backward_plain(*args, g, extent, "linear")
        errs = [check_grad_close(a, b, f"pyramid backward {name} {what}")
                for a, b, what in zip(got, want, ("d_feat", "d_kw"))]
        check_reproducible(args, g, extent, "linear", f"pyramid {name}")
        dev_us = device_us(lambda: kpconv_aggregate_backward(
            *args, g, extent, "linear"), "kpconv_bwd", 20)
        total_us += dev_us
        offsets, _ = invert_neighbors_plain(idx, fmask, N)
        live = int(offsets[:, -1].sum().item())
        deg = int(offsets.diff(dim=1).max().item())
        print(f"{name} {M} {N} {K} {C} | {live} / {B * M * K}, "
              f"{live / (B * N):.1f} {deg} | "
              f"{errs[0]:.3e} {errs[1]:.3e} | {dev_us:.2f}", flush=True)
    print(f"real pyramid, ten calls: device {total_us / 1e3:.5f} ms")
    return total_us / 1e3


def phase_model_grad(cfg, device):
    """Train-mode gradients of every parameter of the width-144 model under
    the masked L1 loss, on one batch and one pyramid: the backward kernel
    against the plain backward on one forward graph, and the kernel path
    against the plain path, each tensor within ``grad_check``'s limit from
    its own float32 noise."""
    model = build_offset_regression(
        cfg, torch.Generator().manual_seed(0)).to(device).train()
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in patch_batch(cfg, 3).items()}
    pyramid = model.make_pyramid(batch["points"], batch["mask"])
    grads = grad_check.model_gradients(model, pyramid, batch["features"],
                                       batch["offsets"], batch["mask"])
    if grads["launches"] != (10, 10):
        raise AssertionError(
            f"one train forward and backward launched "
            f"{grads['launches'][0]} forward and {grads['launches'][1]} "
            "backward kernels, not 10 and 10")
    check_close(grads["loss"], grads["plain_loss"], 1e-5, 0.0, "train loss")
    for what, d, limit, name in grad_check.check_model_gradients(grads):
        print(f"{what}: {len(grads['names'])} parameter gradients within "
              f"their limits; nearest {name}: {d:.3e} of limit {limit:.3e}")
    noise = [(grad_check.max_abs_distance(p, r), n) for n, p, r in zip(
        grads["names"], grads["plain"], grads["float64"])]
    print("float32 noise: the plain path misses the float64 plain path by "
          "up to %.3e of a tensor's max-abs (%s)" % max(noise))


def phase_training(cfg, device, workdir):
    """This slice's path: the training entry point at full width over
    two-shape train and val splits; returns the kernels' launches in it."""
    data_root = os.path.join(workdir, "train_data")
    for split in ("train", "val"):
        os.makedirs(os.path.join(data_root, split))
        save_off(os.path.join(data_root, split, "sphere.off"),
                 make_icosphere(4))
        save_off(os.path.join(data_root, split, "torus.off"), make_torus())
    steps_per_epoch, epochs = 20, 2
    argv = ["--config_file", CONFIG, "--data_root", data_root,
            "--log_dir", os.path.join(workdir, "log"),
            "--num_steps", str(steps_per_epoch * int(cfg.batch_size)),
            "--epochs", str(epochs), "--val_freq", "1", "--device", "cuda"]
    kpconv_aggregate.launches = 0
    kpconv_aggregate_backward.launches = 0
    summary = train_cli.main(argv)
    fwd, bwd = kpconv_aggregate.launches, kpconv_aggregate_backward.launches
    steps, val_batches = summary["steps"], summary["val_batches"]
    if steps != steps_per_epoch * epochs:
        raise AssertionError(f"training took {steps} steps")
    if (fwd, bwd) != (10 * (steps + val_batches), 10 * steps):
        raise AssertionError(
            f"training launched {fwd} forward and {bwd} backward kernels "
            f"for {steps} steps and {val_batches} val batches")
    losses = summary["train_losses"] + summary["val_losses"]
    if len(summary["train_losses"]) != steps \
            or not np.isfinite(losses).all():
        raise AssertionError(f"training: losses {losses}")
    trainer = summary["trainer"]
    initial = build_offset_regression(
        trainer.cfg, torch.Generator().manual_seed(int(cfg.rng_seed)))
    start = initial.state_dict()
    for name, value in trainer.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if torch.equal(value.cpu(), start[name]):
            raise AssertionError(f"training left {name} unchanged")
    model = infer.load_model(trainer.cfg, device, summary["checkpoint"])
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in patch_batch(cfg, 4).items()}
    with torch.inference_mode():
        out = model(batch["points"], batch["mask"], batch["features"])
    if tuple(out.shape) != tuple(batch["points"].shape) \
            or not torch.isfinite(out).all():
        raise AssertionError("the reloaded checkpoint gives a bad forward")
    print(f"steps {steps}, val batches {val_batches}; launches: forward "
          f"{fwd}, backward {bwd}; train loss first {losses[0]:.6f} last "
          f"{summary['train_losses'][-1]:.6f}; val loss "
          f"{summary['val_losses']}; ms per step by epoch (host clock, "
          f"data loading included): "
          + ", ".join(f"{ms:.3f}" for ms in summary["ms_per_step"]))
    profile_train_steps(trainer, batch)
    return fwd, bwd


def train_short(config: str, data_root: str, log_dir: str, cfg,
                entry=train_cli.main):
    """``DEPLOY_STEPS`` steps of a train entry point (``entry``, the
    offset one by default) at full width on clouds of
    ``DEPLOY_TRAIN_POINTS`` points; returns the forward and backward
    kernel launches and the entry point's summary."""
    argv = ["--config_file", os.path.join(ROOT, "cfgs", config + ".yaml"),
            "--data_root", data_root, "--log_dir", log_dir,
            "--num_steps", str(DEPLOY_STEPS * int(cfg.batch_size)),
            "--epochs", "1", "--val_freq", "1", "--num_points_per_shape",
            str(DEPLOY_TRAIN_POINTS), "--device", "cuda"]
    kpconv_aggregate.launches = 0
    kpconv_aggregate_backward.launches = 0
    summary = entry(argv)
    fwd, bwd = kpconv_aggregate.launches, kpconv_aggregate_backward.launches
    steps, val_batches = summary["steps"], summary["val_batches"]
    if steps != DEPLOY_STEPS or (fwd, bwd) != (
            10 * (steps + val_batches), 10 * steps):
        raise AssertionError(
            f"{config}: {steps} steps, {val_batches} val batches, {fwd} "
            f"forward and {bwd} backward launches")
    losses = summary["train_losses"] + summary["val_losses"]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{config}: losses {losses}")
    print(f"{config}: {steps} steps, val batches {val_batches}; launches: "
          f"forward {fwd}, backward {bwd}; train loss first {losses[0]:.6f}"
          f" last {summary['train_losses'][-1]:.6f}; val loss "
          f"{summary['val_losses']}; ms per step (host clock, data loading "
          f"included) {summary['ms_per_step'][0]:.3f}", flush=True)
    return fwd, bwd, summary


def routed_infer(argv, batch: int, votes: int, expect_low_ckpt: str,
                 expect_low: bool):
    """One run of the inference entry point with ``--checkpoint_low auto``
    (batches of ``batch`` patches, ``votes`` vote rounds): the sibling
    found, every cloud routed as expected, outputs finite, and 10 forward
    launches for each model each batch is routed to; returns the summary,
    the launches and the points per second."""
    kpconv_aggregate.launches = 0
    kpconv_aggregate_backward.launches = 0
    summary = infer.main(argv)
    launches = kpconv_aggregate.launches
    if kpconv_aggregate_backward.launches:
        raise AssertionError("inference launched the backward kernel")
    if summary["checkpoint_low"] != expect_low_ckpt:
        raise AssertionError(f"--checkpoint_low auto found "
                             f"{summary['checkpoint_low']}, not "
                             f"{expect_low_ckpt}")
    dataset, route = summary["dataset"], summary["route_low"]
    if route != [expect_low] * len(dataset.shapes):
        raise AssertionError(
            f"routes {route} (sigmas {summary['sigmas']}), expected all "
            f"{'LOW' if expect_low else 'HIGH'}")
    models = sum(len({route[int(c)] for c in dataset.cloud_inds[s:s + batch]})
                 for s in range(0, len(dataset), batch))
    if launches != 10 * models * votes:
        raise AssertionError(f"routed voting launched the forward kernel "
                             f"{launches} times, not {10 * models * votes}")
    for res, shape in zip(summary["results"], dataset.shapes):
        if res["offsets"].shape != shape.points.shape \
                or not np.isfinite(res["offsets"]).all():
            raise AssertionError("routed voting: bad offsets")
    n_points = sum(len(s.points) for s in dataset.shapes)
    return summary, launches, n_points / summary["seconds"]


def check_votes(got, want, what: str) -> float:
    """Device voting's offsets against host voting's, per point within
    VOTE_TOL; returns the max abs difference."""
    return max(check_close(torch.from_numpy(g["offsets"]).double(),
                           torch.from_numpy(w["offsets"]).double(),
                           what=f"{what}: device voting against host voting",
                           **VOTE_TOL)[0]
               for g, w in zip(got["results"], want["results"]))


def cd_tables(out_dir: str):
    """compute_cd on an output tree with the host KD-tree and on the card;
    the two tables within CD_RTOL per entry; returns the host table and
    the largest relative difference."""
    host = compute_cd.main(["--in_dir", out_dir])
    card = compute_cd.main(["--in_dir", out_dir, "--device"])
    worst = 0.0
    for name, row in host.items():
        for key, v in row.items():
            rel = abs(card[name][key] - v) / abs(v)
            if rel > CD_RTOL:
                raise AssertionError(f"compute_cd --device {name} {key}: "
                                     f"{card[name][key]} against {v}")
            worst = max(worst, rel)
    return host, worst


def phase_deployment(cfg, workdir):
    """This slice's path: shape tree, two short trainings, routed voting on
    host and device, the Chamfer and performance tables; returns the
    forward and backward kernel launches in it."""
    tree = os.path.join(workdir, "shapes")
    make_synthetic_dataset.write_tree(tree, verbose=False)
    log_dir = os.path.join(workdir, "log")
    fwd = bwd = 0
    for config in DEPLOY_CONFIGS:
        f, b, _ = train_short(config, tree, log_dir, cfg)
        fwd, bwd = fwd + f, bwd + b
    deploy_root = os.path.join(workdir, "deploy")
    os.makedirs(os.path.join(deploy_root, "qualitative_test"))
    for name in DEPLOY_SHAPES:
        with open(os.path.join(tree, "qualitative_test", name + ".off")) as f:
            text = f.read()
        with open(os.path.join(deploy_root, "qualitative_test",
                               name + ".off"), "w") as f:
            f.write(text)
    config = os.path.join(ROOT, "cfgs", DEPLOY_CONFIGS[0] + ".yaml")
    batch = int(load_config(config).batch_size)
    ckpt = os.path.join(log_dir, DEPLOY_CONFIGS[0], "current.pt")
    low = os.path.join(log_dir, DEPLOY_CONFIGS[1], "current.pt")
    runs = [(level, low_expected, 1) for level, low_expected in DEPLOY_LEVELS]
    runs.append((DEPLOY_LEVELS[-1][0], DEPLOY_LEVELS[-1][1], 2))
    for level, expect_low, votes in runs:
        pair = {}
        for voting in ("host", "device"):
            out_dir = os.path.join(workdir, f"out_{level}_{votes}_{voting}")
            argv = ["--config_file", config, "--data_root", deploy_root,
                    "--out_dir", out_dir,
                    "--checkpoint", ckpt, "--checkpoint_low", "auto",
                    "--noise_type", "gaussian", "--noise_level", str(level),
                    "--num_votes", str(votes), "--device", "cuda"]
            if voting == "device":
                argv.append("--device_voting")
            summary, launches, pps = routed_infer(argv, batch, votes, low,
                                                  expect_low)
            fwd += launches
            pair[voting] = summary
            table, cd_rel = cd_tables(out_dir)
            print(f"deploy sigma {level} votes {votes} {voting} voting: "
                  f"{pps:.1f} points/s ({summary['seconds']:.3f} s), "
                  f"forward launches {launches}; est sigma "
                  + ", ".join(f"{s:.4e}" for s in summary["sigmas"])
                  + " -> " + ("LOW" if expect_low else "HIGH")
                  + "; CD ratio " + ", ".join(
                      f"{n} {r['ratio']:.4f}" for n, r in table.items())
                  + f" (--device tables within {cd_rel:.2e} relative)",
                  flush=True)
        worst = check_votes(pair["device"], pair["host"],
                            f"sigma {level}, {votes} votes")
        t0 = time.perf_counter()
        infer._patch_tables(pair["device"]["dataset"], batch)
        tables = time.perf_counter() - t0
        print(f"deploy sigma {level} votes {votes}: device vs host offsets "
              f"max abs diff {worst:.3e} (rtol {VOTE_TOL['rtol']} / atol "
              f"{VOTE_TOL['atol']}); the host's patch tables alone take "
              f"{tables:.3f} s of device voting's "
              f"{pair['device']['seconds']:.3f} s", flush=True)
    perf = measure_performance.main(["--in_dir", os.path.join(
        workdir, f"out_{DEPLOY_LEVELS[-1][0]}_1_device")])
    if not all(np.isfinite(list(r.values())).all() for r in perf.values()):
        raise AssertionError(f"measure_performance: {perf}")
    return fwd, bwd


def cleaning_infer(argv, batch: int, voting: str):
    """One run of ``infer --full_cleaning`` on CLEANING_SHAPE: 10 forward
    launches for each of CLEANING_BATCHES batches of ``batch`` patches, no
    backward launch, every output finite and each kept point denoised;
    returns the summary and the launches."""
    kpconv_aggregate.launches = 0
    kpconv_aggregate_backward.launches = 0
    summary = infer.main(argv)
    launches = kpconv_aggregate.launches
    if kpconv_aggregate_backward.launches:
        raise AssertionError("cleaning launched the backward kernel")
    dataset = summary["dataset"]
    batches = -(-len(dataset) // batch)
    if (batches, launches) != (CLEANING_BATCHES, 10 * CLEANING_BATCHES):
        raise AssertionError(
            f"{voting} cleaning: {len(dataset)} patches, {batches} batches, "
            f"{launches} forward launches; expected {CLEANING_BATCHES} "
            f"batches and {10 * CLEANING_BATCHES} launches")
    for res, shape in zip(summary["results"], dataset.shapes):
        n = len(shape.points)
        if res["offsets"].shape != (n, 3) \
                or res["outlier_prob"].shape != (n,) \
                or not np.isfinite(res["offsets"]).all() \
                or not np.isfinite(res["outlier_prob"]).all() \
                or res["denoised"].shape != (int(res["keep"].sum()), 3):
            raise AssertionError(f"{voting} cleaning: bad outputs")
    return summary, launches


def compare_cleaning(dev, host):
    """Device cleaning against host cleaning per point: offsets and outlier
    probabilities within VOTE_TOL, ``keep`` identical but within KEEP_BAND
    of 0.5; returns the max abs differences, the points in the band with a
    probability other than 0.5, and those at exactly 0.5 on both paths (a
    point no patch covered has no vote: logit 0, dropped on both)."""
    offs = check_votes(dev, host, "full cleaning")
    band = unvoted = 0
    for d, h in zip(dev["results"], host["results"]):
        prob = check_close(
            torch.from_numpy(d["outlier_prob"]).double(),
            torch.from_numpy(h["outlier_prob"]).double(),
            what="full cleaning: device outlier probability against host",
            **VOTE_TOL)[0]
        near = (np.abs(h["outlier_prob"] - infer.OUTLIER_THRESHOLD)
                < KEEP_BAND) \
            | (np.abs(d["outlier_prob"] - infer.OUTLIER_THRESHOLD)
               < KEEP_BAND)
        apart = (d["keep"] != h["keep"]) & ~near
        if apart.any():
            raise AssertionError(f"full cleaning: {int(apart.sum())} points "
                                 "kept on one path and dropped on the other")
        half = (h["outlier_prob"] == 0.5) & (d["outlier_prob"] == 0.5)
        band += int((near & ~half).sum())
        unvoted += int(half.sum())
    return offs, prob, band, unvoted


def removal_scores(res):
    """Points removed, and the removal's precision and recall against the
    ground-truth outlier labels."""
    removed = ~res["keep"]
    outlier = res["labels"] == 1
    hit = int((removed & outlier).sum())
    return (int(removed.sum()), hit / max(int(removed.sum()), 1),
            hit / max(int(outlier.sum()), 1))


def chamfer_ties(x, y, y_mask, idx_a, idx_b):
    """Where two nearest-neighbour searches of x in y matched different
    points: a tie when the two matches' squared distances (float64) differ
    by at most TIE_GAP of the smaller; raises on any other mismatch;
    returns the tie mask (B, P1)."""
    xd, yd = x.double(), y.double()

    def d2(idx):
        return ((xd - torch.gather(yd, 1, idx[..., None].expand(-1, -1, 3)))
                ** 2).sum(-1)

    da, db = d2(idx_a), d2(idx_b)
    apart = idx_a != idx_b
    tie = apart & ((da - db).abs() <= TIE_GAP * torch.minimum(da, db))
    if (apart & ~tie).any():
        raise AssertionError(
            f"Chamfer search: {int((apart & ~tie).sum())} matches differ "
            "between the card and the CPU beyond a near-tie")
    return tie & (y_mask.sum(1, keepdim=True) > 0)


def val_batch(tcfg, tree):
    """The first validation batch (B=16, N=500) of the tree at
    DEPLOY_TRAIN_POINTS points per cloud, with the config's noise and
    outliers."""
    ds = OffsetDataset(tree, "val", in_radius=tcfg.in_radius,
                       num_points=tcfg.num_points, num_steps=16,
                       num_epochs=1, noise_type=tcfg.noise_type,
                       noise_level=tcfg.noise_level,
                       num_points_per_shape=DEPLOY_TRAIN_POINTS,
                       outlier_proportion=tcfg.outlier_percentage,
                       seed=tcfg.rng_seed)
    return next(iter(BatchLoader(ds, int(tcfg.batch_size)).epoch_iter(0)))


def phase_chamfer_loss(trainer, batch):
    """The Chamfer-L1 loss and its gradient in ``pred`` on one real batch
    (``pred`` is the trained model's forward), on the card against the
    same call on the CPU."""
    tcfg = trainer.cfg
    card = {k: torch.from_numpy(batch[k]).cuda()
            for k in ("points", "mask", "features", "offsets")}
    trainer.model.eval()
    with torch.no_grad():
        pred = trainer.model(card["points"], card["mask"], card["features"])
    loss_fn = get_offset_regression_loss(tcfg.loss)
    out = {}
    for where, dev in (("cuda", torch.device("cuda")),
                       ("cpu", torch.device("cpu"))):
        p = pred.detach().to(dev).requires_grad_(True)
        points, mask, offsets = (card[k].to(dev)
                                 for k in ("points", "mask", "offsets"))
        loss = loss_fn(p, offsets, mask, points)
        loss.backward()
        clean, denoised = points + offsets, points + p.detach()
        out[where] = dict(
            loss=loss.item(), grad=p.grad.cpu(),
            idx_x=chamfer.nearest_indices(clean, denoised, mask).cpu(),
            idx_y=chamfer.nearest_indices(denoised, clean, mask).cpu())
    clean = (card["points"] + card["offsets"]).cpu()
    denoised = (card["points"] + pred).cpu()
    mask = card["mask"].cpu()
    g, c = out["cuda"], out["cpu"]
    tie_x = chamfer_ties(clean, denoised, mask, g["idx_x"], c["idx_x"])
    tie_y = chamfer_ties(denoised, clean, mask, g["idx_y"], c["idx_y"])
    # rows of pred whose gradient a tie can move: the matches of a tied
    # clean point, and a tied denoised point itself
    touched = tie_y.long()
    for idx in (g["idx_x"], c["idx_x"]):
        touched.scatter_add_(1, torch.where(tie_x, idx, 0), tie_x.long())
    rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    if rel > CHAMFER_RTOL:
        raise AssertionError(f"Chamfer-L1 on the card {g['loss']} against "
                             f"the CPU {c['loss']}")
    rows = ~touched.bool()
    scale = c["grad"].abs().max().item()
    gmax, _ = check_close(
        g["grad"][rows], c["grad"][rows], CHAMFER_GRAD_TOL["rtol"],
        CHAMFER_GRAD_TOL["atol_frac"] * scale,
        "Chamfer-L1 gradient, card against CPU")
    t_ms = cuda_ms(lambda: loss_fn(pred.detach().requires_grad_(True),
                                   card["offsets"], card["mask"],
                                   card["points"]).backward(), 20)
    print(f"Chamfer-L1 on one val batch {tuple(pred.shape)}: card "
          f"{g['loss']:.8g}, CPU {c['loss']:.8g} (rel {rel:.2e}); matched "
          f"indices apart at near-ties: {int(tie_x.sum())} clean->denoised, "
          f"{int(tie_y.sum())} denoised->clean; gradient max abs diff "
          f"{gmax:.3e} (max-abs {scale:.3e}) on {int(rows.sum())} of "
          f"{rows.numel()} rows; loss forward+backward on the card "
          f"{t_ms:.3f} ms (CUDA events)", flush=True)


def phase_cleaning(cfg, workdir):
    """This slice's path: full-cleaning and Chamfer-L1 training, and full
    cleaning by host and device voting; returns the kernels' launches by
    path: {"cleaning": (fwd, bwd), "chamfer": (fwd, bwd)}."""
    tree = os.path.join(workdir, "shapes")
    if not os.path.isdir(tree):
        make_synthetic_dataset.write_tree(tree, verbose=False)
    log_dir = os.path.join(workdir, "log_cleaning")
    fwd, bwd, cleaning = train_short(CLEANING_CONFIG, tree, log_dir, cfg,
                                     train_full_cleaning.main)
    root = os.path.join(workdir, "cleaning")
    os.makedirs(os.path.join(root, "qualitative_test"))
    with open(os.path.join(tree, "qualitative_test",
                           CLEANING_SHAPE + ".off")) as f:
        text = f.read()
    with open(os.path.join(root, "qualitative_test",
                           CLEANING_SHAPE + ".off"), "w") as f:
        f.write(text)
    config = os.path.join(ROOT, "cfgs", CLEANING_CONFIG + ".yaml")
    ckpt = os.path.join(log_dir, CLEANING_CONFIG, "current.pt")
    runs = {}
    for voting in ("host", "device"):
        out_dir = os.path.join(workdir, f"out_cleaning_{voting}")
        argv = ["--config_file", config, "--data_root", root,
                "--out_dir", out_dir, "--checkpoint", ckpt,
                "--checkpoint_low", "none", "--full_cleaning",
                "--noise_type", "gaussian", "--noise_level",
                str(CLEANING_LEVEL), "--device", "cuda"]
        if voting == "device":
            argv.append("--device_voting")
        summary, launches = cleaning_infer(
            argv, int(load_config(config).batch_size), voting)
        fwd += launches
        runs[voting] = summary
        res = summary["results"][0]
        n_points = len(res["keep"])
        removed, precision, recall = removal_scores(res)
        table, cd_rel = cd_tables(out_dir)
        print(f"cleaning {CLEANING_SHAPE} {voting} voting: "
              f"{n_points / summary['seconds']:.1f} points/s "
              f"({summary['seconds']:.3f} s, {len(summary['dataset'])} "
              f"patches), forward launches {launches}; removed {removed} of "
              f"{n_points} (ground-truth outliers "
              f"{int((res['labels'] == 1).sum())}): precision "
              f"{precision:.4f}, recall {recall:.4f}; CD ratio "
              f"{table[CLEANING_SHAPE]['ratio']:.4f} (cleaned "
              f"{table[CLEANING_SHAPE]['cd_denoised']:.4e}, noisy "
              f"{table[CLEANING_SHAPE]['cd_noisy']:.4e}; --device tables "
              f"within {cd_rel:.2e} relative)", flush=True)
    offs, prob, band, unvoted = compare_cleaning(runs["device"],
                                                 runs["host"])
    print(f"cleaning: device vs host max abs diff offsets {offs:.3e}, "
          f"outlier probability {prob:.3e} (rtol {VOTE_TOL['rtol']} / atol "
          f"{VOTE_TOL['atol']}); points within {KEEP_BAND} of the threshold "
          f"(keep may differ there): {band}; points with no vote "
          f"(probability 0.5 on both paths, dropped): {unvoted}", flush=True)
    c_fwd, c_bwd, summary = train_short(CHAMFER_CONFIG, tree, log_dir, cfg)
    trainer = summary["trainer"]
    batch = val_batch(trainer.cfg, tree)
    phase_chamfer_loss(trainer, batch)
    # where a train step's device time goes, after the checks above (these
    # steps move the two models on)
    keys = ("points", "mask", "features", "offsets", "labels")
    for t, b in ((cleaning["trainer"], val_batch(cleaning["trainer"].cfg,
                                                 tree)), (trainer, batch)):
        print(f"{t.cfg.experiment_name}: train steps on one validation "
              "batch")
        profile_train_steps(t, {k: torch.from_numpy(b[k]).cuda()
                                for k in keys})
    return {"cleaning": (fwd, bwd), "chamfer": (c_fwd, c_bwd)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--only-kernels"]):
        print("usage: chip_smoke.py [--only-kernels]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(smi)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}"
              f", python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cfg = load_config(CONFIG)
    if (int(cfg.width), int(cfg.depth)) != (144, 2):
        raise AssertionError("cfgs/l1.yaml is no longer width 144, depth 2")
    with phase("build"):
        for name, (path, seconds, log) in _cuda.build().items():
            print(f"{name}: {seconds:.2f} s -> {os.path.relpath(path, ROOT)}")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print("  " + line.strip())
    with phase("kernel vs plain"):
        record = phase_kernels(cfg, device)
    if argv:  # the kernels' phases alone, for comparing checkouts
        with phase("backward kernel vs plain"):
            bwd_record = phase_backward(cfg, device)
        print(smi)
        print(json.dumps({"kernels": [record, bwd_record]}))
        return 0
    with phase("whole model"):
        phase_model(cfg, device)
    with tempfile.TemporaryDirectory() as workdir, phase("serving"):
        serving_launches = phase_serving(cfg, device, workdir)
    with phase("backward kernel vs plain"):
        bwd_record = phase_backward(cfg, device)
    with phase("whole-model gradients"):
        phase_model_grad(cfg, device)
    with tempfile.TemporaryDirectory() as workdir, phase("training"):
        train_fwd, train_bwd = phase_training(cfg, device, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        with phase("deployment"):
            deploy_fwd, deploy_bwd = phase_deployment(cfg, workdir)
        with phase("cleaning"):  # on the deployment phase's shape tree
            cleaning = phase_cleaning(cfg, workdir)
    # launches: this slice's path (cleaning); every path's in the detail
    record.update(launches=cleaning["cleaning"][0], launches_by_path={
        "serving": serving_launches, "training": train_fwd,
        "deployment": deploy_fwd, "cleaning": cleaning["cleaning"][0],
        "chamfer": cleaning["chamfer"][0]})
    bwd_record.update(launches=cleaning["cleaning"][1], launches_by_path={
        "serving": 0, "training": train_bwd,  # inference checks its 0
        "deployment": deploy_bwd, "cleaning": cleaning["cleaning"][1],
        "chamfer": cleaning["chamfer"][1]})
    print(smi)
    print(json.dumps({"kernels": [record, bwd_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

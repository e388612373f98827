#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run it from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It imports the port, torch, numpy and scipy only, and goes through
fifteen phases (phase 9b after 9), each printed with its wall time:

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
   B=16, N=500, two epochs of 10 steps on an icosphere and a torus as
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
   inference entry point on a held-out shape (DEPLOY_SHAPES) of 140,000
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
11. the 15k family (this slice's path):
   ``cfgs/synthetic_quality_chamfer15k.yaml`` (Chamfer, Adam) and
   ``cfgs/outliers_40_1e3.yaml`` (L1, SGD, 40% box outliers), width 144,
   B=8, 15,000-slot patches on the 15k schedule (nsamples [26, 31, 38,
   41, 39], npoints [4096, 1152, 304, 88]), on a
   tree cut to TREE_15K's shapes at the full 140,000 points: (a) both
   kernels against plain at the ten 15k calls of a real pyramid of
   validation patches (sparse: mostly padding), as in phases 3 and 6,
   each call with its live edges, in-degrees, device us and bounds over
   the live edges; (b) the whole model's forward and gradients there, as
   in phases 4 and 7; (c) one train step with ``remat: 1`` against one
   without, from the same weights on one pyramid: the same loss,
   gradients, running statistics and ``num_batches_tracked``, bitwise
   (and a second step without remat bitwise equal to the first), 19
   forward launches against 10 (nine bottlenecks recomputed) and 10
   backward each, and the peak memory of each; (d)
   both configs through the train entry point, STEPS_15K steps each,
   losses finite, parameters and running stats moved, 10 forward and 10
   backward launches per step, then a profiler window of
   PROFILE_STEPS_15K steps on a validation batch with its stem
   in-degrees; (e) the inference entry point on SHAPE_15K (140,000
   points, gaussian sigma 0.5%) with the Chamfer checkpoint, by host and
   by device voting: BATCHES_15K batches, 10 forward launches each, the
   device within rtol 1e-5 / atol 1e-6 of the host.
12. outlier segmentation (this slice's path): ``cfgs/outlier_seg_edf.yaml``
   (the scene-segmentation head, two classes, masked cross-entropy, Adam;
   three Katz visibility channels; width 144, B=8, 15,000-slot patches on
   the 15k schedule) on stand-in EDFS scans in the EDF PLY schema
   (``data.scans``, shape diameter 1, 140,000 points, 10% box outliers),
   the six that ``--DEBUG 1`` reads, the two held-out ones cut to the
   section past SEG_CORNER: (a) both kernels against plain at the ten
   calls of one real training batch (half its patches outlier-centred,
   a few real points each), as in phase 11(a); (b) the whole model's
   forward and its gradients under the cross-entropy there, as in phases
   4 and 7; (c) ``train_outlier_seg`` STEPS_SEG steps, losses finite,
   parameters and running stats moved, 10 forward and 10 backward
   launches per step, then a profiler window of PROFILE_STEPS_SEG steps on
   a validation batch with its stem in-degrees; (d) ``evaluate_outlier_seg``
   on the held-out scans with (c)'s checkpoint, twice: BATCHES_SEG
   batches, 10 forward launches each, the metric table, and the second
   run's voted probabilities bitwise equal to the first's.  No metric is
   held to a value (the weights are barely trained).

13. the other aggregations and the attention operators (this slice's
   path; no KPConv kernel runs on it), on phase 9's shape tree and phase
   12's scans: (a) each of the 15 500-point configs AGG_CONFIGS (PosPool,
   adaptive weight, PointWiseMLP and the ten attention types; width 144,
   depth 2, B=16, N=500) with seeded weights whose BatchNorm statistics,
   gates and final Dense are O(1), on one real batch: the eval forward,
   the train forward and every train-mode gradient under the masked L1
   loss on the card held to the same model's float32 computation on the
   CPU, within ``grad_check``'s per-tensor limits from that computation's
   own distance to float64 (the forward by max-abs and L2, the gradients
   by relative L2; where that one noise sample leaves a tensor over its
   limit, the larger of it and a second, the CPU's with the inputs one
   ulp up; a tensor that float32
   does not pin within FULL_PATH_FLOOR / NOISE_FACTOR held to be finite,
   and then the card's float64 forward and gradients held to the CPU's
   within AGG_FLOAT64_TOL; a gradient
   exactly zero in float64, behind dead ReLUs, exactly zero on the card),
   and no KPConv launch; (b) AGG_TRAINED
   through the train entry point, AGG_EPOCHS epochs of AGG_STEPS steps,
   losses finite and parameters moved, then each checkpoint serving
   AGG_SHAPE (140,000 points) by host and by device voting, within
   VOTE_TOL; (c)
   ``cfgs/outlier_seg_edf_katz.yaml`` (adaptive weight over intensity and
   Katz features, 15,000 slots) through ``train_outlier_seg`` (STEPS_SEG
   steps) and ``evaluate_outlier_seg`` on the cut held-out scans; (d) per
   config the synchronised wall ms per train step and the peak memory,
   and one profiler window each for AGG_PROFILED (device ms per step,
   busy share), printed beside the card's name and power limit, with
   (b)'s points/s.
14. GAN fine-tuning and discriminator pre-training (this slice's path),
   on phase 9's shape tree with phase 9's ``synthetic_quality_diverse``
   checkpoint as the generator (the deployed recipe), width 144, B=16,
   N=500: (a) the backward kernel's d_rel (``kpconv_bwd_drel``) at the ten
   flagship shapes and at the discriminator's ten calls on the pyramid of
   a real batch denoised by that generator: d_rel, d_features and
   d_kernel_weights bitwise equal over two calls and within the
   backward's tolerances of plain, and the whole discriminator's gradient
   in its input points, kernel against plain, by ``grad_check``'s rule,
   with 3 d_rel launches; (b) ``train_discriminator`` on
   ``cfgs/synthetic_quality_disc.yaml``, DISC_EPOCHS epochs of GAN_STEPS
   steps, the validation accuracy printed; (c) ``train_gan`` on
   ``cfgs/synthetic_quality_gan_tuned.yaml`` from (b)'s discriminator and
   phase 9's generator, GAN_EPOCHS epochs of GAN_STEPS updates unbroken,
   and killed one update into its last epoch and run again with
   ``--auto_resume``: both blocks bitwise equal to the unbroken run's,
   GAN_UPDATE_LAUNCHES (forward, backward, d_rel) per update; (d) a
   profiler window of GAN updates (device ms per update, busy share,
   kernels per update, ``kpconv_bwd_drel``'s ms); (e) GAN_SHAPE served
   with the fine-tuned generator through the inference entry point, then
   ``compute_cd``.

9b. bf16 (this slice's path), after phase 9 and on its shape tree:
   ``cfgs/synthetic_quality_diverse_bf16.yaml`` (``compute_dtype:
   bfloat16``) at width 144: (a) the bf16 forms of both kernels
   (``kpconv_fwd_bf16``, ``kpconv_bwd_bf16``) against their bf16 plain
   versions at the ten flagship shapes and at phase 11's 15k stem call
   (N > 2048): the output and d_features within one bf16 ulp of plain
   (plus the float32 phases' atol, for sums that cancel), d_kernel_weights
   at rtol 3e-4 / atol 1e-5 of the largest, the backward bitwise equal
   over two calls, and bf16 calls counted on the bf16 forms only; device
   us per call beside the float32 kernels' on the same values; (b) the
   whole bf16 model on a real batch, kernel path against plain path
   (both bf16) by the output's max-abs and L2 distances, each within
   three times the plain path's own distance from a float64 copy without
   the bf16 casts (``grad_check.check_forward_tensor``), bf16 against
   float32 from the
   same weights within the JAX package's bound (0.1 of the max-abs,
   correlation above 0.99), and the whole-model gradients within
   ``grad_check``'s limits; (c) the train entry point, BF16_EPOCHS epochs
   of BF16_STEPS steps unbroken, and the same run killed one update into
   epoch BF16_EPOCHS and run again with ``--auto_resume``: the end states
   (parameters, BatchNorm buffers, optimizer state, step, checkpoints)
   bitwise equal, 10 bf16 forward and backward launches per step and no
   float32 one; (d) the inference entry point on BF16_SHAPE with the bf16
   checkpoint (``--checkpoint_low none``) by host and device voting,
   within VOTE_TOL as in phase 9, and by the float32 twin's config from the
   same checkpoint; then device ms per train step (profiler) in bf16 and
   in float32 from the same weights.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so it does without a card.

``python3 chip_smoke.py --only-aggregations`` runs phases 1, 2 and 13 alone
(on a shape tree and scans of its own) and prints no result;
``--only-gan`` runs phases 1, 2 and 14 alone (on a shape tree of its own,
with a generator trained as phase 9 trains it) and prints the d_rel
kernel's record, not the result.

``python3 chip_smoke.py --only-kernels`` runs phases 1-3, 6 and 9b(a) (its
15k stem call on random neighbourhoods) and prints the kernels' JSON
records: copied into another checkout, it measures
that checkout's kernels the same way, for comparing two versions in one
call.
"""
from __future__ import annotations

import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from deep3dpointclouddenoising_torch import compute_cd, \
    evaluate_outlier_seg, infer, make_synthetic_dataset, \
    measure_performance, train_discriminator, train_full_cleaning, \
    train_gan, train_outlier_seg
from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.data.loader import BatchLoader
from deep3dpointclouddenoising_torch.data.meshio import read_ply, save_off
from deep3dpointclouddenoising_torch.data.offset_dataset import OffsetDataset
from deep3dpointclouddenoising_torch.data.outlier_dataset import \
    OutlierSegmentationDataset
from deep3dpointclouddenoising_torch.data.scans import make_scans
from deep3dpointclouddenoising_torch.data.synthetic import (make_icosphere,
                                                            make_torus)
from deep3dpointclouddenoising_torch.data.transforms import \
    build_train_transforms
from deep3dpointclouddenoising_torch.losses import chamfer
from deep3dpointclouddenoising_torch.losses.build import \
    get_offset_regression_loss
from deep3dpointclouddenoising_torch.losses.masked import (
    masked_cross_entropy, masked_l1_loss)
from deep3dpointclouddenoising_torch.models import local_aggregation
from deep3dpointclouddenoising_torch.models.build import (
    build_discriminator, build_offset_regression, build_scene_segmentation)
from deep3dpointclouddenoising_torch.models.kernel_points import \
    create_kernel_points
from deep3dpointclouddenoising_torch.models.layers import set_compute_dtype
from deep3dpointclouddenoising_torch.ops import _cuda
from deep3dpointclouddenoising_torch.ops import kpconv as kpconv_ops
from deep3dpointclouddenoising_torch.ops.kpconv import (
    invert_neighbors_plain, kpconv_aggregate, kpconv_aggregate_backward,
    kpconv_aggregate_backward_plain, kpconv_aggregate_plain)
from deep3dpointclouddenoising_torch.profile_serving import \
    _device_events, profile_train_steps, window_summary
from deep3dpointclouddenoising_torch.train import __main__ as train_cli
from deep3dpointclouddenoising_torch.train.gan import GANTrainer
from deep3dpointclouddenoising_torch.train.trainer import Trainer
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
PROFILER_WINDOWS = 5
# the kernels of one backward call that computes d_features and d_kw
BWD_KERNELS = ("kpconv_bwd_invert", "kpconv_bwd_kernel", "kpconv_bwd_reduce")
KERNEL_TOL = dict(rtol=2e-4, atol=2e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
# backward: the JAX package's gradient rtol; the atol is a fraction of the
# largest gradient, since d_kernel_weights sums up to 416,000 terms in
# another order than the plain einsum and d_features is added by atomics
BWD_RTOL, BWD_ATOL_FRAC = 3e-4, 1e-5
# deployment phase: the two configs trained (the second sets
# diverse_levels), steps of each, points per training and validation cloud
# (cut from 140,000), the held-out shape denoised (of the four, one of the
# two with the fewest patches at 140,000 points; two until phase 13 came,
# cut to keep the script's time), the eval noise levels and whether each
# routes low, and the device-vs-host vote tolerance
DEPLOY_CONFIGS = ("synthetic_quality_diverse", "synthetic_quality_stable_low")
DEPLOY_STEPS = 10
DEPLOY_TRAIN_POINTS = 20000
DEPLOY_SHAPES = ("cylinder_t",)
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
# 15k phase: the two 15,000-slot configs (derive_geometry's 15k schedule,
# B=8), the cut tree their trainings read (2 of the 8 train shapes and 1 of
# the 3 val shapes, at the full 140,000 points), the train steps of each,
# the steps of the profiler window, the held-out shape served and its
# batches of 8 at 140,000 points (2,227 patches, tests/test_torch_15k_data.py)
CONFIGS_15K = ("synthetic_quality_chamfer15k", "outliers_40_1e3")
TREE_15K = {"train": ("ellipsoid_a", "torus_thin"), "val": ("cylinder_v",)}
POINTS_15K = 140000
STEPS_15K = 4
PROFILE_STEPS_15K = 3
SHAPE_15K = "cylinder_t"
BATCHES_15K = 279
# outlier-segmentation phase: the config, its stand-in EDFS scans
# (data.scans at shape diameter 1, the config's scale) at 140,000 points,
# the six that --DEBUG 1 reads (train 00-01, val 09-10, test 11-12), the
# two held-out ones cut to the points past SEG_CORNER (a section of the
# shell and of the outlier box at the training scans' density), the train
# steps, the profiler window's steps and the evaluation's batches of 8
# (2,446 patches)
SEG_CONFIG = "outlier_seg_edf"
SEG_POINTS = 140000
SEG_SCANS = (0, 1, 9, 10, 11, 12)
SEG_HELD_OUT = (11, 12)
SEG_CORNER = (0.16, 0.16, 0.16)
STEPS_SEG = 4
PROFILE_STEPS_SEG = 3
BATCHES_SEG = 306
# bf16 phase: the bfloat16 twin of the diverse flagship and its float32
# twin, its training (BF16_EPOCHS epochs of BF16_STEPS steps, unbroken and
# killed one update into the last and resumed), the held-out shape served
# and its noise, and the JAX package's bound on bfloat16 against float32
# from the same weights (tests/test_model.py:121-146)
BF16_CONFIG = "synthetic_quality_diverse_bf16"
FP32_TWIN = "synthetic_quality_diverse"
BF16_STEPS = 10
BF16_EPOCHS = 3
BF16_SHAPE = DEPLOY_SHAPES[0]
BF16_LEVEL = 0.005
BF16_MODEL_BOUND = dict(max_abs_frac=0.1, min_corr=0.99)
# aggregations phase: the 15 500-point configs of the other aggregations
# and the attention operators (width 144, depth 2, B=16), the four trained
# through the train entry point (AGG_EPOCHS epochs of AGG_STEPS steps) and
# served on AGG_SHAPE at gaussian sigma AGG_LEVEL, the segmentation config
# over adaptive weight, the steps timed per config and the two profiled
AGG_CONFIGS = ("pospool_xyz_avg", "pospool_sincos_avg",
               "adaptiveweight_dp_fc1_avg", "pointwisemlp_dp_fj_max",
               "pointwisemlp_dp_fi_df_fc1", "ASCN", "CAA", "CBAM", "CRCR",
               "DUAT", "NOLO", "OFAT", "POAT", "POTR", "SEAT")
AGG_TRAINED = ("pospool_sincos_avg", "pointwisemlp_dp_fi_df_fc1", "OFAT",
               "POTR")
AGG_STEPS = 10
AGG_EPOCHS = 2
AGG_SHAPE = DEPLOY_SHAPES[0]
AGG_LEVEL = 0.005
AGG_SEG_CONFIG = "outlier_seg_edf_katz"
AGG_TIMED_STEPS = 5
AGG_PROFILED = ("POTR", "CAA")
PROFILE_STEPS_AGG = 3
# phase 13(a)'s first paths (agg_paths), and how close the card's float64
# must come to the CPU's
AGG_PATHS = ("card", "cpu", "float64")
AGG_FLOAT64_TOL = 1e-4
AGG_FLOAT64_VANISH = 1e-9
# GAN phase: the pre-training and fine-tuning configs (width 144, B=16,
# N=500), the epochs of each (GAN_STEPS steps each, on clouds of
# DEPLOY_TRAIN_POINTS points of phase 9's tree; the configs ask for 20
# epochs of 125), the GAN run killed one update into its last epoch and
# resumed, the updates of the profiler window, the held-out shape served
# and its noise, and the discriminator's calls that the G-step
# differentiates in rel (their support set is the input points)
DISC_CONFIG = "synthetic_quality_disc"
GAN_CONFIG = "synthetic_quality_gan_tuned"
GAN_STEPS = 5
GAN_EPOCHS = 2
DISC_EPOCHS = 2
PROFILE_UPDATES = 3
GAN_SHAPE = DEPLOY_SHAPES[0]
GAN_LEVEL = 0.005
GAN_DREL_CALLS = ("stem LA", "Bottleneck_0", "T1 strided")
# launches of one GAN update (forward, backward, d_rel): the generator
# forward of the D-step, the discriminator's train step, the generator's
# forward and backward through the eval discriminator
GAN_UPDATE_LAUNCHES = (40, 30, 3)
# (name, M, N, K, C, radius multiple of r0) of the ten aggregations of one
# 15k forward, B=8, P=15
CALLS_15K = [
    ("stem LA", 15000, 15000, 26, 72, 1),
    ("Bottleneck_0", 15000, 15000, 26, 72, 1),
    ("T1 strided", 4096, 15000, 26, 144, 1), ("L1", 4096, 4096, 31, 144, 2),
    ("T2 strided", 1152, 4096, 31, 288, 2), ("L2", 1152, 1152, 38, 288, 4),
    ("T3 strided", 304, 1152, 38, 576, 4), ("L3", 304, 304, 41, 576, 8),
    ("T4 strided", 88, 304, 41, 1152, 8), ("L4", 88, 88, 39, 1152, 16),
]
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


def kpconv_bound(B, M, N, K, C, P, live=None, feat_bytes=4):
    """Least times (ms) for one aggregation: each input read once and the
    output written once at the HBM rate, and its float32 operations at the
    FMA rate; the bound is the larger.  Operations: 12 per (edge, p) for
    the influence weight, 2 per (edge, p, c) for the weighted neighbour
    sum, 2 per (b, m, p, c) for the kernel-point weights, over ``live``
    edges (mask != 0; default all B * M * K: a masked edge has weight 0
    and costs nothing).  ``feat_bytes`` is the size of a feature and an
    output element (2 for bfloat16); indices, positions, masks, kernel
    points and weights are 4 bytes."""
    live = B * M * K if live is None else live
    nbytes = feat_bytes * (B * N * C + B * M * C) \
        + 4 * (B * M * K * 5 + P * 3 + P * C)
    flops = 12 * live * P + 2 * live * P * C + 2 * B * M * P * C
    return nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3


def kpconv_bound_tf32(B, M, N, K, C, P, live=None, feat_bytes=4, passes=3):
    """kpconv_bound with the neighbour contraction (2 per (live edge, p, c))
    on the tensor cores in ``passes`` TF32 operations for each: 3 for
    float32 rows (3xTF32), 2 for bfloat16 rows, which are exact in TF32
    (2xTF32, kpconv_common.cuh mma_rows); the influence weights and the
    kernel-point sum on the float32 units."""
    live = B * M * K if live is None else live
    t_bytes, _ = kpconv_bound(B, M, N, K, C, P, live, feat_bytes)
    t_ops = (passes * 2 * live * P * C / PEAK_TF32_FLOP_S
             + (12 * live * P + 2 * B * M * P * C) / PEAK_F32_FLOP_S)
    return t_bytes, t_ops * 1e3


def device_us(fn, kernel: str, iters: int, by_kernel: bool = False,
              expect=()):
    """Device microseconds per call of the CUDA kernels whose name holds
    ``kernel`` ("" for every kernel), from torch.profiler over ``iters``
    calls of ``fn``: for each such kernel the mean over the launches the
    profiler recorded, summed over the kernels (with ``by_kernel``, also
    the means by kernel name).  The profiler does not always record every
    launch of a window (on the H100 machine it once kept 21 of 50, now and
    then none, and once the backward's invert and reduce kernels without
    its main one), so the mean is over those it kept, and a window that
    kept no launch of some kernel named in ``expect`` (or none at all) is
    taken again, up to PROFILER_WINDOWS times; raises when no window
    kept them all."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_WINDOWS):
        by_name = {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if kernel in e.name \
                    and e.device_type == torch.autograd.DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    getattr(e, "device_time_total", 0.0))
        if by_name and all(any(x in name for name in by_name)
                           for x in expect):
            break
    else:
        raise AssertionError(
            f"the profiler saw no {kernel} kernel (or not each of "
            f"{expect}) in {PROFILER_WINDOWS} windows")
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
        bound_tc = max(kpconv_bound_tf32(B, M, N, K, C, P))
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


def build_model(cfg, seed: int = 0):
    """The config's model (the scene-segmentation model for a
    ``resnet_scene_seg`` head, else the offset regressor), its weights
    drawn from a generator seeded with ``seed``."""
    build = build_scene_segmentation if cfg.head == "resnet_scene_seg" \
        else build_offset_regression
    return build(cfg, torch.Generator().manual_seed(seed))


def model_loss(cfg):
    """``(target key, loss(pred, target, mask))`` of the config's model."""
    if cfg.head == "resnet_scene_seg":
        return "labels", masked_cross_entropy
    return "offsets", masked_l1_loss


def o1_running_stats(model, rng) -> None:
    """Every BatchNorm's running statistics drawn at O(1) from ``rng``."""
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(
                    rng.normal(size=buf.shape).astype(np.float32) * 0.5))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, size=buf.shape).astype(
                        np.float32)))


def seeded_model(cfg, device, seed: int = 0):
    """The config's model with seeded weights; the final Dense, every
    BatchNorm's running stats and the attention gates (``gamma``,
    ``alpha``, zero at init) get O(1) values, so the output is O(1) and no
    branch vanishes."""
    model = build_model(cfg, seed)
    rng = np.random.default_rng(seed)
    o1_running_stats(model, rng)
    with torch.no_grad():
        dense = model.get_submodule(
            [n for n, _ in model.named_modules()
             if n.endswith("MultiDimHead_0.Dense_0")][0])
        dense.weight.copy_(torch.from_numpy(
            rng.normal(size=tuple(dense.weight.shape)).astype(np.float32)))
        dense.bias.copy_(torch.from_numpy(
            rng.normal(size=tuple(dense.bias.shape)).astype(np.float32)))
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("gamma", "alpha"):
                p.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, size=tuple(p.shape)).astype(np.float32)))
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


def phase_model(cfg, device, batch=None):
    """Whole width-144 model, kernel path against plain path on one
    pyramid (of ``batch``, default ``patch_batch(cfg, 1)``), each output
    element within the larger of MODEL_TOL and three times its own float32
    noise (``grad_check.check_forward``)."""
    model = seeded_model(cfg, device)
    batch = patch_batch(cfg, 1) if batch is None else batch
    xyz_t, mask_t = (torch.as_tensor(batch[k]).to(device)
                     for k in ("points", "mask"))
    feat_t = torch.as_tensor(batch["features"]).to(device)
    with torch.inference_mode():
        pyramid = model.make_pyramid(xyz_t, mask_t)

        def head(m, feats):
            return m.head(pyramid, m.ResNetEncoder_0(pyramid, feats))

        kpconv_aggregate.launches = 0
        got = head(model, feat_t)
        torch.cuda.synchronize()
        if kpconv_aggregate.launches != 10:
            raise AssertionError(f"forward launched the kernel "
                                 f"{kpconv_aggregate.launches} times, not 10")
        # the plain path: the same modules with the plain version swapped
        # in for the wrapper, on the same pyramid; and the same in float64
        local_aggregation.kpconv_aggregate = kpconv_aggregate_plain
        try:
            want = head(model, feat_t)
            want64 = head(copy.deepcopy(model).double(), feat_t.double())
        finally:
            local_aggregation.kpconv_aggregate = kpconv_aggregate
        worst = grad_check.check_forward(got, want, want64, **MODEL_TOL)
        fixed = ((got - want).abs() - MODEL_TOL["rtol"] * want.abs()
                 > MODEL_TOL["atol"]).sum().item()
        noise = (want.double() - want64).abs().max().item()
        fwd_ms = cuda_ms(lambda: model(xyz_t, mask_t, feat_t), 10)
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


def kpconv_bwd_bound(B, M, N, K, C, P, live, feat_bytes=4):
    """Least times (ms) for one backward call of the training path (d_features
    and d_kernel_weights) with ``live`` live edges (mask != 0): features,
    indices, relative positions, masks, kernel points and weights and the
    upstream gradient read once, d_features and d_kernel_weights written
    once; float32 operations as the function needs them, grouped by support
    (H[b,n,p,c] = sum of w g over the edges that name n): 2 per (live edge,
    p, c) for H, 12 per (live edge, p) for the influence weights, and 2 per
    (b, n, p, c) for each of d_features = sum_p kw H and d_kernel_weights =
    sum_{b,n} feat H.  A masked edge has weight 0 and costs nothing.
    ``feat_bytes`` is the size of a feature, upstream-gradient and
    d_features element (2 for bfloat16); the rest are 4 bytes."""
    nbytes = feat_bytes * (2 * B * N * C + B * M * C) \
        + 4 * (B * M * K * 5 + P * 3 + 2 * P * C)
    flops = 2 * live * P * C + 12 * live * P + 4 * B * N * P * C
    return nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3


def kpconv_bwd_bound_tf32(B, M, N, K, C, P, live, feat_bytes=4, passes=3):
    """kpconv_bwd_bound with H's contraction on the tensor cores in
    ``passes`` TF32 operations for each of its 2 per (live edge, p, c): 3
    for float32 (3xTF32), 2 for a bfloat16 upstream gradient, exact in
    TF32 (2xTF32); the influence weights and both epilogues on the float32
    units."""
    t_bytes, _ = kpconv_bwd_bound(B, M, N, K, C, P, live, feat_bytes)
    t_ops = (passes * 2 * live * P * C / PEAK_TF32_FLOP_S
             + (12 * live * P + 4 * B * N * P * C) / PEAK_F32_FLOP_S)
    return t_bytes, t_ops * 1e3


def check_grad_close(got, want, what: str):
    """Backward kernel against plain: rtol BWD_RTOL and an atol of
    BWD_ATOL_FRAC of the largest entry; returns the max abs error."""
    scale = want.abs().max().item()
    max_abs, _ = check_close(got, want, BWD_RTOL, BWD_ATOL_FRAC * scale,
                             what)
    return max_abs


def check_grad_float64(got, plain, want64, what: str):
    """Backward kernel against the plain backward in float64 where a
    support's gradient sums ~10^5 edges (a sparse patch's few real points,
    which its padding queries name): the plain float32 backward, adding by
    atomics, is no yardstick there.  Each element within rtol BWD_RTOL and
    an atol of BWD_ATOL_FRAC of the largest entry of the float64 result,
    widened by grad_check.NOISE_FACTOR times the plain float32 backward's
    largest distance from it.  Returns the kernel's and the plain
    version's max abs distances from float64."""
    want = want64.double()
    noise = (plain.double() - want).abs().max().item()
    err = (got.double() - want).abs().max().item()
    limit = BWD_ATOL_FRAC * want.abs().max().item() \
        + grad_check.NOISE_FACTOR * noise
    worst = ((got.double() - want).abs() - BWD_RTOL * want.abs()).max()
    if not torch.isfinite(got).all() or worst.item() > limit:
        raise AssertionError(
            f"{what}: {err:.3e} from float64 (plain float32 {noise:.3e}), "
            f"over rtol {BWD_RTOL} / atol {limit:.3e}")
    return err, noise


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


def pyramid_calls(cfg, device, batch=None, table=FLAGSHIP_CALLS):
    """The ten aggregations' neighbourhoods of one forward on a real
    pyramid (``batch``'s points and mask through ``make_pyramid``; default
    ``patch_batch(cfg, 3)``), checked against ``table``'s shapes: (name,
    M, N, K, C, radius multiple, idx, rel, feature mask) each, the feature
    mask all ones for padding queries as the model makes it."""
    model = build_model(cfg).to(device)
    batch = patch_batch(cfg, 3) if batch is None else batch
    xyz, mask = (torch.as_tensor(batch[k]).to(device)
                 for k in ("points", "mask"))
    with torch.no_grad():
        pyr = model.make_pyramid(xyz, mask)
    levels, trans = pyr.levels, pyr.transitions
    nbrs = [(levels[0].self_nbr, levels[0].mask)] * 2
    for i in range(1, len(levels)):
        nbrs += [(trans[i - 1].pool_nbr, levels[i].mask),
                 (levels[i].self_nbr, levels[i].mask)]
    calls = []
    for (name, M, N, K, C, mult), (nbr, qmask) in zip(table, nbrs):
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
        dev_us, kernels = device_us(call, "kpconv_bwd", 20, by_kernel=True,
                                    expect=BWD_KERNELS)
        rel_ms = cuda_ms(lambda: kpconv_aggregate_backward(
            *args, g, extent, infl, need_rel=True), 20)
        plain_ms = cuda_ms(lambda: kpconv_aggregate_backward_plain(
            *args, g, extent, infl), 10)
        live = int((args[3] != 0).sum().item())
        t_bytes, t_ops = kpconv_bwd_bound(B, M, N, K, C, P, live)
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        bound_tc = max(kpconv_bwd_bound_tf32(B, M, N, K, C, P, live))
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
                        "for, which only the GAN's G-step does (its own "
                        "record, kpconv_bwd_drel)",
    }


def in_degrees(fmask, idx, N):
    """Live edges (mask != 0) of a call, and the mean and largest number
    of them that name one support."""
    offsets, _ = invert_neighbors_plain(idx, fmask, N)
    deg = offsets.diff(dim=1)
    return int(offsets[:, -1].sum().item()), deg.float().mean().item(), \
        int(deg.max().item())


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
            *args, g, extent, "linear"), "kpconv_bwd", 20,
            expect=BWD_KERNELS)
        total_us += dev_us
        live, mean_deg, deg = in_degrees(fmask, idx, N)
        print(f"{name} {M} {N} {K} {C} | {live} / {B * M * K}, "
              f"{mean_deg:.1f} {deg} | "
              f"{errs[0]:.3e} {errs[1]:.3e} | {dev_us:.2f}", flush=True)
    print(f"real pyramid, ten calls: device {total_us / 1e3:.5f} ms")
    return total_us / 1e3


def phase_model_grad(cfg, device, batch=None):
    """Train-mode gradients of every parameter of the width-144 model under
    its loss (the masked L1 loss, or the masked cross-entropy of the
    segmentation model), on one batch (default ``patch_batch(cfg, 3)``) and
    one pyramid: the backward kernel against the plain backward on one
    forward graph, and the kernel path against the plain path, each tensor
    within ``grad_check``'s limit from its own float32 noise."""
    model = build_model(cfg).to(device).train()
    target, loss_fn = model_loss(cfg)
    batch = patch_batch(cfg, 3) if batch is None else batch
    batch = {k: torch.as_tensor(batch[k]).to(device)
             for k in ("points", "mask", "features", target)}
    pyramid = model.make_pyramid(batch["points"], batch["mask"])
    grads = grad_check.model_gradients(model, pyramid, batch["features"],
                                       batch[target], batch["mask"],
                                       loss_fn)
    if grads["launches"] != (10, 10):
        raise AssertionError(
            f"one train forward and backward launched "
            f"{grads['launches'][0]} forward and {grads['launches'][1]} "
            "backward kernels, not 10 and 10")
    # the loss within rtol 1e-5 of the plain path's; in bf16 also within
    # three times the plain loss's own distance from float64 (a one-ulp
    # flip between the two paths moves it by as much as its bf16 noise)
    atol = 0.0
    if str(cfg.compute_dtype) == "bfloat16":
        atol = grad_check.NOISE_FACTOR * (
            grads["plain_loss"].double() - grads["float64_loss"]).abs().item()
    check_close(grads["loss"].double(), grads["plain_loss"].double(), 1e-5,
                atol, "train loss")
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
    steps_per_epoch, epochs = 10, 2
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


def bf16_device_us(calls, iters: int = 20):
    """Device microseconds per call of the bf16 and the float32 forms of
    both kernels from one profiler window over ``iters`` rounds of the four
    calls (``calls``: {"fwd" | "bwd": (bf16 call, float32 call, ...)}),
    told apart by the kernels' template names; the backward's inversion and
    reduction are the same kernels in both forms.  One window, not four:
    the profiler kept nothing, in five windows running, late in a run that
    had opened some 120 of them.  Returns {key: (bf16 us, float32 us)}."""
    def rounds():
        with torch.no_grad():
            for bf16_call, fp32_call, *_ in calls.values():
                bf16_call()
                fp32_call()
    forms = {"bf16": "<__nv_bfloat16", "fp32": "<float"}
    expect = [k + v for k in ("kpconv_fwd_kernel", "kpconv_bwd_kernel")
              for v in forms.values()] + list(BWD_KERNELS[::2])
    _, means = device_us(lambda: [rounds() for _ in range(iters)],
                         "kpconv_", 1, by_kernel=True, expect=expect)
    shared = sum(us for name, us in means.items()
                 if any(k in name for k in BWD_KERNELS[::2]))
    out = {}
    for key, kernel, extra in (("fwd", "kpconv_fwd_kernel", 0.0),
                               ("bwd", "kpconv_bwd_kernel", shared)):
        out[key] = tuple(
            sum(us for name, us in means.items() if kernel + form in name)
            + extra for form in forms.values())
    return out


def bf16_stem_15k(device, workdir, tree):
    """The stem call's neighbourhoods of phase 11's 15k batch (the first
    validation batch of CONFIGS_15K[0] over TREE_15K's validation shape at
    POINTS_15K points, from phase 9's tree): (idx, rel, feature mask,
    extent)."""
    cfg = load_config(os.path.join(ROOT, "cfgs", CONFIGS_15K[0] + ".yaml"))
    val = os.path.join(workdir, "bf16_val15k")
    os.makedirs(os.path.join(val, "val"))
    for name in TREE_15K["val"]:
        shutil.copy(os.path.join(tree, "val", name + ".off"),
                    os.path.join(val, "val"))
    batch = val_batch(cfg, val, POINTS_15K)
    name, M, N, K, C, mult, idx, rel, fmask = pyramid_calls(
        cfg, device, batch, CALLS_15K)[0]
    return idx, rel, fmask, 2.0 * float(cfg.radius) * mult / 5.0


def phase_bf16_kernels(cfg, device, stem_15k=None):
    """(a) The bfloat16 forms of both kernels against their bfloat16 plain
    versions, on bfloat16 features and upstream gradients, at the ten
    flagship shapes (random neighbourhoods, as phases 3 and 6) and at the
    15k stem call (``stem_15k`` from :func:`bf16_stem_15k`: B=8, N = M =
    15,000, the N > 2048 path; random neighbourhoods at that shape when
    None): the output and d_features within one bf16 ulp of plain (plus
    KERNEL_TOL's atol and BWD_ATOL_FRAC of the largest gradient,
    ``check_bf16``), d_kernel_weights at BWD_RTOL and BWD_ATOL_FRAC of the
    largest, the backward bitwise equal over two calls; the wrapper ms,
    device us per call and plain ms of each bf16 form beside the float32
    kernels' device us on the same values (the bf16 features upcast), and
    bounds over bf16 bytes and live edges with the contraction at the
    2xTF32 rate the bf16 forms run it at (``kpconv_bound_tf32``), the float32
    FMA-rate bound beside.  Returns the two records, less launches."""
    rng = np.random.default_rng(12)
    B, P = int(cfg.batch_size), int(cfg.pseudo_grid.num_kernel_points)
    r0 = float(cfg.radius)
    # the bf16 features take the bf16 entry points, never the float32 ones
    args, extent = kpconv_inputs(rng, B, 500, 500, 52, 72, P, r0, device)
    for wrapper in (kpconv_aggregate, kpconv_aggregate_backward):
        wrapper.launches = wrapper.launches_bf16 = 0
    a16 = (args[0].bfloat16(), *args[1:])
    g16 = torch.randn(B, 500, 72, device=device).bfloat16()
    with torch.no_grad():
        kpconv_aggregate(*a16, extent, "linear")
    kpconv_aggregate_backward(*a16, g16, extent, "linear")
    counts = [(w.launches, w.launches_bf16)
              for w in (kpconv_aggregate, kpconv_aggregate_backward)]
    if counts != [(0, 1), (0, 1)]:
        raise AssertionError(f"bf16 calls counted (float32, bf16) launches "
                             f"{counts}, not (0, 1) each")
    rows = [(name, B, M, N, K, C, mult, None)
            for name, M, N, K, C, mult in FLAGSHIP_CALLS]
    rows.append(("15k stem LA", 8) + CALLS_15K[0][1:] + (stem_15k,))
    recs = {k: dict(ms=0.0, device_us=0.0, fp32_device_us=0.0,
                    plain_ms=0.0, bound_ms=0.0, bytes=0.0, ops=0.0,
                    bound_ms_f32_fma=0.0,
                    max_abs_err=0.0, differing=0, device_us_per_call={})
            for k in ("fwd", "bwd")}
    stem = {}
    print("bf16 call B M N K C | fwd max_abs (elements off plain), bwd "
          "d_feat max_abs (off), d_kw max_abs | fwd wrapper_ms device_us "
          "fp32_device_us plain_ms bound_ms (by, 2xTF32) bound_ms at the "
          "float32 FMA rate | bwd the same")
    for name, Bc, M, N, K, C, mult, nbr in rows:
        if nbr is None:
            args, extent = kpconv_inputs(rng, Bc, M, N, K, C, P, r0 * mult,
                                         device)
        else:
            idx, rel, fmask, extent = nbr
            kp = torch.from_numpy(create_kernel_points(1.5 * extent, P)).to(
                device)
            feat, kw = (torch.from_numpy(a.astype(np.float32)).to(device)
                        for a in (rng.normal(size=(Bc, N, C)),
                                  rng.normal(size=(P, C))
                                  * math.sqrt(2.0 / C)))
            args = (feat, idx, rel, fmask, kp, kw)
        a16 = (args[0].bfloat16(), *args[1:])
        a32 = (a16[0].float(), *args[1:])
        g16 = torch.from_numpy(rng.normal(size=(Bc, M, C)).astype(
            np.float32)).to(device).bfloat16()
        g32 = g16.float()
        with torch.no_grad():
            got = kpconv_aggregate(*a16, extent, "linear")
            torch.cuda.synchronize()
            want = kpconv_aggregate_plain(*a16, extent, "linear")
            f_err, f_off = grad_check.check_bf16(got, want, KERNEL_TOL["atol"],
                                      f"bf16 kpconv {name}")
        del got, want
        got = kpconv_aggregate_backward(*a16, g16, extent, "linear")
        torch.cuda.synchronize()
        want = kpconv_aggregate_backward_plain(*a16, g16, extent, "linear")
        d_err, d_off = grad_check.check_bf16(
            got[0], want[0], BWD_ATOL_FRAC * want[0].abs().max().item(),
            f"bf16 backward {name} d_feat")
        if got[1].dtype != torch.float32:
            raise AssertionError(f"bf16 backward {name}: d_kw {got[1].dtype}")
        kw_err = check_grad_close(got[1], want[1],
                                  f"bf16 backward {name} d_kw")
        del got, want
        check_reproducible(a16, g16, extent, "linear", f"bf16 {name}")
        live = int((args[3] != 0).sum().item())
        calls = {
            "fwd": (lambda: kpconv_aggregate(*a16, extent, "linear"),
                    lambda: kpconv_aggregate(*a32, extent, "linear"),
                    lambda: kpconv_aggregate_plain(*a16, extent, "linear"),
                    kpconv_bound_tf32(Bc, M, N, K, C, P, live,
                                      feat_bytes=2, passes=2),
                    kpconv_bound(Bc, M, N, K, C, P, live, feat_bytes=2)),
            "bwd": (lambda: kpconv_aggregate_backward(*a16, g16, extent,
                                                      "linear"),
                    lambda: kpconv_aggregate_backward(*a32, g32, extent,
                                                      "linear"),
                    lambda: kpconv_aggregate_backward_plain(
                        *a16, g16, extent, "linear"),
                    kpconv_bwd_bound_tf32(Bc, M, N, K, C, P, live,
                                          feat_bytes=2, passes=2),
                    kpconv_bwd_bound(Bc, M, N, K, C, P, live,
                                     feat_bytes=2))}
        dev_us = bf16_device_us(calls)
        line = []
        for key, (call, call32, plain, bound, bound_fma) in calls.items():
            with torch.no_grad():
                ms = cuda_ms(call, 50)
                plain_ms = cuda_ms(plain, 5, warmup=1)
            dev, dev32 = dev_us[key]
            t_bytes, t_ops = bound
            bound_ms = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            fma_ms = max(bound_fma)
            line.append(f"{ms:.5f} {dev:.2f} {dev32:.2f} {plain_ms:.5f} "
                        f"{bound_ms:.5f} ({by}) {fma_ms:.5f}")
            if nbr is not None or name.startswith("15k"):
                stem[key] = dict(ms=ms, device_us=dev, fp32_device_us=dev32,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=by, bound_ms_f32_fma=fma_ms,
                                 live_edges=live)
                continue
            r = recs[key]
            r["device_us_per_call"][name] = dev
            for k, v in (("ms", ms), ("device_us", dev),
                         ("fp32_device_us", dev32), ("plain_ms", plain_ms),
                         ("bound_ms", bound_ms), ("bytes", t_bytes),
                         ("ops", t_ops), ("bound_ms_f32_fma", fma_ms)):
                r[k] += v
        for key, err, off in (("fwd", f_err, f_off),
                              ("bwd", max(d_err, kw_err), d_off)):
            recs[key]["max_abs_err"] = max(recs[key]["max_abs_err"], err)
            recs[key]["differing"] += off
        print(f"{name} {Bc} {M} {N} {K} {C} | {f_err:.3e} ({f_off}), "
              f"{d_err:.3e} ({d_off}), {kw_err:.3e} | {line[0]} | "
              f"{line[1]}", flush=True)
    for key in ("fwd", "bwd"):
        r = recs[key]
        print(f"ten flagship calls, bf16 {key}: wrapper {r['ms']:.5f} ms, "
              f"device {r['device_us'] / 1e3:.5f} ms (float32 kernel on "
              f"the same values {r['fp32_device_us'] / 1e3:.5f} ms), plain "
              f"{r['plain_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms "
              f"(2xTF32; {r['bound_ms_f32_fma']:.5f} ms at the float32 FMA "
              "rate)",
              flush=True)
    out = []
    for key, src, replaces in (
            ("fwd", "kpconv_fwd.cu", "pallas_kpconv.py:142"),
            ("bwd", "kpconv_bwd.cu", "pallas_kpconv.py:361")):
        r = recs[key]
        out.append({
            "name": f"kpconv_{key}_bf16", "route": "cuda",
            "source": f"deep3dpointclouddenoising_torch/csrc/{src}",
            "replaces": f"deep3dpointclouddenoising_tpu/ops/{replaces}",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes"] >= r["ops"] else "operations",
            "library_ms": None,
            "bound_ms_f32_fma": r["bound_ms_f32_fma"],
            "device_ms": r["device_us"] / 1e3,
            "fp32_device_ms_same_shapes": r["fp32_device_us"] / 1e3,
            "device_us_per_call": r["device_us_per_call"],
            "elements_off_plain": r["differing"],
            "stem_15k": stem.get(key),
            "timed_at": "sum over the ten calls of one l1.yaml "
                        f"{'forward' if key == 'fwd' else 'backward'}, "
                        "B=16, random neighbourhoods, bfloat16 features"
                        + (" and upstream gradient" if key == "bwd" else "")
                        + "; bound over bfloat16 bytes and live edges, "
                        "the contraction at the 2xTF32 rate",
            "entry_point": f"kpconv_{key}_bf16",
            "launches_are": "calls of the wrapper with bfloat16 features "
                            "(.launches_bf16)",
        })
    out[0]["also_replaces"] = \
        "deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py:98"
    return out


def phase_bf16_model(cfg, twin, device, batch):
    """(b) The whole bf16 model at width 144 on one real batch and pyramid:
    the kernel path against the plain path, both bfloat16, by the whole
    output's max-abs and L2 distances, each within three times the plain
    path's own distance from the same model in float64 without its
    bfloat16 casts (``grad_check.check_forward_tensor``: a one-ulp flip
    between the two paths moves an element as far as its bf16 noise);
    and bfloat16 against
    float32 (``twin``) from the same weights within the JAX package's own
    bound (tests/test_model.py:121-146): the largest difference under
    BF16_MODEL_BOUND's fraction of the float32 output's max-abs, the
    correlation above its minimum.  10 forward launches of the bf16
    kernel and none of the float32 one."""
    model = seeded_model(cfg, device)
    model32 = seeded_model(twin, device)
    model32.load_state_dict(model.state_dict())
    xyz, mask, feats = (torch.as_tensor(batch[k]).to(device)
                        for k in ("points", "mask", "features"))
    with torch.inference_mode():
        pyramid = model.make_pyramid(xyz, mask)

        def head(m, f):
            return m.head(pyramid, m.ResNetEncoder_0(pyramid, f))

        kpconv_aggregate.launches = kpconv_aggregate.launches_bf16 = 0
        got = head(model, feats)
        torch.cuda.synchronize()
        if (kpconv_aggregate.launches, kpconv_aggregate.launches_bf16) \
                != (0, 10):
            raise AssertionError(
                f"the bf16 forward launched {kpconv_aggregate.launches} "
                f"float32 and {kpconv_aggregate.launches_bf16} bf16 kernels")
        out32 = head(model32, feats)
        local_aggregation.kpconv_aggregate = kpconv_aggregate_plain
        try:
            want = head(model, feats)
            want64 = head(grad_check.float64_copy(model), feats.double())
        finally:
            local_aggregation.kpconv_aggregate = kpconv_aggregate
    dist = grad_check.check_forward_tensor(got, want, want64)
    scale = out32.abs().max().item()
    frac = (got - out32).abs().max().item() / scale
    corr = torch.corrcoef(torch.stack([got.reshape(-1).double(),
                                       out32.reshape(-1).double()]))[0, 1]
    if frac >= BF16_MODEL_BOUND["max_abs_frac"] \
            or corr.item() <= BF16_MODEL_BOUND["min_corr"]:
        raise AssertionError(f"bf16 against float32: max diff {frac:.3e} "
                             f"of the max-abs, correlation {corr:.6f}")
    noise = (want.double() - want64).abs().max().item()
    print(f"bf16 model: output {tuple(got.shape)}, |out| max "
          f"{want.abs().max().item():.3f}; kernel vs plain (both bf16): "
          + ", ".join(f"{k} distance {d:.3e} (limit {lim:.3e})"
                      for k, (d, lim) in dist.items())
          + f"; max abs {(got - want).abs().max().item():.3e}; bf16 plain "
          f"vs float64 up to {noise:.3e}; "
          f"bf16 vs float32 (same weights): max diff {frac:.4e} of the "
          f"max-abs (bound {BF16_MODEL_BOUND['max_abs_frac']}), "
          f"correlation {corr.item():.6f} (bound "
          f"{BF16_MODEL_BOUND['min_corr']})", flush=True)


class Killed(Exception):
    """Stands for the end of a training process killed mid-epoch."""


def bf16_train(argv, kill_at_step=None):
    """One run of the train entry point, ended as by a kill just after its
    update ``kill_at_step`` where that is given; returns its summary (None
    when killed) and its (float32, bf16) forward and backward launches."""
    for wrapper in (kpconv_aggregate, kpconv_aggregate_backward):
        wrapper.launches = wrapper.launches_bf16 = 0
    train_step = Trainer.train_step

    def killed_step(trainer, batch):
        loss = train_step(trainer, batch)
        if trainer.step == kill_at_step:
            torch.cuda.synchronize()
            raise Killed(trainer.step)
        return loss

    Trainer.train_step = killed_step
    try:
        summary = train_cli.main(argv)
    except Killed:
        summary = None
    finally:
        Trainer.train_step = train_step
    if kill_at_step is not None and summary is not None:
        raise AssertionError(f"bf16 training ran past step {kill_at_step}")
    return summary, [(w.launches, w.launches_bf16)
                     for w in (kpconv_aggregate, kpconv_aggregate_backward)]


def phase_bf16_training(tree, workdir):
    """(c) ``BF16_CONFIG`` through the train entry point at width 144, B=16,
    BF16_STEPS steps per epoch on clouds of DEPLOY_TRAIN_POINTS points:
    BF16_EPOCHS epochs unbroken; and the same run with ``--auto_resume``
    killed one step into epoch BF16_EPOCHS (after epoch BF16_EPOCHS - 1's
    checkpoint, with one update lost), then run again with
    ``--auto_resume``.  The resumed run's parameters, BatchNorm buffers,
    optimizer state (Adam's moments and steps, ``count``) and step, and
    its checkpoints, equal the unbroken run's bitwise; every loss finite;
    10 bf16 forward and 10 bf16 backward launches per step (and per
    validation batch, forward), none of the float32 kernels.  Returns the
    resumed run's summary and the launches of its two calls."""
    config = os.path.join(ROOT, "cfgs", BF16_CONFIG + ".yaml")
    B = int(load_config(config).batch_size)

    def argv(log_dir):
        return ["--config_file", config, "--data_root", tree,
                "--log_dir", log_dir, "--num_steps", str(BF16_STEPS * B),
                "--epochs", str(BF16_EPOCHS), "--val_freq",
                str(BF16_EPOCHS), "--num_points_per_shape",
                str(DEPLOY_TRAIN_POINTS), "--device", "cuda",
                "--auto_resume"]

    straight, _ = bf16_train(argv(os.path.join(workdir, "bf16_straight")))
    log = os.path.join(workdir, "bf16_resumed")
    saved = BF16_STEPS * (BF16_EPOCHS - 1)
    _, l1 = bf16_train(argv(log), kill_at_step=saved + 1)
    second, l2 = bf16_train(argv(log))
    current = os.path.join(log, BF16_CONFIG, "current.pt")
    fwd = l1[0][1] + l2[0][1]
    bwd = l1[1][1] + l2[1][1]
    if straight["restored"] is not None or second["restored"] != current \
            or second["steps"] != straight["steps"] \
            or straight["steps"] != BF16_STEPS * BF16_EPOCHS:
        raise AssertionError(
            f"bf16 resume: restored {straight['restored']}, "
            f"{second['restored']}; steps {second['steps']}, unbroken "
            f"{straight['steps']}")
    # the killed run's saved + 1 updates, the resumed run's last epoch and
    # its validation
    steps = saved + 1 + BF16_STEPS
    if l1[0][0] + l2[0][0] + l1[1][0] + l2[1][0] \
            or (fwd, bwd) != (10 * (steps + second["val_batches"]),
                              10 * steps):
        raise AssertionError(f"bf16 training launched (float32, bf16) "
                             f"{l1} then {l2}")
    losses = second["train_losses"] + second["val_losses"]
    if not np.isfinite(losses).all():
        raise AssertionError(f"bf16 training: losses {losses}")
    a, b = second["trainer"], straight["trainer"]
    if a.step != b.step:
        raise AssertionError(f"bf16 resume: step {a.step}, not {b.step}")
    for what, x, y in (("model", a.model.state_dict(),
                        b.model.state_dict()),
                       ("optimizer", a.optimizer.state_dict(),
                        b.optimizer.state_dict())):
        diff = grad_check.state_difference(x, y)
        if diff:
            raise AssertionError(f"bf16 resume: {what} differs from the "
                                 f"unbroken run at {diff}")
    for name in ("current.pt", f"ckpt_epoch_{BF16_EPOCHS}.pt"):
        diff = grad_check.state_difference(
            torch.load(os.path.join(log, BF16_CONFIG, name),
                       weights_only=True),
            torch.load(os.path.join(workdir, "bf16_straight", BF16_CONFIG,
                                    name), weights_only=True))
        if diff:
            raise AssertionError(f"bf16 resume: {name} differs at {diff}")
    print(f"bf16 training: {BF16_EPOCHS} epochs of {BF16_STEPS} steps "
          f"unbroken, and a run killed after update {saved + 1} and "
          f"continued by --auto_resume from step {saved}: parameters, "
          f"BatchNorm buffers, optimizer state and step {a.step} bitwise "
          f"equal; bf16 launches forward {fwd}, backward {bwd}, float32 "
          f"none; unbroken train loss first "
          f"{straight['train_losses'][0]:.6f}; resumed last "
          f"{second['train_losses'][-1]:.6f}; val {second['val_losses']}; "
          "ms per step by epoch (host clock, data loading included), "
          "unbroken: " + ", ".join(f"{ms:.3f}"
                                   for ms in straight["ms_per_step"])
          + "; resumed: " + ", ".join(f"{ms:.3f}"
                                      for ms in second["ms_per_step"]),
          flush=True)
    return second, (fwd, bwd)


def phase_bf16_serving(tree, workdir, checkpoint):
    """(d) BF16_SHAPE at 140,000 points, gaussian sigma BF16_LEVEL, served
    with the bf16 checkpoint (``--checkpoint_low none``) by host and by
    device voting: 10 bf16 forward launches per batch on each path and no
    float32 one, the device's offsets within VOTE_TOL of the host's as in
    phase 9; then the same checkpoint served by the float32 twin's config
    (float32 from the same weights), host voting, for points/s beside.
    Returns the bf16 launches of the two bf16 runs."""
    batch_size = int(load_config(os.path.join(
        ROOT, "cfgs", BF16_CONFIG + ".yaml")).batch_size)
    root = os.path.join(workdir, "bf16_serve")
    os.makedirs(os.path.join(root, "qualitative_test"))
    shutil.copy(os.path.join(tree, "qualitative_test", BF16_SHAPE + ".off"),
                os.path.join(root, "qualitative_test"))
    runs, total = {}, 0
    for name, config, voting in (
            ("bf16 host", BF16_CONFIG, "host"),
            ("bf16 device", BF16_CONFIG, "device"),
            ("float32 host", FP32_TWIN, "host")):
        argv = ["--config_file", os.path.join(ROOT, "cfgs", config + ".yaml"),
                "--data_root", root, "--out_dir",
                os.path.join(workdir, "bf16_out_" + name.replace(" ", "_")),
                "--checkpoint", checkpoint, "--checkpoint_low", "none",
                "--noise_type", "gaussian", "--noise_level",
                str(BF16_LEVEL), "--device", "cuda"]
        if voting == "device":
            argv.append("--device_voting")
        for w in (kpconv_aggregate, kpconv_aggregate_backward):
            w.launches = w.launches_bf16 = 0
        summary = infer.main(argv)
        batches = -(-len(summary["dataset"]) // batch_size)
        want = (0, 10 * batches) if config == BF16_CONFIG \
            else (10 * batches, 0)
        got = (kpconv_aggregate.launches, kpconv_aggregate.launches_bf16)
        if got != want or kpconv_aggregate_backward.launches \
                or kpconv_aggregate_backward.launches_bf16:
            raise AssertionError(f"{name} serving launched (float32, bf16) "
                                 f"{got} forward kernels, not {want}")
        res = summary["results"][0]
        if not np.isfinite(res["offsets"]).all():
            raise AssertionError(f"{name} serving: non-finite offsets")
        if config == BF16_CONFIG:
            total += got[1]
        n_points = len(summary["dataset"].shapes[0].points)
        runs[name] = summary
        print(f"{name} voting: {n_points} points, {batches} batches, "
              f"{n_points / summary['seconds']:.1f} points/s "
              f"({summary['seconds']:.3f} s)", flush=True)
    worst = check_votes(runs["bf16 device"], runs["bf16 host"], "bf16")
    off32 = runs["float32 host"]["results"][0]["offsets"]
    off16 = runs["bf16 host"]["results"][0]["offsets"]
    print(f"bf16 serving: device vs host offsets max abs diff {worst:.3e} "
          f"(rtol {VOTE_TOL['rtol']} / atol {VOTE_TOL['atol']}); bf16 vs "
          f"float32 offsets (same weights) max abs diff "
          f"{np.abs(off16 - off32).max():.3e} of max-abs "
          f"{np.abs(off32).max():.3e}", flush=True)
    return total


def phase_bf16(device, workdir, tree):
    """Phase 9b, bfloat16 compute: (a) both kernels' bf16 forms against
    their bf16 plain versions, (b) the whole bf16 model and its gradients,
    (c) training with a stop and ``--auto_resume`` against an unbroken
    run, bitwise, (d) serving by host and device voting; then device ms
    per train step in bf16 and in float32 from the same weights, in this
    process.  Returns the two bf16 kernels' records and the launches of
    the main path (training and serving)."""
    cfg = load_config(os.path.join(ROOT, "cfgs", BF16_CONFIG + ".yaml"))
    twin = load_config(os.path.join(ROOT, "cfgs", FP32_TWIN + ".yaml"))
    if (int(cfg.width), str(cfg.compute_dtype), str(twin.compute_dtype)) \
            != (144, "bfloat16", "float32"):
        raise AssertionError(f"{BF16_CONFIG} is no longer the width-144 "
                             f"bfloat16 twin of {FP32_TWIN}")
    records = phase_bf16_kernels(cfg, device,
                                 bf16_stem_15k(device, workdir, tree))
    batch = val_batch(cfg, tree)
    phase_bf16_model(cfg, twin, device, batch)
    phase_model_grad(cfg, device, batch)
    summary, (fwd, bwd) = phase_bf16_training(tree, workdir)
    serve = phase_bf16_serving(
        tree, workdir, os.path.join(workdir, "bf16_resumed", BF16_CONFIG,
                                    "current.pt"))
    trainer = summary["trainer"]
    tensors = {k: torch.as_tensor(v).to(device) for k, v in batch.items()
               if k in ("points", "mask", "features", "offsets")}
    twin_trainer = copy.deepcopy(trainer)  # float32 from the same weights
    set_compute_dtype(twin_trainer.model, None)
    for name, tr in (("bf16", trainer), ("float32", twin_trainer)):
        print(f"-- {name} train steps, width 144, B=16 (one real batch, "
              "the same weights and optimizer state):", flush=True)
        profile_train_steps(tr, tensors)
    return records, {"training": (fwd, bwd), "serving": serve}


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


def val_batch(tcfg, tree, points: int = DEPLOY_TRAIN_POINTS):
    """The first validation batch (the config's B and patch size) of the
    tree at ``points`` points per cloud, with the config's noise and
    outliers."""
    ds = OffsetDataset(tree, "val", in_radius=tcfg.in_radius,
                       num_points=tcfg.num_points, num_steps=16,
                       num_epochs=1, noise_type=tcfg.noise_type,
                       noise_level=tcfg.noise_level,
                       num_points_per_shape=points,
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


def phase_15k_kernels(cfg, device, batch, source: str,
                      float64: bool = False):
    """Both kernels against plain at the ten calls of a 15k forward on a
    real pyramid (``batch``: B=8, 15,000 slots, sparse patches, of
    ``source``): the forward at KERNEL_TOL, the backward's training
    variant and d_rel variant at BWD_RTOL and BWD_ATOL_FRAC of the largest
    gradient (with ``float64``, against the plain backward in float64 as
    ``check_grad_float64`` says), bitwise reproducible; each call's live
    edges, in-degrees, device us and bounds over the live edges.  Returns
    the 15k block of each kernel's JSON record."""
    rng = np.random.default_rng(11)
    B, P = int(cfg.batch_size), int(cfg.pseudo_grid.num_kernel_points)
    r0 = float(cfg.radius)
    recs = {k: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                    bytes=0.0, ops=0.0, max_abs_err=0.0,
                    device_us_per_call={})
            for k in ("fwd", "bwd")}
    print("15k call M N K C | live edges / slots, in-degree mean max | "
          "fwd max_abs, bwd d_feat d_kw d_rel max_abs | fwd device_us "
          "bound_us (by) | bwd device_us bound_us (by) | wrapper ms fwd "
          "bwd, plain ms fwd bwd")
    for name, M, N, K, C, mult, idx, rel, fmask in pyramid_calls(
            cfg, device, batch, CALLS_15K):
        extent = 2.0 * r0 * mult / 5.0
        kp = torch.from_numpy(create_kernel_points(1.5 * extent, P)).to(
            device)
        feat, kw, g = (torch.from_numpy(a.astype(np.float32)).to(device)
                       for a in (rng.normal(size=(B, N, C)),
                                 rng.normal(size=(P, C)) * math.sqrt(2.0 / C),
                                 rng.normal(size=(B, M, C))))
        args = (feat, idx, rel, fmask, kp, kw)
        with torch.no_grad():
            got = kpconv_aggregate(*args, extent, "linear")
            torch.cuda.synchronize()
            want = kpconv_aggregate_plain(*args, extent, "linear")
            fwd_err, _ = check_close(got, want, what=f"15k kpconv {name}",
                                     **KERNEL_TOL)
        del got, want
        got = kpconv_aggregate_backward(*args, g, extent, "linear")
        got_rel = kpconv_aggregate_backward(*args, g, extent, "linear",
                                            need_rel=True)
        torch.cuda.synchronize()
        want = kpconv_aggregate_backward_plain(*args, g, extent, "linear",
                                               need_rel=True)
        if float64:
            want64 = kpconv_aggregate_backward_plain(
                *[a.double() if a.is_floating_point() else a for a in args],
                g.double(), extent, "linear", need_rel=True)
            pairs = [check_grad_float64(a, b, c, f"15k backward {name} "
                                        f"{what}{variant}")
                     for out, variant, names in (
                         (got, "", ("d_feat", "d_kw")),
                         (got_rel, ", d_rel variant",
                          ("d_feat", "d_kw", "d_rel")))
                     for a, b, c, what in zip(out, want, want64, names)]
            errs = [max(pairs[0][0], pairs[2][0]),
                    max(pairs[1][0], pairs[3][0]), pairs[4][0]]
            print(f"{name}: from float64, kernel / plain float32: d_feat "
                  f"{errs[0]:.3e} / {pairs[0][1]:.3e}, d_kw {errs[1]:.3e} / "
                  f"{pairs[1][1]:.3e}, d_rel {errs[2]:.3e} / "
                  f"{pairs[4][1]:.3e}", flush=True)
            del want64
        else:
            errs = [check_grad_close(a, b, f"15k backward {name} {what}")
                    for a, b, what in zip(got, want, ("d_feat", "d_kw"))]
            errs += [check_grad_close(a, b, f"15k backward {name} {what}, "
                                      "d_rel variant")
                     for a, b, what in zip(got_rel, want,
                                           ("d_feat", "d_kw", "d_rel"))]
            errs = [max(errs[0], errs[2]), max(errs[1], errs[3]), errs[4]]
        del got, got_rel, want
        check_reproducible(args, g, extent, "linear", f"15k {name}")

        def fwd():
            with torch.no_grad():
                return kpconv_aggregate(*args, extent, "linear")

        def plain_fwd():
            with torch.no_grad():
                return kpconv_aggregate_plain(*args, extent, "linear")

        def bwd():
            return kpconv_aggregate_backward(*args, g, extent, "linear")

        def plain_bwd():
            return kpconv_aggregate_backward_plain(*args, g, extent,
                                                   "linear")

        timed = dict(fwd=(cuda_ms(fwd, 20), device_us(
            fwd, "kpconv_fwd_kernel", 10), cuda_ms(plain_fwd, 3, 1)),
            bwd=(cuda_ms(bwd, 10), device_us(bwd, "kpconv_bwd", 10,
                                             expect=BWD_KERNELS),
                 cuda_ms(plain_bwd, 3, 1)))
        live, mean_deg, max_deg = in_degrees(fmask, idx, N)
        bounds = dict(fwd=kpconv_bound(B, M, N, K, C, P, live),
                      bwd=kpconv_bwd_bound(B, M, N, K, C, P, live))
        line = []
        for k, err in (("fwd", fwd_err), ("bwd", max(errs))):
            ms, us, plain_ms = timed[k]
            t_bytes, t_ops = bounds[k]
            rec = recs[k]
            for key, v in (("ms", ms), ("device_ms", us / 1e3),
                           ("plain_ms", plain_ms),
                           ("bound_ms", max(t_bytes, t_ops)),
                           ("bytes", t_bytes), ("ops", t_ops)):
                rec[key] += v
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["device_us_per_call"][name] = us
            line.append(f"{us:.2f} {max(t_bytes, t_ops) * 1e3:.2f} "
                        f"({'bytes' if t_bytes >= t_ops else 'operations'})")
        print(f"{name} {M} {N} {K} {C} | {live} / {B * M * K}, "
              f"{mean_deg:.1f} {max_deg} | {fwd_err:.3e}, {errs[0]:.3e} "
              f"{errs[1]:.3e} {errs[2]:.3e} | {line[0]} | {line[1]} | "
              f"{timed['fwd'][0]:.4f} {timed['bwd'][0]:.4f}, "
              f"{timed['fwd'][2]:.4f} {timed['bwd'][2]:.4f}", flush=True)
    for k, rec in recs.items():
        rec["bound_by"] = "bytes" if rec.pop("bytes") >= rec.pop("ops") \
            else "operations"
        rec["timed_at"] = ("sum over the ten calls of one 15k forward "
                           f"(backward), B=8, on a real pyramid of {source}"
                           "; bounds over the live edges")
        print(f"15k, ten calls, {k}: wrapper {rec['ms']:.4f} ms, device "
              f"{rec['device_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})",
              flush=True)
    return recs


def phase_15k_remat(config: str, device, batch):
    """One train step (forward, the config's loss, backward) with remat=1
    and two with remat=0, from the same weights on one pyramid of
    ``batch``: the same loss, gradients, BatchNorm running statistics and
    ``num_batches_tracked``, bitwise (the two remat=0 steps too: every
    kernel of the step, the Chamfer loss's gather included, adds in a
    fixed order), 19 and 10 forward launches against 10 and 10; the peak
    memory of each."""
    runs = []
    tensors = {k: torch.as_tensor(batch[k]).to(device)
               for k in ("points", "mask", "features", "offsets")}
    pyramid = None
    for remat in (0, 1, 0):
        tcfg = load_config(os.path.join(ROOT, "cfgs", config + ".yaml"),
                           {"remat": remat})
        model = build_offset_regression(
            tcfg, torch.Generator().manual_seed(0)).to(device).train()
        if pyramid is None:
            with torch.no_grad():
                pyramid = model.make_pyramid(tensors["points"],
                                             tensors["mask"])
        loss_fn = get_offset_regression_loss(tcfg.loss)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kpconv_aggregate.launches = 0
        kpconv_aggregate_backward.launches = 0
        pred = model.head(pyramid, model.ResNetEncoder_0(
            pyramid, tensors["features"]))
        loss = loss_fn(pred, tensors["offsets"], tensors["mask"],
                       tensors["points"])
        loss.backward()
        torch.cuda.synchronize()
        runs.append(dict(
            loss=loss.item(), launches=(kpconv_aggregate.launches,
                                        kpconv_aggregate_backward.launches),
            peak=torch.cuda.max_memory_allocated() - base,
            grads={n: p.grad for n, p in model.named_parameters()},
            buffers=dict(model.named_buffers())))
        del pred, loss, model
    plain, remat, again = runs
    if [r["launches"] for r in runs] != [(10, 10), (19, 10), (10, 10)]:
        raise AssertionError("remat launches "
                             f"{[r['launches'] for r in runs]}; expected "
                             "(10, 10), (19, 10), (10, 10)")
    for what, other in (("remat=1", remat), ("a second remat=0 step",
                                              again)):
        if other["loss"] != plain["loss"]:
            raise AssertionError(f"{what}: loss {other['loss']!r} against "
                                 f"{plain['loss']!r}")
        for kind in ("grads", "buffers"):
            for name, b0 in plain[kind].items():
                b1 = other[kind][name]
                if not torch.equal(b0, b1):
                    raise AssertionError(
                        f"{what}: {kind[:-1]} {name} differs by "
                        f"{(b1.double() - b0.double()).abs().max().item():.3e}"
                        " (bitwise check)")
    print(f"{config} remat=1 against remat=0, one step on one B=8 batch: "
          f"loss {remat['loss']:.8g}; {len(plain['grads'])} gradients, the "
          "running stats and num_batches_tracked bitwise equal (and a second "
          f"remat=0 step bitwise equal to the first); launches "
          f"{remat['launches']} / {plain['launches']}; peak memory of the "
          f"step {remat['peak'] / 2**30:.3f} / {plain['peak'] / 2**30:.3f} "
          "GiB (torch.cuda.max_memory_allocated above the step's start)",
          flush=True)


def phase_15k_training(device, tree, log_dir):
    """The train entry point on both 15k configs at width 144, STEPS_15K
    steps each on the cut tree: every loss finite, parameters and running
    stats changed, 10 forward and 10 backward launches per step; then a
    profiler window over PROFILE_STEPS_15K steps on a validation batch,
    with its stem in-degrees.  Returns the launches (forward, backward)
    and the trainers."""
    fwd = bwd = 0
    trainers = {}
    for config in CONFIGS_15K:
        path = os.path.join(ROOT, "cfgs", config + ".yaml")
        tcfg = load_config(path)
        argv = ["--config_file", path, "--data_root", tree,
                "--log_dir", log_dir,
                "--num_steps", str(STEPS_15K * int(tcfg.batch_size)),
                "--epochs", "1", "--val_freq", "1", "--device", "cuda"]
        kpconv_aggregate.launches = 0
        kpconv_aggregate_backward.launches = 0
        summary = train_cli.main(argv)
        f, b = kpconv_aggregate.launches, kpconv_aggregate_backward.launches
        steps, val_batches = summary["steps"], summary["val_batches"]
        if steps != STEPS_15K or (f, b) != (10 * (steps + val_batches),
                                            10 * steps):
            raise AssertionError(f"{config}: {steps} steps, {val_batches} "
                                 f"val batches, {f} forward and {b} "
                                 "backward launches")
        losses = summary["train_losses"] + summary["val_losses"]
        if not np.isfinite(losses).all():
            raise AssertionError(f"{config}: losses {losses}")
        trainer = summary["trainer"]
        start = build_offset_regression(trainer.cfg, torch.Generator(
            ).manual_seed(int(trainer.cfg.rng_seed))).state_dict()
        for name, value in trainer.model.state_dict().items():
            if not name.endswith("num_batches_tracked") \
                    and torch.equal(value.cpu(), start[name]):
                raise AssertionError(f"{config}: training left {name} "
                                     "unchanged")
        fwd, bwd = fwd + f, bwd + b
        print(f"{config} ({trainer.cfg.optimizer}, {trainer.cfg.loss}, "
              f"outliers {trainer.cfg.outlier_percentage}): {steps} steps, "
              f"val batches {val_batches}; launches: forward {f}, backward "
              f"{b}; train losses " + ", ".join(
                  f"{v:.6f}" for v in summary["train_losses"])
              + f"; val loss {summary['val_losses']}; ms per step (host "
              f"clock, data loading and the first step included) "
              f"{summary['ms_per_step'][0]:.3f}", flush=True)
        batch = val_batch(trainer.cfg, tree, POINTS_15K)
        stem = pyramid_calls(trainer.cfg, device, batch, CALLS_15K)[0]
        live, mean_deg, max_deg = in_degrees(stem[8], stem[6], stem[2])
        print(f"{config}: profiled validation batch: real slots per patch "
              + " ".join(str(int(c)) for c in batch["mask"].sum(1))
              + f"; stem live edges {live}, in-degree mean {mean_deg:.1f}, "
              f"max {max_deg}", flush=True)
        keys = ("points", "mask", "features", "offsets", "labels")
        profile_train_steps(trainer, {k: torch.from_numpy(batch[k]).cuda()
                                      for k in keys}, PROFILE_STEPS_15K)
        trainers[config] = trainer
    return (fwd, bwd), trainers


def phase_15k_serving(workdir, tree, log_dir):
    """The inference entry point on SHAPE_15K (140,000 points, gaussian
    sigma 0.5%) with the 15k Chamfer checkpoint, host and device voting:
    BATCHES_15K batches of 8, 10 forward launches each, no backward,
    outputs finite, device within VOTE_TOL of host.  Returns the forward
    launches."""
    root = os.path.join(workdir, "serve15k")
    os.makedirs(os.path.join(root, "qualitative_test"))
    shutil.copy(os.path.join(tree, "qualitative_test", SHAPE_15K + ".off"),
                os.path.join(root, "qualitative_test"))
    config = os.path.join(ROOT, "cfgs", CONFIGS_15K[0] + ".yaml")
    ckpt = os.path.join(log_dir, CONFIGS_15K[0], "current.pt")
    runs, fwd = {}, 0
    for voting in ("host", "device"):
        argv = ["--config_file", config, "--data_root", root, "--out_dir",
                os.path.join(workdir, f"out15k_{voting}"), "--checkpoint",
                ckpt, "--checkpoint_low", "none", "--noise_type",
                "gaussian", "--noise_level", "0.005", "--device", "cuda"]
        if voting == "device":
            argv.append("--device_voting")
        kpconv_aggregate.launches = 0
        kpconv_aggregate_backward.launches = 0
        summary = infer.main(argv)
        launches = kpconv_aggregate.launches
        if kpconv_aggregate_backward.launches:
            raise AssertionError("15k serving launched the backward kernel")
        dataset = summary["dataset"]
        batches = -(-len(dataset) // 8)
        if (batches, launches) != (BATCHES_15K, 10 * BATCHES_15K):
            raise AssertionError(
                f"15k {voting} voting: {len(dataset)} patches, {batches} "
                f"batches, {launches} forward launches; expected "
                f"{BATCHES_15K} batches, {10 * BATCHES_15K} launches")
        res, shape = summary["results"][0], dataset.shapes[0]
        if res["offsets"].shape != shape.points.shape \
                or not np.isfinite(res["offsets"]).all():
            raise AssertionError(f"15k {voting} voting: bad offsets")
        fwd += launches
        runs[voting] = summary
        n = len(shape.points)
        print(f"15k serving {SHAPE_15K} ({n} points, {len(dataset)} "
              f"patches of 15,000 slots, {batches} batches) {voting} "
              f"voting: {n / summary['seconds']:.1f} points/s "
              f"({summary['seconds']:.3f} s), forward launches {launches}",
              flush=True)
    worst = check_votes(runs["device"], runs["host"], "15k serving")
    print(f"15k serving: device vs host offsets max abs diff {worst:.3e} "
          f"(rtol {VOTE_TOL['rtol']} / atol {VOTE_TOL['atol']})", flush=True)
    return fwd


def phase_15k(device, workdir):
    """Phase 11, the 15,000-slot family: kernels against plain at the 15k
    calls, the whole model's forward and gradients, remat, both configs
    trained through the entry point, and serving by host and device
    voting.  Returns each kernel's 15k record and the launches of the
    entry points' runs: {"training": (fwd, bwd), "serving": fwd}."""
    full = os.path.join(workdir, "shapes")
    make_synthetic_dataset.write_tree(full, verbose=False)
    tree = os.path.join(workdir, "shapes15k")
    for split, names in TREE_15K.items():
        os.makedirs(os.path.join(tree, split))
        for name in names:
            shutil.copy(os.path.join(full, split, name + ".off"),
                        os.path.join(tree, split))
    cfg = load_config(os.path.join(ROOT, "cfgs", CONFIGS_15K[0] + ".yaml"))
    if (int(cfg.width), int(cfg.num_points), list(cfg.nsamples),
            list(cfg.npoints)) != (144, 15000, [26, 31, 38, 41, 39],
                                   [4096, 1152, 304, 88]):
        raise AssertionError("the 15k config is no longer width 144 on the "
                             "15k schedule")
    t0 = time.perf_counter()
    batch = val_batch(cfg, tree, POINTS_15K)
    print(f"one validation batch of {CONFIGS_15K[0]} (shapes processed "
          f"included): {time.perf_counter() - t0:.3f} s; real slots per "
          "patch " + " ".join(str(int(c)) for c in batch["mask"].sum(1)),
          flush=True)
    records = phase_15k_kernels(cfg, device, batch,
                                f"{CONFIGS_15K[0]} validation patches")
    phase_model(cfg, device, batch)
    phase_model_grad(cfg, device, batch)
    phase_15k_remat(CONFIGS_15K[0], device, batch)
    log_dir = os.path.join(workdir, "log15k")
    train_launches, _ = phase_15k_training(device, tree, log_dir)
    serve = phase_15k_serving(workdir, full, log_dir)
    return records, {"training": train_launches, "serving": serve}


def seg_training(device, scans, log_dir):
    """Phase 12(c): ``train_outlier_seg`` at width 144, STEPS_SEG steps and
    a validation pass on the scans: every loss finite, parameters and
    running stats changed, 10 forward and 10 backward launches per step;
    then a profiler window over PROFILE_STEPS_SEG steps on a validation
    batch, with its stem in-degrees.  Returns the launches (forward,
    backward) and the checkpoint."""
    path = os.path.join(ROOT, "cfgs", SEG_CONFIG + ".yaml")
    B = int(load_config(path).batch_size)
    argv = ["--config_file", path, "--data_root", scans, "--log_dir",
            log_dir, "--num_steps", str(STEPS_SEG * B), "--epochs", "1",
            "--val_freq", "1", "--DEBUG", "1", "--device", "cuda"]
    kpconv_aggregate.launches = 0
    kpconv_aggregate_backward.launches = 0
    summary = train_outlier_seg.main(argv)
    f, b = kpconv_aggregate.launches, kpconv_aggregate_backward.launches
    steps, val_batches = summary["steps"], summary["val_batches"]
    if steps != STEPS_SEG or (f, b) != (10 * (steps + val_batches),
                                        10 * steps):
        raise AssertionError(f"{SEG_CONFIG}: {steps} steps, {val_batches} "
                             f"val batches, {f} forward and {b} backward "
                             "launches")
    losses = summary["train_losses"] + summary["val_losses"]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{SEG_CONFIG}: losses {losses}")
    trainer = summary["trainer"]
    start = build_model(trainer.cfg, int(trainer.cfg.rng_seed)).state_dict()
    for name, value in trainer.model.state_dict().items():
        if not name.endswith("num_batches_tracked") \
                and torch.equal(value.cpu(), start[name]):
            raise AssertionError(f"{SEG_CONFIG}: training left {name} "
                                 "unchanged")
    print(f"{SEG_CONFIG} ({trainer.cfg.optimizer}, {trainer.cfg.loss}, "
          f"features {list(trainer.cfg.features)} "
          f"{list(trainer.cfg.katz_params)}): {steps} steps, val batches "
          f"{val_batches}; launches: forward {f}, backward {b}; train "
          "losses " + ", ".join(
              f"{v:.6f}" for v in summary["train_losses"])
          + f"; val loss {summary['val_losses']}; ms per step (host clock, "
          f"data loading and the first step included) "
          f"{summary['ms_per_step'][0]:.3f}", flush=True)
    val = OutlierSegmentationDataset(
        scans, "val", num_steps=B, **train_outlier_seg.dataset_kwargs(
            trainer.cfg, None))
    batch = next(iter(BatchLoader(val, B).epoch_iter(0)))
    stem = pyramid_calls(trainer.cfg, device, batch, CALLS_15K)[0]
    live, mean_deg, max_deg = in_degrees(stem[8], stem[6], stem[2])
    print(f"{SEG_CONFIG}: profiled validation batch: real slots per patch "
          + " ".join(str(int(c)) for c in batch["mask"].sum(1))
          + f"; stem live edges {live}, in-degree mean {mean_deg:.1f}, "
          f"max {max_deg}", flush=True)
    profile_train_steps(trainer, {
        k: torch.from_numpy(batch[k]).cuda()
        for k in ("points", "mask", "features", "labels")},
        PROFILE_STEPS_SEG)
    return (f, b), summary["checkpoint"]


def seg_evaluation(scans, checkpoint, workdir):
    """Phase 12(d): ``evaluate_outlier_seg`` on the held-out scans with
    the checkpoint of (c), twice: BATCHES_SEG batches, 10 forward launches
    each and no backward, the metric table, and the second run's written
    probabilities and classes bitwise equal to the first's.  Returns the
    first run's forward launches."""
    path = os.path.join(ROOT, "cfgs", SEG_CONFIG + ".yaml")
    runs = []
    for run in range(2):
        out_dir = os.path.join(workdir, f"seg_eval_{run}")
        kpconv_aggregate.launches = 0
        kpconv_aggregate_backward.launches = 0
        out = evaluate_outlier_seg.main([
            "--config_file", path, "--data_root", scans, "--load_path",
            checkpoint, "--DEBUG", "1", "--write_dir", out_dir,
            "--device", "cuda"])
        launches = kpconv_aggregate.launches
        if kpconv_aggregate_backward.launches:
            raise AssertionError("the evaluation launched the backward "
                                 "kernel")
        if (out["batches"], launches) != (BATCHES_SEG, 10 * BATCHES_SEG):
            raise AssertionError(
                f"evaluation: {len(out['dataset'])} patches, "
                f"{out['batches']} batches, {launches} forward launches; "
                f"expected {BATCHES_SEG} batches, {10 * BATCHES_SEG}")
        ds = out["dataset"]
        points = sum(len(p) for p in ds.clouds_points)
        counts = sum(out["metrics"][k] for k in ("TN", "FP", "FN", "TP"))
        if counts != points:
            raise AssertionError(f"evaluation: {counts} points counted of "
                                 f"{points}")
        plys = [read_ply(os.path.join(out_dir, f"{n}_eval.ply"))
                for n in ds.cloud_names]
        for ply in plys:
            if not np.isfinite(ply["proba"]).all():
                raise AssertionError("evaluation: non-finite probability")
        runs.append((plys, launches))
        print(f"evaluation run {run + 1}: {ds.cloud_names}, {points} points, "
              f"{len(ds)} patches of 15,000 slots, {out['batches']} "
              f"batches, {out['seconds']:.3f} s, "
              f"{points / out['seconds']:.1f} points/s; forward launches "
              f"{launches}; metrics " + json.dumps(out["metrics"]),
              flush=True)
    for a, b in zip(runs[0][0], runs[1][0]):
        for key in ("proba", "pred"):
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"evaluation: a second run's {key} "
                                     "differs")
    print("evaluation: the second run's voted probabilities and classes "
          "bitwise equal to the first's", flush=True)
    return runs[0][1]


def phase_seg(device, workdir):
    """Phase 12, outlier segmentation: the stand-in scans, (a) both kernels
    against plain at the ten calls of one real B=8 training batch, (b) the
    whole model's forward and CE gradients, (c) training and (d) the
    voting evaluation through the entry points.  Returns the kernels'
    records and the launches {"training": (fwd, bwd), "eval": fwd}."""
    scans = os.path.join(workdir, "scans")
    make_scans(scans, n=SEG_POINTS, diameter=1.0, write=SEG_SCANS,
               cut=SEG_HELD_OUT, corner=SEG_CORNER)
    cfg = load_config(os.path.join(ROOT, "cfgs", SEG_CONFIG + ".yaml"),
                      {"DEBUG": 1})
    if (int(cfg.width), int(cfg.num_points), list(cfg.nsamples),
            list(cfg.npoints), int(cfg.input_features_dim),
            int(cfg.num_classes), cfg.head) != (
                144, 15000, [26, 31, 38, 41, 39], [4096, 1152, 304, 88], 3,
                2, "resnet_scene_seg"):
        raise AssertionError(f"{SEG_CONFIG} is no longer width 144 on the "
                             "15k schedule with three Katz channels and two "
                             "classes")
    t0 = time.perf_counter()
    B = int(cfg.batch_size)
    train = OutlierSegmentationDataset(
        scans, "train", num_steps=STEPS_SEG * B,
        transforms=build_train_transforms(cfg),
        **train_outlier_seg.dataset_kwargs(cfg, None))
    batch = next(iter(BatchLoader(train, B, drop_last=True).epoch_iter(0)))
    print(f"train split {train.cloud_names} (scans read, Katz features, "
          f"voxel pre-subsampling and projections included): "
          f"{time.perf_counter() - t0:.3f} s; first training batch: real "
          "slots per patch " + " ".join(
              str(int(c)) for c in batch["mask"].sum(1)) + ", outlier "
          "points among them " + " ".join(
              str(int(batch["labels"][i][batch["mask"][i] > 0].sum()))
              for i in range(B)), flush=True)
    records = phase_15k_kernels(cfg, device, batch,
                                f"{SEG_CONFIG} training patches",
                                float64=True)
    phase_model(cfg, device, batch)
    phase_model_grad(cfg, device, batch)
    log_dir = os.path.join(workdir, "log_seg")
    train_launches, checkpoint = seg_training(device, scans, log_dir)
    eval_launches = seg_evaluation(scans, checkpoint, workdir)
    return records, {"training": train_launches, "eval": eval_launches}


def to_device(obj, device):
    """A pyramid (nested named tuples of tensors and floats) on
    ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        items = [to_device(o, device) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") \
            else type(obj)(items)
    return obj


def agg_paths(model, pyramid, batch, train: bool, paths=AGG_PATHS):
    """One forward of ``model`` (on the card, in float32) on ``pyramid``
    by each of ``paths``, each from its own copy of the model: ``card``
    and ``cpu`` (float32), ``float64`` (on the card), ``cpu_float64`` and
    ``cpu_nudged`` (float32 on the CPU with every input feature one
    float32 ulp up: how far rounding-sized changes move the result).  In
    train mode the masked L1 loss's gradients of every parameter too.
    Returns ``{path: (output, [gradients])}``."""
    cpu = torch.device("cpu")
    out = {}
    for path in paths:
        m, pyr, b = copy.deepcopy(model), pyramid, batch
        if path.endswith("float64"):
            m = grad_check.float64_copy(model)
            b = {k: v.double() if v.is_floating_point() else v
                 for k, v in batch.items()}
        if path.startswith("cpu"):
            m, pyr = m.to(cpu), to_device(pyramid, cpu)
            b = {k: v.to(cpu) for k, v in b.items()}
            if path == "cpu_nudged":
                b = dict(b, features=torch.nextafter(
                    b["features"], torch.tensor(math.inf)))
        m.train(train)
        with torch.set_grad_enabled(train):
            y = m.head(pyr, m.ResNetEncoder_0(pyr, b["features"]))
            grads = []
            if train:
                loss = masked_l1_loss(y, b["offsets"], b["mask"])
                grads = torch.autograd.grad(loss, list(m.parameters()))
        out[path] = (y.detach(), [g.detach() for g in grads])
    return out


def _hold_float32(name, names, res, train: bool, samples):
    """The float32 rule of :func:`check_agg_paths` with each tensor's
    noise the largest distance from float64 among the paths ``samples``;
    returns the forward's worst ratio to its limit, the gradients' (ratio,
    name), the count of zero gradients and the tensors that no sample pins
    and that the card misses (held to be finite only)."""
    ref = res["float64"][0]
    worst, zeros, unpinned = [0.0, (0.0, "")], 0, []

    def hold(what, got, plain, ref, others, distance, floor):
        noises = [distance(o.to(ref.device), ref) for o in others]
        limit = max(grad_check.NOISE_FACTOR * max(noises), floor)
        d = distance(got, plain.to(got.device))
        if d <= limit:
            return d / limit
        spread = max(grad_check.l2_distance(o.to(ref.device), ref)
                     for o in others)
        if len(samples) > 1 and spread >= grad_check.FULL_PATH_FLOOR \
                / grad_check.NOISE_FACTOR:
            unpinned.append((d, what))
            return 0.0
        raise AssertionError(
            f"{name} ({'train' if train else 'eval'}): {what} on the card "
            f"{d:.3e} from the CPU's (limit {limit:.3e}; float32 noise "
            + ", ".join(f"{x:.3e}" for x in noises) + ")")

    got = res["card"][0]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output on the card")
    for what, distance, floor in (
            ("output max-abs", grad_check.max_abs_distance,
             grad_check.SAME_GRAPH_FLOOR),
            ("output L2", grad_check.l2_distance,
             grad_check.FULL_PATH_FLOOR)):
        worst[0] = max(worst[0], hold(
            what, got, res["cpu"][0], ref, [res[k][0] for k in samples],
            distance, floor))
    for i, n in enumerate(names if train else ()):
        g, r = res["card"][1][i], res["float64"][1][i]
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: gradient of {n} is non-finite")
        if r.abs().max() == 0:
            if g.abs().max() != 0:
                raise AssertionError(f"{name}: gradient of {n} is zero in "
                                     "float64, not on the card")
            zeros += 1
            continue
        ratio = hold(f"gradient of {n}", g, res["cpu"][1][i], r,
                     [res[k][1][i] for k in samples],
                     grad_check.l2_distance, grad_check.FULL_PATH_FLOOR)
        worst[1] = max(worst[1], (ratio, n))
    return worst[0], worst[1], zeros, unpinned


def _hold_float64(name, names, res, train: bool):
    """The card's float64 forward and gradients against the CPU's: the
    output within AGG_FLOAT64_TOL of its max-abs; each gradient within
    AGG_FLOAT64_TOL of its L2 norm, or, where that norm is below
    AGG_FLOAT64_VANISH of the largest gradient's (zero by construction),
    the card's below it too.  Returns the largest relative distance."""
    card, cpu = res["float64"], res["cpu_float64"]
    worst = grad_check.max_abs_distance(card[0], cpu[0].to(card[0].device))
    if worst > AGG_FLOAT64_TOL:
        raise AssertionError(f"{name}: float64 output on the card "
                             f"{worst:.3e} from the CPU's")
    if not train:
        return worst
    largest = max(float(g.norm()) for g in cpu[1])
    for n, a, b in zip(names, card[1], cpu[1]):
        b = b.to(a.device)
        if float(b.norm()) <= AGG_FLOAT64_VANISH * largest:
            if float(a.norm()) > AGG_FLOAT64_VANISH * largest:
                raise AssertionError(f"{name}: float64 gradient of {n} "
                                     "vanishes on the CPU, not on the card")
            continue
        d = grad_check.l2_distance(a, b)
        worst = max(worst, d)
        if d > AGG_FLOAT64_TOL:
            raise AssertionError(f"{name}: float64 gradient of {n} on the "
                                 f"card {d:.3e} from the CPU's")
    return worst


def check_agg_paths(name, names, res, train: bool, more_paths):
    """The card held to the CPU.  Float32: the output's max-abs and L2
    distances from the CPU's (floors SAME_GRAPH_FLOOR, FULL_PATH_FLOOR)
    and each gradient's relative L2 distance (floor FULL_PATH_FLOOR), each
    within NOISE_FACTOR times that tensor's float32 noise, the CPU's
    distance from float64 (``grad_check``'s per-tensor rule); all finite;
    a gradient exactly zero in float64 (every unit behind a ReLU dead)
    exactly zero on the card too.  Where one noise sample leaves a tensor
    over its limit, ``more_paths(("cpu_nudged",))`` adds a second float32
    sample (each noise is then the larger of the two).  A tensor that the
    card still misses and that float32 does not pin (a sample misses
    float64 by at least FULL_PATH_FLOOR / NOISE_FACTOR in relative L2) is
    float32 noise of an ill-conditioned computation (a softmax over
    unnormalised channel products, a BatchNorm scale over one channel): it
    is held to be finite, and then ``more_paths(("cpu_float64",))`` and
    the card's float64 forward and gradients must equal the CPU's within
    AGG_FLOAT64_TOL, which shows that the card computes the same function.
    Returns the forward's and the gradients' worst ratios, the zero count
    and a note."""
    try:
        fwd, grad, zeros, unpinned = _hold_float32(name, names, res, train,
                                                   ("cpu",))
        return fwd, grad, zeros, ""
    except AssertionError as first:
        print(f"{name}: one float32 noise sample: {first}; taking a "
              "second", flush=True)
    res.update(more_paths(("cpu_nudged",)))
    fwd, grad, zeros, unpinned = _hold_float32(
        name, names, res, train, ("cpu", "cpu_nudged"))
    note = " (two float32 noise samples"
    if unpinned:
        res.update(more_paths(("cpu_float64",)))
        d64 = _hold_float64(name, names, res, train)
        d, what = max(unpinned)
        note += (f"; {len(unpinned)} tensor(s) that float32 does not pin, "
                 f"largest {what} at {d:.3e} from the CPU's; float64 "
                 f"card = CPU within {d64:.3e}")
    return fwd, grad, zeros, note + ")"


def agg_batch(tree):
    """Phase 13's batch: the first validation batch of phase 9's tree for
    AGG_CONFIGS[0], which every config of AGG_CONFIGS shares (B, N, patch
    radius, neighbourhoods)."""
    cfgs = {n: load_config(os.path.join(ROOT, "cfgs", n + ".yaml"))
            for n in AGG_CONFIGS}
    geo = {n: (int(c.width), int(c.depth), int(c.batch_size),
               int(c.num_points), float(c.in_radius), float(c.radius),
               list(c.nsamples), list(c.npoints))
           for n, c in cfgs.items()}
    if len({str(g) for g in geo.values()}) != 1 \
            or geo[AGG_CONFIGS[0]][:4] != (144, 2, 16, 500):
        raise AssertionError(f"phase 13's configs no longer share width "
                             f"144, depth 2, B=16, N=500: {geo}")
    return cfgs, val_batch(cfgs[AGG_CONFIGS[0]], tree)


def agg_numerics(device, cfgs, batch):
    """13(a): for each config, the seeded model (O(1) statistics, gates and
    head) on one real batch: the eval forward, the train forward and the
    train-mode gradients on the card held to the CPU and float64
    (:func:`check_agg_paths`), with no KPConv kernel launched."""
    tensors = {k: torch.as_tensor(batch[k]).to(device)
               for k in ("points", "mask", "features", "offsets")}
    launches = grad_check.launches()
    for name, cfg in cfgs.items():
        t0 = time.perf_counter()
        model = seeded_model(cfg, device)
        names = [n for n, _ in model.named_parameters()]
        with torch.no_grad():
            pyramid = model.make_pyramid(tensors["points"], tensors["mask"])
        line = []
        for train in (False, True):
            res = agg_paths(model, pyramid, tensors, train)
            fwd, (grad, gname), zeros, note = check_agg_paths(
                name, names, res, train, lambda paths: agg_paths(
                    model, pyramid, tensors, train, paths))
            line.append(f"{'train' if train else 'eval'} forward at "
                        f"{fwd:.3f} of its limit{note}")
        print(f"{name} ({cfg.local_aggregation_type}"
              + (f" {cfg.attention.type}" if cfg.local_aggregation_type
                 == "attention" else "")
              + f"): {'; '.join(line)}; {len(names)} gradients ({zeros} "
              f"zero in float64 and on the card), nearest {gname} at "
              f"{grad:.3f} of its limit; |out| max "
              f"{res['card'][0].abs().max().item():.3f}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if grad_check.launches() != launches:
        raise AssertionError("phase 13(a) launched a KPConv kernel")


def agg_training(tree, workdir):
    """13(b): AGG_TRAINED through the train entry point, AGG_EPOCHS epochs
    of AGG_STEPS steps on phase 9's tree, losses finite, parameters moved,
    no KPConv launch; then each checkpoint serves AGG_SHAPE (140,000
    points, gaussian sigma AGG_LEVEL) by host and by device voting, the two
    within VOTE_TOL (and whether bitwise equal).  Returns
    {config: points/s by voting}."""
    serve_root = os.path.join(workdir, "agg_serve")
    os.makedirs(os.path.join(serve_root, "qualitative_test"))
    shutil.copy(os.path.join(tree, "qualitative_test", AGG_SHAPE + ".off"),
                os.path.join(serve_root, "qualitative_test"))
    log_dir = os.path.join(workdir, "agg_log")
    pps = {}
    for name in AGG_TRAINED:
        path = os.path.join(ROOT, "cfgs", name + ".yaml")
        cfg = load_config(path)
        B = int(cfg.batch_size)
        launches = grad_check.launches()
        summary = train_cli.main([
            "--config_file", path, "--data_root", tree, "--log_dir",
            log_dir, "--num_steps", str(AGG_STEPS * B), "--epochs",
            str(AGG_EPOCHS), "--val_freq", "1", "--num_points_per_shape",
            str(DEPLOY_TRAIN_POINTS), "--device", "cuda"])
        losses = summary["train_losses"] + summary["val_losses"]
        if summary["steps"] != AGG_STEPS * AGG_EPOCHS \
                or not np.isfinite(losses).all():
            raise AssertionError(f"{name}: {summary['steps']} steps, "
                                 f"losses {losses}")
        trainer = summary["trainer"]
        start = build_model(trainer.cfg, int(cfg.rng_seed)).state_dict()
        for n, v in trainer.model.state_dict().items():
            if not n.endswith("num_batches_tracked") \
                    and torch.equal(v.cpu(), start[n]):
                raise AssertionError(f"{name}: training left {n} unchanged")
        print(f"{name}: {summary['steps']} steps, val batches "
              f"{summary['val_batches']}; train loss first {losses[0]:.6f} "
              f"last {summary['train_losses'][-1]:.6f}; val loss "
              f"{summary['val_losses']}; ms per step by epoch (host clock, "
              "data loading included) " + ", ".join(
                  f"{ms:.3f}" for ms in summary["ms_per_step"]), flush=True)
        runs = {}
        for voting in ("host", "device"):
            argv = ["--config_file", path, "--data_root", serve_root,
                    "--out_dir", os.path.join(workdir, f"agg_out_{name}_"
                                              f"{voting}"),
                    "--checkpoint", summary["checkpoint"],
                    "--checkpoint_low", "none", "--noise_type", "gaussian",
                    "--noise_level", str(AGG_LEVEL), "--device", "cuda"]
            if voting == "device":
                argv.append("--device_voting")
            runs[voting] = infer.main(argv)
            res = runs[voting]["results"][0]
            if not np.isfinite(res["offsets"]).all():
                raise AssertionError(f"{name} {voting} voting: non-finite "
                                     "offsets")
            n_points = len(runs[voting]["dataset"].shapes[0].points)
            pps.setdefault(name, {})[voting] = \
                n_points / runs[voting]["seconds"]
        worst = check_votes(runs["device"], runs["host"], name)
        same = all(np.array_equal(a["offsets"], b["offsets"]) for a, b in
                   zip(runs["device"]["results"], runs["host"]["results"]))
        if grad_check.launches() != launches:
            raise AssertionError(f"{name} launched a KPConv kernel")
        print(f"{name} serving {AGG_SHAPE} ({n_points} points, "
              f"{len(runs['host']['dataset'])} patches): host voting "
              f"{pps[name]['host']:.1f} points/s, device voting "
              f"{pps[name]['device']:.1f} points/s; device vs host offsets "
              f"max abs diff {worst:.3e} (bitwise equal: {same})",
              flush=True)
    return pps


def agg_segmentation(scans, workdir):
    """13(c): AGG_SEG_CONFIG through ``train_outlier_seg`` (STEPS_SEG steps
    on phase 12's stand-in scans, ``--dataset_type EDFS``: the config names
    no split layout) and ``evaluate_outlier_seg`` on the cut
    held-out scans with its checkpoint: losses finite, every point
    counted, probabilities finite, no KPConv launch."""
    path = os.path.join(ROOT, "cfgs", AGG_SEG_CONFIG + ".yaml")
    cfg = load_config(path, {"DEBUG": 1})
    if (cfg.local_aggregation_type, list(cfg.features), int(cfg.width),
            int(cfg.num_points)) != ("adaptive_weight",
                                     ["intensity", "katz_1"], 144, 15000):
        raise AssertionError(f"{AGG_SEG_CONFIG} is no longer adaptive "
                             "weight over intensity and katz_1 at width "
                             "144 and 15,000 slots")
    launches = grad_check.launches()
    B = int(cfg.batch_size)
    summary = train_outlier_seg.main([
        "--config_file", path, "--data_root", scans, "--log_dir",
        os.path.join(workdir, "agg_seg_log"), "--num_steps",
        str(STEPS_SEG * B), "--epochs", "1", "--val_freq", "1", "--DEBUG",
        "1", "--dataset_type", "EDFS", "--device", "cuda"])
    losses = summary["train_losses"] + summary["val_losses"]
    if summary["steps"] != STEPS_SEG or not np.isfinite(losses).all():
        raise AssertionError(f"{AGG_SEG_CONFIG}: {summary['steps']} steps, "
                             f"losses {losses}")
    print(f"{AGG_SEG_CONFIG}: {summary['steps']} steps, val batches "
          f"{summary['val_batches']}; train losses " + ", ".join(
              f"{v:.6f}" for v in summary["train_losses"])
          + f"; val loss {summary['val_losses']}; ms per step (host clock, "
          f"data loading and the first step included) "
          f"{summary['ms_per_step'][0]:.3f}", flush=True)
    out = evaluate_outlier_seg.main([
        "--config_file", path, "--data_root", scans, "--load_path",
        summary["checkpoint"], "--DEBUG", "1", "--dataset_type", "EDFS",
        "--write_dir", os.path.join(workdir, "agg_seg_eval"), "--device",
        "cuda"])
    ds = out["dataset"]
    points = sum(len(p) for p in ds.clouds_points)
    counted = sum(out["metrics"][k] for k in ("TN", "FP", "FN", "TP"))
    if counted != points or out["batches"] != -(-len(ds) // B):
        raise AssertionError(f"evaluation: {counted} points counted of "
                             f"{points}, {out['batches']} batches")
    for n in ds.cloud_names:
        ply = read_ply(os.path.join(workdir, "agg_seg_eval",
                                    f"{n}_eval.ply"))
        if not np.isfinite(ply["proba"]).all():
            raise AssertionError("evaluation: non-finite probability")
    if grad_check.launches() != launches:
        raise AssertionError(f"{AGG_SEG_CONFIG} launched a KPConv kernel")
    print(f"{AGG_SEG_CONFIG} evaluation: {ds.cloud_names}, {points} "
          f"points, {len(ds)} patches, {out['batches']} batches, "
          f"{out['seconds']:.3f} s, {points / out['seconds']:.1f} points/s;"
          f" metrics " + json.dumps(out["metrics"]), flush=True)


def agg_timing(device, cfgs, batch, smi: str):
    """13(d): per config a Trainer from its seeded init on the batch:
    synchronised wall ms per train step (CUDA events over AGG_TIMED_STEPS
    steps after two) and the peak memory allocated in them (weights, Adam
    state and batch included); for AGG_PROFILED one profiler window of
    PROFILE_STEPS_AGG steps: device ms per step and busy share."""
    tensors = {k: torch.as_tensor(batch[k]).to(device)
               for k in ("points", "mask", "features", "offsets")}
    print(f"phase 13 train steps, B=16, N=500, width 144, on {smi}:")
    for name, cfg in cfgs.items():
        trainer = Trainer(cfg, AGG_STEPS,
                          torch.Generator().manual_seed(int(cfg.rng_seed)),
                          device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: trainer.train_step(tensors), AGG_TIMED_STEPS,
                     warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        line = (f"  {name}: {ms:.3f} ms per train step (wall, synchronised)"
                f", peak memory {peak:.3f} GiB")
        if name in AGG_PROFILED:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILE_STEPS_AGG):
                    trainer.train_step(tensors)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            got = window_summary(f"{name} train step under the profiler",
                                 prof, wall, PROFILE_STEPS_AGG)
            line += "; profiler: " + (
                "not measured" if got is None else
                f"device {got[0]:.3f} ms per step, busy share {got[1]:.3f}")
        print(line, flush=True)
        del trainer
        torch.cuda.empty_cache()


def phase_aggregations(device, workdir, tree, scans, smi: str):
    """Phase 13, the other aggregations and the attention operators:
    (a) numerics of the 15 500-point configs, (b) four of them trained and
    served through the entry points, (c) ``outlier_seg_edf_katz`` trained
    and evaluated, (d) ms per train step, peak memory and two profiler
    windows.  No KPConv kernel runs on these paths."""
    cfgs, batch = agg_batch(tree)
    t0 = time.perf_counter()
    agg_numerics(device, cfgs, batch)
    print(f"13(a): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    pps = agg_training(tree, workdir)
    print(f"13(b): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    agg_segmentation(scans, workdir)
    print(f"13(c): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    agg_timing(device, cfgs, batch, smi)
    print(f"13(d): {time.perf_counter() - t0:.1f} s; serving points/s "
          + json.dumps({n: {k: round(v, 1) for k, v in d.items()}
                        for n, d in pps.items()}), flush=True)


def kpconv_drel_bound(B, M, N, K, C, P, live):
    """Least times (ms) for d_rel alone: features, indices, relative
    positions, masks, kernel points and weights and the upstream gradient
    read once, d_rel written once; float32 operations: 2 per (b, m, p, c)
    for q = kw * g, 2 per (live edge, p, c) for each edge's contraction
    sum_c q[p,c] feat[idx,c], and 20 per (live edge, p) for the influence
    slope and the 3-vector.  A masked edge costs nothing."""
    nbytes = 4 * (B * N * C + B * M * C + B * M * K * 5 + P * 3 + P * C
                  + B * M * K * 3)
    flops = 2 * B * M * P * C + 2 * live * P * C + 20 * live * P
    return nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3


def seeded_discriminator(cfg, device, seed: int = 0):
    """The discriminator with seeded weights and O(1) BatchNorm running
    statistics, in eval mode."""
    model = build_discriminator(cfg, torch.Generator().manual_seed(seed))
    o1_running_stats(model, np.random.default_rng(seed))
    return model.to(device).eval()


def denoised_batch(cfg, device, tree, gen_ckpt):
    """Phase 9's first validation batch denoised by phase 9's generator
    (eval mode): the discriminator's input in a G-step."""
    batch = val_batch(cfg, tree)
    gen = infer.load_model(cfg, device, gen_ckpt)
    pts, mask, feats = (torch.as_tensor(batch[k]).to(device)
                        for k in ("points", "mask", "features"))
    with torch.no_grad():
        den = (pts + gen(pts, mask, feats)).cpu().numpy()
    return {"points": den, "mask": batch["mask"], "features": den.copy()}


def disc_input_gradient(disc, batch, device):
    """The eval discriminator's gradient in its input points (the
    G-step's: through the features and the level-0 rel) four ways, as
    ``grad_check.model_gradients`` takes a parameter's, and held by
    ``grad_check.check_model_gradients``; returns its worst comparisons
    and the kernel path's (forward, backward, d_rel) launches."""
    pts, mask = (torch.as_tensor(batch[k]).to(device)
                 for k in ("points", "mask"))
    w = torch.from_numpy(np.random.default_rng(6).normal(
        size=(len(pts), 1)).astype(np.float32)).to(device)

    def grad(model, dtype):
        x = pts.to(dtype).requires_grad_(True)
        score = torch.sum(model(x, mask.to(dtype), x) * w.to(dtype))
        return score, x

    counts = (kpconv_aggregate.launches, kpconv_aggregate_backward.launches,
              kpconv_aggregate_backward.launches_drel)
    score, x = grad(disc, torch.float32)
    kernel = torch.autograd.grad(score, x, retain_graph=True)
    torch.cuda.synchronize()
    counts = (kpconv_aggregate.launches - counts[0],
              kpconv_aggregate_backward.launches - counts[1],
              kpconv_aggregate_backward.launches_drel - counts[2])
    backward = kpconv_aggregate_backward
    kpconv_ops.kpconv_aggregate_backward = kpconv_aggregate_backward_plain
    try:
        same_graph = torch.autograd.grad(score, x)
    finally:
        kpconv_ops.kpconv_aggregate_backward = backward
    local_aggregation.kpconv_aggregate = kpconv_aggregate_plain
    try:
        score, x = grad(disc, torch.float32)
        plain = torch.autograd.grad(score, x)
        score, x = grad(grad_check.float64_copy(disc), torch.float64)
        float64 = torch.autograd.grad(score, x)
    finally:
        local_aggregation.kpconv_aggregate = kpconv_aggregate
    worst = grad_check.check_model_gradients(dict(
        names=["input points"], kernel=kernel, same_graph=same_graph,
        plain=plain, float64=float64))
    return worst, counts


def phase_gan_kernels(cfg, device, batch):
    """(a) The backward kernel with d_rel (``kpconv_bwd_drel``) at the ten
    flagship shapes (random neighbourhoods) and at the discriminator's ten
    calls on the pyramid of ``batch`` (denoised points): d_rel, d_features
    and d_kernel_weights bitwise equal over two calls and within
    BWD_RTOL / BWD_ATOL_FRAC of plain, d_rel alone equal to d_rel with the
    others; times of the three GAN_DREL_CALLS on the real pyramid (the
    call with and without d_rel, d_rel alone, its plain version, its
    device time and bound); then the whole discriminator's gradient in its
    input points by grad_check's rule.  Returns the d_rel kernel's record,
    less launches."""
    rng = np.random.default_rng(12)
    B, P = int(cfg.batch_size), int(cfg.pseudo_grid.num_kernel_points)
    r0 = float(cfg.radius)
    rows = []
    for name, M, N, K, C, mult in FLAGSHIP_CALLS:
        args, extent = kpconv_inputs(rng, B, M, N, K, C, P, r0 * mult,
                                     device)
        rows.append(("random " + name, M, N, K, C, args, extent))
    for name, M, N, K, C, mult, idx, rel, fmask in pyramid_calls(
            cfg, device, batch):
        extent = 2.0 * r0 * mult / 5.0
        kp = torch.from_numpy(create_kernel_points(1.5 * extent, P)).to(
            device)
        feat, kw = (torch.from_numpy(a.astype(np.float32)).to(device)
                    for a in (rng.normal(size=(B, N, C)),
                              rng.normal(size=(P, C)) * math.sqrt(2.0 / C)))
        rows.append((name, M, N, K, C, (feat, idx, rel, fmask, kp, kw),
                     extent))
    worst_abs = 0.0
    sums = dict(ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0)
    timed = []
    print("call M N K C | d_feat d_kw d_rel max_abs | with d_rel ms, "
          "without ms, d_rel alone ms, its plain ms, bound ms bound_by")
    for name, M, N, K, C, args, extent in rows:
        g = torch.from_numpy(rng.normal(size=(B, M, C)).astype(
            np.float32)).to(device)
        first = kpconv_aggregate_backward(*args, g, extent, "linear",
                                          need_rel=True)
        second = kpconv_aggregate_backward(*args, g, extent, "linear",
                                           need_rel=True)
        alone = kpconv_aggregate_backward(
            *args, g, extent, "linear", need_features=False,
            need_kernel_weights=False, need_rel=True)
        torch.cuda.synchronize()
        want = kpconv_aggregate_backward_plain(*args, g, extent, "linear",
                                               need_rel=True)
        for what, a, b in zip(("d_feat", "d_kw", "d_rel"), first, second):
            if not torch.equal(a, b):
                raise AssertionError(f"d_rel variant {name}: {what} differs "
                                     "between two calls")
        if not torch.equal(alone[2], first[2]) or alone[0] is not None:
            raise AssertionError(f"d_rel alone {name}: not the d_rel of "
                                 "the full call")
        errs = [check_grad_close(a, b, f"d_rel variant {name} {what}")
                for a, b, what in zip(first, want,
                                      ("d_feat", "d_kw", "d_rel"))]
        worst_abs = max(worst_abs, *errs)
        line = (f"{name} {M} {N} {K} {C} | {errs[0]:.3e} {errs[1]:.3e} "
                f"{errs[2]:.3e}")
        if not name.startswith("random ") and name in GAN_DREL_CALLS \
                or name == "random stem LA":
            full = cuda_ms(lambda: kpconv_aggregate_backward(
                *args, g, extent, "linear", need_rel=True), 20)
            base = cuda_ms(lambda: kpconv_aggregate_backward(
                *args, g, extent, "linear"), 20)
            drel = lambda: kpconv_aggregate_backward(  # noqa: E731
                *args, g, extent, "linear", need_features=False,
                need_kernel_weights=False, need_rel=True)
            drel_ms = cuda_ms(drel, 20)
            plain_ms = cuda_ms(lambda: kpconv_aggregate_backward_plain(
                *args, g, extent, "linear", need_features=False,
                need_kernel_weights=False, need_rel=True), 5)
            live = int((args[3] != 0).sum().item())
            t_bytes, t_ops = kpconv_drel_bound(B, M, N, K, C, P, live)
            line += (f" | {full:.5f} {base:.5f} {drel_ms:.5f} "
                     f"{plain_ms:.5f} {max(t_bytes, t_ops):.5f} "
                     + ("bytes" if t_bytes >= t_ops else "operations"))
            if not name.startswith("random "):
                timed.append(drel)
                for key, v in (("ms", drel_ms), ("plain_ms", plain_ms),
                               ("bytes", t_bytes), ("ops", t_ops)):
                    sums[key] += v
        print(line, flush=True)
    dev_us = device_us(lambda: [f() for f in timed], "kpconv_bwd_drel", 10)
    disc = seeded_discriminator(cfg, device)
    worst, counts = disc_input_gradient(disc, batch, device)
    if counts != (10, 10, len(GAN_DREL_CALLS)):
        raise AssertionError(f"the discriminator's input gradient launched "
                             f"{counts} (forward, backward, d_rel)")
    print(f"d_rel at the {len(timed)} level-0 calls of the real pyramid: "
          f"{sums['ms']:.5f} ms (CUDA events), device "
          f"{dev_us * len(timed) / 1e3:.5f} ms ({dev_us:.2f} us a call), "
          f"plain {sums['plain_ms']:.5f} ms, bound "
          f"{max(sums['bytes'], sums['ops']):.5f} ms; the discriminator's "
          "gradient in its input points (launches forward, backward, "
          f"d_rel {counts}): " + "; ".join(
              f"{what}: {d:.3e} of limit {limit:.3e}"
              for what, d, limit, _ in worst), flush=True)
    return {
        "name": "kpconv_bwd_drel", "route": "cuda",
        "source": "deep3dpointclouddenoising_torch/csrc/kpconv_bwd.cu",
        "replaces": "deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py:361",
        "max_abs_err": worst_abs, "ms": sums["ms"],
        "plain_ms": sums["plain_ms"],
        "bound_ms": max(sums["bytes"], sums["ops"]),
        "bound_by": "bytes" if sums["bytes"] >= sums["ops"]
        else "operations",
        "library_ms": None, "device_ms": dev_us * len(timed) / 1e3,
        "timed_at": "d_rel alone (need_rel only) at the discriminator's "
                    "three level-0 calls (stem LA, Bottleneck_0, T1) on a "
                    "real pyramid of denoised points, B=16, width 144; "
                    "device_ms: torch.profiler",
        "launches_are": "backward calls that launch kpconv_bwd_drel (the "
                        "G-step's discriminator calls whose support set is "
                        "the input points)",
    }


def reset_launches():
    for wrapper in (kpconv_aggregate, kpconv_aggregate_backward):
        wrapper.launches = wrapper.launches_bf16 = 0
    kpconv_aggregate_backward.launches_drel = 0


def launch_counts():
    """(forward, backward, d_rel) launches since reset_launches."""
    return (kpconv_aggregate.launches, kpconv_aggregate_backward.launches,
            kpconv_aggregate_backward.launches_drel)


def gan_argv(config, tree, log_dir, epochs, *extra):
    path = os.path.join(ROOT, "cfgs", config + ".yaml")
    return ["--config_file", path, "--data_root", tree, "--log_dir",
            log_dir, "--num_steps",
            str(GAN_STEPS * int(load_config(path).batch_size)), "--epochs",
            str(epochs),
            "--num_points_per_shape", str(DEPLOY_TRAIN_POINTS), "--device",
            "cuda", *extra]


def phase_disc_pretraining(tree, workdir):
    """(b) ``train_discriminator`` on DISC_CONFIG at width 144, DISC_EPOCHS
    epochs of GAN_STEPS steps, validation every epoch: losses finite,
    accuracies in [0, 1], 10 forward and 10 backward launches per step (10
    forward per validation batch), no d_rel.  Returns the checkpoint and
    the launches."""
    reset_launches()
    summary = train_discriminator.main(gan_argv(
        DISC_CONFIG, tree, workdir, DISC_EPOCHS, "--val_freq", "1"))
    steps, val = summary["steps"], summary["val_batches"]
    counts = launch_counts()
    if steps != GAN_STEPS * DISC_EPOCHS \
            or counts != (10 * (steps + val), 10 * steps, 0):
        raise AssertionError(f"pre-training: {steps} steps, {val} val "
                             f"batches, launches {counts}")
    acc = summary["val_accuracy"]
    if not np.isfinite(summary["train_losses"]).all() \
            or not all(0.0 <= a <= 1.0 for a in acc):
        raise AssertionError(f"pre-training: losses "
                             f"{summary['train_losses']}, accuracy {acc}")
    print(f"discriminator pre-training: {steps} steps, {val} val batches; "
          f"launches forward {counts[0]}, backward {counts[1]}; loss first "
          f"{summary['train_losses'][0]:.6f} last "
          f"{summary['train_losses'][-1]:.6f}; validation accuracy by "
          f"epoch {acc}; ms per step (host clock, data loading included) "
          + ", ".join(f"{ms:.3f}" for ms in summary["ms_per_step"]),
          flush=True)
    return summary["checkpoint"], counts[:2]


def gan_run(argv, kill_at_step=None):
    """One run of ``train_gan``, ended as by a kill just after update
    ``kill_at_step`` where that is given; returns its summary (None when
    killed) and its launches."""
    reset_launches()
    update = GANTrainer.update

    def killed(trainer, batch, *args, **kwargs):
        metrics = update(trainer, batch, *args, **kwargs)
        if trainer.step == kill_at_step:
            torch.cuda.synchronize()
            raise Killed(trainer.step)
        return metrics

    GANTrainer.update = killed
    try:
        summary = train_gan.main(argv)
    except Killed:
        summary = None
    finally:
        GANTrainer.update = update
    if kill_at_step is not None and summary is not None:
        raise AssertionError(f"GAN training ran past update {kill_at_step}")
    return summary, launch_counts()


def phase_gan_training(tree, workdir, gen_ckpt, disc_ckpt):
    """(c) ``train_gan`` on GAN_CONFIG at width 144 from phase 9's
    generator and (b)'s discriminator, GAN_EPOCHS epochs of GAN_STEPS
    updates unbroken; and the same run killed one update into epoch
    GAN_EPOCHS and run again with ``--auto_resume``: both blocks'
    parameters, BatchNorm buffers, optimizer state and step, and their
    checkpoints, bitwise equal to the unbroken run's; both blocks moved
    from what they loaded; metrics finite; GAN_UPDATE_LAUNCHES per update.
    Returns the resumed run's summary and the launches of its two calls."""
    def argv(log_dir):
        return gan_argv(GAN_CONFIG, tree, log_dir, GAN_EPOCHS,
                        "--auto_resume", "--load_path_generator", gen_ckpt,
                        "--load_path_discriminator", disc_ckpt)

    straight_dir = os.path.join(workdir, "gan_straight")
    straight, c0 = gan_run(argv(straight_dir))
    updates = GAN_STEPS * GAN_EPOCHS
    if straight["steps"] != updates or straight["restored"] != {
            "generator": gen_ckpt, "discriminator": disc_ckpt} \
            or c0 != tuple(updates * n for n in GAN_UPDATE_LAUNCHES):
        raise AssertionError(f"GAN training: {straight['steps']} updates, "
                             f"restored {straight['restored']}, launches "
                             f"{c0}")
    log = os.path.join(workdir, "gan_resumed")
    saved = GAN_STEPS * (GAN_EPOCHS - 1)
    _, c1 = gan_run(argv(log), kill_at_step=saved + 1)
    second, c2 = gan_run(argv(log))
    run = os.path.join(log, GAN_CONFIG)
    done = saved + 1 + GAN_STEPS
    counts = tuple(a + b for a, b in zip(c1, c2))
    if second["restored"] != {k: os.path.join(run, k, "current.pt")
                              for k in ("generator", "discriminator")} \
            or second["steps"] != updates \
            or counts != tuple(done * n for n in GAN_UPDATE_LAUNCHES):
        raise AssertionError(f"GAN resume: restored {second['restored']}, "
                             f"{second['steps']} updates, launches {c1} "
                             f"then {c2}")
    for name, loaded in (("generator", gen_ckpt),
                         ("discriminator", disc_ckpt)):
        a = second["trainer"].blocks[name]
        b = straight["trainer"].blocks[name]
        for what, x, y in (("model", a.model.state_dict(),
                            b.model.state_dict()),
                           ("optimizer", a.optimizer.state_dict(),
                            b.optimizer.state_dict())):
            diff = grad_check.state_difference(x, y)
            if diff:
                raise AssertionError(f"GAN resume: {name} {what} differs "
                                     f"from the unbroken run at {diff}")
        for leaf in ("current.pt", f"ckpt_epoch_{GAN_EPOCHS}.pt"):
            diff = grad_check.state_difference(
                torch.load(os.path.join(run, name, leaf), weights_only=True),
                torch.load(os.path.join(straight_dir, GAN_CONFIG, name,
                                        leaf), weights_only=True))
            if diff:
                raise AssertionError(f"GAN resume: {name} {leaf} differs "
                                     f"at {diff}")
        start = torch.load(loaded, map_location="cpu",
                           weights_only=True)["model"]
        moved = [k for k, v in a.model.state_dict().items()
                 if not torch.equal(v.cpu(), start[k])]
        if not moved:
            raise AssertionError(f"GAN training did not move the {name}")
    metrics = straight["metrics"]
    if not all(np.isfinite(v).all() for v in metrics.values()):
        raise AssertionError(f"GAN training: metrics {metrics}")
    print(f"GAN fine-tuning: {GAN_EPOCHS} epochs of {GAN_STEPS} updates "
          f"unbroken, and a run killed after update {saved + 1} and "
          f"continued by --auto_resume from update {saved}: both blocks' "
          f"parameters, BatchNorm buffers, optimizer state and step "
          f"{second['trainer'].step} bitwise equal; launches per update "
          f"(forward, backward, d_rel) {tuple(c // updates for c in c0)}; "
          "unbroken metrics, last: " + ", ".join(
              f"{k} {v[-1]:.6f}" for k, v in metrics.items())
          + "; ms per update by epoch (host clock, data loading included), "
          "unbroken: " + ", ".join(f"{ms:.3f}"
                                   for ms in straight["ms_per_update"]),
          flush=True)
    return second, counts


def profile_gan_updates(trainer, batch):
    """(d) Wall ms per GAN update on one real batch (10 updates,
    synchronised, twice), then a profiler window of PROFILE_UPDATES
    updates: device ms per update, busy share, kernels per update and
    ``kpconv_bwd_drel``'s device ms per update and per call.  Returns
    those as a dict."""
    for _ in range(2):
        trainer.update(batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(10):
            trainer.update(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / 10 * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_UPDATES):
            trainer.update(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = window_summary("GAN update under the profiler", prof, wall,
                             PROFILE_UPDATES)
    events = _device_events(prof)
    drel = [us for name, us in events if "kpconv_bwd_drel" in name]
    out = {"wall_ms": walls,
           "kernels_per_update": len(events) / PROFILE_UPDATES,
           "drel_ms_per_update": sum(drel) / PROFILE_UPDATES / 1e3,
           "drel_us_per_call": sum(drel) / len(drel) if drel else None}
    if summary is not None:
        out["device_ms"], out["busy"] = summary
    print("GAN update, width 144, B=16 (one real batch): wall ms per update "
          "(10 updates, synchronised) " + ", ".join(f"{w:.3f}" for w in walls)
          + f"; under the profiler {json.dumps(out)}", flush=True)
    return out


def phase_gan_serving(tree, workdir, checkpoint):
    """(e) GAN_SHAPE at 140,000 points, gaussian sigma GAN_LEVEL, served
    with the fine-tuned generator (``--checkpoint_low none``), host
    voting: 10 forward launches per batch, no backward; then
    ``compute_cd`` on the output tree.  Returns the forward launches."""
    root = os.path.join(workdir, "gan_serve")
    os.makedirs(os.path.join(root, "qualitative_test"))
    shutil.copy(os.path.join(tree, "qualitative_test", GAN_SHAPE + ".off"),
                os.path.join(root, "qualitative_test"))
    config = os.path.join(ROOT, "cfgs", GAN_CONFIG + ".yaml")
    out_dir = os.path.join(workdir, "gan_out")
    reset_launches()
    summary = infer.main(["--config_file", config, "--data_root", root,
                          "--out_dir", out_dir, "--checkpoint", checkpoint,
                          "--checkpoint_low", "none", "--noise_type",
                          "gaussian", "--noise_level", str(GAN_LEVEL),
                          "--device", "cuda"])
    batches = -(-len(summary["dataset"]) // int(load_config(
        config).batch_size))
    counts = launch_counts()
    if counts != (10 * batches, 0, 0):
        raise AssertionError(f"GAN serving launched {counts}, not "
                             f"{10 * batches} forward kernels")
    res = summary["results"][0]
    if not np.isfinite(res["offsets"]).all():
        raise AssertionError("GAN serving: non-finite offsets")
    table = compute_cd.main(["--in_dir", out_dir])
    n_points = len(summary["dataset"].shapes[0].points)
    print(f"GAN generator serving {GAN_SHAPE}: {n_points} points, "
          f"{batches} batches, {n_points / summary['seconds']:.1f} points/s "
          f"({summary['seconds']:.3f} s); CD ratio " + ", ".join(
              f"{n} {r['ratio']:.4f}" for n, r in table.items()), flush=True)
    return counts[0]


def phase_gan(device, workdir, tree, gen_ckpt):
    """Phase 14, GAN fine-tuning and discriminator pre-training: (a) the
    d_rel kernel and the discriminator's input gradient, (b)
    ``train_discriminator``, (c) ``train_gan`` with a kill and
    ``--auto_resume``, (d) a profiler window of GAN updates, (e) the
    fine-tuned generator served.  Returns the d_rel kernel's record, the
    profile and the launches of the main path."""
    cfg = load_config(os.path.join(ROOT, "cfgs", GAN_CONFIG + ".yaml"))
    if (int(cfg.width), int(cfg.depth), int(cfg.batch_size),
            int(cfg.num_points), float(cfg.gan_alpha)) \
            != (144, 2, 16, 500, 1e-4):
        raise AssertionError(f"{GAN_CONFIG} is no longer width 144, depth "
                             "2, B=16, N=500, gan_alpha 1e-4")
    t0 = time.perf_counter()
    batch = denoised_batch(cfg, device, tree, gen_ckpt)
    record = phase_gan_kernels(cfg, device, batch)
    print(f"14(a): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    disc_ckpt, pretrain = phase_disc_pretraining(
        tree, os.path.join(workdir, "disc"))
    print(f"14(b): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    summary, training = phase_gan_training(tree, workdir, gen_ckpt,
                                           disc_ckpt)
    print(f"14(c): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    real = {k: v for k, v in val_batch(cfg, tree).items()
            if k in ("points", "mask", "features", "offsets")}
    prof = profile_gan_updates(summary["trainer"], real)
    print(f"14(d): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    serving = phase_gan_serving(tree, workdir, os.path.join(
        workdir, "gan_resumed", GAN_CONFIG, "generator", "current.pt"))
    print(f"14(e): {time.perf_counter() - t0:.1f} s", flush=True)
    record.update(profile=prof)
    return record, {"gan_training": training, "disc_pretraining": pretrain,
                    "gan_serving": serving}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--only-kernels"], ["--only-aggregations"],
                    ["--only-gan"]):
        print("usage: chip_smoke.py [--only-kernels | --only-aggregations "
              "| --only-gan]", file=sys.stderr)
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
    if argv == ["--only-aggregations"]:
        # phase 13 alone, on a tree and scans of its own
        with tempfile.TemporaryDirectory() as workdir, \
                phase("aggregations"):
            tree = os.path.join(workdir, "shapes")
            make_synthetic_dataset.write_tree(tree, verbose=False)
            scans = os.path.join(workdir, "scans")
            make_scans(scans, n=SEG_POINTS, diameter=1.0, write=SEG_SCANS,
                       cut=SEG_HELD_OUT, corner=SEG_CORNER)
            phase_aggregations(device, workdir, tree, scans, smi)
        print(smi)
        return 0
    if argv == ["--only-gan"]:
        # phase 14 alone, on a tree of its own and a generator trained as
        # phase 9 trains it
        with tempfile.TemporaryDirectory() as workdir, phase("gan"):
            tree = os.path.join(workdir, "shapes")
            make_synthetic_dataset.write_tree(tree, verbose=False)
            log_dir = os.path.join(workdir, "log")
            train_short(DEPLOY_CONFIGS[0], tree, log_dir, cfg)
            record, path_gan = phase_gan(device, workdir, tree, os.path.join(
                log_dir, DEPLOY_CONFIGS[0], "current.pt"))
        print(smi)
        print(json.dumps({"drel": record, "launches": path_gan}))
        return 0
    with phase("kernel vs plain"):
        record = phase_kernels(cfg, device)
    if argv:  # the kernels' phases alone, for comparing checkouts
        with phase("backward kernel vs plain"):
            bwd_record = phase_backward(cfg, device)
        with phase("bf16 kernels vs plain"):
            bf16_records = phase_bf16_kernels(
                load_config(os.path.join(ROOT, "cfgs",
                                         BF16_CONFIG + ".yaml")), device)
        print(smi)
        print(json.dumps({"kernels": [record, bwd_record] + bf16_records}))
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
    with tempfile.TemporaryDirectory() as deploy_dir, \
            tempfile.TemporaryDirectory() as seg_dir:
        tree = os.path.join(deploy_dir, "shapes")
        with phase("deployment"):
            deploy_fwd, deploy_bwd = phase_deployment(cfg, deploy_dir)
        with phase("bf16"):  # on the deployment phase's shape tree
            bf16_records, path_bf16 = phase_bf16(device, deploy_dir, tree)
        with phase("cleaning"):  # on the deployment phase's shape tree
            cleaning = phase_cleaning(cfg, deploy_dir)
        with tempfile.TemporaryDirectory() as workdir, phase("15k family"):
            records_15k, path_15k = phase_15k(device, workdir)
        with phase("outlier segmentation"):
            records_seg, path_seg = phase_seg(device, seg_dir)
        # on phase 9's shape tree and phase 12's scans
        with phase("aggregations"):
            phase_aggregations(device, seg_dir, tree,
                               os.path.join(seg_dir, "scans"), smi)
        # on phase 9's shape tree, from phase 9's diverse checkpoint
        with tempfile.TemporaryDirectory() as workdir, phase("gan"):
            drel_record, path_gan = phase_gan(
                device, workdir, tree, os.path.join(
                    deploy_dir, "log", DEPLOY_CONFIGS[0], "current.pt"))
    # launches: this slice's path (discriminator pre-training, GAN
    # fine-tuning and the fine-tuned generator served); every path's in the
    # detail
    gan_paths = ("disc_pretraining", "gan_training")
    record.update(
        launches=sum(path_gan[k][0] for k in gan_paths)
        + path_gan["gan_serving"],
        launches_by_path={
            "disc_pretraining": path_gan["disc_pretraining"][0],
            "gan_training": path_gan["gan_training"][0],
            "gan_serving": path_gan["gan_serving"],
            "serving": serving_launches, "training": train_fwd,
            "deployment": deploy_fwd, "cleaning": cleaning["cleaning"][0],
            "chamfer": cleaning["chamfer"][0],
            "15k_training": path_15k["training"][0],
            "15k_serving": path_15k["serving"],
            "outlier_seg_training": path_seg["training"][0],
            "outlier_seg_eval": path_seg["eval"]},
        shapes_15k=records_15k["fwd"], shapes_seg=records_seg["fwd"])
    bwd_record.update(
        launches=sum(path_gan[k][1] for k in gan_paths),
        launches_by_path={
            "disc_pretraining": path_gan["disc_pretraining"][1],
            "gan_training": path_gan["gan_training"][1], "gan_serving": 0,
            "serving": 0, "training": train_bwd,  # inference checks its 0
            "deployment": deploy_bwd, "cleaning": cleaning["cleaning"][1],
            "chamfer": cleaning["chamfer"][1],
            "15k_training": path_15k["training"][1], "15k_serving": 0,
            "outlier_seg_training": path_seg["training"][1],
            "outlier_seg_eval": 0},
        shapes_15k=records_15k["bwd"], shapes_seg=records_seg["bwd"])
    # the bf16 forms: their slice's path (bf16 training with its resume,
    # and bf16 serving)
    bf16_records[0].update(
        launches=path_bf16["training"][0] + path_bf16["serving"],
        launches_by_path={"bf16_training": path_bf16["training"][0],
                          "bf16_serving": path_bf16["serving"]})
    bf16_records[1].update(
        launches=path_bf16["training"][1],
        launches_by_path={"bf16_training": path_bf16["training"][1],
                          "bf16_serving": 0})
    drel_record.update(
        launches=path_gan["gan_training"][2],
        launches_by_path={"gan_training": path_gan["gan_training"][2],
                          "disc_pretraining": 0, "gan_serving": 0})
    print(smi)
    print(json.dumps({"kernels": [record, bwd_record] + bf16_records
                      + [drel_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

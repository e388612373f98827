#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run it from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It imports the port, torch, numpy and scipy only, and goes through
eighteen phases (phase 9b after 9), each printed with its wall time:

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
   the live edges, d_rel bitwise over two calls, and d_rel alone's device
   us and bound at the stem call; (b) the whole model's forward and
   gradients there, as in phases 4 and 7; (c) one train step with
   ``remat: 1`` against one without, from the same weights on one
   pyramid: the same loss, gradients, running statistics and
   ``num_batches_tracked``, bitwise
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
   depth 2 (AGG_NUMERICS_DEPTH, 1, in (a)), B=16, N=500) with seeded
   weights whose BatchNorm statistics, gates and final Dense are O(1), on
   one real batch: the eval forward,
   the train forward and every train-mode gradient under the masked L1
   loss on the card held to the same model's float32 computation on the
   CPU (its BatchNorms by ``F.batch_norm``, as on the card), within ``grad_check``'s per-tensor limits from that computation's
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
   backward's tolerances of plain, d_rel alone's device time at each of
   the three level-0 calls beside its bound (at 3xTF32, as the kernel
   computes it), and the whole discriminator's gradient in its input
   points, kernel against plain, by ``grad_check``'s rule, with 3 d_rel
   launches; (b)
   ``train_discriminator`` on ``cfgs/synthetic_quality_disc.yaml``,
   DISC_EPOCHS epochs of GAN_STEPS steps, the validation accuracy
   printed; (c) ``train_gan`` on
   ``cfgs/synthetic_quality_gan_tuned.yaml`` from (b)'s discriminator and
   phase 9's generator, GAN_EPOCHS epochs of GAN_STEPS updates unbroken,
   and killed one update into its last epoch and run again with
   ``--auto_resume``: both blocks bitwise equal to the unbroken run's,
   GAN_UPDATE_LAUNCHES (forward, backward, d_rel) per update; (d) a
   profiler window of GAN updates (device ms per update, busy share,
   kernels per update, ``kpconv_bwd_drel``'s ms); (e) GAN_SHAPE served
   with the fine-tuned generator through the inference entry point, then
   ``compute_cd``.
15. the PointCleanNet baseline and on-card patch sampling (this slice's
   paths), on phase 9's shape tree: (a) the ``ResPCPNet`` of
   ``cfgs/synthetic_quality_pcn4.yaml`` at B=64, N=500, seeded, its final
   Dense and BatchNorm statistics O(1): the eval forward on the card
   against the CPU by ``grad_check.check_forward`` and every train-mode
   gradient by ``grad_check.check_device_gradients`` (float64 card
   against float64 CPU, float32 by the full-path rule where float32 pins
   the tensor), no KPConv launch, and ms per
   forward (CUDA events) beside its float32 FLOP bound; (b) ``train_pcn``
   PCN_EPOCHS epochs of PCN_STEPS steps with validation on PCN_TREE's
   clouds, unbroken and killed one step into its last epoch and resumed
   with ``--auto_resume``: bitwise equal, then a profiler window (device
   ms per step, busy share, kernels per step); (c) PCN_SHAPE at 140,000
   points served by ``infer --pcn --device_voting`` (points/s) and by
   ``infer --pcn`` on the host over the first PCN_HOST_PATCHES patches:
   equal within VOTE_TOL on every patch that does not underfill (a
   near-tie at the 500th neighbour excepted and counted), the underfilled
   ones counted with their largest difference, ``compute_cd`` on both
   trees; (d) ``cfgs/l1.yaml`` with ``device_sampler: 1`` through the
   train entry point, DS_STEPS steps at width 144, B=16, twice: 10 forward
   and 10 backward launches per step, the two runs bitwise equal, and a
   profiler window of device-sampled steps beside one of host-sampled
   steps and phase 8's.
16. export (this slice's path), last, from phase 8's l1.yaml checkpoint
   and phase 10's cleaning checkpoint on phase 9's shape tree:
   (a) ``export_model --check`` of l1.yaml at width 144, B=16, N=500 on
   the card (the KPConv forward kernel as the custom op
   ``d3pcd_torch::kpconv_fwd`` in the graph, ten nodes), the artifact
   loaded by a fresh process that imports ``serving`` alone, ten forward
   launches and no backward one per call, its output on a real batch of
   EXPORT_SHAPE within ``1e-5 * max(scale, 1)`` of the eager forward; the
   export seconds, artifact bytes and load seconds printed; (b)
   EXPORT_SHAPE (140,000 points, gaussian sigma EXPORT_LEVEL) served by
   host voting through the artifact ``--check`` loaded in this process (a
   short last batch padded) and through the eager model: 10 launches per
   batch, the offsets within VOTE_TOL, points/s of both; (c) the
   ``synthetic_quality_cleaning`` artifact (``--full_cleaning``): its four
   raw channels on (a)'s batch bitwise equal to the eager forward's; (d)
   phase 8's train command with ``--profile_dir``, TRACE_EPOCHS epochs of
   TRACE_STEPS steps, in a fresh process started beside (a) (no profiler
   session of that size in this one, which opens many windows): its
   ``log.txt`` holds every line it printed,
   ``metrics.jsonl`` ``train/loss``, ``train/lr`` and ``val/loss`` at
   steps 1..TRACE_EPOCHS, and its Chrome trace names
   ``kpconv_fwd_kernel`` and ``kpconv_bwd_kernel``.
17. data parallel, in the fourth part, on a copy of phase 8's tree: the train
   command with ``--multihost`` on PAR_WORLD gloo ranks sharing the card
   and on one NCCL rank (torchrun; each rank is ``chip_smoke.py
   --parallel-rank``) against the same command in one process, and one
   SGD step's gradients across ranks (``phase_parallel``).
18. spatial denoising and the data-parallel GAN (this slice's paths):
   (a) before the parts start, on an idle card: SPATIAL_SHAPE (140,000
   points, gaussian sigma 0.5%, padded to 141,312 slots) denoised by
   ``infer --spatial`` in one forward in this process from phase 8's
   checkpoint (10 forward launches; wall s, device ms, peak GiB, points/s
   beside phase 5's), and both kernels against plain (the backward
   against float64) at its level-0 stem call; in the fourth part after
   17, one torchrun job
   of PAR_WORLD gloo ranks sharing the card (each ``chip_smoke.py
   --spatial-rank``): (b) the same cloud by ``infer --spatial
   --multihost``, within MODEL_TOL of (a), its all-gathers' bytes and ms;
   (c) point-sharded training on SPATIAL_TRAIN_POINTS points, B=1,
   SPATIAL_TRAIN_STEPS Adam steps, against one process: the first loss
   within PAR_FIRST_LOSS_RTOL, the ranks bitwise equal; (d)
   ``train_discriminator`` and ``train_gan --multihost``, one epoch of
   SPATIAL_GAN_STEPS steps each, also on one NCCL rank, against one
   process: ranks bitwise equal, the first losses within
   PAR_FIRST_LOSS_RTOL, 40 forward, 30 backward and 3 ``kpconv_bwd_drel``
   launches per update on each rank.  Every aggregation operator and the
   Chamfer losses point-sharded (this slice's paths): (e) after (a), on
   an idle card: the same cloud by ``infer --spatial`` of
   SPATIAL_OP_CONFIG (PosPool, width 144, depth 2) from seeded weights
   (``seeded_operator_model``: the gates and the head's final Dense O(1))
   in this process: offsets finite, no KPConv launch, wall s, device ms
   and busy share under the profiler, peak GiB beside (a)'s PseudoGrid
   figures; then in (b-d)'s torchrun job: the same by ``infer --spatial
   --multihost``, within MODEL_TOL of one process, the all-gathers' count,
   bytes and ms per rank; (f) the forwards of SPATIAL_OPERATORS (adaptive
   weight, PointWiseMLP and the ten attention types; CAA built for the
   cloud's slots) at depth SPATIAL_OP_DEPTH on the SPATIAL_TRAIN_POINTS
   cloud against the part's process: in float64 (positions float32)
   within MODEL_TOL, in float32 element by element within the larger of
   MODEL_TOL and three times the one-process float32 noise at the element
   (``grad_check.check_forward``; every operator's result is printed
   before a miss fails the run), but SPATIAL_FLOAT32_BY_TENSOR's by the
   whole tensor within three times that noise; no launch, its device ms
   and each rank's all-gathered and reduce-scattered bytes; (g)
   point-sharded training of SPATIAL_CHAMFER_CONFIG (loss ``chamfer``,
   PseudoGrid, width 144, depth 2) on that cloud for SPATIAL_TRAIN_STEPS
   Adam steps: the ranks bitwise equal, the first loss within
   PAR_FIRST_LOSS_RTOL of the part's process, 10 forward and 10 backward
   launches a step on each rank, device ms a step and busy share under
   the profiler.  Each rank prints the wall time of (e), (f) and (g).
19. the 2-D layout, the ``custom_cfgs`` sweep and the classification and
   part-segmentation heads (this slice's paths): (a) in the second part
   after 12, one torchrun job of MESH2D_DATA x MESH2D_POINTS gloo ranks
   sharing the card (each ``chip_smoke.py --mesh2d-rank``;
   ``make_mesh_2d``) from phase 8's checkpoint on MESH2D_BATCH clouds of
   SPATIAL_TRAIN_POINTS points: the 2-D forward within MODEL_TOL of one
   process's, MESH2D_STEPS Adam steps of ``Trainer(spatial="2d")`` with
   the ranks bitwise equal and the first loss within PAR_FIRST_LOSS_RTOL
   of one process's, per rank 10 forward launches a forward and 10
   forward and 10 backward a step, its wall and device ms a step, its
   all-gathers' count, bytes and ms; (b) in the first part after 13,
   ``run_custom_sweep`` on SWEEP_CONFIGS at width 144 and 15,000-point
   patches, one epoch of SWEEP_STEPS steps on scans of SWEEP_SCAN_POINTS
   points written first, the test scans cut at SEG_CORNER (each of its
   processes ``chip_smoke.py
   --sweep-child``, which counts the launches): every metric finite, the
   PseudoGrid config 10 forward and 10 backward launches a step and 10
   forward a validation and evaluation batch, the PosPool config none,
   the seconds per config and the table; (c) in the second part after
   (a),
   ``ClassificationModel`` (HEADS_CLASSES classes) and
   ``MultiPartSegmentationModel`` (SHAPENET_PARTS) at width 144, B=16,
   N=500: the eval forward and one train step's gradients on the card
   against the CPU's plain computation of the same weights by
   ``grad_check``'s rules, 10 and 10/10 launches, one SGD step, ms per
   forward and per step.

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

Phases 1-8, phase 9's trainings, 9b(a), 14(a), 18(a) and 18(e)'s
one-process run go first, one after another.  Then five processes run the
rest at once: this one runs 10, 16 and phase 9's voting, and four started
with ``--part`` run 13 and 19(b), then 11, 12, 19(a) and 19(c), then
9b(b-d), 14(b-e) and 15, then 17 and 18(b-g).  Each of the first three works on a
copy of phase 9's meshes and uses phase 9's generator; the fourth works
on a copy of phase 8's tree.  Their output is printed when they end, and
they are killed if this process fails.  So the kernels' times of the
result line (phases 3, 6, 9b(a), 14(a), 18(a)) are taken on a card
that nothing else uses.  The wall and device times of the later phases are
taken beside the other processes; compare those only with the same phase
run alone (``--only-*``).

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so it does without a card.

``python3 chip_smoke.py --only-aggregations`` runs phases 1, 2 and 13 alone
(on a shape tree and scans of its own) and prints no result;
``--only-gan`` runs phases 1, 2 and 14 alone (on a shape tree of its own,
with a generator trained as phase 9 trains it) and prints the d_rel
kernel's record, not the result; ``--only-pcn`` runs phases 1, 2 and 15
alone (on a shape tree of its own) and prints the phase's numbers.

``--only-export`` runs phases 1, 2, 8 and 16 (phase 16 on a shape tree of
its own and a cleaning checkpoint trained as phase 10 trains it) and prints
the phase's numbers; ``--only-parallel`` runs phases 1, 2 and 17;
``--only-spatial`` runs phases 1, 2, 8 and 18 (a)-(g) and prints the
phase's numbers; ``--only-mesh2d`` runs phases 1, 2, 8 and 19 and prints the
phase's numbers.

``python3 chip_smoke.py --only-kernels`` runs phases 1-3, 6 and 9b(a) (its
15k stem call on random neighbourhoods) and prints the kernels' JSON
records: copied into another checkout, it measures
that checkout's kernels the same way, for comparing two versions in one
call.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import gc
import hashlib
import importlib
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from deep3dpointclouddenoising_torch import compute_cd, \
    evaluate_outlier_seg, export_model, infer, make_synthetic_dataset, \
    measure_performance, run_custom_sweep, train_discriminator, \
    train_full_cleaning, train_gan, train_outlier_seg, train_pcn
from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.data.device_sampler import (
    DeviceSampler, sample_generator, torch_draws)
from deep3dpointclouddenoising_torch.data.loader import BatchLoader
from deep3dpointclouddenoising_torch.data.meshio import (read_ply,
                                                         sample_surface,
                                                         save_off)
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
    label_smoothing_cross_entropy, masked_cross_entropy, masked_l1_loss,
    multi_shape_cross_entropy)
from deep3dpointclouddenoising_torch.models import layers as model_layers
from deep3dpointclouddenoising_torch.models import local_aggregation
from deep3dpointclouddenoising_torch.models.build import (
    build_classification, build_discriminator, build_multi_part_segmentation,
    build_offset_regression, build_offset_regression_PCN,
    build_scene_segmentation)
from deep3dpointclouddenoising_torch.models.kernel_points import \
    create_kernel_points
from deep3dpointclouddenoising_torch.models.layers import set_compute_dtype
from deep3dpointclouddenoising_torch.ops import _cuda
from deep3dpointclouddenoising_torch.ops import kpconv as kpconv_ops
from deep3dpointclouddenoising_torch.ops.kpconv import (
    invert_neighbors_plain, kpconv_aggregate, kpconv_aggregate_backward,
    kpconv_aggregate_backward_plain, kpconv_aggregate_plain)
from deep3dpointclouddenoising_torch.parallel.dist import (
    all_gather_points, initialize_distributed, local_device, make_mesh_2d,
    point_rows, process_slice, reduce_scatter_points, shutdown_distributed,
    world_size)
from deep3dpointclouddenoising_torch.parallel.spatial import (
    build_spatial_forward, build_spatial_model, gather_points)
from deep3dpointclouddenoising_torch.parallel.dist import rank as dist_rank
from deep3dpointclouddenoising_torch.profile_serving import \
    _device_events, profile_train_steps, window_summary
from deep3dpointclouddenoising_torch.train import __main__ as train_cli
from deep3dpointclouddenoising_torch.train.gan import GANTrainer
from deep3dpointclouddenoising_torch.train.pcn import PCNTrainer, rotate_back
from deep3dpointclouddenoising_torch.train.trainer import Trainer
from deep3dpointclouddenoising_torch.utils import grad_check
from deep3dpointclouddenoising_torch.utils.checkpoint import load_model_state
from deep3dpointclouddenoising_torch.utils.profiling import (TRACE_NAME,
                                                             cuda_ms,
                                                             device_us)

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "cfgs", "l1.yaml")
# published peaks of one H100 SXM at 700 W (NVIDIA data sheet): HBM3 bytes/s
# and float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# dense TF32 tensor-core FLOP/s (same sheet); 3xTF32 spends three of them
# on each float32 multiply-add of the neighbour contraction
PEAK_TF32_FLOP_S = 495e12
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
DEPLOY_STEPS = 5
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
BF16_STEPS = 5
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
AGG_EPOCHS = 1
AGG_SHAPE = DEPLOY_SHAPES[0]
AGG_LEVEL = 0.005
AGG_SEG_CONFIG = "outlier_seg_edf_katz"
AGG_TIMED_STEPS = 5
AGG_PROFILED = ("POTR", "CAA")
PROFILE_STEPS_AGG = 3
# phase 13(a)'s first paths (agg_paths), and how close the card's float64
# must come to the CPU's
AGG_PATHS = ("card", "cpu", "float64")
# the models' depth in 13(a) (the configs' 2 elsewhere): cut to keep the
# script inside its time limit
AGG_NUMERICS_DEPTH = 1
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
GAN_STEPS = 3
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
# PCN phase: the PointCleanNet config (ResPCPNet, B=64, 500-point patches,
# L1, Adam), its training (PCN_EPOCHS epochs of PCN_STEPS steps on clouds
# of DEPLOY_TRAIN_POINTS points of phase 9's tree cut to PCN_TREE's
# shapes: the config's five noise levels make five clouds of each), the
# steps of each profiler window, the held-out shape served (every one of
# its 140,000 points a patch) and its noise, the host path's share of its
# patch table (the host path serves ~580 PCN patches a second), the
# squared-distance gap under which two neighbours are a near-tie, and the
# steps of the device-sampled l1.yaml training
PCN_CONFIG = "synthetic_quality_pcn4"
PCN_PATH = os.path.join(ROOT, "cfgs", PCN_CONFIG + ".yaml")
PCN_BATCH = 64
PCN_POINTS = 500
PCN_STEPS = 5
PCN_EPOCHS = 2
PCN_TREE = {"train": ("ellipsoid_a", "torus_thin"), "val": ("cylinder_v",)}
PROFILE_STEPS_PCN = 3
PCN_SHAPE = DEPLOY_SHAPES[0]
PCN_LEVEL = 0.005
PCN_CLOUD_POINTS = 140000
PCN_HOST_PATCHES = 3000
PCN_TIE = 1e-6
DS_STEPS = 10
# export phase: the shape served through the loaded artifact, its noise,
# and a fresh process that loads the artifact with the serving module
# alone and prints what it saw as one JSON line
EXPORT_SHAPE = DEPLOY_SHAPES[0]
EXPORT_LEVEL = 0.005
# (d)'s traced training: epochs and steps per epoch (the first traced)
TRACE_EPOCHS = 2
TRACE_STEPS = 3
# the default run's phases after 9's trainings, 9b(a), 14(a) and 18(a) go
# in five processes at once: this one (10, 16, then 9's voting), and four
# started with
# ``--part`` (name: torch CPU threads, phases), each on a copy of phase 9's
# shape tree without its caches ("parallel" on a copy of phase 8's tree);
# the kernels' times of the result line are taken before they start, on a
# card nothing else uses; a part still running PART_LIMIT_S after it
# started is killed and fails the run
PARTS = {"aggregations": (3, "13, 19(b)"),
         "15k_seg": (2, "11, 12, 19(a), 19(c)"),
         "bf16_gan_pcn": (2, "9b(b-d), 14(b-e), 15"),
         "parallel": (1, "17, 18(b-d)")}
PART_LIMIT_S = 900
# phase 17 (data parallel): PAR_WORLD ranks on the card over gloo, then one
# over NCCL, each started by torchrun and run for PAR_EPOCHS epochs of
# PAR_STEPS steps; (a) and (c) hold the first train loss within
# PAR_FIRST_LOSS_RTOL of one process's, (b) the SGD step's gradients within
# PAR_SGD_ATOL (tests/test_trainer.py:106-144); a torchrun still running
# after PAR_LIMIT_S is killed and fails the run
PAR_WORLD = 2
PAR_STEPS = 3
PAR_EPOCHS = 2
PAR_DEVICE = "cuda"
PAR_BATCH_SEED = 17
PAR_FIRST_LOSS_RTOL = 1e-4
PAR_SGD_ATOL = 2e-5
PAR_LIMIT_S = 420
# phase 18 (spatial): SPATIAL_SHAPE at SPATIAL_POINTS points (gaussian sigma
# SPATIAL_LEVEL), padded to SPATIAL_PAD slots, denoised in one spatial
# forward at l1.yaml width 144 from phase 8's checkpoint, in one process
# and on PAR_WORLD gloo ranks (within MODEL_TOL of each other); spatial
# training on SPATIAL_TRAIN_POINTS points, B=1, SPATIAL_TRAIN_STEPS Adam
# steps; train_discriminator and train_gan with --multihost, one epoch of
# SPATIAL_GAN_STEPS steps each; the first losses within PAR_FIRST_LOSS_RTOL
# of one process's
SPATIAL_SHAPE = "cylinder_t"
SPATIAL_POINTS = 140000
SPATIAL_PAD = 141312
SPATIAL_LEVEL = 0.005
SPATIAL_TRAIN_POINTS = 16384
SPATIAL_TRAIN_STEPS = 2
SPATIAL_GAN_STEPS = 2
SPATIAL_SEED = 18
# 18(e)-(g) (every aggregation operator and the Chamfer losses
# point-sharded): (e) SPATIAL_OP_CONFIG (width 144, depth 2) served by
# ``infer --spatial`` on SPATIAL_SHAPE from seed SPATIAL_SEED's weights, in
# one process and on PAR_WORLD gloo ranks; (f) the forwards of
# SPATIAL_OPERATORS at width 144, depth SPATIAL_OP_DEPTH (cut from 2), on
# the SPATIAL_TRAIN_POINTS-point cloud; (g) SPATIAL_CHAMFER_CONFIG (loss
# ``chamfer``, PseudoGrid, width 144, depth 2) trained point-sharded for
# SPATIAL_TRAIN_STEPS Adam steps on that cloud.  Dense attention is not
# run at SPATIAL_PAD slots: one (N, N) float32 matrix is ~80 GB there
SPATIAL_OP_CONFIG = "pospool_sincos_avg"
SPATIAL_OPERATORS = ("adaptiveweight_dp_fc1_avg", "pointwisemlp_dp_fj_max",
                     "NOLO", "CRCR", "SEAT", "CBAM", "DUAT", "ASCN", "POAT",
                     "OFAT", "CAA", "POTR")
# 18(f)'s operators whose float32 2-rank forward leaves MODEL_TOL and three
# times the one-process float32 noise at an element (on the H100: Criss-cross
# by 2.4x, Dual-attention 6.0x, Offset-attention 1.04x) while the float64
# forwards agree element by element: held in float32 by the whole tensor
SPATIAL_FLOAT32_BY_TENSOR = ("CRCR", "DUAT", "OFAT")
SPATIAL_OP_DEPTH = 1
SPATIAL_CHAMFER_CONFIG = "synthetic_quality_chamfer"
# phase 19 (the 2-D layout, the custom_cfgs sweep, the classification and
# part-segmentation heads): (a) MESH2D_DATA x MESH2D_POINTS gloo ranks
# sharing the card, MESH2D_BATCH clouds of SPATIAL_TRAIN_POINTS points,
# MESH2D_STEPS Adam steps; (b) run_custom_sweep on SWEEP_CONFIGS (name,
# whether it aggregates by the KPConv kernels), one epoch of SWEEP_STEPS
# steps on 14 scans of SWEEP_SCAN_POINTS points; (c) HEADS_CLASSES
# classes (ModelNet40's count) and SHAPENET_PARTS (ShapeNet-Part's 16
# classes, 50 parts)
MESH2D_DATA, MESH2D_POINTS = 2, 2
MESH2D_BATCH = 2
MESH2D_STEPS = 2
SWEEP_CONFIGS = (("pseudogrid_intensity_katz_1_std_3.30", True),
                 ("pospool_katz_1_std_3.30", False))
SWEEP_STEPS = 4
# the EDFS test scans, cut at SEG_CORNER: the voting evaluation's patches
# (one per occupied 0.5-voxel) of whole scans would be ~2,000 a scan
SWEEP_HELD_OUT = (11, 12, 13)
SWEEP_SCAN_POINTS = 12000
HEADS_CLASSES = 40
SHAPENET_PARTS = (4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3)
FRESH_LOAD = r"""
import json, sys, time
import numpy as np
import torch
t0 = time.perf_counter()
from deep3dpointclouddenoising_torch import serving
from deep3dpointclouddenoising_torch.ops import kpconv
predict = serving.load_denoiser(sys.argv[1])
load_s = time.perf_counter() - t0
b = np.load(sys.argv[2])
args = (b["points"], b["mask"], b["features"])
t0 = time.perf_counter()
out = predict(*args)
torch.cuda.synchronize()
first_s = time.perf_counter() - t0
counts = []
for _ in range(2):
    c0 = (kpconv.kpconv_aggregate.launches,
          kpconv.kpconv_aggregate_backward.launches)
    out = predict(*args)
    torch.cuda.synchronize()
    counts.append((kpconv.kpconv_aggregate.launches - c0[0],
                   kpconv.kpconv_aggregate_backward.launches - c0[1]))
np.save(sys.argv[3], out.cpu().numpy())
ep = predict.exported
nodes = sum(1 for n in ep.graph.nodes if n.op == "call_function"
            and str(n.target).startswith("d3pcd_torch.kpconv_fwd"))
tensors = list(ep.state_dict.values()) + [
    t for t in ep.constants.values() if isinstance(t, torch.Tensor)]
print(json.dumps({
    "load_s": load_s, "first_call_s": first_s, "launches": counts,
    "nodes": nodes, "out_device": str(out.device),
    "weights_devices": sorted({str(t.device) for t in ep.state_dict.values()}),
    "constants_devices": sorted({str(t.device) for t in tensors}),
    "modules": sorted(m for m in sys.modules
                      if m.startswith("deep3dpointclouddenoising"))}))
"""
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
    qualitative_test split; returns the kernel's launches in it and the
    voting's points/s."""
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
    return launches, n_points / seconds


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


def write_train_tree(data_root: str) -> str:
    """Phase 8's shape tree: a sphere and a torus in each of the train and
    val splits; returns ``data_root``."""
    for split in ("train", "val"):
        os.makedirs(os.path.join(data_root, split))
        save_off(os.path.join(data_root, split, "sphere.off"),
                 make_icosphere(4))
        save_off(os.path.join(data_root, split, "torus.off"), make_torus())
    return data_root


def phase_training(cfg, device, workdir):
    """This slice's path: the training entry point at full width over
    two-shape train and val splits; returns the kernels' launches in it
    and the profiler window's (device ms per step, busy share)."""
    data_root = write_train_tree(os.path.join(workdir, "train_data"))
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
    return fwd, bwd, profile_train_steps(trainer, batch)


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


def deploy_split(tree: str, workdir: str) -> str:
    """``<workdir>/deploy``: a ``qualitative_test`` split of the tree's
    DEPLOY_SHAPES."""
    deploy_root = os.path.join(workdir, "deploy")
    os.makedirs(os.path.join(deploy_root, "qualitative_test"))
    for name in DEPLOY_SHAPES:
        shutil.copy(os.path.join(tree, "qualitative_test", name + ".off"),
                    os.path.join(deploy_root, "qualitative_test"))
    return deploy_root


def phase_deployment(cfg, workdir):
    """This slice's path: shape tree, two short trainings, routed voting on
    host and device, the Chamfer and performance tables; returns the
    forward and backward kernel launches in it."""
    fwd, bwd = deploy_training(cfg, workdir)
    f, b = deploy_voting(workdir)
    return fwd + f, bwd + b


def deploy_training(cfg, workdir):
    """Phase 9's shape tree, its two short trainings and its split
    (:func:`deploy_split`); returns their forward and backward
    launches."""
    tree = os.path.join(workdir, "shapes")
    make_synthetic_dataset.write_tree(tree, verbose=False)
    log_dir = os.path.join(workdir, "log")
    fwd = bwd = 0
    for config in DEPLOY_CONFIGS:
        f, b, _ = train_short(config, tree, log_dir, cfg)
        fwd, bwd = fwd + f, bwd + b
    deploy_split(tree, workdir)
    return fwd, bwd


def deploy_voting(workdir):
    """Phase 9's routed voting on host and device from the checkpoints of
    :func:`deploy_training`, the Chamfer and performance tables; returns
    the forward and backward launches."""
    log_dir = os.path.join(workdir, "log")
    deploy_root = os.path.join(workdir, "deploy")
    fwd = bwd = 0
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


def bf16_configs():
    """The bf16 config and its float32 twin, checked to be what phase 9b
    holds them to be."""
    cfg = load_config(os.path.join(ROOT, "cfgs", BF16_CONFIG + ".yaml"))
    twin = load_config(os.path.join(ROOT, "cfgs", FP32_TWIN + ".yaml"))
    if (int(cfg.width), str(cfg.compute_dtype), str(twin.compute_dtype)) \
            != (144, "bfloat16", "float32"):
        raise AssertionError(f"{BF16_CONFIG} is no longer the width-144 "
                             f"bfloat16 twin of {FP32_TWIN}")
    return cfg, twin


def phase_bf16(device, workdir, tree, kernels: bool = True):
    """Phase 9b, bfloat16 compute: (a) both kernels' bf16 forms against
    their bf16 plain versions (left out when not ``kernels``: the default
    run takes them on a card nothing else uses), (b) the whole bf16 model
    and its gradients, (c) training with a stop and ``--auto_resume``
    against an unbroken run, bitwise, (d) serving by host and device
    voting; then device ms per train step in bf16 and in float32 from the
    same weights, in this process.  Returns the two bf16 kernels' records
    (None without (a)) and the launches of the main path (training and
    serving)."""
    cfg, twin = bf16_configs()
    records = phase_bf16_kernels(cfg, device, bf16_stem_15k(
        device, workdir, tree)) if kernels else None
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
    ``check_grad_float64`` says), bitwise reproducible (d_rel alone equal
    to the d_rel variant's); each call's live edges, in-degrees, device us
    and bounds over the live edges, and at the stem call d_rel alone's
    device us and bound.  Returns the 15k block of each kernel's JSON
    record ("fwd", "bwd", and "drel_stem" for ``kpconv_bwd_drel``)."""
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
        alone = kpconv_aggregate_backward(
            *args, g, extent, "linear", need_features=False,
            need_kernel_weights=False, need_rel=True)[2]
        torch.cuda.synchronize()
        if not torch.equal(alone, got_rel[2]):
            raise AssertionError(f"15k backward {name}: d_rel alone differs "
                                 "from the d_rel of a second call with "
                                 "d_features and d_kernel_weights")
        del got, got_rel, want, alone
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
        if name == "stem LA":  # d_rel alone (kpconv_bwd_drel) at the stem
            d_us = device_us(lambda: kpconv_aggregate_backward(
                *args, g, extent, "linear", need_features=False,
                need_kernel_weights=False, need_rel=True),
                "kpconv_bwd_drel", 10)
            d_bytes, d_ops = kpconv_drel_bound_tf32(B, M, N, K, C, P, live)
            d_bound = max(d_bytes, d_ops) * 1e3
            drel_stem = {
                "call": name, "device_us": d_us, "bound_us": d_bound,
                "bound_by": "bytes" if d_bytes >= d_ops else "operations",
                "bound_us_fma": max(kpconv_drel_bound(
                    B, M, N, K, C, P, live)) * 1e3,
                "times_bound": d_us / d_bound, "live_edges": live,
                "max_in_degree": max_deg}
            print(f"{name}: d_rel alone (kpconv_bwd_drel) device "
                  f"{d_us:.2f} us, bound {d_bound:.2f} us at 3xTF32 "
                  f"({drel_stem['bound_by']}; "
                  f"{drel_stem['bound_us_fma']:.2f} at the FMA rate), "
                  f"{d_us / d_bound:.1f}x", flush=True)
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
    recs["drel_stem"] = drel_stem
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
            "--log_dir", out_dir + "_log", "--device", "cuda"])
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
    train mode the masked L1 loss's gradients of every parameter too, and
    the CPU's paths run their BatchNorms by ``F.batch_norm`` as the card's
    do (:func:`batch_norm_kernel_on_cpu`), so that each CPU path's distance
    from float64 is a sample of the card's arithmetic's noise.  Returns
    ``{path: (output, [gradients])}``."""
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
        with torch.set_grad_enabled(train), batch_norm_kernel_on_cpu(
                train and path.startswith("cpu")):
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
    """13(a): for each config, the seeded model at AGG_NUMERICS_DEPTH (O(1)
    statistics, gates and head) on one real batch: the eval forward, the
    train forward and the
    train-mode gradients on the card held to the CPU and float64
    (:func:`check_agg_paths`), with no KPConv kernel launched."""
    tensors = {k: torch.as_tensor(batch[k]).to(device)
               for k in ("points", "mask", "features", "offsets")}
    launches = grad_check.launches()
    for name, cfg in cfgs.items():
        t0 = time.perf_counter()
        cfg = copy.deepcopy(cfg)
        cfg.depth = AGG_NUMERICS_DEPTH
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
        "--write_dir", os.path.join(workdir, "agg_seg_eval"), "--log_dir",
        os.path.join(workdir, "agg_seg_eval_log"), "--device", "cuda"])
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


def kpconv_drel_bound_tf32(B, M, N, K, C, P, live, passes=3):
    """kpconv_drel_bound with each edge's contraction (2 per (live edge, p,
    c)) on the tensor cores in ``passes`` TF32 operations for each (3xTF32,
    as kpconv_bwd_drel runs it); q = kw * g and the slopes on the float32
    units.  The least time of d_rel as the kernel computes it."""
    t_bytes, _ = kpconv_drel_bound(B, M, N, K, C, P, live)
    t_ops = (passes * 2 * live * P * C / PEAK_TF32_FLOP_S
             + (2 * B * M * P * C + 20 * live * P) / PEAK_F32_FLOP_S)
    return t_bytes, t_ops * 1e3


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
    device time, bound and their ratio per call); then the whole
    discriminator's gradient in its input points by grad_check's rule.
    Returns the d_rel kernel's record, less launches."""
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
    sums = dict(ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0, bound=0.0,
                bound_fma=0.0)
    timed = []
    print("call M N K C | d_feat d_kw d_rel max_abs | with d_rel ms, "
          "without ms, d_rel alone ms, its plain ms, bound ms at 3xTF32 "
          "bound_by, bound ms at the FMA rate")
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
            # bound now: drel is timed again after the loop
            drel = functools.partial(
                kpconv_aggregate_backward, *args, g, extent, "linear",
                need_features=False, need_kernel_weights=False,
                need_rel=True)
            drel_ms = cuda_ms(drel, 20)
            plain_ms = cuda_ms(lambda: kpconv_aggregate_backward_plain(
                *args, g, extent, "linear", need_features=False,
                need_kernel_weights=False, need_rel=True), 5)
            live = int((args[3] != 0).sum().item())
            t_bytes, t_ops = kpconv_drel_bound_tf32(B, M, N, K, C, P, live)
            bound_fma = max(kpconv_drel_bound(B, M, N, K, C, P, live))
            line += (f" | {full:.5f} {base:.5f} {drel_ms:.5f} "
                     f"{plain_ms:.5f} {max(t_bytes, t_ops):.5f} "
                     + ("bytes" if t_bytes >= t_ops else "operations")
                     + f" {bound_fma:.5f}")
            if not name.startswith("random "):
                timed.append((name, drel, max(t_bytes, t_ops) * 1e3,
                              bound_fma * 1e3))
                for key, v in (("ms", drel_ms), ("plain_ms", plain_ms),
                               ("bytes", t_bytes), ("ops", t_ops),
                               ("bound", max(t_bytes, t_ops)),
                               ("bound_fma", bound_fma)):
                    sums[key] += v
        print(line, flush=True)
    per_call = {}
    for name, drel, bound_us, bound_fma_us in timed:
        us = device_us(drel, "kpconv_bwd_drel", 10)
        per_call[name] = {"device_us": us, "bound_us": bound_us,
                          "bound_us_fma": bound_fma_us,
                          "times_bound": us / bound_us}
        print(f"d_rel alone at {name}: device {us:.2f} us, bound "
              f"{bound_us:.2f} us at 3xTF32 ({bound_fma_us:.2f} at the FMA "
              f"rate), {us / bound_us:.1f}x", flush=True)
    dev_us = sum(c["device_us"] for c in per_call.values()) / len(timed)
    disc = seeded_discriminator(cfg, device)
    worst, counts = disc_input_gradient(disc, batch, device)
    if counts != (10, 10, len(GAN_DREL_CALLS)):
        raise AssertionError(f"the discriminator's input gradient launched "
                             f"{counts} (forward, backward, d_rel)")
    print(f"d_rel at the {len(timed)} level-0 calls of the real pyramid: "
          f"{sums['ms']:.5f} ms (CUDA events), device "
          f"{dev_us * len(timed) / 1e3:.5f} ms ({dev_us:.2f} us a call), "
          f"plain {sums['plain_ms']:.5f} ms, bound {sums['bound']:.5f} ms "
          f"at 3xTF32 ({sums['bound_fma']:.5f} at the FMA rate); the "
          "discriminator's "
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
        "bound_ms": sums["bound"],
        "bound_by": "bytes" if sums["bytes"] >= sums["ops"]
        else "operations",
        "bound_ms_fma": sums["bound_fma"],
        "library_ms": None, "device_ms": dev_us * len(timed) / 1e3,
        "per_call": per_call,
        "timed_at": "d_rel alone (need_rel only) at the discriminator's "
                    "three level-0 calls (stem LA, Bottleneck_0, T1) on a "
                    "real pyramid of denoised points, B=16, width 144; "
                    "device_ms: torch.profiler, summed over the calls",
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


def gan_config():
    """The fine-tuning config, checked to be what phase 14 holds it to
    be."""
    cfg = load_config(os.path.join(ROOT, "cfgs", GAN_CONFIG + ".yaml"))
    if (int(cfg.width), int(cfg.depth), int(cfg.batch_size),
            int(cfg.num_points), float(cfg.gan_alpha)) \
            != (144, 2, 16, 500, 1e-4):
        raise AssertionError(f"{GAN_CONFIG} is no longer width 144, depth "
                             "2, B=16, N=500, gan_alpha 1e-4")
    return cfg


def phase_drel(device, tree, gen_ckpt):
    """14(a) on a batch of ``tree`` denoised by ``gen_ckpt``: returns the
    d_rel kernel's record."""
    cfg = gan_config()
    t0 = time.perf_counter()
    batch = denoised_batch(cfg, device, tree, gen_ckpt)
    record = phase_gan_kernels(cfg, device, batch)
    print(f"14(a): {time.perf_counter() - t0:.1f} s", flush=True)
    return record


def phase_gan(device, workdir, tree, gen_ckpt, kernels: bool = True):
    """Phase 14, GAN fine-tuning and discriminator pre-training: (a) the
    d_rel kernel and the discriminator's input gradient (left out when not
    ``kernels``: the default run takes it on a card nothing else uses),
    (b) ``train_discriminator``, (c) ``train_gan`` with a kill and
    ``--auto_resume``, (d) a profiler window of GAN updates, (e) the
    fine-tuned generator served.  Returns the d_rel kernel's record (only
    the profile without (a)) and the launches of the main path."""
    cfg = gan_config()
    record = phase_drel(device, tree, gen_ckpt) if kernels else {}
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


def pcn_flops(model, x) -> float:
    """Floating-point operations of one ``model(x)`` forward: 2 per
    multiply-add of every Dense (counted by hooks on the rows it gets)
    and of the two transforms' products."""
    total = [0.0]

    def hook(mod, inputs, out):
        rows = inputs[0].numel() // mod.in_features
        total[0] += 2.0 * rows * mod.in_features * mod.out_features

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Linear)]
    try:
        with torch.no_grad():
            _, trans, trans2 = model(x)
    finally:
        for h in handles:
            h.remove()
    B, N = x.shape[:2]
    return total[0] + 2.0 * B * N * (trans.shape[1] ** 2
                                     + trans2.shape[1] ** 2)


def seeded_pcn(device, seed: int = 0):
    """The PCN baseline with seeded weights, its final Dense and every
    BatchNorm's running statistics O(1), in eval mode on ``device``."""
    model = build_offset_regression_PCN(
        load_config(PCN_PATH), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    o1_running_stats(model, rng)
    with torch.no_grad():
        for p in (model.Dense_0.weight, model.Dense_0.bias):
            p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(
                np.float32)))
    return model.to(device).eval()


def pcn_patches(seed: int):
    """PCN_BATCH patch-like clouds of PCN_POINTS points: discs of the
    config's patch radius at differing extent and place, and O(1e-3)
    target offsets of the centres."""
    rng = np.random.default_rng(seed)
    r = float(load_config(PCN_PATH).in_radius)
    x = rng.normal(size=(PCN_BATCH, PCN_POINTS, 3))
    x = r * x / np.linalg.norm(x, axis=-1, keepdims=True) \
        * rng.random((PCN_BATCH, PCN_POINTS, 1)) \
        * rng.uniform(0.3, 1.0, size=(PCN_BATCH, 1, 1)) \
        + rng.normal(size=(PCN_BATCH, 1, 3)) * r
    target = rng.normal(size=(PCN_BATCH, 3)) * 1e-3
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(target.astype(np.float32)))


def phase_pcn_model(device):
    """15(a) The PCN baseline at B=PCN_BATCH, N=PCN_POINTS on the card
    against the CPU: the eval forward by ``grad_check.check_forward``
    (MODEL_TOL, or three times its own float32 noise), every parameter's
    train-mode L1 gradient by ``grad_check.check_device_gradients`` (the
    card's float64 within 1e-6 of the CPU's, and the card's float32 by
    the full-path rule unless float32 does not pin the tensor); no KPConv
    launch; ms per forward (CUDA events) beside the float32 FLOP bound.
    Returns the numbers."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the PCN runs in float32")
    model = seeded_pcn(torch.device("cpu"))
    x, target = pcn_patches(15)
    copies = {"card": copy.deepcopy(model).to(device), "cpu": model,
              "float64": grad_check.float64_copy(model),
              "card64": grad_check.float64_copy(model).to(device)}
    reset_launches()
    out, grads = {}, {}
    for key, m in copies.items():
        dev, dtype = next(m.parameters()).device, next(m.parameters()).dtype
        xi, ti = x.to(dev, dtype), target.to(dev, dtype)
        m.eval()
        with torch.no_grad():
            out[key] = rotate_back(*m(xi)[:2]).cpu().double()
        m.train()
        pred, trans, _ = m(xi)
        loss = torch.mean(torch.abs(rotate_back(pred, trans) - ti))
        grads[key] = [g.cpu().double() for g in torch.autograd.grad(
            loss, list(m.parameters()))]
    if launch_counts() != (0, 0, 0):
        raise AssertionError(f"the PCN launched KPConv kernels: "
                             f"{launch_counts()}")
    worst = grad_check.check_forward(out["card"], out["cpu"],
                                     out["float64"], **MODEL_TOL)
    held = grad_check.check_device_gradients(
        [n for n, _ in model.named_parameters()], grads["card"],
        grads["cpu"], grads["float64"], grads["card64"])
    nearest = held["nearest"]
    card = copies["card"].eval()
    xc = x.to(device)
    with torch.no_grad():
        ms = cuda_ms(lambda: card(xc), 20)
    flops = pcn_flops(card, xc)
    bound_ms = flops / PEAK_F32_FLOP_S * 1e3
    res = {"forward_ms": ms, "gflop": flops / 1e9, "bound_ms": bound_ms,
           "points_per_s_at_bound": PCN_BATCH / bound_ms * 1e3,
           "points_per_s_forward": PCN_BATCH / ms * 1e3}
    print(f"15(a) ResPCPNet B={PCN_BATCH}, N={PCN_POINTS}: eval forward "
          f"card vs CPU max abs {worst['max_abs']:.3e} (nearest its limit: "
          f"{worst['diff']:.3e} of {worst['limit']:.3e}); float32 gradients "
          f"nearest their limit: {nearest[1]} at {nearest[0]:.3f} of it; "
          f"float64 gradients card vs CPU within "
          f"{held['float64_max_l2']:.3e}; decided in float64 (float32 does "
          f"not pin them): {held['decided_in_float64']}; "
          f"{json.dumps(res)} (float32 FLOP bound at "
          f"{PEAK_F32_FLOP_S / 1e12:.0f} TFLOP/s)", flush=True)
    return res


def pcn_argv(tree, log_dir, *extra):
    return ["--config_file", PCN_PATH, "--data_root", tree, "--log_dir",
            log_dir, "--num_steps", str(PCN_STEPS * PCN_BATCH), "--epochs",
            str(PCN_EPOCHS), "--val_freq", "1", "--num_points_per_shape",
            str(DEPLOY_TRAIN_POINTS), "--device", "cuda", *extra]


def pcn_run(argv, kill_at_step=None):
    """One ``train_pcn`` run, ended as by a kill just after step
    ``kill_at_step`` where that is given; returns its summary (None when
    killed)."""
    reset_launches()
    step = PCNTrainer.train_step

    def killed(trainer, batch):
        loss = step(trainer, batch)
        if trainer.step == kill_at_step:
            torch.cuda.synchronize()
            raise Killed(trainer.step)
        return loss

    PCNTrainer.train_step = killed
    try:
        summary = train_pcn.main(argv)
    except Killed:
        summary = None
    finally:
        PCNTrainer.train_step = step
    if launch_counts() != (0, 0, 0):
        raise AssertionError(f"PCN training launched KPConv kernels: "
                             f"{launch_counts()}")
    return summary


def profile_window(label, step_fn, steps: int, timed: int = 10):
    """Wall ms per call of ``step_fn`` (``timed`` calls after two,
    synchronised), then a profiler window of ``steps`` calls: device ms
    per call, busy share and kernels per call.  Returns them as a
    dict."""
    for _ in range(2):
        step_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        step_fn()
    torch.cuda.synchronize()
    out = {"wall_ms": (time.perf_counter() - t0) / timed * 1e3}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = window_summary(label, prof, wall, steps)
    out["kernels_per_step"] = len(_device_events(prof)) / steps
    if summary is not None:
        out["device_ms"], out["busy"] = summary
        # the profiler slows the host: the share of the unprofiled wall
        out["busy_of_unprofiled_wall"] = out["device_ms"] / out["wall_ms"]
    return out


def phase_pcn_training(tree, workdir):
    """15(b) ``train_pcn`` on PCN_CONFIG, PCN_EPOCHS epochs of PCN_STEPS
    steps with validation, unbroken, and killed one step into the last
    epoch and run again with ``--auto_resume``: the end states and the
    checkpoints bitwise equal, losses finite, the weights moved, no
    KPConv launch; then a profiler window of train steps on a validation
    batch.  Returns the unbroken summary and the window."""
    straight_dir = os.path.join(workdir, "pcn_straight")
    straight = pcn_run(pcn_argv(tree, straight_dir, "--auto_resume"))
    steps = PCN_STEPS * PCN_EPOCHS
    if straight["steps"] != steps or not np.isfinite(
            straight["train_losses"] + straight["val_losses"]).all():
        raise AssertionError(f"PCN training: {straight['steps']} steps, "
                             f"losses {straight['train_losses']}")
    log = os.path.join(workdir, "pcn_resumed")
    saved = PCN_STEPS * (PCN_EPOCHS - 1)
    pcn_run(pcn_argv(tree, log, "--auto_resume"), kill_at_step=saved + 1)
    second = pcn_run(pcn_argv(tree, log, "--auto_resume"))
    run = os.path.join(log, PCN_CONFIG)
    if second["restored"] != os.path.join(run, "current.pt") \
            or second["steps"] != steps:
        raise AssertionError(f"PCN resume: restored {second['restored']}, "
                             f"{second['steps']} steps")
    a, b = second["trainer"], straight["trainer"]
    for what, x, y in (("model", a.model.state_dict(), b.model.state_dict()),
                       ("optimizer", a.optimizer.state_dict(),
                        b.optimizer.state_dict())):
        diff = grad_check.state_difference(x, y)
        if diff:
            raise AssertionError(f"PCN resume: {what} differs from the "
                                 f"unbroken run at {diff}")
    for leaf in ("current.pt", f"ckpt_epoch_{PCN_EPOCHS}.pt"):
        diff = grad_check.state_difference(
            torch.load(os.path.join(run, leaf), weights_only=True),
            torch.load(os.path.join(straight_dir, PCN_CONFIG, leaf),
                       weights_only=True))
        if diff:
            raise AssertionError(f"PCN resume: {leaf} differs at {diff}")
    start = build_offset_regression_PCN(
        a.cfg, torch.Generator().manual_seed(int(a.cfg.rng_seed)))
    if all(torch.equal(v.cpu(), start.state_dict()[k])
           for k, v in a.model.state_dict().items()):
        raise AssertionError("PCN training left the weights unchanged")
    cfg = a.cfg
    ds = train_cli.offset_dataset(cfg, "val", 1, architecture="PCN")
    batch = next(iter(BatchLoader(ds, PCN_BATCH).epoch_iter(0)))
    prof = profile_window("PCN train step under the profiler",
                          lambda: a.train_step(batch), PROFILE_STEPS_PCN)
    print(f"15(b) train_pcn {PCN_CONFIG}: {PCN_EPOCHS} epochs of "
          f"{PCN_STEPS} steps at B={PCN_BATCH} unbroken, and killed after "
          f"step {saved + 1} and resumed from step {saved}: state and "
          f"checkpoints bitwise equal; loss first "
          f"{straight['train_losses'][0]:.6f} last "
          f"{straight['train_losses'][-1]:.6f}, val {straight['val_losses']}"
          f"; ms per step by epoch (host clock, data loading included) "
          + ", ".join(f"{ms:.3f}" for ms in straight["ms_per_step"])
          + f"; one batch under the profiler {json.dumps(prof)}", flush=True)
    return straight, prof


def pcn_near_tie(points, center, n: int) -> bool:
    """Whether the ``n``-th and ``n+1``-th nearest cloud points of point
    ``center`` lie within PCN_TIE of each other's squared distance, where
    the host's float32 norms and the card's squared distances may order
    them apart."""
    diff = points - points[center]
    d2 = np.sort(diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]
                 + diff[:, 2] * diff[:, 2])
    return d2[n] - d2[n - 1] <= PCN_TIE * d2[n]


def phase_pcn_serving(tree, workdir, checkpoint):
    """15(c) PCN_SHAPE at 140,000 points, gaussian sigma PCN_LEVEL, served
    with (b)'s checkpoint by ``infer --pcn --device_voting`` (every point
    a patch), then by ``infer --pcn`` on the host over the first
    PCN_HOST_PATCHES patches of the same table (the host path serves ~580
    patches a second).  Device = host within VOTE_TOL on every host patch
    that does not underfill (a patch whose 500th and 501st neighbours are
    a near-tie may take the other: counted and checked); the underfilled
    ones counted with their largest difference; ``compute_cd`` on both
    trees; no KPConv launch.  Returns the numbers."""
    root = os.path.join(workdir, "pcn_serve")
    os.makedirs(os.path.join(root, "qualitative_test"))
    shutil.copy(os.path.join(tree, "qualitative_test", PCN_SHAPE + ".off"),
                os.path.join(root, "qualitative_test"))
    common = ["--config_file", PCN_PATH, "--data_root", root, "--checkpoint",
              checkpoint, "--noise_type", "gaussian", "--noise_level",
              str(PCN_LEVEL), "--pcn", "--device", "cuda"]
    out = {}
    reset_launches()
    dev_dir = os.path.join(workdir, "pcn_out_device")
    out["device"] = infer.main(common + ["--out_dir", dev_dir,
                                         "--device_voting"])
    make_dataset = infer.make_dataset

    def cut(*args, **kwargs):
        ds = make_dataset(*args, **kwargs)
        ds.point_inds = ds.point_inds[:PCN_HOST_PATCHES]
        ds.cloud_inds = ds.cloud_inds[:PCN_HOST_PATCHES]
        ds.num_steps = PCN_HOST_PATCHES
        return ds

    host_dir = os.path.join(workdir, "pcn_out_host")
    infer.make_dataset = cut
    try:
        out["host"] = infer.main(common + ["--out_dir", host_dir])
    finally:
        infer.make_dataset = make_dataset
    if launch_counts() != (0, 0, 0):
        raise AssertionError(f"PCN serving launched KPConv kernels: "
                             f"{launch_counts()}")
    dev, host = out["device"]["results"][0], out["host"]["results"][0]
    n_points = len(dev["offsets"])
    if n_points != PCN_CLOUD_POINTS or not np.isfinite(dev["offsets"]).all():
        raise AssertionError(f"PCN serving: {n_points} points")
    reals = dev["patch_reals"][:PCN_HOST_PATCHES]
    got = dev["offsets"][:PCN_HOST_PATCHES].astype(np.float64)
    want = host["offsets"][:PCN_HOST_PATCHES].astype(np.float64)
    over = np.abs(got - want) - VOTE_TOL["atol"] \
        - VOTE_TOL["rtol"] * np.abs(want)
    full = reals == PCN_POINTS
    bad = np.nonzero(full & (over.max(1) > 0))[0]
    points = out["device"]["dataset"].shapes[0].points
    ties = [int(i) for i in bad if pcn_near_tie(points, i, PCN_POINTS)]
    if len(ties) != len(bad):
        i = int(next(i for i in bad if int(i) not in ties))
        raise AssertionError(f"PCN serving: patch {i} (full) device "
                             f"{got[i]} against host {want[i]}")
    diff = np.abs(got - want).max(1)
    tables = {k: compute_cd.main(["--in_dir", d])
              for k, d in (("device", dev_dir), ("host", host_dir))}
    res = {"points": n_points,
           "device_points_per_s": n_points / out["device"]["seconds"],
           "host_patches": PCN_HOST_PATCHES,
           "host_points_per_s": PCN_HOST_PATCHES / out["host"]["seconds"],
           "full_max_abs_diff": float(diff[full].max())
           if full.any() else None,
           "near_ties": len(ties),
           "underfilled": int((~full).sum()),
           "underfilled_max_abs_diff": float(diff[~full].max())
           if (~full).any() else None,
           "underfilled_in_cloud": int((dev["patch_reals"]
                                        < PCN_POINTS).sum()),
           "cd_ratio_device": tables["device"]["mean"]["ratio"]}
    print(f"15(c) PCN serving {PCN_SHAPE}: {json.dumps(res)}", flush=True)
    return res


def phase_device_sampler(workdir, phase8_window=None):
    """15(d) ``cfgs/l1.yaml`` with ``device_sampler: 1`` through the train
    entry point at width 144, B=16, DS_STEPS steps on phase 8's sphere and
    torus (clouds of DEPLOY_TRAIN_POINTS points), twice: 10 forward and 10
    backward KPConv launches per step (10 forward per validation batch),
    the two runs bitwise equal; then a profiler window of device-sampled
    steps (the sampling on the card included) beside one of host-sampled
    steps on the same data, and beside phase 8's host-sampled window
    (``phase8_window``: device ms per step and busy share, on patch-like
    random inputs) where that ran.  Returns the launches and the
    windows."""
    data_root = os.path.join(workdir, "ds_data")
    for split in ("train", "val"):
        os.makedirs(os.path.join(data_root, split))
        save_off(os.path.join(data_root, split, "sphere.off"),
                 make_icosphere(4))
        save_off(os.path.join(data_root, split, "torus.off"), make_torus())
    with open(CONFIG) as f:
        text = f.read()
    config = os.path.join(workdir, "l1_device_sampler.yaml")
    with open(config, "w") as f:
        f.write(text + "\ndevice_sampler: 1\n")
    cfg = load_config(config)
    runs, counts = [], []
    for i in range(2):
        reset_launches()
        runs.append(train_cli.main([
            "--config_file", config, "--data_root", data_root,
            "--log_dir", os.path.join(workdir, f"ds_log{i}"),
            "--num_steps", str(DS_STEPS * int(cfg.batch_size)),
            "--epochs", "1", "--val_freq", "1", "--num_points_per_shape",
            str(DEPLOY_TRAIN_POINTS), "--device", "cuda"]))
        counts.append(launch_counts())
    steps, val = runs[0]["steps"], runs[0]["val_batches"]
    if steps != DS_STEPS or counts != [(10 * (steps + val), 10 * steps,
                                        0)] * 2:
        raise AssertionError(f"device-sampled training: {steps} steps, "
                             f"{val} val batches, launches {counts}")
    for what, x, y in (("model", runs[0]["trainer"].model.state_dict(),
                        runs[1]["trainer"].model.state_dict()),
                       ("optimizer",
                        runs[0]["trainer"].optimizer.state_dict(),
                        runs[1]["trainer"].optimizer.state_dict())):
        diff = grad_check.state_difference(x, y)
        if diff:
            raise AssertionError(f"device-sampled training: the two runs' "
                                 f"{what} differ at {diff}")
    if not np.isfinite(runs[0]["train_losses"]).all():
        raise AssertionError(f"device-sampled training: losses "
                             f"{runs[0]['train_losses']}")
    trainer = runs[0]["trainer"]
    cfg = trainer.cfg  # with the run's data root and overrides
    ds = train_cli.offset_dataset(cfg, "train", 1,
                                  build_train_transforms(cfg))
    sampler = DeviceSampler(ds, cfg, trainer.device)
    centers = sampler.centers(0, int(cfg.batch_size))[0]
    generator = sample_generator(0, 0, trainer.device)

    def sampled_step():
        trainer.train_step(sampler.sample(centers, torch_draws(
            sampler, generator, int(cfg.batch_size))))

    host_batch = next(iter(BatchLoader(ds, int(cfg.batch_size))))
    windows = {
        "device_sampled": profile_window(
            "device-sampled train step under the profiler", sampled_step,
            PROFILE_STEPS_PCN),
        "host_sampled": profile_window(
            "host-sampled train step (one batch) under the profiler",
            lambda: trainer.train_step(host_batch), PROFILE_STEPS_PCN)}
    if phase8_window is not None:
        windows["phase_8"] = dict(zip(("device_ms", "busy"), phase8_window))
    print(f"15(d) l1.yaml with device_sampler: 1: {steps} steps, {val} val "
          f"batches, launches (forward, backward, d_rel) {counts[0]}, two "
          f"runs bitwise equal; loss first {runs[0]['train_losses'][0]:.6f}"
          f" last {runs[0]['train_losses'][-1]:.6f}; ms per step (host "
          f"clock, sampling included) {runs[0]['ms_per_step'][0]:.3f}; "
          f"windows {json.dumps(windows)}", flush=True)
    return counts[0], windows


def phase_pcn(device, workdir, tree, phase8_window=None):
    """Phase 15, the PointCleanNet baseline and on-card patch sampling:
    (a) the PCN model on the card, (b) ``train_pcn`` with a kill and
    ``--auto_resume``, (c) PCN serving by device and host, (d) l1.yaml
    with ``device_sampler: 1``.  Returns the numbers and the launches of
    the three paths."""
    cfg = load_config(PCN_PATH)
    if (int(cfg.batch_size), int(cfg.num_points), str(cfg.loss)) \
            != (PCN_BATCH, PCN_POINTS, "L1"):
        raise AssertionError(f"{PCN_CONFIG} is no longer B={PCN_BATCH}, "
                             f"N={PCN_POINTS}, L1")
    pcn_tree = os.path.join(workdir, "pcn_shapes")
    for split, names in PCN_TREE.items():
        os.makedirs(os.path.join(pcn_tree, split))
        for name in names:
            shutil.copy(os.path.join(tree, split, name + ".off"),
                        os.path.join(pcn_tree, split))
    res = {}
    for part, fn in (("a", lambda: phase_pcn_model(device)),
                     ("b", lambda: phase_pcn_training(pcn_tree, workdir)),
                     ("c", lambda: phase_pcn_serving(
                         tree, workdir, os.path.join(
                             workdir, "pcn_resumed", PCN_CONFIG,
                             "current.pt"))),
                     ("d", lambda: phase_device_sampler(workdir,
                                                        phase8_window))):
        t0 = time.perf_counter()
        res[part] = fn()
        print(f"15({part}): {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {"pcn_training": 0, "pcn_serving": 0,
                "device_sampled_training": res["d"][0]}
    summary = {"model": res["a"], "training_window": res["b"][1],
               "serving": res["c"], "device_sampler_windows": res["d"][1]}
    return summary, launches

def export_cli(config: str, checkpoint: str, out: str, *extra):
    """``export_model --check`` on the card; returns its result (the
    sidecar, the export seconds, the round trip's error and scale, the
    loaded artifact)."""
    return export_model.main(["--config_file", config, "--checkpoint",
                              checkpoint, "--out", out, "--check",
                              "--device", "cuda", *extra])


def graph_ops(exported, name: str) -> int:
    return sum(1 for n in exported.graph.nodes if n.op == "call_function"
               and str(n.target).startswith(f"d3pcd_torch.{name}"))


def artifact_predict_fn(predict, batch_size: int):
    """``infer``'s ``predict_fn`` over a loaded artifact of batch
    ``batch_size``: a shorter batch (a split's last) is padded with copies
    of its first patch, whose outputs are dropped."""
    def fn(batch):
        n = len(batch["points"])
        arrays = [np.asarray(batch[k]) for k in ("points", "mask",
                                                 "features")]
        if n < batch_size:
            arrays = [np.concatenate([a, np.repeat(a[:1], batch_size - n,
                                                   0)]) for a in arrays]
        return predict(*arrays)[:n]
    return fn


def check_round_trip(got: torch.Tensor, want: torch.Tensor, what: str):
    """``export_model --check``'s rule: the largest difference within
    1e-5 * max(scale, 1), scale the largest output; returns (difference,
    scale, bitwise equal)."""
    if tuple(got.shape) != tuple(want.shape) or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: bad output {tuple(got.shape)}")
    err = (got.double() - want.double()).abs().max().item()
    scale = want.abs().max().item() or 1.0
    if err > 1e-5 * max(scale, 1.0):
        raise AssertionError(f"{what}: max abs difference {err:.3e} from "
                             f"eager (output scale {scale:.3e})")
    return err, scale, bool(torch.equal(got, want))


def fresh_load(artifact: str, batch, workdir: str):
    """The artifact loaded and run on ``batch`` in a fresh process that
    imports ``serving`` alone; returns its report and its output."""
    npz, out = os.path.join(workdir, "batch.npz"), os.path.join(workdir,
                                                                "out.npy")
    np.savez(npz, **{k: batch[k] for k in ("points", "mask", "features")})
    run = subprocess.run([sys.executable, "-c", FRESH_LOAD, artifact, npz,
                          out], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    if run.returncode != 0:
        raise AssertionError(f"loading the artifact in a fresh process "
                             f"failed:\n{run.stderr[-4000:]}")
    report = json.loads(run.stdout.strip().splitlines()[-1])
    return report, torch.from_numpy(np.load(out))


def start_traced_training(data_root: str, workdir: str, steps: int):
    """(d): phase 8's train command with ``--profile_dir``, TRACE_EPOCHS
    epochs of ``steps`` steps, started in a fresh process (a profiler
    session in this one would add to the many windows the phases open) to
    run beside (a); :func:`traced_training` waits for it."""
    B = int(load_config(CONFIG).batch_size)
    out = {k: open(os.path.join(workdir, f"traced.{k}"), "w")
           for k in ("stdout", "stderr")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "deep3dpointclouddenoising_torch.train",
         "--config_file", CONFIG, "--data_root", data_root, "--log_dir",
         os.path.join(workdir, "log"), "--num_steps", str(steps * B),
         "--epochs", str(TRACE_EPOCHS), "--val_freq", "1", "--device",
         "cuda", "--profile_dir", os.path.join(workdir, "trace")],
        cwd=ROOT, stdout=out["stdout"], stderr=out["stderr"],
        env=dict(os.environ, PYTHONPATH=ROOT))
    for f in out.values():
        f.close()
    return proc


def traced_training(proc, workdir: str):
    """Wait for :func:`start_traced_training`'s process: its ``log.txt``
    holding every line it printed, ``metrics.jsonl`` JAX's tags at steps
    1..TRACE_EPOCHS, and a Chrome trace naming both KPConv kernels.
    Returns what was found."""
    log_dir, trace = (os.path.join(workdir, d) for d in ("log", "trace"))
    rc = proc.wait(timeout=900)
    with open(os.path.join(workdir, "traced.stdout")) as f:
        stdout = f.read()
    if rc != 0:
        with open(os.path.join(workdir, "traced.stderr")) as f:
            raise AssertionError(f"the traced training failed:\n"
                                 f"{f.read()[-4000:]}")
    run_dir = os.path.join(log_dir, load_config(CONFIG).experiment_name)
    with open(os.path.join(run_dir, "log.txt")) as f:
        log = f.read()
    printed = [line for line in stdout.splitlines() if line]
    missing = [line for line in printed if f"INFO: {line}" not in log]
    if f"epoch {TRACE_EPOCHS}:" not in stdout or missing:
        raise AssertionError(f"log.txt lacks printed lines {missing[:3]}")
    steps_by_tag = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            steps_by_tag.setdefault(rec["tag"], []).append(rec["step"])
            if not math.isfinite(rec["value"]):
                raise AssertionError(f"metrics.jsonl: {rec}")
    want = {t: list(range(1, TRACE_EPOCHS + 1))
            for t in ("train/loss", "train/lr", "val/loss")}
    if steps_by_tag != want:
        raise AssertionError(f"metrics.jsonl has {steps_by_tag}, not {want}")
    path = os.path.join(trace, TRACE_NAME)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            for key in ("kpconv_fwd_kernel", "kpconv_bwd_kernel"):
                if key in e.get("name", ""):
                    kernels[key] = kernels.get(key, 0) + 1
    # the profiler may drop launches (device_us), so each kernel is held to
    # appear, and its count is printed
    if set(kernels) != {"kpconv_fwd_kernel", "kpconv_bwd_kernel"}:
        raise AssertionError(f"the trace names the KPConv kernels "
                             f"{kernels}")
    return dict(log_lines=len(log.splitlines()), metrics=steps_by_tag,
                trace_mb=os.path.getsize(path) / 2 ** 20,
                trace_events=len(events), trace_kernels=kernels)


def phase_export(cfg, workdir, deploy_root, l1_ckpt, cleaning_ckpt,
                 train_data):
    """This slice's path: (a) ``export_model --check`` of l1.yaml at width
    144, B=16, N=500 from phase 8's checkpoint, the artifact loaded in a
    fresh process and held to eager on a real batch; (b) EXPORT_SHAPE served
    by host voting through the artifact loaded here, against eager voting;
    (c) the full-cleaning artifact from phase 10's checkpoint, raw outputs
    against eager; (d) phase 8's train command on its data with
    ``--profile_dir``, in a fresh process that runs beside (a)
    (:func:`traced_training`).  Returns the forward launches of (b) and
    the phase's numbers."""
    gc.collect()  # the card's cached blocks back for (a)'s and (d)'s
    torch.cuda.empty_cache()  # fresh processes
    traced = start_traced_training(train_data, workdir, TRACE_STEPS)
    try:
        return _export_paths(cfg, workdir, deploy_root, l1_ckpt,
                             cleaning_ckpt, traced)
    finally:  # a failed check leaves no process behind
        if traced.poll() is None:
            traced.kill()
            traced.wait()


def _export_paths(cfg, workdir, deploy_root, l1_ckpt, cleaning_ckpt,
                  traced):
    device = torch.device("cuda", 0)
    B = int(cfg.batch_size)
    art = os.path.join(workdir, "l1.pt2")
    t0 = time.perf_counter()
    kpconv_aggregate.launches = 0
    kpconv_aggregate_backward.launches = 0
    result = export_cli(CONFIG, l1_ckpt, art)
    export_wall = time.perf_counter() - t0
    if kpconv_aggregate_backward.launches:
        raise AssertionError("export launched the backward kernel")
    meta = result["meta"]
    if (meta["platforms"], meta["in_avals"]) != (
            ["cuda"], [f"float32[{B},{int(cfg.num_points)},3]",
                       f"float32[{B},{int(cfg.num_points)}]",
                       f"float32[{B},{int(cfg.num_points)},3]"]):
        raise AssertionError(f"artifact metadata {meta}")
    # EXPORT_SHAPE under gaussian EXPORT_LEVEL noise, cut into l1.yaml's
    # patches as the inference entry point cuts them
    served = copy.deepcopy(cfg)
    served.noise_type, served.noise_level = "gaussian", EXPORT_LEVEL
    dataset = infer.make_dataset(served, deploy_root)
    batch = next(iter(BatchLoader(dataset, B)))
    model = infer.load_model(cfg, device, l1_ckpt)
    eager_fn = infer.make_predict_fn(model)
    want = eager_fn(batch).cpu()
    report, got = fresh_load(art, batch, workdir)
    err, scale, bitwise = check_round_trip(got, want, "fresh-process "
                                                      "artifact")
    if report["launches"] != [[10, 0], [10, 0]] or report["nodes"] != 10:
        raise AssertionError(f"the loaded artifact: {report}")
    if any(m.endswith((".models", ".infer", ".config", ".train"))
           for m in report["modules"]) \
            or not report["out_device"].startswith("cuda") \
            or report["weights_devices"] != ["cuda:0"]:
        raise AssertionError(f"the fresh process: {report}")
    print(f"(a) l1.yaml artifact, width {int(cfg.width)}, B={B}, "
          f"N={int(cfg.num_points)}: export {result['export_s']:.3f} s "
          f"({export_wall:.3f} s with the load and --check), "
          f"{meta['bytes']} bytes, --check max abs err {result['err']:.3e} "
          f"(scale {result['scale']:.3e}); fresh process: load "
          f"{report['load_s']:.3f} s, first call "
          f"{report['first_call_s']:.3f} s, {report['nodes']} kpconv_fwd "
          f"nodes, launches per call (forward, backward) "
          f"{report['launches']}, weights on {report['weights_devices']}, "
          f"constants on {report['constants_devices']}, modules "
          f"{report['modules']}; against eager on a real batch: max abs "
          f"diff {err:.3e} (scale {scale:.3e}), bitwise equal {bitwise}",
          flush=True)

    # (d) done before (b) times the voting: no training beside it
    logs = traced_training(traced, workdir)
    predict = result["predict"]  # export_model --check's load
    if graph_ops(predict.exported, "kpconv_fwd") != 10 \
            or graph_ops(predict.exported, "kpconv_bwd"):
        raise AssertionError("the artifact's graph lacks the ten forward ops")
    art_fn = artifact_predict_fn(predict, B)
    art_fn(batch)  # the loaded module's first call
    torch.cuda.synchronize()
    runs = {}
    for name, fn in (("eager", eager_fn), ("artifact", art_fn)):
        kpconv_aggregate.launches = 0
        kpconv_aggregate_backward.launches = 0
        t0 = time.perf_counter()
        offsets = infer.predict_offsets_voting(fn, dataset, B)
        seconds = time.perf_counter() - t0
        runs[name] = (offsets, kpconv_aggregate.launches,
                      kpconv_aggregate_backward.launches, seconds)
    batches = -(-len(dataset) // B)
    n_points = sum(len(s.points) for s in dataset.shapes)
    launches = runs["artifact"][1]
    if (launches, runs["artifact"][2]) != (10 * batches, 0):
        raise AssertionError(f"artifact voting launched {launches} forward "
                             f"and {runs['artifact'][2]} backward kernels "
                             f"for {batches} batches")
    worst = max(check_close(torch.from_numpy(g).double(),
                            torch.from_numpy(w).double(), what="artifact "
                            "voting against eager voting", **VOTE_TOL)[0]
                for g, w in zip(runs["artifact"][0], runs["eager"][0]))
    pps = {k: n_points / v[3] for k, v in runs.items()}
    print(f"(b) {EXPORT_SHAPE} ({n_points} points, {len(dataset)} patches, "
          f"{batches} batches) by host voting: artifact "
          f"{pps['artifact']:.1f} points/s, eager {pps['eager']:.1f} "
          f"points/s; artifact launches {launches} (10 per batch); offsets "
          f"max abs diff {worst:.3e} (rtol {VOTE_TOL['rtol']} / atol "
          f"{VOTE_TOL['atol']})", flush=True)

    clean_cfg = load_config(os.path.join(ROOT, "cfgs",
                                         CLEANING_CONFIG + ".yaml"))
    if (int(clean_cfg.batch_size), int(clean_cfg.num_points)) != (
            B, int(cfg.num_points)):
        raise AssertionError(f"{CLEANING_CONFIG} no longer serves l1.yaml's "
                             "batch shape")
    clean_art = os.path.join(workdir, "cleaning.pt2")
    clean = export_cli(os.path.join(ROOT, "cfgs", CLEANING_CONFIG + ".yaml"),
                       cleaning_ckpt, clean_art, "--full_cleaning")
    norm = float(clean_cfg.in_radius) / 100.0 if clean_cfg.norm else None
    clean_model = infer.load_model(clean_cfg, device, cleaning_ckpt,
                                   full_cleaning=True)
    # (a)'s real batch: the cleaning config's patches have its shape
    want = infer.make_predict_fn(clean_model, norm, False)(batch).cpu()
    got = clean["predict"](
        *(batch[k] for k in ("points", "mask", "features"))).cpu()
    if got.shape[-1] != 4:
        raise AssertionError(f"the cleaning artifact gives {got.shape}")
    c_err, c_scale, c_bitwise = check_round_trip(got, want,
                                                 "cleaning artifact")
    if not c_bitwise:  # the same kernels on the same inputs, no atomics
        raise AssertionError(f"the cleaning artifact's raw outputs differ "
                             f"from eager's by up to {c_err:.3e}")
    print(f"(c) {CLEANING_CONFIG} --full_cleaning artifact: export "
          f"{clean['export_s']:.3f} s, {clean['meta']['bytes']} bytes; raw "
          f"4 channels against eager on (a)'s batch: bitwise equal "
          f"(scale {c_scale:.3e})", flush=True)

    print(f"(d) phase 8's train command, {TRACE_EPOCHS} epochs of "
          f"{TRACE_STEPS} steps, first traced: log.txt {logs['log_lines']} "
          f"lines, "
          f"metrics.jsonl {logs['metrics']}, trace {logs['trace_mb']:.1f} "
          f"MiB, {logs['trace_events']} events, KPConv kernels in it "
          f"{logs['trace_kernels']}", flush=True)
    return launches, dict(
        export_s=result["export_s"], bytes=meta["bytes"],
        fresh_load_s=report["load_s"],
        artifact_pps=pps["artifact"], eager_pps=pps["eager"],
        fresh_max_abs=err, vote_max_abs=worst, cleaning_max_abs=c_err,
        cleaning_export_s=clean["export_s"], trace_mb=logs["trace_mb"])

def par_argv(cfg, data_root: str, log_dir: str, *extra):
    """Phase 17's train command: l1.yaml at width 144, the global batch of
    its config (16), PAR_EPOCHS epochs of PAR_STEPS steps on phase 8's
    tree, a validation pass each epoch."""
    return ["--config_file", CONFIG, "--data_root", data_root, "--log_dir",
            log_dir, "--num_steps", str(PAR_STEPS * int(cfg.batch_size)),
            "--epochs", str(PAR_EPOCHS), "--val_freq", "1", *extra]


def state_hashes(state) -> dict:
    """{name: sha256 of the tensor's bytes}: equal only if bitwise equal."""
    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy()
                              .tobytes()).hexdigest()
            for k, v in state.items()}


@contextlib.contextmanager
def two_pass_batch_norm(on: bool = True):
    """With ``on``, one process's train-mode BatchNorms on CUDA tensors take
    the two-pass form that CPU tensors take (the cross-rank form, its
    collectives identities outside a group) in place of
    ``F.batch_norm``, so a card path computes the CPU's arithmetic."""
    kept = model_layers.is_distributed
    if on:
        model_layers.is_distributed = lambda: True
    try:
        yield
    finally:
        model_layers.is_distributed = kept


@contextlib.contextmanager
def batch_norm_kernel_on_cpu(on: bool = True):
    """With ``on``, one process's train-mode BatchNorms on CPU tensors run
    ``F.batch_norm``, as they do on CUDA tensors, in place of the two
    passes that ``models/layers.py`` takes there, so a CPU path computes
    the card's arithmetic (the running statistics are not kept as
    ``models/layers.py`` keeps them: nothing here reads them)."""
    kept = model_layers.ChannelsLastBatchNorm.forward

    def forward(self, x):
        if not (self.training and x.device.type == "cpu"):
            return kept(self, x)
        shape = x.shape
        x = x.reshape(-1, shape[-1]).to(
            torch.promote_types(x.dtype, self.weight.dtype))
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, True, self.momentum,
                            self.eps).reshape(shape)

    if on:
        model_layers.ChannelsLastBatchNorm.forward = forward
    try:
        yield
    finally:
        model_layers.ChannelsLastBatchNorm.forward = kept


def sgd_gradient(device, batch, two_pass: bool = False):
    """One SGD step (momentum 0, no weight decay) of the l1.yaml Trainer
    from its seed's init on ``batch`` (this rank's rows inside a process
    group): the gradient it applied, ``(p0 - p1) / lr``, and ``lr``
    (tests/test_trainer.py:106-144).  ``two_pass`` runs one process's
    BatchNorms in their cross-rank form (two passes; its collectives are
    identities outside a group) in place of ``F.batch_norm``."""
    cfg = load_config(CONFIG)
    cfg.optimizer, cfg.momentum, cfg.weight_decay = "sgd", 0.0, 0.0
    with two_pass_batch_norm(two_pass):
        tt = Trainer(cfg, 1,
                     torch.Generator().manual_seed(int(cfg.rng_seed)),
                     device)
        p0 = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
        tt.train_step(batch)
    lr = tt.lr_schedule(0)
    return {n: (p0[n] - p.detach()) / lr
            for n, p in tt.model.named_parameters()}, lr


def allreduce_ms(nbytes: int, device, iters: int = 5) -> float:
    """Host ms per SUM all-reduce of ``nbytes`` of float32 on ``device``
    over the process group (synchronised after ``iters`` calls)."""
    x = torch.ones(max(nbytes // 4, 1), device=device)
    for _ in range(2):
        torch.distributed.all_reduce(x)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        torch.distributed.all_reduce(x)
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3


def parallel_rank(spec_path: str) -> int:
    """One rank of phase 17, started by torchrun: the train CLI with
    ``--multihost`` (the kernels' launches counted around it), then a
    profiler window of train steps on this rank's rows of a real global
    batch, the all-reduce's time at the gradients' bytes and at one float,
    and, with ``spec["sgd"]``, one SGD step from the seed's init; writes
    its record to ``<out>/rank<r>.json`` (and rank 0 the SGD gradient to
    ``<out>/sgd.pt``)."""
    with open(spec_path) as f:
        spec = json.load(f)
    initialize_distributed(spec["device"], spec["backend"])
    try:
        r, world = dist_rank(), world_size()
        device = local_device(spec["device"])
        torch.cuda.set_device(device)
        reset_launches()
        summary = train_cli.main(spec["argv"])
        fwd, bwd, _ = launch_counts()
        trainer = summary["trainer"]
        out = {"rank": r, "world": world, "device": str(device),
               "backend": torch.distributed.get_backend(),
               "launches": [fwd, bwd], "steps": summary["steps"],
               "val_batches": summary["val_batches"],
               "train_losses": summary["train_losses"],
               "val_losses": summary["val_losses"],
               "ms_per_step": summary["ms_per_step"],
               "hashes": state_hashes(trainer.model.state_dict())}
        if out["backend"] == "nccl":
            v = torch.cuda.nccl.version()
            out["nccl"] = ".".join(map(str, v)) if isinstance(v, tuple) \
                else str(v)
        cfg = load_config(CONFIG)
        whole = patch_batch(cfg, PAR_BATCH_SEED)
        rows = process_slice(len(whole["points"]))
        batch = {k: torch.from_numpy(v[rows]).to(device)
                 for k, v in whole.items()}
        out["window"] = profile_window(f"rank {r} train step",
                                       lambda: trainer.train_step(batch), 3)
        out["grad_bytes"] = sum(p.grad.numel() * p.grad.element_size()
                                for p in trainer.model.parameters()
                                if p.grad is not None)
        out["allreduce_ms"] = allreduce_ms(out["grad_bytes"], device)
        out["allreduce_scalar_ms"] = allreduce_ms(4, device)
        if spec["sgd"]:
            grads, out["sgd_lr"] = sgd_gradient(device, batch)
            out["sgd_hashes"] = state_hashes(grads)
            if r == 0:
                torch.save({k: v.cpu() for k, v in grads.items()},
                           os.path.join(spec["out"], "sgd.pt"))
        with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown_distributed()
    return 0


def run_torchrun(nproc: int, spec: dict, name: str,
                 flag: str = "--parallel-rank") -> list:
    """``torchrun --standalone --nproc_per_node=nproc chip_smoke.py
    <flag>`` (``--parallel-rank`` for phase 17, ``--spatial-rank`` for
    phase 18), in a session of its own, killed with whatever it started if
    it runs past PAR_LIMIT_S; prints its output and returns the ranks'
    records."""
    os.makedirs(spec["out"], exist_ok=True)
    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    log = os.path.join(spec["out"], "log.txt")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", os.path.abspath(__file__),
           flag, path]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=ROOT, start_new_session=True,
                                env=dict(os.environ, OMP_NUM_THREADS="2"))
        try:
            rc = proc.wait(timeout=PAR_LIMIT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = None
    with open(log) as f:
        text = f.read()
    print(f"-- torchrun, {name}, {nproc} rank(s):\n{text}", end=""
          if text.endswith("\n") else "\n")
    if rc != 0:
        raise AssertionError(f"torchrun ({name}) " + (
            f"ran past {PAR_LIMIT_S} s" if rc is None else f"exited {rc}"))
    out = []
    for r in range(nproc):
        with open(os.path.join(spec["out"], f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def check_parallel_run(name: str, ranks: list, one: dict, one_launches,
                       checkpoints, lr: float) -> dict:
    """Phase 17's checks of a data-parallel run of the train command
    against the same command in one process: every rank took the steps
    and launched 10 forward and 10 backward kernels a step on its rows;
    the ranks' end states are bitwise equal; the first train loss (one
    init, one global batch: the ranks' shares summed) within
    PAR_FIRST_LOSS_RTOL of the one-process loss, every loss finite; every
    parameter of the coordinator's checkpoint within Adam's reach of the
    one-process run's, 2 * lr a step (Adam moves each element by about
    lr a step whatever its gradient, so rounding-level gradients of
    opposite signs part by 2 * lr).  Returns the run's numbers."""
    steps, val = one["steps"], one["val_batches"]
    if tuple(one_launches) != (10 * (steps + val), 10 * steps):
        raise AssertionError(f"{name}: the one-process run launched "
                             f"{one_launches}")
    for r in ranks:
        if (r["steps"], r["val_batches"]) != (steps, val):
            raise AssertionError(f"{name}: rank {r['rank']} took "
                                 f"{r['steps']} steps, {r['val_batches']} "
                                 f"val batches; one process {steps}, {val}")
        if r["launches"] != [10 * (steps + val), 10 * steps]:
            raise AssertionError(
                f"{name}: rank {r['rank']} launched {r['launches']} "
                f"forward and backward kernels for {steps} steps and "
                f"{val} val batches")
        if r["hashes"] != ranks[0]["hashes"] \
                or r["train_losses"] != ranks[0]["train_losses"]:
            raise AssertionError(f"{name}: rank {r['rank']} ended apart "
                                 "from rank 0")
    losses = ranks[0]["train_losses"] + ranks[0]["val_losses"]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: losses {losses}")
    first, want = ranks[0]["train_losses"][0], one["train_losses"][0]
    if abs(first - want) > PAR_FIRST_LOSS_RTOL * abs(want):
        raise AssertionError(f"{name}: first train loss {first!r} against "
                             f"one process {want!r}")
    got, ref = (load_model_state(c) for c in checkpoints)
    worst = max(float((got[k] - ref[k]).abs().max()) for k in ref
                if ref[k].is_floating_point() and "running_" not in k)
    if worst > 2.0 * lr * steps:
        raise AssertionError(f"{name}: a parameter {worst:.3g} from the "
                             f"one-process run's (limit {2 * lr * steps})")
    print(f"{name}: {len(ranks)} rank(s), {steps} steps, {val} val batches "
          f"each; launches per rank (forward, backward): "
          f"{[r['launches'] for r in ranks]}; ranks bitwise equal; train "
          f"losses {ranks[0]['train_losses']} against one process "
          f"{one['train_losses']}; val {ranks[0]['val_losses']} against "
          f"{one['val_losses']}; parameters at most {worst / lr:.3f} lr "
          f"from the one-process run's")
    for r in ranks:
        w = r["window"]
        print(f"  rank {r['rank']} ({r['backend']} on {r['device']}"
              + (f", NCCL {r['nccl']}" if "nccl" in r else "") + "): ms per "
              f"step by epoch (host clock, data loading included) "
              + ", ".join(f"{ms:.3f}" for ms in r["ms_per_step"])
              + f"; a step of its rows of a real batch: wall "
              f"{w['wall_ms']:.3f} ms, device "
              + (f"{w['device_ms']:.3f} ms, busy {w['busy']:.3f}, "
                 if "device_ms" in w else "not measured, ")
              + f"{w['kernels_per_step']:.1f} kernels; gradients "
              f"{r['grad_bytes']:,} bytes, all-reduce {r['allreduce_ms']:.3f}"
              f" ms (one float: {r['allreduce_scalar_ms']:.3f} ms)")
    return {"ranks": [{k: r[k] for k in (
        "rank", "backend", "launches", "ms_per_step", "window", "grad_bytes",
        "allreduce_ms", "allreduce_scalar_ms") if k in r} for r in ranks],
        "max_param_diff_lr": worst / lr, "first_loss": first,
        "one_process_first_loss": want}


def phase_parallel(cfg, device, workdir, data_root):
    """This slice's path, on phase 8's tree: (a) the train command on
    PAR_WORLD ranks sharing the card over gloo (torchrun, ``--multihost
    --dist_backend gloo --device cuda:0``), then in one process; (b) one
    SGD step of the Trainer on the ranks' rows of a real global batch
    against one process on the whole batch: the applied gradients within
    PAR_SGD_ATOL, the ranks' bitwise equal, the LR scaled by the world
    size.  (b)'s one process runs its BatchNorms in the ranks' two-pass
    form: on the CPU, ``F.batch_norm``'s train-mode gradients missed
    float64 by up to 6% of a gradient on this model at width 8, where the
    two-pass form was within 4e-7; the distance to ``F.batch_norm``'s step
    is printed beside.  (c) the train command on one rank over NCCL (torchrun,
    ``--multihost``) against the one-process run.  Returns the phase's
    numbers and each run's kernel launches."""
    gc.collect()  # the card's cached blocks back for the ranks
    torch.cuda.empty_cache()
    gloo = run_torchrun(PAR_WORLD, {
        "argv": par_argv(cfg, data_root, os.path.join(workdir, "log_gloo"),
                         "--device", f"{PAR_DEVICE}:0", "--multihost",
                         "--dist_backend", "gloo"),
        "device": f"{PAR_DEVICE}:0", "backend": "gloo", "sgd": True,
        "out": os.path.join(workdir, "gloo")}, "(a) gloo")
    reset_launches()
    one = train_cli.main(par_argv(cfg, data_root,
                                  os.path.join(workdir, "log_one"),
                                  "--device", PAR_DEVICE))
    one_launches = launch_counts()[:2]
    run = cfg.experiment_name
    lr = float(cfg.base_learning_rate)
    ckpt_one = os.path.join(workdir, "log_one", run, "current.pt")
    out = {"gloo": check_parallel_run(
        "(a) gloo", gloo, one, one_launches,
        (os.path.join(workdir, "log_gloo", run, "current.pt"), ckpt_one), lr)}
    # (b): against one process in the ranks' BatchNorm arithmetic, and
    # (printed) in F.batch_norm's
    batch = patch_batch(cfg, PAR_BATCH_SEED)
    grads, sgd_lr = sgd_gradient(device, batch, two_pass=True)
    plain, _ = sgd_gradient(device, batch)
    ranks_grads = torch.load(os.path.join(workdir, "gloo", "sgd.pt"))
    if any(r["sgd_hashes"] != gloo[0]["sgd_hashes"] for r in gloo):
        raise AssertionError("(b): the ranks applied different gradients")
    if not math.isclose(gloo[0]["sgd_lr"], PAR_WORLD * sgd_lr,
                        rel_tol=1e-6):
        raise AssertionError(f"(b): the ranks' SGD LR {gloo[0]['sgd_lr']}, "
                             f"one process {sgd_lr}")
    diff = {n: float((ranks_grads[n] - g.cpu()).abs().max())
            for n, g in grads.items()}
    worst = max(diff, key=diff.get)
    scale = max(float(g.abs().max()) for g in grads.values())
    plain_diff = max(float((ranks_grads[n] - g.cpu()).abs().max())
                     for n, g in plain.items())
    if diff[worst] > PAR_SGD_ATOL:
        raise AssertionError(f"(b): {worst}'s gradient {diff[worst]:.3g} "
                             f"from one process's (atol {PAR_SGD_ATOL})")
    print(f"(b) SGD: the {PAR_WORLD} ranks' applied gradients within "
          f"{diff[worst]:.3g} of one process's on the whole batch (atol "
          f"{PAR_SGD_ATOL}; largest gradient {scale:.3g}; worst {worst}); "
          f"with F.batch_norm's BatchNorms one process's are "
          f"{plain_diff:.3g} from the ranks'; ranks bitwise equal; LR "
          f"{gloo[0]['sgd_lr']:.6g} = {PAR_WORLD} x {sgd_lr:.6g}")
    out["sgd"] = {"max_abs_diff": diff[worst], "max_abs_grad": scale,
                  "max_abs_diff_batch_norm": plain_diff}
    nccl = run_torchrun(1, {
        "argv": par_argv(cfg, data_root, os.path.join(workdir, "log_nccl"),
                         "--device", PAR_DEVICE, "--multihost"),
        "device": PAR_DEVICE, "backend": None, "sgd": False,
        "out": os.path.join(workdir, "nccl")}, "(c) nccl")
    if nccl[0]["backend"] != "nccl":
        raise AssertionError(f"(c) ran over {nccl[0]['backend']}")
    out["nccl"] = check_parallel_run(
        "(c) nccl", nccl, one, one_launches,
        (os.path.join(workdir, "log_nccl", run, "current.pt"), ckpt_one), lr)
    out["nccl"]["version"] = nccl[0]["nccl"]
    launches = {"data_parallel_gloo_rank0": gloo[0]["launches"],
                "data_parallel_gloo_rank1": gloo[1]["launches"],
                "data_parallel_nccl_rank0": nccl[0]["launches"],
                "data_parallel_one_process": list(one_launches)}
    return out, launches



def spatial_tree(root: str) -> str:
    """Phase 18's ``qualitative_test`` split: SPATIAL_SHAPE alone."""
    os.makedirs(os.path.join(root, "qualitative_test"))
    save_off(os.path.join(root, "qualitative_test", SPATIAL_SHAPE + ".off"),
             make_synthetic_dataset.shapes_for("qualitative_test")[
                 SPATIAL_SHAPE])
    return root


def spatial_infer_argv(data_root: str, out_dir: str, checkpoint: str,
                       *extra, config: str = CONFIG):
    """``infer --spatial`` of SPATIAL_SHAPE at gaussian SPATIAL_LEVEL with
    ``checkpoint`` (of ``config``, l1.yaml by default), no routing."""
    return ["--config_file", config, "--data_root", data_root, "--out_dir",
            out_dir, "--checkpoint", checkpoint, "--checkpoint_low", "none",
            "--noise_type", "gaussian", "--noise_level", str(SPATIAL_LEVEL),
            "--spatial", *extra]


def spatial_level0_kernels(cfg, device, dataset):
    """Both kernels against plain at the spatial forward's level-0 call of
    the stem: the whole cloud's SPATIAL_PAD queries against all of its
    supports (one rank's query block in one process), on the real
    neighbourhood of the spatial pyramid, with random features, kernel
    weights and upstream gradient at the stem's width.  The forward at
    KERNEL_TOL; the training path's backward against the plain backward
    in float64 (``check_grad_float64``) and bitwise reproducible.  Returns
    each kernel's record at that shape: wrapper ms (CUDA events), plain
    ms, bound over the live edges, largest error."""
    n = len(dataset.shapes[0].points)
    scfg = infer.spatial_config(cfg, SPATIAL_PAD)
    model = build_spatial_model(scfg).to(device)
    pts = torch.zeros(1, SPATIAL_PAD, 3, device=device)
    pts[0, :n] = torch.from_numpy(dataset.shapes[0].points).to(device)
    mask = torch.zeros(1, SPATIAL_PAD, device=device)
    mask[0, :n] = 1.0
    with torch.no_grad():
        level = model.make_pyramid(pts, mask).levels[0]
    nbr = level.self_nbr
    fmask = local_aggregation._feature_mask(nbr, level.mask).contiguous()
    pg = model.ResNetEncoder_0.LocalAggregation_0.PseudoGrid_0
    B, M, K = nbr.idx.shape
    N, (P, C) = SPATIAL_PAD, pg.kernel_weights.shape
    rng = np.random.default_rng(SPATIAL_SEED)
    feat, g, kw = (torch.from_numpy(a.astype(np.float32)).to(device)
                   for a in (rng.normal(size=(B, N, C)),
                             rng.normal(size=(B, M, C)),
                             rng.normal(size=(P, C)) * math.sqrt(2.0 / C)))
    args = (feat, nbr.idx, nbr.rel_xyz, fmask, pg.kpoints, kw)
    extent, infl = pg.extent, pg.influence
    with torch.no_grad():
        got = kpconv_aggregate(*args, extent, infl)
        torch.cuda.synchronize()
        want = kpconv_aggregate_plain(*args, extent, infl)
        fwd_err, _ = check_close(got, want, what="spatial level-0 kpconv",
                                 **KERNEL_TOL)
    del got, want
    got = kpconv_aggregate_backward(*args, g, extent, infl)
    torch.cuda.synchronize()
    want = kpconv_aggregate_backward_plain(*args, g, extent, infl)
    want64 = kpconv_aggregate_backward_plain(
        *[a.double() if a.is_floating_point() else a for a in args],
        g.double(), extent, infl)
    pairs = [check_grad_float64(a, b, c, f"spatial level-0 backward {what}")
             for a, b, c, what in zip(got[:2], want[:2], want64[:2],
                                      ("d_feat", "d_kw"))]
    del got, want, want64
    check_reproducible(args, g, extent, infl, "spatial level 0")

    def fwd():
        with torch.no_grad():
            return kpconv_aggregate(*args, extent, infl)

    def plain_fwd():
        with torch.no_grad():
            return kpconv_aggregate_plain(*args, extent, infl)

    def bwd():
        return kpconv_aggregate_backward(*args, g, extent, infl)

    def plain_bwd():
        return kpconv_aggregate_backward_plain(*args, g, extent, infl)

    live, mean_deg, max_deg = in_degrees(fmask, nbr.idx, N)
    out = {}
    for key, err, fn, plain, bound in (
            ("fwd", fwd_err, fwd, plain_fwd,
             kpconv_bound(B, M, N, K, C, P, live)),
            ("bwd", max(p[0] for p in pairs), bwd, plain_bwd,
             kpconv_bwd_bound(B, M, N, K, C, P, live))):
        t_bytes, t_ops = bound
        out[key] = {
            "ms": cuda_ms(fn, 5, 1), "plain_ms": cuda_ms(plain, 2, 1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err, "shape": {"B": B, "M": M, "N": N, "K": K,
                                          "C": C, "P": P},
            "live_edges": live, "in_degree_mean": mean_deg,
            "in_degree_max": max_deg,
            "timed_at": "the stem's level-0 call of one spatial forward of "
                        f"{SPATIAL_SHAPE} ({n} points in {SPATIAL_PAD} "
                        "slots), a real neighbourhood, random features; ms "
                        "by CUDA events around back-to-back wrapper calls; "
                        "bound over the live edges"}
        if key == "bwd":
            out[key]["float64_distance_plain_float32"] = max(
                p[1] for p in pairs)
    print(f"18(a) level-0 stem call B {B} M {M} N {N} K {K} C {C} P {P}: "
          f"live edges {live}, in-degree mean {mean_deg:.1f} max {max_deg}; "
          f"forward {out['fwd']['ms']:.3f} ms (plain "
          f"{out['fwd']['plain_ms']:.3f}, bound {out['fwd']['bound_ms']:.4f}"
          f" {out['fwd']['bound_by']}), max abs {fwd_err:.3e}; backward "
          f"{out['bwd']['ms']:.3f} ms (plain {out['bwd']['plain_ms']:.3f}, "
          f"bound {out['bwd']['bound_ms']:.4f} {out['bwd']['bound_by']}), "
          f"from float64: d_feat {pairs[0][0]:.3e} (plain float32 "
          f"{pairs[0][1]:.3e}), d_kw {pairs[1][0]:.3e} (plain float32 "
          f"{pairs[1][1]:.3e})", flush=True)
    return out


def phase_spatial_serving(cfg, device, workdir, checkpoint,
                          voting_pps=None, data_root=None):
    """18(a): SPATIAL_SHAPE (SPATIAL_POINTS points, padded to SPATIAL_PAD)
    denoised by ``infer --spatial`` in this process from ``checkpoint``:
    10 forward launches and no backward one for the cloud, every offset
    finite; wall s, peak GiB, points/s beside ``voting_pps`` (phase 5's),
    then a second ``denoise_clouds_spatial`` of the cloud under the
    profiler (device ms, busy share), then both kernels at its level-0
    shape.  ``data_root``: a ``qualitative_test`` split of SPATIAL_SHAPE
    alone whose processed cloud may be cached (phase 9's), else one is
    written.  Returns the phase's numbers, the offsets, the split's root
    and the kernels' records."""
    if data_root is None:
        data_root = spatial_tree(os.path.join(workdir, "spatial_data"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    summary = infer.run(CONFIG, data_root, os.path.join(workdir,
                                                        "spatial_out"),
                        checkpoint, device=device, noise_type="gaussian",
                        noise_level=SPATIAL_LEVEL, checkpoint_low="none",
                        spatial=True)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    dataset, res = summary["dataset"], summary["results"][0]
    n = len(dataset.shapes[0].points)
    if (n, -(-n // 2048) * 2048) != (SPATIAL_POINTS, SPATIAL_PAD):
        raise AssertionError(f"18(a): {n} points")
    if launches != (10, 0, 0):
        raise AssertionError(f"18(a): launches {launches} for one cloud")
    if res["offsets"].shape != (n, 3) \
            or not np.isfinite(res["offsets"]).all():
        raise AssertionError("18(a): bad offsets")
    seconds = summary["seconds"]
    tcfg = load_config(CONFIG)
    state = infer.load_model(tcfg, device, checkpoint).state_dict()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = infer.denoise_clouds_spatial(state, tcfg, dataset, device)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    if not np.array_equal(again[0]["offsets"], res["offsets"]):
        raise AssertionError("18(a): a second spatial forward gave other "
                             "offsets")
    window = window_summary("18(a) spatial forward", prof, wall2, 1)
    out = {"points": n, "slots": SPATIAL_PAD, "seconds": seconds,
           "points_per_s": n / seconds, "peak_gib": peak,
           "forward_launches": launches[0], "profiled_wall_s": wall2,
           "voting_points_per_s_phase5": voting_pps}
    if window is not None:
        out["device_ms"], out["busy"] = window
    print(f"18(a) {SPATIAL_SHAPE}: {n} points in {SPATIAL_PAD} slots, one "
          f"spatial forward in one process: {seconds:.3f} s wall = "
          f"{n / seconds:.1f} points/s (phase 5's voting: "
          + (f"{voting_pps:.1f}" if voting_pps else "not run")
          + f" points/s), device "
          + (f"{out['device_ms']:.3f} ms (busy {out['busy']:.3f})"
             if window is not None else "not measured")
          + f", {launches[0]} forward launches, peak {peak:.3f} GiB",
          flush=True)
    kernels = spatial_level0_kernels(tcfg, device, dataset)
    gc.collect()  # the cached blocks back for the processes after it
    torch.cuda.empty_cache()
    return out, res["offsets"], data_root, kernels


def spatial_train_batch(n: int = SPATIAL_TRAIN_POINTS,
                        seed: int = SPATIAL_SEED):
    """One whole cloud of ``n`` points for 18(c): SPATIAL_SHAPE's surface
    sampled from ``seed``, gaussian noise of SPATIAL_LEVEL of its
    bounding-box diagonal, the target offsets back to the surface."""
    mesh = make_synthetic_dataset.shapes_for("qualitative_test")[
        SPATIAL_SHAPE]
    rng = np.random.default_rng(seed)
    clean, _ = sample_surface(mesh, n, rng)
    diag = np.linalg.norm(clean.max(0) - clean.min(0))
    noisy = clean + rng.normal(size=clean.shape) * SPATIAL_LEVEL * diag
    pts = noisy[None].astype(np.float32)
    return {"points": pts, "mask": np.ones((1, n), np.float32),
            "features": pts.copy(),
            "offsets": (clean - noisy)[None].astype(np.float32)}


def spatial_training(device, spatial: bool) -> dict:
    """SPATIAL_TRAIN_STEPS Adam steps of the l1.yaml Trainer (width 144,
    the spatial schedule of SPATIAL_TRAIN_POINTS slots, B=1) from its
    seed's init on :func:`spatial_train_batch`, point-sharded over the
    process group with ``spatial``: losses, launches, the end state's
    hashes."""
    cfg = infer.spatial_config(load_config(CONFIG), SPATIAL_TRAIN_POINTS)
    cfg.batch_size = 1
    tt = Trainer(cfg, 10, torch.Generator().manual_seed(int(cfg.rng_seed)),
                 device, spatial=spatial)
    batch = spatial_train_batch()
    reset_launches()
    losses = [tt.train_step(batch).item() for _ in range(SPATIAL_TRAIN_STEPS)]
    return {"losses": losses, "launches": list(launch_counts()),
            "hashes": state_hashes(tt.model.state_dict())}


def gan_dp_argv(config: str, tree: str, log_dir: str, *extra):
    """One epoch of SPATIAL_GAN_STEPS steps of ``config`` at width 144 on
    ``tree``, clouds of DEPLOY_TRAIN_POINTS points, one validation pass."""
    path = os.path.join(ROOT, "cfgs", config + ".yaml")
    return ["--config_file", path, "--data_root", tree, "--log_dir",
            log_dir, "--num_steps",
            str(SPATIAL_GAN_STEPS * int(load_config(path).batch_size)),
            "--epochs", "1", "--val_freq", "1", "--num_points_per_shape",
            str(DEPLOY_TRAIN_POINTS), *extra]


def gan_dp_runs(tree: str, log_dir: str, generator: str,
                discriminator=None, *extra) -> dict:
    """18(d): ``train_discriminator`` and then ``train_gan`` from
    ``generator`` and ``discriminator`` (default: the pre-training's own
    checkpoint); each one's steps, launches, first losses and end state's
    hashes."""
    reset_launches()
    disc = train_discriminator.main(gan_dp_argv(
        DISC_CONFIG, tree, os.path.join(log_dir, "disc"), *extra))
    d_launches = launch_counts()
    reset_launches()
    gan = train_gan.main(gan_dp_argv(
        GAN_CONFIG, tree, os.path.join(log_dir, "gan"),
        "--load_path_generator", generator, "--load_path_discriminator",
        discriminator or disc["checkpoint"], *extra))
    g_launches = launch_counts()
    return {"disc": {"steps": disc["steps"], "val_batches": disc[
        "val_batches"], "losses": disc["train_losses"],
        "launches": list(d_launches), "checkpoint": disc["checkpoint"],
        "hashes": state_hashes(disc["trainer"].discriminator.state_dict())},
        "gan": {"steps": gan["steps"], "metrics": gan["metrics"],
                "launches": list(g_launches),
                "hashes": {name: state_hashes(b.model.state_dict())
                           for name, b in gan["trainer"].blocks.items()}}}


def allgather_ms(n: int, channels: int, device, group=None,
                 iters: int = 5) -> float:
    """Host ms per ``all_gather_points`` of this rank's rows of an
    (1, n, channels) float32 level over ``group`` (the process group for
    ``None``), synchronised after ``iters`` calls."""
    x = torch.ones(1, len(range(n)[point_rows(n, group=group)]), channels,
                   device=device)
    for _ in range(2):
        all_gather_points(x, n, group)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        all_gather_points(x, n, group)
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3


def spatial_rank(spec_path: str) -> int:
    """One rank of phase 18, started by torchrun: with ``spec["infer"]``
    that command (``infer --spatial --multihost``, its launches and its
    all-gathers counted, the offsets saved), then the all-gather's time at
    the stem's level-0 rows; with ``spec["train"]`` point-sharded
    training; with ``spec["infer_op"]``, ``spec["operators"]`` and
    ``spec["chamfer"]`` 18(e)'s command likewise, 18(f)'s forwards
    (:func:`operator_forwards`, the outputs saved) and 18(g)'s training
    (:func:`chamfer_training` with its profiler window); with
    ``spec["gan"]`` :func:`gan_dp_runs` with ``--multihost``.  Writes its
    record to ``<out>/rank<r>.json``."""
    with open(spec_path) as f:
        spec = json.load(f)
    initialize_distributed(spec["device"], spec["backend"])
    try:
        r = dist_rank()
        device = local_device(spec["device"])
        torch.cuda.set_device(device)
        out = {"rank": r, "world": world_size(), "device": str(device),
               "backend": torch.distributed.get_backend()}
        if spec.get("infer"):
            reset_launches()
            all_gather_points.calls = all_gather_points.bytes = 0
            summary = infer.main(spec["infer"])
            torch.cuda.synchronize(device)
            out["infer"] = {"seconds": summary["seconds"],
                            "launches": list(launch_counts()),
                            "gathers": all_gather_points.calls,
                            "gather_bytes": all_gather_points.bytes}
            np.save(os.path.join(spec["out"], f"offsets{r}.npy"),
                    summary["results"][0]["offsets"])
            out["infer"]["gather_ms_level0_stem"] = allgather_ms(
                SPATIAL_PAD, int(load_config(CONFIG).width) // 2, device)
        if spec.get("train"):
            out["train"] = spatial_training(device, True)
        if spec.get("infer_op"):  # 18(e)
            t0 = time.perf_counter()
            reset_launches()
            all_gather_points.calls = all_gather_points.bytes = 0
            summary = infer.main(spec["infer_op"])
            torch.cuda.synchronize(device)
            out["infer_op"] = {"seconds": summary["seconds"],
                               "launches": list(launch_counts()),
                               "gathers": all_gather_points.calls,
                               "gather_bytes": all_gather_points.bytes}
            np.save(os.path.join(spec["out"], f"op_offsets{r}.npy"),
                    summary["results"][0]["offsets"])
            out["infer_op"]["gather_ms_level0_stem"] = allgather_ms(
                SPATIAL_PAD, int(load_config(config_path(
                    SPATIAL_OP_CONFIG)).width) // 2, device)
            print(f"[rank {r}] 18(e): {time.perf_counter() - t0:.3f} s",
                  flush=True)
        if spec.get("operators"):  # 18(f)
            t0 = time.perf_counter()
            ops = operator_forwards(device, True)
            for name, rec in ops.items():
                for key in ("output", "output64"):
                    np.save(os.path.join(spec["out"],
                                         f"op_{name}_{key}_{r}.npy"),
                            rec.pop(key))
            out["operators"] = ops
            print(f"[rank {r}] 18(f): {time.perf_counter() - t0:.3f} s",
                  flush=True)
        if spec.get("chamfer"):  # 18(g)
            t0 = time.perf_counter()
            out["chamfer"] = chamfer_training(device, True, window=True)
            print(f"[rank {r}] 18(g): {time.perf_counter() - t0:.3f} s",
                  flush=True)
        if spec.get("gan"):
            backend = ["--dist_backend", spec["backend"]] \
                if spec["backend"] else []
            out["gan"] = gan_dp_runs(
                spec["tree"], os.path.join(spec["out"], "log"),
                spec["generator"], spec.get("discriminator"), "--device",
                spec["device"], "--multihost", *backend)
        with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown_distributed()
    return 0


def check_gan_dp(name: str, ranks: list, one: dict) -> dict:
    """18(d)'s checks of a data-parallel run against one process: the
    ranks' end states and losses bitwise equal; the steps taken; per rank
    10 forward and 10 backward launches per pre-training step (10 forward
    per validation batch) and GAN_UPDATE_LAUNCHES per update (3
    ``kpconv_bwd_drel``); the first pre-training loss and the first
    update's err_d and err_g within PAR_FIRST_LOSS_RTOL of one process's
    (the GAN runs from one discriminator checkpoint).  Returns the run's
    numbers."""
    for r in ranks:
        d, g = r["gan"]["disc"], r["gan"]["gan"]
        for block, key in (("disc", "hashes"), ("disc", "losses"),
                           ("gan", "hashes"), ("gan", "metrics")):
            if r["gan"][block][key] != ranks[0]["gan"][block][key]:
                raise AssertionError(f"{name}: rank {r['rank']}'s {block} "
                                     f"{key} differ from rank 0's")
        steps, val = d["steps"], d["val_batches"]
        if steps != SPATIAL_GAN_STEPS or g["steps"] != SPATIAL_GAN_STEPS:
            raise AssertionError(f"{name}: {steps} and {g['steps']} steps")
        if d["launches"] != [10 * (steps + val), 10 * steps, 0]:
            raise AssertionError(f"{name}: pre-training launched "
                                 f"{d['launches']} ({val} val batches)")
        if g["launches"] != [n * SPATIAL_GAN_STEPS
                             for n in GAN_UPDATE_LAUNCHES]:
            raise AssertionError(f"{name}: the GAN launched "
                                 f"{g['launches']}")
    d, g = ranks[0]["gan"]["disc"], ranks[0]["gan"]["gan"]
    firsts = {"disc_loss": (d["losses"][0], one["disc"]["losses"][0])}
    for k in ("err_d", "err_g"):
        firsts[k] = (g["metrics"][k][0], one["gan"]["metrics"][k][0])
    for k, (got, want) in firsts.items():
        if not math.isfinite(got) \
                or abs(got - want) > PAR_FIRST_LOSS_RTOL * abs(want):
            raise AssertionError(f"{name}: first {k} {got!r} against one "
                                 f"process {want!r}")
    print(f"{name}: {len(ranks)} rank(s) bitwise equal; pre-training "
          f"{d['steps']} steps, launches per rank {d['launches']}; GAN "
          f"{g['steps']} updates, launches per rank (forward, backward, "
          f"d_rel) {g['launches']}; first losses against one process "
          + ", ".join(f"{k} {a:.6f} / {b:.6f}" for k, (a, b) in
                      firsts.items()), flush=True)
    return {"disc_launches": d["launches"], "gan_launches": g["launches"],
            "first_losses": firsts}


def phase_spatial_parallel(device, workdir, checkpoint, data_root, tree,
                           offsets_one, op_checkpoint, op_offsets_one
                           ) -> tuple:
    """18(b-d) and 18(e)-(g), after 18(a) (``offsets_one``) and 18(e)'s
    one-process run (``op_checkpoint``, ``op_offsets_one``), on
    ``data_root``: one torchrun job of PAR_WORLD gloo ranks sharing the
    card runs (b) ``infer --spatial --multihost`` of the same cloud,
    within MODEL_TOL of (a), 10 forward launches per rank, its
    all-gathers' bytes and ms; (c) point-sharded training on
    SPATIAL_TRAIN_POINTS points against :func:`spatial_training` in this
    process, the first loss within PAR_FIRST_LOSS_RTOL, the ranks bitwise
    equal, 10 forward and 10 backward launches per step per rank; (e)-(g)
    (:func:`check_spatial_operators`); (d) :func:`gan_dp_runs` on
    ``tree`` (phase 8's) with ``checkpoint`` as the generator; then (d) on
    one NCCL rank, and (d) in this process, both from the gloo job's
    discriminator checkpoint: :func:`check_gan_dp`.  Returns the phase's
    numbers and its launches by path."""
    gc.collect()
    torch.cuda.empty_cache()
    gloo = run_torchrun(PAR_WORLD, {
        "device": f"{PAR_DEVICE}:0", "backend": "gloo",
        "out": os.path.join(workdir, "spatial_gloo"),
        "infer": spatial_infer_argv(
            data_root, os.path.join(workdir, "spatial_out_gloo"), checkpoint,
            "--multihost", "--dist_backend", "gloo", "--device",
            f"{PAR_DEVICE}:0"),
        "infer_op": spatial_infer_argv(
            data_root, os.path.join(workdir, "spatial_op_out_gloo"),
            op_checkpoint, "--multihost", "--dist_backend", "gloo",
            "--device", f"{PAR_DEVICE}:0",
            config=config_path(SPATIAL_OP_CONFIG)),
        "operators": True, "chamfer": True,
        "train": True, "gan": True, "tree": tree, "generator": checkpoint},
        "18(b-d), 18(e)-(g) gloo", "--spatial-rank")
    two = np.load(os.path.join(workdir, "spatial_gloo", "offsets0.npy"))
    other = np.load(os.path.join(workdir, "spatial_gloo", "offsets1.npy"))
    if not np.array_equal(two, other):
        raise AssertionError("18(b): the ranks' offsets differ")
    err, _ = check_close(torch.from_numpy(two), torch.from_numpy(offsets_one),
                         what="18(b) 2 ranks against one process",
                         **MODEL_TOL)
    for r in gloo:
        if r["infer"]["launches"] != [10, 0, 0]:
            raise AssertionError(f"18(b): rank {r['rank']} launched "
                                 f"{r['infer']['launches']}")
    inf = gloo[0]["infer"]
    print(f"18(b) {PAR_WORLD} gloo ranks on one card: {SPATIAL_POINTS} "
          f"points in {inf['seconds']:.3f} s wall = "
          f"{SPATIAL_POINTS / inf['seconds']:.1f} points/s; offsets within "
          f"{err:.3e} of one process's (max abs); per rank "
          f"{inf['gathers']} all-gathers, {inf['gather_bytes']:,} bytes; "
          f"one all-gather of the stem's level-0 rows "
          f"{inf['gather_ms_level0_stem']:.3f} ms", flush=True)
    one_train = spatial_training(device, False)
    for r in gloo:
        t = r["train"]
        if t["hashes"] != gloo[0]["train"]["hashes"] \
                or t["losses"] != gloo[0]["train"]["losses"]:
            raise AssertionError(f"18(c): rank {r['rank']} ended apart")
        if t["launches"] != [10 * SPATIAL_TRAIN_STEPS,
                             10 * SPATIAL_TRAIN_STEPS, 0]:
            raise AssertionError(f"18(c): rank {r['rank']} launched "
                                 f"{t['launches']}")
    first, want = gloo[0]["train"]["losses"][0], one_train["losses"][0]
    losses = gloo[0]["train"]["losses"] + one_train["losses"]
    if not np.isfinite(losses).all() \
            or abs(first - want) > PAR_FIRST_LOSS_RTOL * abs(want):
        raise AssertionError(f"18(c): first loss {first!r} against one "
                             f"process {want!r}")
    print(f"18(c) point-sharded training, {SPATIAL_TRAIN_POINTS} points, "
          f"B=1, {SPATIAL_TRAIN_STEPS} Adam steps: {PAR_WORLD} ranks "
          f"bitwise equal, losses {gloo[0]['train']['losses']} against one "
          f"process {one_train['losses']}; launches per rank "
          f"{gloo[0]['train']['launches']}", flush=True)
    operators = check_spatial_operators(gloo, device, workdir, op_offsets_one)
    disc_ckpt = gloo[0]["gan"]["disc"]["checkpoint"]
    nccl = run_torchrun(1, {
        "device": PAR_DEVICE, "backend": None,
        "out": os.path.join(workdir, "spatial_nccl"), "gan": True,
        "tree": tree, "generator": checkpoint, "discriminator": disc_ckpt},
        "18(d) nccl", "--spatial-rank")
    if nccl[0]["backend"] != "nccl":
        raise AssertionError(f"18(d) ran over {nccl[0]['backend']}")
    one_gan = gan_dp_runs(tree, os.path.join(workdir, "gan_one"), checkpoint,
                          disc_ckpt, "--device", PAR_DEVICE)
    out = {"serving_2_ranks": {
        "seconds": inf["seconds"],
        "points_per_s": SPATIAL_POINTS / inf["seconds"],
        "max_abs_from_one_process": err, "gathers": inf["gathers"],
        "gather_bytes": inf["gather_bytes"],
        "gather_ms_level0_stem": inf["gather_ms_level0_stem"]},
        "training": {"losses": gloo[0]["train"]["losses"],
                     "one_process_losses": one_train["losses"]},
        "operators": operators,
        "gan_gloo": check_gan_dp("18(d) gloo", gloo, one_gan),
        "gan_nccl": check_gan_dp("18(d) nccl", nccl, one_gan)}
    launches = {
        "spatial_serving_gloo_rank0": gloo[0]["infer"]["launches"],
        "spatial_training_gloo_rank0": gloo[0]["train"]["launches"],
        "spatial_pospool_serving_gloo_rank0": gloo[0]["infer_op"]["launches"],
        **{f"spatial_{name}_forward_gloo_rank0":
           gloo[0]["operators"][name]["launches"]
           for name in SPATIAL_OPERATORS},
        "spatial_chamfer_training_gloo_rank0": gloo[0]["chamfer"]["launches"],
        "disc_dp_gloo_rank0": gloo[0]["gan"]["disc"]["launches"],
        "gan_dp_gloo_rank0": gloo[0]["gan"]["gan"]["launches"],
        "disc_dp_nccl_rank0": nccl[0]["gan"]["disc"]["launches"],
        "gan_dp_nccl_rank0": nccl[0]["gan"]["gan"]["launches"]}
    return out, launches


def config_path(name: str) -> str:
    return os.path.join(ROOT, "cfgs", name + ".yaml")


def seeded_operator_model(cfg, spatial: bool = False,
                          seed: int = SPATIAL_SEED):
    """The offset model of ``cfg`` (``parallel.spatial``'s with
    ``spatial``, whose parameters are the plain model's) from generator
    seed ``seed``, its attention gates (zero at init, which would make
    each gated operator the identity) and its head's final Dense (1e-4 at
    init, under MODEL_TOL's atol) drawn O(1) from numpy seed ``seed``: the
    same weights in every process."""
    g = torch.Generator().manual_seed(seed)
    model = build_spatial_model(cfg, generator=g) if spatial \
        else build_offset_regression(cfg, g)
    grad_check.draw_gates_and_head(model, np.random.default_rng(seed))
    return model


def operator_config(name: str):
    """18(f)'s ``cfgs/<name>.yaml``: the spatial schedule of
    SPATIAL_TRAIN_POINTS slots (CAA's point-axis layers built for them),
    depth SPATIAL_OP_DEPTH."""
    cfg = infer.spatial_config(load_config(config_path(name)),
                               SPATIAL_TRAIN_POINTS)
    cfg.depth = SPATIAL_OP_DEPTH
    return cfg


def phase_spatial_operator_serving(device, workdir, data_root,
                                   pseudogrid: dict):
    """18(e) in this process, on an idle card: SPATIAL_SHAPE (the split
    ``data_root`` of 18(a)) denoised by ``infer --spatial`` of
    SPATIAL_OP_CONFIG (PosPool, width 144, depth 2) from
    :func:`seeded_operator_model`'s weights, written to a checkpoint that
    18(e)'s ranks load too: every offset finite, no KPConv launch (PosPool
    reaches no kernel); wall s, peak GiB, then a second forward under the
    profiler (device ms, busy share), beside 18(a)'s PseudoGrid figures
    (``pseudogrid``).  Returns the phase's numbers, the offsets and the
    checkpoint."""
    path = config_path(SPATIAL_OP_CONFIG)
    cfg = load_config(path)
    ckpt = os.path.join(workdir, SPATIAL_OP_CONFIG + "_seeded.pt")
    torch.save(seeded_operator_model(cfg).state_dict(), ckpt)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    all_gather_points.calls = all_gather_points.bytes = 0
    summary = infer.run(path, data_root, os.path.join(workdir,
                                                      "spatial_op_out"),
                        ckpt, device=device, noise_type="gaussian",
                        noise_level=SPATIAL_LEVEL, checkpoint_low="none",
                        spatial=True)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    dataset, res = summary["dataset"], summary["results"][0]
    n = len(dataset.shapes[0].points)
    if (n, -(-n // 2048) * 2048) != (SPATIAL_POINTS, SPATIAL_PAD):
        raise AssertionError(f"18(e): {n} points")
    if launches != (0, 0, 0):
        raise AssertionError(f"18(e): PosPool launched {launches}")
    if res["offsets"].shape != (n, 3) \
            or not np.isfinite(res["offsets"]).all():
        raise AssertionError("18(e): bad offsets")
    seconds = summary["seconds"]
    state = load_model_state(ckpt)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = infer.denoise_clouds_spatial(state, cfg, dataset, device)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    if not np.array_equal(again[0]["offsets"], res["offsets"]):
        raise AssertionError("18(e): a second spatial forward gave other "
                             "offsets")
    window = window_summary("18(e) PosPool spatial forward", prof, wall2, 1)
    out = {"config": SPATIAL_OP_CONFIG, "points": n, "slots": SPATIAL_PAD,
           "seconds": seconds, "points_per_s": n / seconds,
           "peak_gib": peak, "forward_launches": launches[0],
           "profiled_wall_s": wall2,
           "offsets_max_abs": float(np.abs(res["offsets"]).max())}
    if window is not None:
        out["device_ms"], out["busy"] = window
    pg = pseudogrid
    print(f"18(e) {SPATIAL_OP_CONFIG} {SPATIAL_SHAPE}: {n} points in "
          f"{SPATIAL_PAD} slots, one spatial forward in one process: "
          f"{seconds:.3f} s wall = {n / seconds:.1f} points/s, device "
          + (f"{out['device_ms']:.3f} ms (busy {out['busy']:.3f})"
             if window is not None else "not measured")
          + f", {launches[0]} KPConv launches, peak {peak:.3f} GiB; 18(a) "
          f"PseudoGrid: {pg['seconds']:.3f} s, device "
          + (f"{pg['device_ms']:.3f} ms" if "device_ms" in pg
             else "not measured") + f", peak {pg['peak_gib']:.3f} GiB",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out, res["offsets"], ckpt


def operator_forwards(device, spatial: bool) -> dict:
    """18(f): each of SPATIAL_OPERATORS' eval forward of
    :func:`spatial_train_batch` from :func:`seeded_operator_model`'s
    weights, point-sharded over the process group with ``spatial`` (the
    output gathered whole), else in one process: {name: output, the same
    forward in float64 (``output64``, positions float32, the head's output
    rounded to float32), launches, seconds, the collectives' counts and
    bytes, device ms in one process}."""
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in spatial_train_batch().items()}
    out = {}
    for name in SPATIAL_OPERATORS:
        model = seeded_operator_model(operator_config(name), spatial)
        model = model.to(device).eval()

        def fwd():
            with torch.no_grad():
                return model(batch["points"], batch["mask"],
                             batch["features"])

        reset_launches()
        all_gather_points.calls = all_gather_points.bytes = 0
        reduce_scatter_points.calls = reduce_scatter_points.bytes = 0
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        y = fwd()
        torch.cuda.synchronize(device)
        rec = {"seconds": time.perf_counter() - t0,
               "launches": list(launch_counts()),
               "gathers": all_gather_points.calls,
               "gather_bytes": all_gather_points.bytes,
               "reduce_scatters": reduce_scatter_points.calls,
               "reduce_scatter_bytes": reduce_scatter_points.bytes}
        if not spatial:
            rec["device_ms"] = cuda_ms(fwd, 2, 1)
        model = grad_check.float64_copy(model)
        with torch.no_grad():
            y64 = model(batch["points"], batch["mask"],
                        batch["features"].double())
        for key, v in (("output", y), ("output64", y64)):
            if spatial:
                v = gather_points(v, SPATIAL_TRAIN_POINTS)
            rec[key] = v.cpu().numpy()
        out[name] = rec
        del model, y, y64
        gc.collect()
        torch.cuda.empty_cache()
    return out


def chamfer_training(device, spatial: bool, window: bool = False) -> dict:
    """18(g): SPATIAL_TRAIN_STEPS Adam steps of SPATIAL_CHAMFER_CONFIG's
    Trainer (the spatial schedule of SPATIAL_TRAIN_POINTS slots, B=1) from
    its seed's init on :func:`spatial_train_batch`, point-sharded over the
    process group with ``spatial``: losses, launches, all-gathers, the end
    state's hashes; with ``window``, then a profiler window of steps."""
    cfg = infer.spatial_config(load_config(config_path(
        SPATIAL_CHAMFER_CONFIG)), SPATIAL_TRAIN_POINTS)
    cfg.batch_size = 1
    if cfg.loss != "chamfer":
        raise AssertionError(f"18(g): {SPATIAL_CHAMFER_CONFIG} trains "
                             f"{cfg.loss}")
    tt = Trainer(cfg, 10, torch.Generator().manual_seed(int(cfg.rng_seed)),
                 device, spatial=spatial)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in spatial_train_batch().items()}
    reset_launches()
    all_gather_points.calls = all_gather_points.bytes = 0
    losses = [tt.train_step(batch).item() for _ in range(SPATIAL_TRAIN_STEPS)]
    out = {"losses": losses, "launches": list(launch_counts()),
           "gathers": all_gather_points.calls,
           "gather_bytes": all_gather_points.bytes,
           "hashes": state_hashes(tt.model.state_dict())}
    if window:
        out["window"] = profile_window(
            f"18(g) rank {dist_rank()} Chamfer step",
            lambda: tt.train_step(batch), 2, timed=2)
    return out


def check_spatial_operators(ranks: list, device, workdir,
                            offsets_one) -> dict:
    """18(e)-(g)'s checks of the ranks' records against this process: (e)
    the PosPool offsets of ``infer --spatial --multihost`` within
    MODEL_TOL of 18(e)'s ``offsets_one``, the ranks' equal, no launch;
    (f) each operator's float64 forward within MODEL_TOL of
    :func:`operator_forwards`' in this process and its float32 forward
    element by element within the larger of MODEL_TOL and three times the
    one-process float32 noise (``grad_check.check_forward``; every
    operator is checked and printed before the misses fail), but
    SPATIAL_FLOAT32_BY_TENSOR's by the whole tensor
    (``grad_check.check_forward_tensor``), no launch;
    (g) the ranks' states and losses bitwise
    equal, the first loss within PAR_FIRST_LOSS_RTOL of
    :func:`chamfer_training` in this process, 10 forward and 10 backward
    launches a step on each rank.  Returns the numbers."""
    out = {}
    t0 = time.perf_counter()
    two = [np.load(os.path.join(workdir, "spatial_gloo",
                                f"op_offsets{r['rank']}.npy"))
           for r in ranks]
    if not all(np.array_equal(two[0], o) for o in two):
        raise AssertionError("18(e): the ranks' offsets differ")
    err, _ = check_close(torch.from_numpy(two[0]),
                         torch.from_numpy(offsets_one),
                         what="18(e) 2 ranks against one process",
                         **MODEL_TOL)
    for r in ranks:
        if r["infer_op"]["launches"] != [0, 0, 0]:
            raise AssertionError(f"18(e): rank {r['rank']} launched "
                                 f"{r['infer_op']['launches']}")
    inf = ranks[0]["infer_op"]
    out["pospool_serving_2_ranks"] = {
        "seconds": inf["seconds"], "max_abs_from_one_process": err,
        "offsets_max_abs": float(np.abs(offsets_one).max()),
        "per_rank": [{k: r["infer_op"][k] for k in (
            "seconds", "gathers", "gather_bytes", "gather_ms_level0_stem")}
            for r in ranks]}
    print(f"18(e) {SPATIAL_OP_CONFIG} on {PAR_WORLD} gloo ranks on one "
          f"card: {SPATIAL_POINTS} points in {inf['seconds']:.3f} s wall; "
          f"offsets within {err:.3e} of one process's (max abs; the "
          f"offsets reach {np.abs(offsets_one).max():.3f}); per rank "
          + "; ".join(f"rank {r['rank']}: {r['infer_op']['gathers']} "
                      f"all-gathers, {r['infer_op']['gather_bytes']:,} bytes,"
                      f" one of the stem's level-0 rows "
                      f"{r['infer_op']['gather_ms_level0_stem']:.3f} ms"
                      for r in ranks), flush=True)
    one = operator_forwards(device, False)
    ops, misses = {}, []
    for name in SPATIAL_OPERATORS:
        for r in ranks:
            if r["operators"][name]["launches"] != [0, 0, 0]:
                raise AssertionError(f"18(f) {name}: rank {r['rank']} "
                                     f"launched "
                                     f"{r['operators'][name]['launches']}")
        got = {key: [torch.from_numpy(np.load(os.path.join(
            workdir, "spatial_gloo", f"op_{name}_{key}_{r['rank']}.npy")))
            for r in ranks] for key in ("output", "output64")}
        if not all(torch.equal(v[0], g) for v in got.values() for g in v):
            raise AssertionError(f"18(f) {name}: the ranks' outputs differ")
        want = one[name]
        want32, want64 = (torch.from_numpy(want[k])
                          for k in ("output", "output64"))
        # element by element: float64 within MODEL_TOL; float32 within the
        # larger of MODEL_TOL and three times the one-process forward's own
        # float32 noise at the element, as the ranks' (m, N) @ (N, C)
        # products sum over the keys in another order than one process's
        # (N, N) @ (N, C)
        e, _ = check_close(got["output64"][0], want64,
                           what=f"18(f) {name} on {PAR_WORLD} ranks against "
                           "one process, float64", **MODEL_TOL)
        try:
            if name in SPATIAL_FLOAT32_BY_TENSOR:
                f32 = grad_check.check_forward_tensor(got["output"][0],
                                                      want32, want64)
                f32_text = ("float32 by the whole tensor: max-abs "
                            f"{f32['max_abs'][0]:.3e} (limit "
                            f"{f32['max_abs'][1]:.3e}), L2 "
                            f"{f32['l2'][0]:.3e} (limit {f32['l2'][1]:.3e})")
            else:
                f32 = grad_check.check_forward(got["output"][0], want32,
                                               want64, **MODEL_TOL)
                f32_text = (f"float32 worst element {f32['index']}: "
                            f"{f32['diff']:.3e} (limit {f32['limit']:.3e})")
        except AssertionError as exc:
            f32 = f32_text = f"float32 MISSED: {exc}"
            misses.append(f"{name}: {exc}")
        rk = ranks[0]["operators"][name]
        ops[name] = {"max_abs_from_one_process_float64": e,
                     "float32": f32,
                     "output_max_abs": float(np.abs(want["output"]).max()),
                     "one_process_device_ms": want["device_ms"],
                     "one_process_wall_s": want["seconds"],
                     "rank_wall_s": rk["seconds"],
                     "gathers_per_rank": rk["gathers"],
                     "gather_bytes_per_rank": rk["gather_bytes"],
                     "reduce_scatter_bytes_per_rank":
                         rk["reduce_scatter_bytes"]}
        print(f"18(f) {name} (depth {SPATIAL_OP_DEPTH}, "
              f"{SPATIAL_TRAIN_POINTS} points): {PAR_WORLD} ranks within "
              f"{e:.3e} of one process in float64 (output max "
              f"{ops[name]['output_max_abs']:.3f}), {f32_text}; "
              "one process "
              f"{want['device_ms']:.3f} device ms a forward; a rank's "
              f"forward {rk['seconds']:.3f} s wall, {rk['gathers']} "
              f"all-gathers, {rk['gather_bytes']:,} bytes, "
              f"{rk['reduce_scatter_bytes']:,} bytes reduce-scattered",
              flush=True)
    if misses:
        raise AssertionError("18(f): float32 2-rank forwards off one "
                             "process's: " + "; ".join(misses))
    out["operators"] = ops
    one_train = chamfer_training(device, False)
    steps = SPATIAL_TRAIN_STEPS
    for r in ranks:
        t = r["chamfer"]
        if t["hashes"] != ranks[0]["chamfer"]["hashes"] \
                or t["losses"] != ranks[0]["chamfer"]["losses"]:
            raise AssertionError(f"18(g): rank {r['rank']} ended apart")
        if t["launches"] != [10 * steps, 10 * steps, 0]:
            raise AssertionError(f"18(g): rank {r['rank']} launched "
                                 f"{t['launches']}")
    if one_train["launches"] != [10 * steps, 10 * steps, 0]:
        raise AssertionError(f"18(g): one process launched "
                             f"{one_train['launches']}")
    first, want = ranks[0]["chamfer"]["losses"][0], one_train["losses"][0]
    losses = ranks[0]["chamfer"]["losses"] + one_train["losses"]
    if not np.isfinite(losses).all() \
            or abs(first - want) > PAR_FIRST_LOSS_RTOL * abs(want):
        raise AssertionError(f"18(g): first loss {first!r} against one "
                             f"process {want!r}")
    out["chamfer_training"] = {
        "losses": ranks[0]["chamfer"]["losses"],
        "one_process_losses": one_train["losses"],
        "per_rank": [{"rank": r["rank"], "window": r["chamfer"]["window"],
                      "gathers_per_step": r["chamfer"]["gathers"] // steps,
                      "gather_bytes_per_step":
                          r["chamfer"]["gather_bytes"] // steps}
                     for r in ranks]}
    print(f"18(g) point-sharded {SPATIAL_CHAMFER_CONFIG} training (loss "
          f"chamfer), {SPATIAL_TRAIN_POINTS} points, B=1, {steps} Adam "
          f"steps: {PAR_WORLD} ranks bitwise equal, losses "
          f"{ranks[0]['chamfer']['losses']} against one process "
          f"{one_train['losses']}; launches per rank "
          f"{ranks[0]['chamfer']['launches']}; per rank "
          + "; ".join(
              f"rank {r['rank']}: step wall "
              f"{r['chamfer']['window']['wall_ms']:.3f} ms, device "
              + (f"{r['chamfer']['window']['device_ms']:.3f} ms, busy "
                 f"{r['chamfer']['window']['busy']:.3f}"
                 if "device_ms" in r["chamfer"]["window"]
                 else "not measured")
              + f", {r['chamfer']['gathers'] // steps} all-gathers a step"
              for r in ranks), flush=True)
    print(f"18(e)-(g) checks in this process: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return out


def mesh2d_batch() -> dict:
    """19(a)'s global batch: MESH2D_BATCH whole clouds of
    SPATIAL_TRAIN_POINTS points (:func:`spatial_train_batch` from
    consecutive seeds)."""
    clouds = [spatial_train_batch(seed=SPATIAL_SEED + i)
              for i in range(MESH2D_BATCH)]
    return {k: np.concatenate([c[k] for c in clouds]) for k in clouds[0]}


def mesh2d_config():
    """l1.yaml at width 144 for a whole cloud of SPATIAL_TRAIN_POINTS
    slots, batch MESH2D_BATCH."""
    cfg = infer.spatial_config(load_config(CONFIG), SPATIAL_TRAIN_POINTS)
    cfg.batch_size = MESH2D_BATCH
    return cfg


def mesh2d_training(device, checkpoint: str, mesh=None) -> dict:
    """MESH2D_STEPS Adam steps of the l1.yaml Trainer from ``checkpoint``'s
    weights on :func:`mesh2d_batch`: with ``mesh`` ``Trainer(spatial="2d")``
    on this rank's data rows, else one process on the whole batch; the
    losses, launches, all-gathers and the end state's hashes, and the
    trainer with its batch."""
    cfg = mesh2d_config()
    tt = Trainer(cfg, 10, torch.Generator().manual_seed(int(cfg.rng_seed)),
                 device, spatial="2d" if mesh else False, mesh=mesh)
    tt.model.load_state_dict(load_model_state(checkpoint))
    batch = mesh2d_batch()
    if mesh:
        batch = {k: v[mesh.batch_rows(MESH2D_BATCH)] for k, v in
                 batch.items()}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    reset_launches()
    all_gather_points.calls = all_gather_points.bytes = 0
    losses = [tt.train_step(batch).item() for _ in range(MESH2D_STEPS)]
    return {"losses": losses, "launches": list(launch_counts()),
            "gathers": all_gather_points.calls,
            "gather_bytes": all_gather_points.bytes,
            "hashes": state_hashes(tt.model.state_dict()),
            "lr0": tt.lr_schedule(0)}, tt, batch


def mesh2d_rank(spec_path: str) -> int:
    """One rank of 19(a), started by torchrun: the 2-D layout
    (``make_mesh_2d``), the eval forward of :func:`mesh2d_batch` from
    ``spec["checkpoint"]`` (this rank's data rows gathered over its points
    group, saved; its launches and all-gathers), :func:`mesh2d_training`
    with the layout, then a profiler window of 2-D steps and the
    all-gather's time at the stem's level-0 rows within the points group.
    Writes its record to ``<out>/rank<r>.json``."""
    with open(spec_path) as f:
        spec = json.load(f)
    initialize_distributed(spec["device"], "gloo")
    try:
        r = dist_rank()
        mesh = make_mesh_2d(MESH2D_DATA, MESH2D_POINTS)
        device = local_device(spec["device"])
        torch.cuda.set_device(device)
        out = {"rank": r, "world": world_size(),
               "place": [mesh.data_index, mesh.points_index],
               "backend": torch.distributed.get_backend()}
        model, forward = build_spatial_forward(mesh2d_config(),
                                               device=device, mesh=mesh)
        model.load_state_dict(load_model_state(spec["checkpoint"]))
        whole = mesh2d_batch()
        reset_launches()
        all_gather_points.calls = all_gather_points.bytes = 0
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        rows = forward(whole["points"], whole["mask"], whole["features"])
        torch.cuda.synchronize(device)
        out["forward"] = {"seconds": time.perf_counter() - t0,
                          "launches": list(launch_counts()),
                          "gathers": all_gather_points.calls,
                          "gather_bytes": all_gather_points.bytes}
        np.save(os.path.join(spec["out"], f"forward{r}.npy"), gather_points(
            rows, SPATIAL_TRAIN_POINTS, mesh.points_group).cpu().numpy())
        del model, forward, rows
        out["train"], trainer, batch = mesh2d_training(
            device, spec["checkpoint"], mesh)
        out["window"] = profile_window(
            f"rank {r} 2-D step", lambda: trainer.train_step(batch), 2,
            timed=2)
        out["gather_ms_level0_stem"] = allgather_ms(
            SPATIAL_TRAIN_POINTS, int(load_config(CONFIG).width) // 2,
            device, mesh.points_group)
        with open(os.path.join(spec["out"], f"rank{r}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown_distributed()
    return 0


def phase_mesh2d(device, workdir, checkpoint) -> tuple:
    """19(a): one torchrun job of MESH2D_DATA x MESH2D_POINTS gloo ranks
    sharing the card (each ``chip_smoke.py --mesh2d-rank``), from
    ``checkpoint`` (phase 8's): the 2-D forward of :func:`mesh2d_batch`
    within MODEL_TOL of one process's, 10 forward launches per rank;
    MESH2D_STEPS Adam steps of ``Trainer(spatial="2d")``, the ranks
    bitwise equal, the first loss within PAR_FIRST_LOSS_RTOL of one
    process's on the whole batch, 10 forward and 10 backward launches per
    step per rank.  Returns the phase's numbers and its launches by
    path."""
    gc.collect()
    torch.cuda.empty_cache()
    ranks = run_torchrun(MESH2D_DATA * MESH2D_POINTS, {
        "device": f"{PAR_DEVICE}:0", "backend": "gloo",
        "out": os.path.join(workdir, "mesh2d"), "checkpoint": checkpoint},
        "19(a) 2-D layout", "--mesh2d-rank")
    plain = build_offset_regression(mesh2d_config()).to(device).eval()
    plain.load_state_dict(load_model_state(checkpoint))
    whole = {k: torch.from_numpy(v).to(device)
             for k, v in mesh2d_batch().items()}
    with torch.no_grad():
        want = plain(whole["points"], whole["mask"], whole["features"])
    del plain
    err = 0.0
    for r in ranks:
        d, p = r["place"]
        if (d, p) != divmod(r["rank"], MESH2D_POINTS):
            raise AssertionError(f"19(a): rank {r['rank']} at {(d, p)}")
        got = torch.from_numpy(np.load(os.path.join(
            workdir, "mesh2d", f"forward{r['rank']}.npy")))
        rows = process_slice(MESH2D_BATCH, d, MESH2D_DATA)
        e, _ = check_close(got, want[rows].cpu(),
                           what=f"19(a) rank {r['rank']}'s 2-D forward "
                           "against one process", **MODEL_TOL)
        err = max(err, e)
        if r["forward"]["launches"] != [10, 0, 0]:
            raise AssertionError(f"19(a): rank {r['rank']}'s forward "
                                 f"launched {r['forward']['launches']}")
        t = r["train"]
        if t["hashes"] != ranks[0]["train"]["hashes"] \
                or t["losses"] != ranks[0]["train"]["losses"]:
            raise AssertionError(f"19(a): rank {r['rank']} ended apart")
        if t["launches"] != [10 * MESH2D_STEPS, 10 * MESH2D_STEPS, 0]:
            raise AssertionError(f"19(a): rank {r['rank']}'s steps "
                                 f"launched {t['launches']}")
    one, _, _ = mesh2d_training(device, checkpoint)
    t = ranks[0]["train"]
    if t["lr0"] != one["lr0"]:  # Adam: the world does not scale the LR
        raise AssertionError(f"19(a): LR {t['lr0']} against {one['lr0']}")
    first, want_first = t["losses"][0], one["losses"][0]
    if not np.isfinite(t["losses"] + one["losses"]).all() \
            or abs(first - want_first) > PAR_FIRST_LOSS_RTOL * abs(
                want_first):
        raise AssertionError(f"19(a): first loss {first!r} against one "
                             f"process {want_first!r}")
    per_rank = [{"rank": r["rank"], "place": r["place"],
                 "forward_s": r["forward"]["seconds"],
                 "step_wall_ms": r["window"]["wall_ms"],
                 "step_device_ms": r["window"].get("device_ms"),
                 "busy": r["window"].get("busy"),
                 "gathers_per_step": r["train"]["gathers"] // MESH2D_STEPS,
                 "gather_bytes_per_step":
                     r["train"]["gather_bytes"] // MESH2D_STEPS,
                 "forward_gathers": r["forward"]["gathers"],
                 "forward_gather_bytes": r["forward"]["gather_bytes"],
                 "gather_ms_level0_stem": r["gather_ms_level0_stem"],
                 "launches_forward": r["forward"]["launches"],
                 "launches_training": r["train"]["launches"]}
                for r in ranks]
    print(f"19(a) {MESH2D_DATA} x {MESH2D_POINTS} gloo ranks on one card, "
          f"B={MESH2D_BATCH} clouds of {SPATIAL_TRAIN_POINTS} points: 2-D "
          f"forward within {err:.3e} of one process's (max abs); "
          f"{MESH2D_STEPS} Adam steps, ranks bitwise equal, losses "
          f"{t['losses']} against one process {one['losses']}; per rank "
          + json.dumps(per_rank), flush=True)
    out = {"forward_max_abs_from_one_process": err, "losses": t["losses"],
           "one_process_losses": one["losses"], "ranks": per_rank}
    launches = {"mesh2d_forward_rank0": ranks[0]["forward"]["launches"],
                "mesh2d_training_rank0": ranks[0]["train"]["launches"]}
    return out, launches


def sweep_child(argv) -> int:
    """A process of 19(b)'s sweep in place of ``python -m MODULE ARGS``:
    ``MODULE.main(ARGS)`` in this process with the KPConv launches counted
    around it, its record appended to the JSON lines file ``argv[0]``."""
    log, module, args = argv[0], argv[1], argv[2:]
    reset_launches()
    summary = importlib.import_module(module).main(args)
    torch.cuda.synchronize()
    rec = {"module": module.rsplit(".", 1)[-1],
           "config": os.path.splitext(os.path.basename(
               args[args.index("--config_file") + 1]))[0],
           "launches": list(launch_counts())}
    for key in ("steps", "val_batches", "batches", "seconds"):
        if key in summary:
            rec[key] = summary[key]
    with open(log, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return 0


def phase_sweep(workdir) -> tuple:
    """19(b): ``run_custom_sweep`` on SWEEP_CONFIGS at their own width 144
    and 15,000-point patches, one epoch of SWEEP_STEPS steps of batch 8 on
    SWEEP_SCAN_POINTS-point scans written first (the test scans cut at
    SEG_CORNER), each of its processes
    ``chip_smoke.py --sweep-child`` (:func:`sweep_child`): every config
    scored with all seven metrics finite; the PseudoGrid config launched
    10 forward and 10 backward kernels a train step, 10 forward a
    validation and an evaluation batch, the PosPool config none.  Returns
    the seconds per config, the table and the launches by path."""
    out_dir = os.path.join(workdir, "sweep")
    make_scans(os.path.join(out_dir, "scans"), n=SWEEP_SCAN_POINTS,
               cut=SWEEP_HELD_OUT, corner=SEG_CORNER)
    log = os.path.join(workdir, "sweep_children.jsonl")

    def run(argv):
        return subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--sweep-child", log,
             *argv], capture_output=True, text=True, cwd=ROOT,
            timeout=run_custom_sweep.RUN_TIMEOUT_S)

    kept = run_custom_sweep._run
    run_custom_sweep._run = run
    try:
        res = run_custom_sweep.main([
            "--out_dir", out_dir, "--configs",
            *(os.path.join(ROOT, "cfgs", "custom_cfgs", c + ".yaml")
              for c, _ in SWEEP_CONFIGS),
            "--epochs", "1", "--num_steps", str(SWEEP_STEPS * 8),
            "--width", "144", "--num_points", "15000", "--batch_size", "8",
            "--device", "cuda"])
    finally:
        run_custom_sweep._run = kept
    with open(log) as f:
        children = [json.loads(line) for line in f]
    launches, rows = {}, dict(res["rows"])
    for config, kpconv in SWEEP_CONFIGS:
        met = rows[config]
        if met is None or not all(math.isfinite(met[k])
                                  for k in run_custom_sweep.METRIC_KEYS):
            raise AssertionError(f"19(b): {config} scored {met}")
        train, ev = (next(c for c in children if c["config"] == config
                          and c["module"] == m)
                     for m in ("train_outlier_seg", "evaluate_outlier_seg"))
        if train["steps"] != SWEEP_STEPS:
            raise AssertionError(f"19(b): {config} took {train['steps']} "
                                 "steps")
        want_train = [10 * (SWEEP_STEPS + train["val_batches"]),
                      10 * SWEEP_STEPS, 0] if kpconv else [0, 0, 0]
        want_eval = [10 * ev["batches"], 0, 0] if kpconv else [0, 0, 0]
        if train["launches"] != want_train or ev["launches"] != want_eval:
            raise AssertionError(
                f"19(b): {config} launched {train['launches']} training "
                f"and {ev['launches']} evaluating, not {want_train} and "
                f"{want_eval}")
        launches[f"sweep_{config}_training"] = train["launches"]
        launches[f"sweep_{config}_eval"] = ev["launches"]
    with open(res["table"]) as f:
        table = f.read()
    print(f"19(b) run_custom_sweep, {len(SWEEP_CONFIGS)} configs at width "
          f"144, 15,000-point patches, 1 epoch of {SWEEP_STEPS} steps on "
          f"14 scans of {SWEEP_SCAN_POINTS} points: seconds per config "
          f"{json.dumps(res['seconds'])}; processes {json.dumps(children)}"
          f"\n{table}", end="", flush=True)
    return {"seconds": res["seconds"], "table": table,
            "children": children}, launches


def heads_config(kind: str):
    """l1.yaml (width 144, depth 2, B=16, N=500) with the classifier's
    HEADS_CLASSES classes or the part segmentation's SHAPENET_PARTS."""
    cfg = load_config(CONFIG)
    cfg.num_classes = HEADS_CLASSES if kind == "classification" \
        else len(SHAPENET_PARTS)
    cfg.num_parts = list(SHAPENET_PARTS)
    return cfg


def heads_targets(kind: str, rng, B: int, N: int):
    """The loss's targets: class labels, or (part labels, shape labels)
    with every cloud's part labels inside its class's part count."""
    if kind == "classification":
        return (torch.from_numpy(rng.integers(0, HEADS_CLASSES, B)),)
    shapes = rng.integers(0, len(SHAPENET_PARTS), B)
    parts = np.stack([rng.integers(0, SHAPENET_PARTS[s], N)
                      for s in shapes])
    return torch.from_numpy(parts), torch.from_numpy(shapes)


def phase_heads(device) -> tuple:
    """19(c): ``ClassificationModel`` (HEADS_CLASSES classes) and
    ``MultiPartSegmentationModel`` (SHAPENET_PARTS) at width 144, depth 2,
    B=16, N=500 on one pyramid built on the card: the eval forward (10
    forward launches) by ``grad_check.check_forward_tensor`` (the whole
    output's max-abs and L2 distances within three times the CPU float32
    output's own from float64: one element's float32 noise does not bound
    another sample's there) against the CPU's plain computation of the
    same weights, every parameter's train-mode gradient under the
    model's loss (10 forward and 10 backward launches; the classifier's
    Dropouts from one set of keep-masks) by
    ``grad_check.check_device_gradients`` (the card's float64 plain path
    within 1e-6 of the CPU's, the card's float32 kernel path by the
    full-path rule unless float32 does not pin the tensor), then one SGD
    step on the card; ms per forward and per train step.  Returns the
    numbers and the launches by path."""
    out, launches = {}, {}
    for kind, build, loss_fn in (
            ("classification", build_classification,
             label_smoothing_cross_entropy),
            ("part_segmentation", build_multi_part_segmentation,
             multi_shape_cross_entropy)):
        cfg = heads_config(kind)
        model = build(cfg, torch.Generator().manual_seed(19))
        rng = np.random.default_rng(19)
        o1_running_stats(model, rng)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in patch_batch(cfg, 19).items()}
        B, N = batch["mask"].shape
        targets = heads_targets(kind, rng, B, N)
        pyramid = model.make_pyramid(batch["points"], batch["mask"])
        w = int(cfg.width)
        keep = [torch.rand((B, h), generator=torch.Generator().manual_seed(
            19 + i)) >= 0.5 for i, h in enumerate((8 * w, 4 * w, 2 * w))]
        extra = (None, keep) if kind == "classification" else ()
        copies = {"card": copy.deepcopy(model).to(device), "cpu": model,
                  "float64": grad_check.float64_copy(model),
                  "card64": grad_check.float64_copy(model).to(device)}
        res, grads = {}, {}
        for key, m in copies.items():
            dev, dtype = next(m.parameters()).device, \
                next(m.parameters()).dtype
            pyr = to_device(pyramid, dev)
            feats = batch["features"].to(dev, dtype)
            tg = [t.to(dev) for t in targets]
            aggregate = local_aggregation.kpconv_aggregate
            if key == "card64":  # the kernels take float32 and bfloat16
                local_aggregation.kpconv_aggregate = kpconv_aggregate_plain
            try:
                if key == "card":
                    reset_launches()
                m.eval()
                with torch.no_grad():
                    y = m.head(pyr, m.ResNetEncoder_0(pyr, feats))
                res[key] = (torch.cat(y, -1) if isinstance(y, list)
                            else y).cpu().double()
                if key == "card":
                    eval_launches = launch_counts()
                    reset_launches()
                m.train()
                with batch_norm_kernel_on_cpu(dev.type == "cpu"):
                    y = m.head(pyr, m.ResNetEncoder_0(pyr, feats), *extra)
                    loss = loss_fn(y, *tg)
                    g = torch.autograd.grad(loss, list(m.parameters()))
                if key == "card":
                    torch.cuda.synchronize()
                    step_launches = launch_counts()
                grads[key] = [t.cpu().double() for t in g]
                if key == "card":
                    card_grads, card_loss = g, loss.item()
            finally:
                local_aggregation.kpconv_aggregate = aggregate
        if (eval_launches, step_launches) != ((10, 0, 0), (10, 10, 0)):
            raise AssertionError(f"19(c) {kind}: launched {eval_launches} "
                                 f"in eval and {step_launches} in train")
        fwd = grad_check.check_forward_tensor(res["card"], res["cpu"],
                                              res["float64"])
        held = grad_check.check_device_gradients(
            [n for n, _ in model.named_parameters()], grads["card"],
            grads["cpu"], grads["float64"], grads["card64"])
        card = copies["card"]
        opt = torch.optim.SGD(card.parameters(), lr=0.01)
        before = [p.detach().clone() for p in card.parameters()]
        for p, g in zip(card.parameters(), card_grads):
            p.grad = g
        opt.step()
        for p, p0, g in zip(card.parameters(), before, card_grads):
            torch.testing.assert_close(p.detach(), p0 - 0.01 * g,
                                       msg=f"19(c) {kind}: the SGD step")

        def train_step():
            card.train()
            opt.zero_grad(set_to_none=True)
            y = card(batch["points"], batch["mask"], batch["features"],
                     *extra)
            loss_fn(y, *(t.to(device) for t in targets)).backward()
            opt.step()

        card.eval()
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: card(batch["points"], batch["mask"],
                                          batch["features"]), 10)
        step_ms = cuda_ms(train_step, 10)
        out[kind] = {"forward_ms": fwd_ms, "step_ms": step_ms,
                     "loss": card_loss,
                     "forward_from_cpu": fwd,
                     "nearest_gradient": held["nearest"],
                     "float64_max_l2": held["float64_max_l2"],
                     "decided_in_float64": held["decided_in_float64"]}
        launches[f"{kind}_forward"] = list(eval_launches)
        launches[f"{kind}_step"] = list(step_launches)
        print(f"19(c) {type(model).__name__} at width {w}, B={B}, N={N}: "
              f"eval forward card vs CPU (of the largest output): max "
              f"abs {fwd['max_abs'][0]:.3e} (limit {fwd['max_abs'][1]:.3e})"
              f", L2 {fwd['l2'][0]:.3e} (limit {fwd['l2'][1]:.3e}); "
              f"gradients of the loss "
              f"({card_loss:.6f}) nearest their limit: "
              f"{held['nearest'][1]} at {held['nearest'][0]:.3f} of it; "
              f"float64 card vs CPU within {held['float64_max_l2']:.3e}; "
              f"decided in float64: {held['decided_in_float64']}; "
              f"launches eval {list(eval_launches)}, train "
              f"{list(step_launches)}; {fwd_ms:.3f} ms per forward, "
              f"{step_ms:.3f} ms per SGD step", flush=True)
    return out, launches


def run_part(name: str, ctx: dict, device, smi: str) -> dict:
    """The phases of part ``name`` of PARTS in this process, on a copy of
    ``ctx["tree"]`` (its meshes: the part processes its own clouds);
    returns what the result line takes from them."""
    torch.set_num_threads(PARTS[name][0])
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        tree = os.path.join(workdir, "shapes")
        shutil.copytree(ctx["tree"], tree,
                        ignore=shutil.ignore_patterns("processed_torch"))
        if name == "aggregations":
            with phase("aggregations"):  # on scans of its own
                scans = os.path.join(workdir, "scans")
                make_scans(scans, n=SEG_POINTS, diameter=1.0,
                           write=SEG_SCANS, cut=SEG_HELD_OUT,
                           corner=SEG_CORNER)
                phase_aggregations(device, workdir, tree, scans, smi)
            with phase("custom_cfgs sweep"):  # 19(b)
                out["sweep"], out["sweep_launches"] = phase_sweep(workdir)
        elif name == "parallel":
            # phase 8's tree without its caches: phase 16(d) trains on
            # the original meanwhile
            train_data = os.path.join(workdir, "train_data")
            shutil.copytree(ctx["train_data"], train_data,
                            ignore=shutil.ignore_patterns("processed_torch"))
            with phase("data parallel"):
                out["par"], out["par_launches"] = phase_parallel(
                    load_config(CONFIG), device, workdir, train_data)
            with phase("spatial parallel"):
                out["spatial_par"], out["spatial_launches"] = \
                    phase_spatial_parallel(
                        device, workdir, ctx["l1_ckpt"],
                        ctx["spatial_root"], train_data,
                        np.load(ctx["spatial_offsets"]),
                        ctx["spatial_op_ckpt"],
                        np.load(ctx["spatial_op_offsets"]))
        elif name == "15k_seg":
            for key, title, fn in (("15k", "15k family", phase_15k),
                                   ("seg", "outlier segmentation",
                                    phase_seg)):
                sub = os.path.join(workdir, key)
                os.makedirs(sub)
                with phase(title):
                    out[f"records_{key}"], out[f"path_{key}"] = fn(device,
                                                                   sub)
            with phase("2-D layout"):  # 19(a), from phase 8's checkpoint
                out["mesh2d"], out["mesh2d_launches"] = phase_mesh2d(
                    device, workdir, ctx["l1_ckpt"])
            with phase("classification and part-segmentation heads"):
                out["heads"], out["heads_launches"] = phase_heads(device)
        else:
            for key in ("bf16", "gan", "pcn"):
                os.makedirs(os.path.join(workdir, key))
            with phase("bf16"):  # (a) ran in the parent
                _, out["path_bf16"] = phase_bf16(
                    device, os.path.join(workdir, "bf16"), tree,
                    kernels=False)
            with phase("gan"):  # (a) ran in the parent
                gan, out["path_gan"] = phase_gan(
                    device, os.path.join(workdir, "gan"), tree,
                    ctx["gen_ckpt"], kernels=False)
                out["gan_profile"] = gan["profile"]
            with phase("pcn"):
                out["pcn_summary"], out["path_pcn"] = phase_pcn(
                    device, os.path.join(workdir, "pcn"), tree,
                    ctx["phase8_window"])
    return out


def start_parts(ctx: dict, partdir: str) -> dict:
    """Each part of PARTS started as ``chip_smoke.py --part`` in a session
    of its own, its output to a file: {name: (process, log, result)}."""
    parts = {}
    for name, (threads, _) in PARTS.items():
        path = os.path.join(partdir, name)
        with open(path + ".json", "w") as f:
            json.dump(dict(ctx, out=path + ".out.json"), f)
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        with open(path + ".log", "w") as log:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--part", name,
                 path + ".json"], stdout=log, stderr=subprocess.STDOUT,
                cwd=ROOT, env=env, start_new_session=True)
        parts[name] = (proc, path + ".log", path + ".out.json")
    return parts


def finish_parts(parts: dict, started: float) -> dict:
    """Wait for every part (until PART_LIMIT_S after ``started``), print
    its output, and fail on the first that did not exit 0; returns their
    results merged."""
    out = {}
    for name, (proc, log, result) in parts.items():
        try:
            rc = proc.wait(timeout=max(
                1.0, started + PART_LIMIT_S - time.perf_counter()))
        except subprocess.TimeoutExpired:
            stop_parts(parts)
            rc = None
        with open(log) as f:
            text = f.read()
        print(f"== part {name} (phases {PARTS[name][1]}, a process of its "
              f"own)\n{text}", end="" if text.endswith("\n") else "\n")
        if rc != 0:
            raise AssertionError(
                f"part {name} " + ("ran past its limit of "
                                   f"{PART_LIMIT_S} s" if rc is None
                                   else f"exited with {rc}"))
        print(f"== part {name}: ok, {time.perf_counter() - started:.3f} s "
              "after the parts started", flush=True)
        with open(result) as f:
            out.update(json.load(f))
    return out


def stop_parts(parts: dict) -> None:
    """Kill every part still running, with whatever it started."""
    for proc, _, _ in parts.values():
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    part = len(argv) == 3 and argv[0] == "--part" and argv[1] in PARTS
    rank_jobs = {"--parallel-rank": parallel_rank,
                 "--spatial-rank": spatial_rank, "--mesh2d-rank": mesh2d_rank}
    rank_job = len(argv) == 2 and argv[0] in rank_jobs
    child = len(argv) >= 3 and argv[0] == "--sweep-child"
    if not (part or rank_job or child) and argv not in (
            [], ["--only-kernels"], ["--only-aggregations"], ["--only-gan"],
            ["--only-pcn"], ["--only-export"], ["--only-parallel"],
            ["--only-spatial"], ["--only-mesh2d"]):
        print("usage: chip_smoke.py [--only-kernels | --only-aggregations "
              "| --only-gan | --only-pcn | --only-export | --only-parallel "
              "| --only-spatial | --only-mesh2d]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if rank_job:  # a rank of phase 17, 18 or 19(a), started by torchrun
        return rank_jobs[argv[0]](argv[1])
    if child:  # a process of 19(b)'s sweep
        return sweep_child(argv[1:])
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
    if part:  # started by the default run, which built the kernels
        with open(argv[2]) as f:
            ctx = json.load(f)
        out = run_part(argv[1], ctx, device, smi)
        with open(ctx["out"], "w") as f:
            json.dump(out, f)
        return 0
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
    if argv == ["--only-pcn"]:
        # phase 15 alone, on a tree of its own
        with tempfile.TemporaryDirectory() as workdir, phase("pcn"):
            tree = os.path.join(workdir, "shapes")
            make_synthetic_dataset.write_tree(tree, verbose=False)
            summary, path_pcn = phase_pcn(device, workdir, tree)
        print(smi)
        print(json.dumps({"pcn": summary, "launches": path_pcn}))
        return 0
    if argv == ["--only-parallel"]:
        # phase 17 alone, on a tree like phase 8's
        with tempfile.TemporaryDirectory() as workdir, \
                phase("data parallel"):
            par, par_launches = phase_parallel(
                cfg, device, workdir,
                write_train_tree(os.path.join(workdir, "train_data")))
        print(smi)
        print(json.dumps({"parallel": par, "launches": par_launches}))
        return 0
    if argv == ["--only-spatial"]:
        # phase 18 alone, after phase 8's training (its checkpoint and tree)
        with tempfile.TemporaryDirectory() as workdir, phase("spatial"):
            with phase("training"):
                phase_training(cfg, device, workdir)
            ckpt = os.path.join(workdir, "log", cfg.experiment_name,
                                "current.pt")
            serving, offsets, root, kernels = phase_spatial_serving(
                cfg, device, workdir, ckpt)
            op_serving, op_offsets, op_ckpt = \
                phase_spatial_operator_serving(device, workdir, root,
                                               serving)
            par, launches = phase_spatial_parallel(
                device, workdir, ckpt, root,
                os.path.join(workdir, "train_data"), offsets, op_ckpt,
                op_offsets)
        print(smi)
        print(json.dumps({"spatial": dict(par, serving=serving,
                                          pospool_serving=op_serving),
                          "kernels_level0": kernels, "launches": launches}))
        return 0
    if argv == ["--only-mesh2d"]:
        # phase 19 alone, after phase 8's training (its checkpoint)
        with tempfile.TemporaryDirectory() as workdir, phase("2-D layout"):
            with phase("training"):
                phase_training(cfg, device, workdir)
            ckpt = os.path.join(workdir, "log", cfg.experiment_name,
                                "current.pt")
            mesh2d, launches = phase_mesh2d(device, workdir, ckpt)
            with phase("custom_cfgs sweep"):
                sweep, sweep_launches = phase_sweep(workdir)
            with phase("classification and part-segmentation heads"):
                heads, heads_launches = phase_heads(device)
        print(smi)
        print(json.dumps({"mesh2d": mesh2d, "sweep": sweep, "heads": heads,
                          "launches": {**launches, **sweep_launches,
                                       **heads_launches}}))
        return 0
    if argv == ["--only-export"]:
        # phase 16 alone, after phase 8's training and a short cleaning
        # training on a tree of its own
        with tempfile.TemporaryDirectory() as workdir, phase("export"):
            tree = os.path.join(workdir, "shapes")
            make_synthetic_dataset.write_tree(tree, verbose=False)
            train_dir = os.path.join(workdir, "training")
            with phase("training"):
                phase_training(cfg, device, train_dir)
            train_short(CLEANING_CONFIG, tree, os.path.join(
                workdir, "log_cleaning"), cfg, train_full_cleaning.main)
            run = os.path.join(train_dir, "log", cfg.experiment_name)
            launches, summary = phase_export(
                cfg, workdir, deploy_split(tree, workdir),
                os.path.join(run, "current.pt"), os.path.join(
                    workdir, "log_cleaning", CLEANING_CONFIG, "current.pt"),
                os.path.join(train_dir, "train_data"))
        print(smi)
        print(json.dumps({"export": summary, "launches": launches}))
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
        serving_launches, serving_pps = phase_serving(cfg, device,
                                                      workdir)
    with phase("backward kernel vs plain"):
        bwd_record = phase_backward(cfg, device)
    with phase("whole-model gradients"):
        phase_model_grad(cfg, device)
    with tempfile.TemporaryDirectory() as deploy_dir:
        # phase 8's run, its checkpoint and data kept for phase 16
        train_dir = os.path.join(deploy_dir, "training")
        with phase("training"):
            train_fwd, train_bwd, phase8_window = phase_training(
                cfg, device, train_dir)
        tree = os.path.join(deploy_dir, "shapes")
        with phase("deployment training"):  # its voting: after 16
            deploy_fwd, deploy_bwd = deploy_training(cfg, deploy_dir)
        gen_ckpt = os.path.join(deploy_dir, "log", DEPLOY_CONFIGS[0],
                                "current.pt")
        # the kernels' phases of 9b and 14 here, before the parts start
        with phase("bf16 kernels vs plain"):  # 9b(a)
            bf16_records = phase_bf16_kernels(
                bf16_configs()[0], device,
                bf16_stem_15k(device, deploy_dir, tree))
        with phase("d_rel kernel vs plain"):  # 14(a)
            drel_record = phase_drel(device, tree, gen_ckpt)
        l1_ckpt = os.path.join(train_dir, "log", cfg.experiment_name,
                               "current.pt")
        with phase("spatial serving"):  # 18(a), on an idle card
            # phase 9's split of SPATIAL_SHAPE, its noisy cloud cached
            assert DEPLOY_SHAPES == (SPATIAL_SHAPE,)
            spatial_serving, spatial_offsets, spatial_root, \
                spatial_kernels = phase_spatial_serving(
                    cfg, device, deploy_dir, l1_ckpt, serving_pps,
                    os.path.join(deploy_dir, "deploy"))
        with phase("spatial PosPool serving"):  # 18(e), on an idle card
            op_serving, op_offsets, op_ckpt = \
                phase_spatial_operator_serving(device, deploy_dir,
                                               spatial_root, spatial_serving)
        partdir = os.path.join(deploy_dir, "parts")
        os.makedirs(partdir)
        offsets_path = os.path.join(partdir, "spatial_offsets.npy")
        np.save(offsets_path, spatial_offsets)
        op_offsets_path = os.path.join(partdir, "spatial_op_offsets.npy")
        np.save(op_offsets_path, op_offsets)
        started = time.perf_counter()
        parts = start_parts({"tree": tree, "gen_ckpt": gen_ckpt,
                             "phase8_window": phase8_window,
                             "train_data": os.path.join(train_dir,
                                                        "train_data"),
                             "l1_ckpt": l1_ckpt,
                             "spatial_root": spatial_root,
                             "spatial_offsets": offsets_path,
                             "spatial_op_ckpt": op_ckpt,
                             "spatial_op_offsets": op_offsets_path}, partdir)
        try:
            with phase("cleaning"):  # on phase 9's shape tree
                cleaning = phase_cleaning(cfg, deploy_dir)
            # phase 8's and phase 10's checkpoints, phase 9's shape
            with tempfile.TemporaryDirectory() as workdir, phase("export"):
                export_fwd, export_summary = phase_export(
                    cfg, workdir, os.path.join(deploy_dir, "deploy"),
                    os.path.join(train_dir, "log", cfg.experiment_name,
                                 "current.pt"), os.path.join(
                        deploy_dir, "log_cleaning", CLEANING_CONFIG,
                        "current.pt"), os.path.join(train_dir, "train_data"))
            with phase("deployment voting"):  # phase 9's, on its split
                f, b = deploy_voting(deploy_dir)
                deploy_fwd, deploy_bwd = deploy_fwd + f, deploy_bwd + b
            res = finish_parts(parts, started)
        finally:
            stop_parts(parts)
    records_15k, path_15k = res["records_15k"], res["path_15k"]
    records_seg, path_seg = res["records_seg"], res["path_seg"]
    path_bf16, path_gan = res["path_bf16"], res["path_gan"]
    pcn_summary, path_pcn = res["pcn_summary"], res["path_pcn"]
    par, par_launches = res["par"], res["par_launches"]
    spatial_par, spatial_launches = res["spatial_par"], \
        res["spatial_launches"]
    drel_record.update(profile=res["gan_profile"])
    # launches: this slice's path that reaches the kernels, 18(g)'s
    # point-sharded Chamfer training on gloo rank 0 (each rank launches as
    # many; 18(e) and 18(f) launch none, checked); every path's in the
    # detail
    ds_fwd, ds_bwd, _ = path_pcn["device_sampled_training"]
    spatial_par["serving"] = spatial_serving
    spatial_par["pospool_serving"] = op_serving
    # phase 19's paths: 19(a) rank 0's 2-D forward and steps, 19(b)'s
    # sweep processes, 19(c)'s heads; each (forward, backward, d_rel)
    slice19 = {**res["mesh2d_launches"], **res["sweep_launches"],
               **res["heads_launches"]}
    record.update(
        launches=spatial_launches["spatial_chamfer_training_gloo_rank0"][0],
        launches_by_path={
            "spatial_serving": spatial_serving["forward_launches"],
            "spatial_pospool_serving": op_serving["forward_launches"],
            **{k: v[0] for k, v in spatial_launches.items()},
            **{k: v[0] for k, v in par_launches.items()},
            "export_serving": export_fwd,
            "device_sampled_training": ds_fwd, "pcn_training": 0,
            "pcn_serving": 0,
            "disc_pretraining": path_gan["disc_pretraining"][0],
            "gan_training": path_gan["gan_training"][0],
            "gan_serving": path_gan["gan_serving"],
            "serving": serving_launches, "training": train_fwd,
            "deployment": deploy_fwd, "cleaning": cleaning["cleaning"][0],
            "chamfer": cleaning["chamfer"][0],
            "15k_training": path_15k["training"][0],
            "15k_serving": path_15k["serving"],
            "outlier_seg_training": path_seg["training"][0],
            "outlier_seg_eval": path_seg["eval"],
            **{k: v[0] for k, v in slice19.items()}},
        shapes_15k=records_15k["fwd"], shapes_seg=records_seg["fwd"],
        spatial_level0=spatial_kernels["fwd"],
        pcn=pcn_summary, export=export_summary, data_parallel=par,
        spatial=spatial_par, mesh2d=res["mesh2d"], sweep=res["sweep"],
        heads=res["heads"],
        device_us_by_cuda_events=device_us.by_cuda_events)
    bwd_record.update(
        launches=spatial_launches["spatial_chamfer_training_gloo_rank0"][1],
        launches_by_path={
            "spatial_serving": 0, "spatial_pospool_serving": 0,
            **{k: v[1] for k, v in spatial_launches.items()},
            **{k: v[1] for k, v in par_launches.items()},
            "export_serving": 0,
            "device_sampled_training": ds_bwd, "pcn_training": 0,
            "pcn_serving": 0,
            "disc_pretraining": path_gan["disc_pretraining"][1],
            "gan_training": path_gan["gan_training"][1], "gan_serving": 0,
            "serving": 0, "training": train_bwd,  # inference checks its 0
            "deployment": deploy_bwd, "cleaning": cleaning["cleaning"][1],
            "chamfer": cleaning["chamfer"][1],
            "15k_training": path_15k["training"][1], "15k_serving": 0,
            "outlier_seg_training": path_seg["training"][1],
            "outlier_seg_eval": 0, **{k: v[1] for k, v in slice19.items()}},
        shapes_15k=records_15k["bwd"], shapes_seg=records_seg["bwd"],
        spatial_level0=spatial_kernels["bwd"])
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
        shapes_15k=records_15k["drel_stem"],
        shapes_seg=records_seg["drel_stem"],
        launches=spatial_launches["gan_dp_gloo_rank0"][2],
        launches_by_path={**{k: v[2] for k, v in spatial_launches.items()},
                          "gan_training": path_gan["gan_training"][2],
                          "disc_pretraining": 0, "gan_serving": 0,
                          **{k: v[2] for k, v in slice19.items()}})
    print(smi)
    print(json.dumps({"kernels": [record, bwd_record] + bf16_records
                      + [drel_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

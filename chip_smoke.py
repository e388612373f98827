#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run it from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It imports the port, torch, numpy and scipy only, and goes through five
phases, each printed with its wall time:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: every kernel under ``deep3dpointclouddenoising_torch/csrc``, one
   ``nvcc`` each, all started together;
3. kernel vs plain: the KPConv kernel against its plain PyTorch version at
   the ten shapes of one flagship forward (``cfgs/l1.yaml``, B=16), with
   masked slots, a padded query row and M not a multiple of the tile;
   rtol 2e-4 / atol 2e-5; times with CUDA events beside the bound;
4. whole model: ``cfgs/l1.yaml`` at width 144, depth 2, B=16, N=500, with
   seeded weights whose final Dense and BatchNorm running stats are O(1),
   kernel path against plain path on one pyramid, rtol 5e-4 / atol 5e-5;
5. serving (the main path): an icosphere and a torus as a
   ``qualitative_test`` split, denoised by the inference entry point at
   full width; every output finite and the kernel launched 10 times per
   batch.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so it does without a card.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from deep3dpointclouddenoising_torch import infer
from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.data.meshio import save_off
from deep3dpointclouddenoising_torch.data.synthetic import (make_icosphere,
                                                            make_torus)
from deep3dpointclouddenoising_torch.models import local_aggregation
from deep3dpointclouddenoising_torch.models.build import \
    build_offset_regression
from deep3dpointclouddenoising_torch.models.kernel_points import \
    create_kernel_points
from deep3dpointclouddenoising_torch.ops import _cuda
from deep3dpointclouddenoising_torch.ops.kpconv import (
    kpconv_aggregate, kpconv_aggregate_plain)

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "cfgs", "l1.yaml")
# published peaks of one H100 SXM at 700 W (NVIDIA data sheet): HBM3 bytes/s
# and float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
KERNEL_TOL = dict(rtol=2e-4, atol=2e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
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
    worst_abs, ms_sum, plain_sum, bound_sum = 0.0, 0.0, 0.0, 0.0
    bytes_sum, ops_sum = 0.0, 0.0
    print("call M N K C influence | max_abs max_rel | kernel_ms plain_ms "
          "bound_ms bound_by")
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
            plain_ms = cuda_ms(
                lambda: kpconv_aggregate_plain(*args, extent, infl), 20)
        t_bytes, t_ops = kpconv_bound(B, M, N, K, C, P)
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        worst_abs = max(worst_abs, max_abs)
        if infl == "linear":
            ms_sum += ms
            plain_sum += plain_ms
            bound_sum += bound_ms
            bytes_sum += t_bytes
            ops_sum += t_ops
        print(f"{name} {M} {N} {K} {C} {infl} | {max_abs:.3e} "
              f"{max_rel:.3e} | {ms:.5f} {plain_ms:.5f} {bound_ms:.5f} "
              f"{bound_by}", flush=True)
    print(f"ten flagship calls (linear), per forward: kernel {ms_sum:.5f} "
          f"ms, plain {plain_sum:.5f} ms, bound {bound_sum:.5f} ms")
    return {
        "name": "kpconv_fwd", "route": "cuda",
        "source": "deep3dpointclouddenoising_torch/csrc/kpconv_fwd.cu",
        "replaces": "deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py:142",
        "also_replaces":
            "deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py:98",
        "max_abs_err": worst_abs, "ms": ms_sum, "plain_ms": plain_sum,
        "bound_ms": bound_sum,
        "bound_by": "bytes" if bytes_sum >= ops_sum else "operations",
        "library_ms": None,
        "timed_at": "sum over the ten calls of one l1.yaml forward, B=16",
    }


def seeded_model(cfg, device, seed: int = 0):
    """l1.yaml model with seeded weights; the final Dense and every
    BatchNorm's running stats get O(1) values, so the output is O(1)."""
    torch.manual_seed(seed)
    model = build_offset_regression(cfg)
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


def phase_model(cfg, device):
    """Whole width-144 model, kernel path against plain path on one
    pyramid."""
    model = seeded_model(cfg, device)
    rng = np.random.default_rng(1)
    B, N = int(cfg.batch_size), int(cfg.num_points)
    # patch-like input: points on a noisy sphere cap of the patch radius,
    # the last 50 slots of the last cloud padding
    xyz = rng.normal(size=(B, N, 3))
    xyz = cfg.in_radius * xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    xyz = (xyz * rng.random((B, N, 1))).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[-1, -50:] = 0.0
    xyz[-1, -50:] = xyz[-1, :50]
    xyz_t, mask_t = (torch.from_numpy(a).to(device) for a in (xyz, mask))
    with torch.inference_mode():
        pyramid = model.make_pyramid(xyz_t, mask_t)

        def head(pyr):
            return model.MultiDimHead_0(
                pyr, model.ResNetEncoder_0(pyr, xyz_t))

        kpconv_aggregate.launches = 0
        got = head(pyramid)
        torch.cuda.synchronize()
        if kpconv_aggregate.launches != 10:
            raise AssertionError(f"forward launched the kernel "
                                 f"{kpconv_aggregate.launches} times, not 10")
        # the plain path: the same modules with the plain version swapped
        # in for the wrapper, on the same pyramid
        local_aggregation.kpconv_aggregate = kpconv_aggregate_plain
        want = head(pyramid)
        local_aggregation.kpconv_aggregate = kpconv_aggregate
        max_abs, max_rel = check_close(got, want, what="whole model",
                                       **MODEL_TOL)
        fwd_ms = cuda_ms(lambda: model(xyz_t, mask_t, xyz_t), 10)
    print(f"output {tuple(got.shape)}, |out| max {want.abs().max().item():.3f}"
          f"; kernel vs plain: max abs {max_abs:.3e}, max rel {max_rel:.3e}"
          f"; full forward (pyramid included) {fwd_ms:.3f} ms")


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
    dataset, results, seconds = infer.run(CONFIG, data_root, out_dir,
                                          device=device)
    launches = kpconv_aggregate.launches
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


def main() -> int:
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
    with phase("whole model"):
        phase_model(cfg, device)
    with tempfile.TemporaryDirectory() as workdir, phase("serving"):
        record["launches"] = phase_serving(cfg, device, workdir)
    print(smi)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

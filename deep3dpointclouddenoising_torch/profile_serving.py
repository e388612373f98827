"""Where the time of the flagship voting inference goes, on the card.

    python -m deep3dpointclouddenoising_torch.profile_serving

Prints, for ``cfgs/l1.yaml`` (width 144, B=16, N=500, seeded weights):

* the forward's wall time per batch (host clock around synchronised calls);
* a ``torch.profiler`` window over a few forwards: device time per forward,
  the busy share of the wall time, and device time by kernel;
* the KPConv kernel's device time at each of its ten calls, and the host
  time one call of the forward's and of the backward's wrapper takes to
  enqueue its kernels at the stem;
* the wall time of a train step (forward, masked L1, backward, clip and
  Adam; synchronised, no profiler), then the same as for the forward over
  a profiler window of train steps, with the backward's kernels' device
  time per call (inversion, per-support kernel, reduction) and per step,
  and the host time per call of the aggregation's custom ops and their
  autograd nodes (names holding ``d3pcd_torch``);
* the same busy share over a window of the voting loop on two synthetic
  shapes (icosphere and torus, 140000 points each).

Every time comes from the card this runs on; the first line names it.
"""
from __future__ import annotations

import os
import subprocess
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import infer
from .config import load_config
from .data.meshio import save_off
from .data.synthetic import make_icosphere, make_torus
from .models.build import build_offset_regression
from .ops.kpconv import kpconv_aggregate, kpconv_aggregate_backward
from .train.trainer import Trainer

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cfgs", "l1.yaml")


def _device_events(prof):
    """(name, device microseconds) of every kernel the profiler saw; the
    ranges that annotate the device timeline (``Optimizer.step#Adam.step``)
    are not kernels and are left out."""
    out = []
    for e in prof.events():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            out.append((e.name, us))
    return out


def window_summary(label: str, prof, wall_s: float, steps: int):
    """Print a profiler window's wall and device ms per step, busy share
    and device time by kernel; returns ``(device ms per step, busy
    share)``, or ``None`` when the profiler saw no device time."""
    events = _device_events(prof)
    if not events:
        print(f"{label}: the profiler saw no device time: not measured")
        return None
    busy_us = sum(us for _, us in events)
    print(f"{label}: wall {wall_s / steps * 1e3:.3f} ms per step, device "
          f"{busy_us / steps / 1e3:.3f} ms per step, busy share "
          f"{busy_us / 1e6 / wall_s:.3f}, {len(events) / steps:.1f} kernels "
          f"per step")
    by_name = defaultdict(float)
    for name, us in events:
        by_name[name] += us
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / steps / 1e3:9.4f} ms/step  {us / busy_us:6.3f}  "
              f"{name[:90]}")
    return busy_us / steps / 1e3, busy_us / 1e6 / wall_s


def _per_call(prof, kernel: str, steps: int, calls: int = 10) -> None:
    us = [u for name, u in _device_events(prof) if kernel in name]
    if len(us) >= calls * steps:
        per_call = np.asarray(us[:calls * steps]).reshape(steps, calls)
        print(f"{kernel} device us per call, in launch order: "
              + " ".join(f"{u:.1f}" for u in per_call.mean(axis=0))
              + f" (sum {per_call.sum(axis=1).mean() / 1e3:.4f} ms)")


def _enqueue_us(fn, args, calls: int) -> float:
    """Host microseconds per call of ``fn(*args)``, the card left to run:
    ``calls`` calls enqueued one after another, with no synchronisation
    inside the timed loop."""
    for _ in range(5):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host_us


def _host_us_per_call(prof, key: str, steps: int) -> None:
    """Host time per call of the profiler's CPU ops whose name holds
    ``key``, children included (an autograd node: its wrapper, allocations
    and launches)."""
    for avg in prof.key_averages():
        if key in avg.key and avg.count:
            print(f"{avg.key}: {avg.cpu_time_total / avg.count:.1f} us of "
                  f"host time per call, {avg.count / steps:.1f} calls per "
                  f"step")


def profile_train_steps(trainer: Trainer, batch, steps: int = 5):
    """Wall time per train step on one batch, synchronised at the end of
    20 steps with no profiler; then a profiler window over ``steps`` train
    steps: wall and device time per step, the busy share, device time by
    kernel, the KPConv kernels' device time per call and the host time of
    the aggregation's custom ops and autograd nodes per call.  Returns the
    window's ``(device ms per step, busy share)``, or ``None`` when the
    profiler saw no device time."""
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(20):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        print(f"train step: {(time.perf_counter() - t0) / 20 * 1e3:.3f} ms "
              f"wall per step (20 steps, synchronised, no profiler)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = window_summary("train step under the profiler", prof, wall,
                             steps)
    _per_call(prof, "kpconv_fwd_kernel", steps)
    for kernel in ("kpconv_bwd_invert", "kpconv_bwd_kernel",
                   "kpconv_bwd_reduce"):  # the training path's backward
        _per_call(prof, kernel, steps)
    us = sum(u for name, u in _device_events(prof) if "kpconv_bwd" in name)
    print(f"kpconv_bwd kernels together: {us / steps / 1e3:.4f} ms per step")
    _host_us_per_call(prof, "d3pcd_torch", steps)
    return summary


def _batch(cfg, device, seed: int = 1):
    rng = np.random.default_rng(seed)
    B, N = int(cfg.batch_size), int(cfg.num_points)
    xyz = rng.normal(size=(B, N, 3))
    xyz = cfg.in_radius * xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    xyz = (xyz * rng.random((B, N, 1))).astype(np.float32)
    x = torch.from_numpy(xyz).to(device)
    return x, torch.ones(B, N, device=device)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    device = torch.device("cuda", 0)
    cfg = load_config(CONFIG)
    model = build_offset_regression(
        cfg, generator=torch.Generator().manual_seed(0)).to(device).eval()
    xyz, mask = _batch(cfg, device)
    with torch.inference_mode():
        for _ in range(3):
            model(xyz, mask, xyz)
        torch.cuda.synchronize()
        steps = 20
        t0 = time.perf_counter()
        for _ in range(steps):
            model(xyz, mask, xyz)
        torch.cuda.synchronize()
        print(f"forward B=16: {(time.perf_counter() - t0) / steps * 1e3:.3f}"
              f" ms wall per batch (synchronised)")

        steps = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                model(xyz, mask, xyz)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        window_summary("forward under the profiler", prof, wall, steps)
        _per_call(prof, "kpconv_fwd_kernel", steps)

        # host-side cost of one wrapper call, from the stem's inputs
        pyr = model.make_pyramid(xyz, mask)
        nbr = pyr.levels[0].self_nbr
        la = model.ResNetEncoder_0.LocalAggregation_0.PseudoGrid_0
        feats = torch.randn(xyz.shape[0], xyz.shape[1], 72, device=device)
        fmask = (nbr.mask + (1.0 - mask[:, :, None])).contiguous()
        args = (feats, nbr.idx, nbr.rel_xyz, fmask, la.kpoints,
                la.kernel_weights, la.extent, la.influence)
        print(f"kpconv_aggregate stem call: "
              f"{_enqueue_us(kpconv_aggregate, args, 200):.1f} us of host "
              f"time per call (enqueue only)")
        grad_out = torch.randn_like(feats)
        bwd_args = args[:6] + (grad_out,) + args[6:]
        print(f"kpconv_aggregate_backward stem call: "
              f"{_enqueue_us(kpconv_aggregate_backward, bwd_args, 100):.1f} "
              f"us of host time per call (enqueue only)")

    trainer = Trainer(cfg, 1, torch.Generator().manual_seed(0), device)
    profile_train_steps(trainer, {"points": xyz, "mask": mask,
                                  "features": xyz,
                                  "offsets": 0.01 * torch.randn_like(xyz)})

    with tempfile.TemporaryDirectory() as workdir:
        root = os.path.join(workdir, "qualitative_test")
        os.makedirs(root)
        save_off(os.path.join(root, "sphere.off"), make_icosphere(4))
        save_off(os.path.join(root, "torus.off"), make_torus())
        dataset = infer.make_dataset(cfg, workdir)
        predict = infer.make_predict_fn(model)
        window = 40
        dataset.num_steps = window * int(cfg.batch_size)  # first batches
        infer.predict_offsets_voting(predict, dataset, 16)  # warm up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            infer.predict_offsets_voting(predict, dataset, 16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        window_summary(f"voting loop ({window} batches of 16 patches)",
                       prof, wall, window)


if __name__ == "__main__":
    main()

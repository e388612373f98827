"""Where the time of the flagship voting inference goes, on the card.

    python -m deep3dpointclouddenoising_torch.profile_serving

Prints, for ``cfgs/l1.yaml`` (width 144, B=16, N=500, seeded weights):

* the forward's wall time per batch (host clock around synchronised calls);
* a ``torch.profiler`` window over a few forwards: device time per forward,
  the busy share of the wall time, and device time by kernel;
* the KPConv kernel's device time at each of its ten calls, and the host
  time one wrapper call takes to enqueue it;
* the same for a window of train steps (forward, masked L1, backward,
  clip and Adam), with the backward kernel's device time per call;
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
from .ops.kpconv import kpconv_aggregate
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


def _summary(label: str, prof, wall_s: float, steps: int) -> None:
    events = _device_events(prof)
    if not events:
        print(f"{label}: the profiler saw no device time: not measured")
        return
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


def _per_call(prof, kernel: str, steps: int, calls: int = 10) -> None:
    us = [u for name, u in _device_events(prof) if kernel in name]
    if len(us) >= calls * steps:
        per_call = np.asarray(us[:calls * steps]).reshape(steps, calls)
        print(f"{kernel} device us per call, in launch order: "
              + " ".join(f"{u:.1f}" for u in per_call.mean(axis=0))
              + f" (sum {per_call.sum(axis=1).mean() / 1e3:.4f} ms)")


def profile_train_steps(trainer: Trainer, batch, steps: int = 5) -> None:
    """A profiler window over ``steps`` train steps on one batch: wall and
    device time per step, the busy share, device time by kernel, and the
    KPConv kernels' device time per call."""
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _summary("train step under the profiler", prof, wall, steps)
    _per_call(prof, "kpconv_fwd_kernel", steps)
    _per_call(prof, "kpconv_bwd_kernel", steps)
    _per_call(prof, "kpconv_bwd_reduce", steps)


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
        _summary("forward under the profiler", prof, wall, steps)
        _per_call(prof, "kpconv_fwd_kernel", steps)

        # host-side cost of one wrapper call, from the stem's inputs
        pyr = model.make_pyramid(xyz, mask)
        nbr = pyr.levels[0].self_nbr
        la = model.ResNetEncoder_0.LocalAggregation_0.PseudoGrid_0
        feats = torch.randn(xyz.shape[0], xyz.shape[1], 72, device=device)
        fmask = (nbr.mask + (1.0 - mask[:, :, None])).contiguous()
        args = (feats, nbr.idx, nbr.rel_xyz, fmask, la.kpoints,
                la.kernel_weights, la.extent, la.influence)
        for _ in range(5):
            kpconv_aggregate(*args)
        torch.cuda.synchronize()
        n = 200
        t0 = time.perf_counter()
        for _ in range(n):
            kpconv_aggregate(*args)
        host_us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        print(f"kpconv_aggregate stem call: {host_us:.1f} us of host time "
              f"per call (enqueue only)")

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
        _summary(f"voting loop ({window} batches of 16 patches)", prof, wall,
                 window)


if __name__ == "__main__":
    main()

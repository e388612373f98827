"""Host time of this checkout's KPConv wrappers and train step against
another checkout's, in one process on the card.

    python -m deep3dpointclouddenoising_torch.compare_host OTHER_CHECKOUT

Loads ``OTHER_CHECKOUT/deep3dpointclouddenoising_torch`` under another
module name beside this package (each builds and loads its own kernels
from its own ``csrc/``).  On the stem's and the deepest level's
neighbourhoods of a ``cfgs/l1.yaml`` pyramid (B=16, seeded points) it
times the forward's and the backward's wrapper of both in turns (this,
other, other, this; ``ROUNDS`` rounds), each turn ``CALLS`` calls enqueued
with no synchronisation inside and the card drained before it.  Then it
times train steps of both packages' ``Trainer`` on one batch the same way
for ``TRAIN_ROUNDS`` rounds, ``STEPS`` steps a turn, synchronised at its
end (the host sets a step's time).  Prints the median and the range of
each, and, round by round, the median of this minus other and the rounds
in which this was slower.  Host clocks on a shared machine drift, so only
turns taken side by side compare.

    python -m deep3dpointclouddenoising_torch.compare_host OTHER --drel

times the gradient in rel alone (``kpconv_bwd_drel``) of both instead, at
the pyramid's level-0 calls that the GAN's G-step differentiates in rel
(the stem's self neighbourhoods at C = 72, the first strided block's pool
neighbourhoods at C = 144): device microseconds per launch from
torch.profiler windows of ``DREL_CALLS`` calls (``utils.profiling``'s
``device_us``), in turns as above, and the two packages' d_rel against
each other.
"""
from __future__ import annotations

import functools
import importlib
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import load_config
from .models.build import build_offset_regression
from .ops import kpconv
from .train.trainer import Trainer
from .utils.profiling import device_us

PACKAGE = "deep3dpointclouddenoising_torch"
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cfgs", "l1.yaml")
ROUNDS = 10
CALLS = 100
TRAIN_ROUNDS = 40
STEPS = 5
DREL_CALLS = 20


def load_other(checkout: str):
    """The package in ``checkout``, imported as
    ``other_deep3dpointclouddenoising_torch``."""
    root = os.path.join(os.path.abspath(checkout), PACKAGE)
    name = "other_" + PACKAGE
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def turn_us(fn, args, calls: int, sync: bool = False) -> float:
    """Microseconds per call over ``calls`` calls, the card drained before
    them (and, with ``sync``, after them inside the timing)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    if sync:
        torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def in_turns(fns, args, calls: int, rounds: int, sync: bool = False):
    """{"this": [...], "other": [...]}: ``turn_us`` of each, taken in turns
    this, other, other, this for ``rounds`` rounds."""
    times = {key: [] for key in fns}
    for _ in range(rounds):
        for key in ("this", "other", "other", "this"):
            times[key].append(turn_us(fns[key], args, calls, sync))
    return times


def summary(times, scale: float = 1.0) -> str:
    """Median (range) of each, then the rounds' this - other (each the
    mean of its two turns): their median and the rounds this was slower."""
    out = ", ".join(f"{key} {np.median(t) * scale:.3f} "
                    f"({min(t) * scale:.3f}-{max(t) * scale:.3f})"
                    for key, t in times.items())
    diff = (np.reshape(times["this"], (-1, 2)).mean(1)
            - np.reshape(times["other"], (-1, 2)).mean(1)) * scale
    return (out + f"; this - other by round: median {np.median(diff):.3f}, "
            f"this slower in {int((diff > 0).sum())} of {diff.size}")


def compare_drel(other_kpconv, pyr, la, B, gen, device) -> None:
    """d_rel alone of this package and ``other_kpconv`` at the level-0
    calls of ``pyr``: device us per launch in turns, and their distance."""
    calls = (("stem", pyr.levels[0].self_nbr, pyr.levels[0], 72),
             ("T1 strided", pyr.transitions[0].pool_nbr, pyr.levels[1], 144))
    for name, nbr, qlevel, C in calls:
        M, N = nbr.idx.shape[1], pyr.levels[0].xyz.shape[1]
        fmask = (nbr.mask + (1.0 - qlevel.mask[:, :, None])).contiguous()
        feats = torch.randn(B, N, C, generator=gen).to(device)
        g = torch.randn(B, M, C, generator=gen).to(device)
        kw = torch.randn(la.kpoints.shape[0], C, generator=gen).to(device)
        args = (feats, nbr.idx, nbr.rel_xyz, fmask, la.kpoints, kw, g,
                la.extent, la.influence, False, False, True)
        fns = {"this": kpconv.kpconv_aggregate_backward,
               "other": other_kpconv.kpconv_aggregate_backward}
        got = {key: fn(*args)[2] for key, fn in fns.items()}
        torch.cuda.synchronize()
        scale = got["other"].abs().max().item()
        times = {key: [] for key in fns}
        for _ in range(ROUNDS):
            for key in ("this", "other", "other", "this"):
                times[key].append(device_us(
                    functools.partial(fns[key], *args), "kpconv_bwd_drel",
                    DREL_CALLS))
        diff = (got["this"] - got["other"]).abs().max().item()
        print(f"d_rel alone, {name} M={M} N={N} K={nbr.idx.shape[2]} C={C}: "
              "device us per launch, median (range) " + summary(times)
              + f"; max |this - other| {diff:.3e} of max |other| {scale:.3e}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (1, 2) or argv[1:] not in ([], ["--drel"]):
        raise SystemExit("usage: compare_host OTHER_CHECKOUT [--drel]")
    if not torch.cuda.is_available():
        raise SystemExit("compare_host: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    other = load_other(argv[0])
    other_kpconv = importlib.import_module(other.__name__ + ".ops.kpconv")
    device = torch.device("cuda", 0)
    cfg = load_config(CONFIG)
    model = build_offset_regression(
        cfg, generator=torch.Generator().manual_seed(0)).to(device).eval()
    gen = torch.Generator().manual_seed(1)
    B, N = int(cfg.batch_size), int(cfg.num_points)
    xyz = (torch.rand(B, N, 3, generator=gen) - 0.5) * 2 * cfg.in_radius
    xyz, mask = xyz.to(device), torch.ones(B, N, device=device)
    with torch.no_grad():
        pyr = model.make_pyramid(xyz, mask)
    la = model.ResNetEncoder_0.LocalAggregation_0.PseudoGrid_0
    if argv[1:] == ["--drel"]:
        compare_drel(other_kpconv, pyr, la, B, gen, device)
        return
    for level, C in ((pyr.levels[0], 72), (pyr.levels[-1], 1152)):
        nbr = level.self_nbr
        M = nbr.idx.shape[1]
        fmask = (nbr.mask + (1.0 - level.mask[:, :, None])).contiguous()
        feats = torch.randn(B, M, C, generator=gen).to(device)
        g = torch.randn(B, M, C, generator=gen).to(device)
        kw = torch.randn(la.kpoints.shape[0], C, generator=gen).to(device)
        fwd = (feats, nbr.idx, nbr.rel_xyz, fmask, la.kpoints, kw,
               la.extent, la.influence)
        bwd = fwd[:6] + (g,) + fwd[6:]
        for what, fn_name, args in (
                ("forward", "kpconv_aggregate", fwd),
                ("backward", "kpconv_aggregate_backward", bwd)):
            fns = {"this": getattr(kpconv, fn_name),
                   "other": getattr(other_kpconv, fn_name)}
            for fn in fns.values():
                for _ in range(5):
                    fn(*args)
            print(f"{what} M={M} C={C}: host us per call, median (range) "
                  + summary(in_turns(fns, args, CALLS, ROUNDS)))

    batch = {"points": xyz, "mask": mask, "features": xyz,
             "offsets": 0.01 * torch.randn(xyz.shape, generator=gen).to(
                 device)}
    other_cfg = importlib.import_module(
        other.__name__ + ".config").load_config(CONFIG)
    other_trainer = importlib.import_module(
        other.__name__ + ".train.trainer")
    trainers = {
        "this": Trainer(cfg, 1, torch.Generator().manual_seed(0), device),
        "other": other_trainer.Trainer(
            other_cfg, 1, torch.Generator().manual_seed(0), device)}
    steps = {key: t.train_step for key, t in trainers.items()}
    for step in steps.values():
        for _ in range(3):
            step(batch)
    print("train step (B=16, width 144, one batch): ms wall per step, "
          "median (range) "
          + summary(in_turns(steps, (batch,), STEPS, TRAIN_ROUNDS,
                             sync=True), 1e-3))


if __name__ == "__main__":
    main()

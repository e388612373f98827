"""The ``custom_cfgs`` feature-ablation sweep: every config trained and
scored on stand-in EDF scans.

Counterpart of ``scripts/run_custom_sweep.py``: the outlier-segmentation
configs of ``cfgs/custom_cfgs/`` (aggregation operator x raw, intensity
and Katz-visibility input features), the 12-config core matrix first,
then the ``pseudogrid*`` and ``Non-local*`` extras.  Each config trains
through ``python -m deep3dpointclouddenoising_torch.train_outlier_seg``
and is scored by the voting evaluation of ``python -m
deep3dpointclouddenoising_torch.evaluate_outlier_seg`` on the test split,
each in a process of its own; ``OUT/ablation_table.md`` is written anew
after every config.  ``OUT/scans`` receives ``data.scans.make_scans``'s
scans when it holds none (14 scans of 24,000 points, diameter 10, 10%
outliers)::

    python -m deep3dpointclouddenoising_torch.run_custom_sweep \\
        --out_dir OUT [--configs cfgs/custom_cfgs/*.yaml] [--epochs 8] \\
        [--width 72] [--num_points 512] [--num_steps 256] \\
        [--batch_size 8] [--device cuda]

A config whose training or evaluation fails, or whose evaluation prints
no metric table, is printed with the process's output, stands as
``FAILED`` in the table, and makes the sweep exit with code 1 after the
other configs ran.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from .config import load_config
from .data.scans import make_scans
from .train.__main__ import run_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_KEYS = ("macc", "miou", "prec", "rec", "fdrate", "forate", "f_b")
RUN_TIMEOUT_S = 3600


def parse_metrics(text: str) -> Dict[str, float]:
    """The metric suite from ``format_metric_table``'s columns: a header
    row of ``|``-separated keys followed (after a ``----`` separator) by a
    row of ``|``-separated values; ``{}`` when there is none."""
    lines = text.splitlines()
    for i, ln in enumerate(lines):
        if "macc" in ln and "|" in ln:
            keys = [k.strip() for k in ln.split("|")]
            for vln in lines[i + 1:i + 4]:
                if re.search(r"\d+\.\d+", vln) and "|" in vln:
                    vals = [v.strip() for v in vln.split("|")]
                    if len(vals) == len(keys):
                        return {k: float(v) for k, v in zip(keys, vals)}
    return {}


def ordered_configs(paths: Sequence[str]) -> List[str]:
    """The core matrix (PosPool, PointWiseMLP, AdaptiveWeight) first, then
    the ``pseudogrid*`` and ``Non-local*`` extras, each in the given
    order."""
    core = [c for c in paths if not os.path.basename(c).startswith(
        ("pseudogrid", "Non-local"))]
    return core + [c for c in paths if c not in core]


def write_table(path: str, rows) -> None:
    """``| config | macc | mIoU | ... |``, one row per ``(name, metrics or
    None)``, ``FAILED`` for ``None``."""
    with open(path, "w") as f:
        f.write("| config | macc | mIoU | prec | recall | FDR | FOR |"
                " F-beta |\n|---|---|---|---|---|---|---|---|\n")
        for name, met in rows:
            if met is None:
                f.write(f"| {name} | FAILED |\n")
            else:
                f.write(f"| {name} | " + " | ".join(
                    f"{met.get(k, float('nan')):.1f}"
                    for k in METRIC_KEYS) + " |\n")


def _run(argv: List[str]) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", *argv], capture_output=True,
                          text=True, cwd=REPO, timeout=RUN_TIMEOUT_S)


def _failed(name: str, what: str, proc: subprocess.CompletedProcess
            ) -> None:
    print(f"{name}: {what} FAILED (exit code {proc.returncode})\n"
          f"{proc.stdout[-1500:]}{proc.stderr[-3000:]}", flush=True)


def sweep_config(cfg_path: str, scan_dir: str, log_dir: str,
                 args: argparse.Namespace) -> Optional[Dict[str, float]]:
    """Train and evaluate one config; its metrics, or ``None`` (printed)
    when a step failed."""
    name = os.path.splitext(os.path.basename(cfg_path))[0]
    common = ["--config_file", cfg_path, "--data_root", scan_dir,
              "--device", args.device, "--log_dir", log_dir,
              "--dataset_type", "EDFS", "--width", str(args.width),
              "--num_points", str(args.num_points),
              "--batch_size", str(args.batch_size)]
    tr = _run(["deep3dpointclouddenoising_torch.train_outlier_seg", *common,
               "--num_steps", str(args.num_steps),
               "--epochs", str(args.epochs)])
    if tr.returncode != 0:
        _failed(name, "TRAIN", tr)
        return None
    ckpt = os.path.join(run_dir(load_config(cfg_path), log_dir),
                        "current.pt")
    ev = _run(["deep3dpointclouddenoising_torch.evaluate_outlier_seg",
               *common, "--load_path", ckpt, "--split", "test"])
    met = parse_metrics(ev.stdout + ev.stderr)
    if ev.returncode != 0 or not met:
        _failed(name, "EVALUATION", ev)
        return None
    return met


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        "python -m deep3dpointclouddenoising_torch.run_custom_sweep",
        description="custom_cfgs mini ablation")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--configs", nargs="*", default=None)
    # the JAX script's defaults: 8 epochs of 256 steps at width 72 leave
    # the all-inlier optimum, a shorter sweep leaves every config there
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--width", type=int, default=72)
    ap.add_argument("--num_points", type=int, default=512)
    ap.add_argument("--num_steps", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the sweep; returns ``rows`` (``(name, metrics or None)``),
    ``seconds`` per config and the ``table`` path.  Exits with code 1
    after the sweep when a config failed."""
    args = parse_args(argv)
    cfgs = ordered_configs(args.configs or sorted(
        glob.glob(os.path.join(REPO, "cfgs", "custom_cfgs", "*.yaml"))))
    args.out_dir = os.path.abspath(args.out_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    scan_dir = os.path.join(args.out_dir, "scans")
    if not glob.glob(os.path.join(scan_dir, "*.ply")):
        print("generating synthetic EDF scans...", flush=True)
        make_scans(scan_dir)
    log_dir = os.path.join(args.out_dir, "log")
    table = os.path.join(args.out_dir, "ablation_table.md")
    rows, seconds = [], {}
    for cfg_path in cfgs:
        name = os.path.splitext(os.path.basename(cfg_path))[0]
        t0 = time.perf_counter()
        met = sweep_config(os.path.abspath(cfg_path), scan_dir, log_dir,
                           args)
        seconds[name] = time.perf_counter() - t0
        if met is not None:
            print(f"{name}: {met} ({seconds[name]:.0f}s)", flush=True)
        rows.append((name, met))
        write_table(table, rows)
    print(f"table: {table}", flush=True)
    failed = [name for name, met in rows if met is None]
    if failed:
        print(f"failed configs: {failed}", flush=True)
        sys.exit(1)
    return {"rows": rows, "seconds": seconds, "table": table}


if __name__ == "__main__":
    main()

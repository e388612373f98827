"""Noise-ratio and outlier-ratio table of a PLY tree.

Counterpart of ``scripts/measure_performance.py``: for each cloud of
``<in_dir>/<which>/`` (``denoised`` or ``noisy``), the mean distance to
the nearest point of its ``clean/`` cloud and the share of points farther
than ``--threshold``; writes ``<in_dir>/Performance.txt``.  Run it as::

    python -m deep3dpointclouddenoising_torch.measure_performance \\
        --in_dir O [--which denoised|noisy] [--threshold 0.05]
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

from .evaluate import format_performance_table, performance_table, \
    read_ply_tree


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    p = argparse.ArgumentParser(
        "python -m deep3dpointclouddenoising_torch.measure_performance",
        description="Noise and outlier ratios of a PLY tree.")
    p.add_argument("--in_dir", required=True)
    p.add_argument("--which", default="denoised",
                   choices=["denoised", "noisy"])
    p.add_argument("--threshold", type=float, default=0.05)
    args = p.parse_args(argv)
    names, clouds = read_ply_tree(args.in_dir, (args.which,))
    table = performance_table(clouds["clean"], clouds[args.which],
                              args.threshold, names)
    txt = format_performance_table(table)
    print(txt)
    with open(os.path.join(args.in_dir, "Performance.txt"), "w") as f:
        f.write(txt + "\n")
    return table


if __name__ == "__main__":
    main()

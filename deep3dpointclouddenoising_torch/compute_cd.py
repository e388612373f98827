"""Chamfer-ratio tables of a denoised PLY tree.

Counterpart of ``scripts/compute_cd.py``.  Reads the ``noisy/``,
``denoised/`` and ``clean/`` trees that ``infer`` writes and writes
``CD_table.txt`` (per shape CD(denoised), CD(noisy) and their ratio) and
``CD_table_absolute.txt`` (per shape CD(denoised)), in the JAX script's
format.  Run it as::

    python -m deep3dpointclouddenoising_torch.compute_cd --in_dir O \\
        [--out_dir T] [--device [cuda|cpu]]

Without ``--device`` the nearest-neighbour distances come from a host
KD-tree; with it, from the brute-force torch path on the card (``cuda``,
the default of the flag; it raises without a card) or on the device
named.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

from .evaluate import chamfer_ratio_table, format_cd_table, read_ply_tree


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    p = argparse.ArgumentParser(
        "python -m deep3dpointclouddenoising_torch.compute_cd",
        description="Chamfer-ratio tables of a noisy/denoised/clean PLY "
                    "tree.")
    p.add_argument("--in_dir", required=True,
                   help="directory holding noisy/ denoised/ clean/ trees")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--device", nargs="?", const="cuda", default=None,
                   help="nearest neighbours by brute force in torch on "
                        "this device (default of the flag: cuda) instead "
                        "of the host KD-tree")
    args = p.parse_args(argv)
    out_dir = args.out_dir or args.in_dir
    names, clouds = read_ply_tree(args.in_dir, ("noisy", "denoised"))
    table = chamfer_ratio_table(clouds["clean"], clouds["noisy"],
                                clouds["denoised"], names,
                                device=args.device or False)
    txt = format_cd_table(table)
    print(txt)
    with open(os.path.join(out_dir, "CD_table.txt"), "w") as f:
        f.write(txt + "\n")
    with open(os.path.join(out_dir, "CD_table_absolute.txt"), "w") as f:
        for name, row in table.items():
            f.write(f"{name} {row['cd_denoised']:.8g}\n")
    return table


if __name__ == "__main__":
    main()

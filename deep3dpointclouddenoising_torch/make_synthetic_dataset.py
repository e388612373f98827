"""Write the synthetic shape tree of the end-to-end quality runs.

Counterpart of ``scripts/make_synthetic_dataset.py``: a
``{train,val,test,qualitative_test}/*.off`` tree of procedural meshes
(spheres, ellipsoids, tori, boxes and cylinders of varied proportions):
8 training shapes, 3 validation shapes and the same 4 held-out shapes in
``test`` and ``qualitative_test``.  Run it as::

    python -m deep3dpointclouddenoising_torch.make_synthetic_dataset \\
        --out D
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

from .data.meshio import TriMesh, save_off
from .data.synthetic import (make_box, make_cylinder, make_ellipsoid,
                             make_icosphere, make_torus)

SPLITS = ("train", "val", "test", "qualitative_test")


def shapes_for(split: str) -> Dict[str, TriMesh]:
    if split == "train":
        return {
            "sphere": make_icosphere(3),
            "ellipsoid_a": make_ellipsoid(3, (1.0, 0.7, 0.45)),
            "ellipsoid_b": make_ellipsoid(3, (1.0, 0.9, 0.3)),
            "torus_fat": make_torus(1.0, 0.45),
            "torus_thin": make_torus(1.0, 0.2),
            "box": make_box(10, (1.0, 0.8, 0.6)),
            "box_flat": make_box(10, (1.0, 1.0, 0.25)),
            "cylinder": make_cylinder(48, 16, 0.5, 2.0),
        }
    if split == "val":
        return {
            "ellipsoid_v": make_ellipsoid(3, (1.0, 0.8, 0.55)),
            "torus_v": make_torus(1.0, 0.3),
            "cylinder_v": make_cylinder(40, 12, 0.65, 1.6),
        }
    # held-out geometries for test/qualitative_test
    return {
        "ellipsoid_t": make_ellipsoid(3, (1.0, 0.6, 0.6)),
        "torus_t": make_torus(1.0, 0.38),
        "box_t": make_box(10, (0.9, 0.7, 0.7)),
        "cylinder_t": make_cylinder(56, 20, 0.4, 2.2),
    }


def write_tree(out: str, verbose: bool = True) -> List[str]:
    """Write every split's shapes under ``out``; returns the files."""
    written = []
    for split in SPLITS:
        d = os.path.join(out, split)
        os.makedirs(d, exist_ok=True)
        for name, mesh in shapes_for(split).items():
            path = os.path.join(d, f"{name}.off")
            save_off(path, mesh)
            written.append(path)
            if verbose:
                print(f"{split}/{name}.off  ({len(mesh.vertices)} verts)")
    return written


def main(argv: Optional[List[str]] = None) -> List[str]:
    p = argparse.ArgumentParser(
        "python -m deep3dpointclouddenoising_torch.make_synthetic_dataset",
        description="Write the synthetic shape tree.")
    p.add_argument("--out", required=True)
    return write_tree(p.parse_args(argv).out)


if __name__ == "__main__":
    main()

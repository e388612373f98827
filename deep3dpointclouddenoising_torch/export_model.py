"""Export a trained denoiser checkpoint as a sealed serving artifact.

Counterpart of ``scripts/export_model.py``: the inference forward of the
offset model (the full-cleaning model with ``--full_cleaning``) exported
by ``torch.export`` at a fixed (batch, points) shape, with the
checkpoint's weights inside (``serving.py``)::

    python -m deep3dpointclouddenoising_torch.export_model \\
        --config_file cfgs/l1.yaml --checkpoint L/<experiment>/current.pt \\
        --out denoiser.pt2 [--batch_size B] [--full_cleaning] [--check] \\
        [--device cuda]

It writes the artifact and ``<out>.json`` (shapes, platform, format
version) and prints the metadata.  ``--device`` (default ``cuda``) is where
the artifact runs; it takes the place of the JAX script's ``--platforms``
and ``--platform``.  ``--check`` loads the artifact back and holds it to
the direct forward (``infer.make_predict_fn``) on the example batch, within
``1e-5 * max(scale, 1)`` of the output's largest value, as the JAX script
does.  ``serving.load_denoiser`` serves the artifact.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .config import load_config
from .infer import load_model, make_predict_fn
from .serving import (artifact_meta, export_denoiser, load_denoiser,
                      save_artifact)
from .utils.device import resolve_device


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        "python -m deep3dpointclouddenoising_torch.export_model",
        description="Serving-artifact export.")
    p.add_argument("--config_file", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True,
                   help="artifact path (+ .json metadata sidecar)")
    p.add_argument("--batch_size", type=int, default=None,
                   help="served batch size (default: cfg.batch_size)")
    p.add_argument("--full_cleaning", action="store_true")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and verify it matches the "
                        "direct forward on the example batch")
    p.add_argument("--device", default="cuda",
                   help="where the artifact runs")
    return p.parse_args(argv)


def example_batch(cfg, batch: int) -> Dict[str, np.ndarray]:
    """The JAX script's example: seeded normal points and features scaled
    by ``in_radius``, every slot real."""
    rng = np.random.default_rng(0)
    return {
        "points": rng.standard_normal(
            (batch, cfg.num_points, 3)).astype(np.float32) * cfg.in_radius,
        "mask": np.ones((batch, cfg.num_points), np.float32),
        "features": rng.standard_normal(
            (batch, cfg.num_points, cfg.input_features_dim)
        ).astype(np.float32) * cfg.in_radius,
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Export; returns the metadata, the ``export_s`` seconds and, with
    ``--check``, the round trip's ``err`` and ``scale`` and the loaded
    artifact's ``predict``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config_file)
    batch = args.batch_size or int(cfg.batch_size)
    model = load_model(cfg, device, args.checkpoint,
                       full_cleaning=args.full_cleaning)
    norm_factor = float(cfg.in_radius) / 100.0 if cfg.norm else None
    example = example_batch(cfg, batch)
    t0 = time.perf_counter()
    exported = export_denoiser(model, example, norm_factor=norm_factor,
                               scale_outputs=not args.full_cleaning,
                               device=device)
    export_s = time.perf_counter() - t0
    save_artifact(exported, args.out, meta={
        "config_file": os.path.basename(args.config_file),
        "checkpoint": args.checkpoint,
        "full_cleaning": bool(args.full_cleaning),
        "norm_factor": norm_factor,
    })
    meta = artifact_meta(args.out)
    print(json.dumps(meta, indent=1))
    print(f"exported in {export_s:.3f} s", flush=True)
    result: Dict[str, Any] = dict(meta=meta, export_s=export_s)
    if args.check:
        predict = load_denoiser(args.out)
        got = predict(example["points"], example["mask"],
                      example["features"]).cpu().numpy()
        want = make_predict_fn(model, norm_factor,
                               not args.full_cleaning)(example).cpu().numpy()
        err = float(np.max(np.abs(got - want)))
        scale = float(np.max(np.abs(want))) or 1.0
        print(f"roundtrip max abs err {err:.3e} (output scale {scale:.3e})")
        if not err <= 1e-5 * max(scale, 1.0):
            raise AssertionError("artifact mismatch")
        print("CHECK OK", flush=True)
        result.update(err=err, scale=scale, predict=predict)
    return result


if __name__ == "__main__":
    main()

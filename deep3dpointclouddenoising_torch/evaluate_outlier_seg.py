"""Voting evaluation of an outlier-segmentation checkpoint over whole
scans.

Counterpart of ``scripts/evaluate_outlier_seg.py``: the test split's
covering patches through the scene-segmentation model in eval mode, their
class probabilities voted onto each scan
(``evaluate.evaluate_outlier_segmentation``), and the metric table::

    python -m deep3dpointclouddenoising_torch.evaluate_outlier_seg \\
        --config_file cfgs/outlier_seg_edf.yaml --data_root D \\
        --load_path L/<experiment_name>/current.pt [--split test] \\
        [--write_dir O] [--dataset_type EDFS] [--DEBUG 1] [--device cuda] \\
        [--log_dir L]

Without ``--load_path`` the weights are initialised from the config's
``rng_seed``.  The printed lines also go to
``L/<experiment_name>/log.txt`` (``L`` defaults to ``log``, as for the JAX
script).  ``--write_dir`` receives each scan's ``<name>_eval.ply``
(points, outlier probability, class, label).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch

from .data.outlier_dataset import OutlierSegmentationDataset
from .evaluate import evaluate_outlier_segmentation
from .infer import make_predict_fn
from .models import build_scene_segmentation
from .train.__main__ import load_run_config, run_dir
from .train_outlier_seg import dataset_kwargs
from .utils.checkpoint import load_model_state
from .utils.device import resolve_device
from .utils.logger import run_logs
from .utils.metrics import format_metric_table

def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        "python -m deep3dpointclouddenoising_torch.evaluate_outlier_seg",
        description="Outlier-segmentation voting evaluation on one card.")
    p.add_argument("--config_file", required=True)
    p.add_argument("--data_root", required=True)
    p.add_argument("--load_path", default="",
                   help="a checkpoint of train_outlier_seg")
    p.add_argument("--split", default="test")
    p.add_argument("--write_dir", default=None)
    p.add_argument("--dataset_type", default=None)
    p.add_argument("--DEBUG", type=int)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--num_points", type=int)
    p.add_argument("--width", type=int,
                   help="the model width (must match the checkpoint's)")
    p.add_argument("--rng_seed", type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--log_dir", default="log",
                   help="log.txt goes to <log_dir>/<experiment_name>")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Evaluate; prints the metric table and returns ``metrics``, the
    ``dataset``, the ``batches`` and the ``seconds`` of the voting."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_run_config(args)
    cfg.num_classes = 2
    with run_logs(run_dir(cfg, args.log_dir), metrics=False) as (logger, _):
        return _evaluate(cfg, args, device, logger)


def _evaluate(cfg, args, device, logger) -> Dict[str, Any]:
    dataset = OutlierSegmentationDataset(
        cfg.data_root, args.split, num_steps=cfg.num_steps,
        **dataset_kwargs(cfg, args.dataset_type))
    cfg.input_features_dim = dataset.input_features_dim
    model = build_scene_segmentation(
        cfg, torch.Generator().manual_seed(int(cfg.rng_seed)))
    if args.load_path:
        model.load_state_dict(load_model_state(args.load_path))
        logger.info(f"loaded {args.load_path}")
    else:
        logger.info("no --load_path: evaluating a random init")
    batch_size = int(cfg.batch_size)
    t0 = time.perf_counter()
    metrics = evaluate_outlier_segmentation(
        make_predict_fn(model.to(device)), dataset, batch_size=batch_size,
        write_dir=args.write_dir)
    seconds = time.perf_counter() - t0
    batches = -(-len(dataset) // batch_size)
    points = sum(len(p) for p in dataset.clouds_points)
    logger.info(f"{args.split}: {len(dataset.cloud_names)} scans, {points} "
                f"points, {len(dataset)} patches, {batches} batches, "
                f"{seconds:.3f} s ({points / seconds:.1f} points/s)")
    logger.info(format_metric_table(metrics, name=args.split))
    return dict(metrics=metrics, dataset=dataset, batches=batches,
                seconds=seconds)


if __name__ == "__main__":
    main()

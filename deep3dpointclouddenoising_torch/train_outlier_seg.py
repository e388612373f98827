"""Outlier-segmentation training on labelled scans, on one card.

Counterpart of ``scripts/train_outlier_seg.py``: the scene-segmentation
model (two classes, inlier and outlier) trained under the masked
cross-entropy on ``OutlierSegmentationDataset`` patches of the ``train``
split (the config's train transforms), a validation loss over the ``val``
split every ``val_freq`` epochs, and a checkpoint per epoch; the train
entry point's flags and epoch loop, plus the split layout::

    python -m deep3dpointclouddenoising_torch.train_outlier_seg \\
        --config_file cfgs/outlier_seg_edf.yaml --data_root D --log_dir L \\
        [--dataset_type EDFM|EDFS|EDFS{K}f{i}|PCN] [--DEBUG 1] \\
        [--num_steps S] [--epochs E] [--device cuda] [--auto_resume]

``D`` holds the scans (``pointcloud_NN.ply`` for EDF, the
``outliers_*_W_NOR`` lists for PCN; ``data.scans.make_scans`` writes
stand-ins); ``--DEBUG 1`` reads the first two scans of each split.
``evaluate_outlier_seg --load_path L/<experiment_name>/current.pt`` reads
the checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from .data.outlier_dataset import OutlierSegmentationDataset
from .data.transforms import build_train_transforms
from .train import __main__ as _train_cli
from .utils.device import resolve_device


def dataset_kwargs(cfg, dataset_type: Optional[str]) -> Dict[str, Any]:
    """The ``OutlierSegmentationDataset`` arguments every split of a run
    shares."""
    return dict(dataset_type=dataset_type or str(cfg.datasets),
                input_features=list(cfg.features),
                katz_params=list(cfg.katz_params), katz_type=cfg.katz_type,
                subsampling_parameter=float(cfg.sampleDl),
                in_radius=cfg.in_radius, num_points=cfg.num_points,
                debug=bool(cfg.DEBUG), seed=cfg.rng_seed)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train; returns the train entry point's summary."""
    args = _train_cli.parse_args(argv, "segmentation")
    device = resolve_device(args.device)
    cfg = _train_cli.load_run_config(args)
    cfg.num_classes = 2
    common = dataset_kwargs(cfg, args.dataset_type)
    train_ds = OutlierSegmentationDataset(
        cfg.data_root, "train", num_steps=cfg.num_steps,
        num_epochs=int(cfg.epochs), transforms=build_train_transforms(cfg),
        **common)
    val_ds = OutlierSegmentationDataset(
        cfg.data_root, "val", num_steps=cfg.num_steps, num_epochs=1,
        **common)
    cfg.input_features_dim = train_ds.input_features_dim
    return _train_cli.fit(cfg, args.log_dir, device, train_ds, val_ds,
                          "segmentation",
                          load_weights_path=args.load_weights_path,
                          auto_resume=args.auto_resume)


if __name__ == "__main__":
    main()

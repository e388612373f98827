"""PointCleanNet-baseline training on one card: the ``ResPCPNet`` on raw
patches.

Counterpart of ``scripts/train_pcn.py``: the PCN ``OffsetDataset``
(``architecture="PCN"``) of the ``train`` split with the config's
augmentation and of the ``val`` split, ``train.pcn.PCNTrainer`` with the
config's loss (``L1``, ``original``, ``original_no_reg``) and optimizer,
a validation pass every ``val_freq`` epochs and the train entry point's
checkpoints and resume (``current.pt`` every epoch, ``ckpt_epoch_<E>.pt``
every ``save_freq``; ``--load_path``, ``--load_weights_path``,
``--auto_resume``, ``--start_epoch``).  Each patch draws from a generator
seeded by its index and the model holds no dropout, so a resumed run
repeats an unbroken one bitwise.  Run it as::

    python -m deep3dpointclouddenoising_torch.train_pcn \\
        --config_file cfgs/synthetic_quality_pcn4.yaml --data_root D \\
        --log_dir L [--num_steps S] [--epochs E] [--device cuda] \\
        [--auto_resume] [--load_path P] [--load_weights_path W]

``infer --pcn --checkpoint L/<experiment>/current.pt`` reads the
checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from .data.transforms import build_train_transforms
from .train import __main__ as _train_cli
from .utils.device import resolve_device


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train; returns the train entry point's summary."""
    args = _train_cli.parse_args(argv, loss_mode="pcn")
    device = resolve_device(args.device)
    cfg = _train_cli.load_run_config(args)
    cfg.architecture = "PCN"
    train_ds = _train_cli.offset_dataset(cfg, "train", int(cfg.epochs),
                                         build_train_transforms(cfg), "PCN")
    val_ds = _train_cli.offset_dataset(cfg, "val", 1, architecture="PCN")
    return _train_cli.fit(cfg, args.log_dir, device, train_ds, val_ds,
                          "pcn", None, args.load_weights_path,
                          args.auto_resume)


if __name__ == "__main__":
    main()

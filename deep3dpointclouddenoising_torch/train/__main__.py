"""Offset-regression training on one card, and the epoch loop that
full-cleaning training (``train_full_cleaning``) shares.

Counterpart of ``scripts/train.py`` for one device: the same config file
and overrides, epochs of train steps over the ``train`` split with a
validation pass over the ``val`` split every ``val_freq`` epochs, and a
checkpoint per epoch.  Run it as::

    python -m deep3dpointclouddenoising_torch.train \\
        --config_file cfgs/l1.yaml --data_root D --log_dir L \\
        [--num_steps S] [--epochs E] [--batch_size B] [--device cuda]

``D`` holds ``train/*.off`` and ``val/*.off``.  Checkpoints go to
``L/<experiment_name>/current.pt`` (every epoch) and ``ckpt_epoch_<E>.pt``
(every ``save_freq`` epochs and the last); ``infer --checkpoint`` reads
either.  The loss is read back from the card only every ``print_freq``
steps, so the host prepares batches while the card computes.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import load_config
from ..data.loader import BatchLoader
from ..data.offset_dataset import OffsetDataset
from ..data.transforms import build_train_transforms
from ..utils.checkpoint import save_checkpoint
from ..utils.device import resolve_device
from ..utils.metrics import AverageMeter
from .trainer import Trainer

_OVERRIDES = ("batch_size", "num_points", "width", "num_steps", "epochs",
              "base_learning_rate", "weight_decay", "rng_seed", "val_freq",
              "num_points_per_shape")


_CLIS = {
    "offset": ("python -m deep3dpointclouddenoising_torch.train",
               "Offset-regression training on one card."),
    "full_cleaning": (
        "python -m deep3dpointclouddenoising_torch.train_full_cleaning",
        "Full-cleaning training (offsets and outlierness) on one card."),
}


def parse_args(argv: Optional[List[str]] = None,
               loss_mode: str = "offset") -> argparse.Namespace:
    prog, description = _CLIS[loss_mode]
    p = argparse.ArgumentParser(prog, description=description)
    p.add_argument("--config_file", required=True)
    p.add_argument("--data_root", required=True)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--num_points", type=int)
    p.add_argument("--width", type=int,
                   help="override the model width (debug runs)")
    p.add_argument("--num_steps", type=int,
                   help="patches per epoch (steps = num_steps // batch)")
    p.add_argument("--epochs", type=int)
    p.add_argument("--base_learning_rate", type=float)
    p.add_argument("--weight_decay", type=float)
    p.add_argument("--val_freq", type=int)
    p.add_argument("--num_points_per_shape", type=int,
                   help="points of each processed training and validation "
                        "cloud")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--rng_seed", type=int)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _normed(batch: Dict[str, np.ndarray], norm_factor: Optional[float]):
    if norm_factor:
        for k in ("points", "offsets", "features"):
            batch[k] = batch[k] / norm_factor
    return batch


def main(argv: Optional[List[str]] = None,
         loss_mode: str = "offset") -> Dict[str, Any]:
    """Train the model of ``loss_mode`` (``Trainer``'s: ``"offset"`` or
    ``"full_cleaning"``); returns a summary: every train loss, the val
    losses, ms per step of each epoch, the step count, val batches and the
    last checkpoint's path."""
    args = parse_args(argv, loss_mode)
    device = resolve_device(args.device)
    cfg = load_config(args.config_file,
                      {k: getattr(args, k) for k in _OVERRIDES
                       if getattr(args, k) is not None})
    cfg.data_root = args.data_root
    log_dir = os.path.join(args.log_dir, cfg.experiment_name or "run")
    common = dict(
        in_radius=cfg.in_radius, num_points=cfg.num_points,
        num_steps=cfg.num_steps, noise_type=cfg.noise_type,
        noise_level=cfg.noise_level,
        num_points_per_shape=cfg.num_points_per_shape,
        outlier_proportion=cfg.outlier_percentage,
        fourier_features=bool(cfg.fourier_features), seed=cfg.rng_seed,
        diverse_levels=list(cfg.diverse_levels) or None)
    train_ds = OffsetDataset(cfg.data_root, "train",
                             num_epochs=int(cfg.epochs),
                             transforms=build_train_transforms(cfg),
                             **common)
    val_ds = OffsetDataset(cfg.data_root, "val", num_epochs=1, **common)
    batch_size = int(cfg.batch_size)
    train_loader = BatchLoader(train_ds, batch_size, drop_last=True)
    val_loader = BatchLoader(val_ds, batch_size)
    print(f"device {device}; train patches {len(train_ds)} "
          f"({len(train_loader)} steps per epoch), val patches "
          f"{len(val_ds)}", flush=True)
    trainer = Trainer(cfg, len(train_loader),
                      torch.Generator().manual_seed(int(cfg.rng_seed)),
                      device, loss_mode=loss_mode)
    norm_factor = float(cfg.in_radius) / 100.0 if cfg.norm else None
    summary: Dict[str, Any] = {"train_losses": [], "val_losses": [],
                               "ms_per_step": [], "val_batches": 0}
    checkpoint = None
    for epoch in range(int(cfg.start_epoch), int(cfg.epochs) + 1):
        meter = AverageMeter()
        pending: List = []  # (loss on the device, batch size)
        t0 = time.perf_counter()
        steps = 0
        for it, batch in enumerate(train_loader.epoch_iter(epoch - 1)):
            loss = trainer.train_step(_normed(batch, norm_factor))
            pending.append((loss, len(batch["points"])))
            steps += 1
            if it % int(cfg.print_freq) == 0:
                for value, n in pending:  # waits for the card here only
                    meter.update(value.item(), n)
                    summary["train_losses"].append(meter.val)
                pending.clear()
                print(f"Train [{epoch}/{cfg.epochs}][{it}/"
                      f"{len(train_loader)}] loss {meter.val:.6f} "
                      f"({meter.avg:.6f})", flush=True)
        for value, n in pending:
            meter.update(value.item(), n)
            summary["train_losses"].append(meter.val)
        _sync(device)
        ms = (time.perf_counter() - t0) / max(steps, 1) * 1e3
        summary["ms_per_step"].append(ms)
        print(f"epoch {epoch}: {steps} steps, loss {meter.avg:.6f}, lr "
              f"{trainer.lr_schedule(trainer.step):.6g}, {ms:.3f} ms per "
              f"step (host clock, data loading included)", flush=True)
        if epoch % int(cfg.val_freq) == 0:
            vmeter = AverageMeter()
            vpending = [(trainer.eval_step(_normed(b, norm_factor)),
                         len(b["points"])) for b in val_loader.epoch_iter(0)]
            for value, n in vpending:
                vmeter.update(value.item(), n)
            summary["val_batches"] += len(vpending)
            summary["val_losses"].append(vmeter.avg)
            print(f"val [{epoch}] loss {vmeter.avg:.6f}", flush=True)
        checkpoint = save_checkpoint(os.path.join(log_dir, "current.pt"),
                                     trainer.model, trainer.optimizer,
                                     trainer.step)
        if epoch % int(cfg.save_freq) == 0 or epoch == int(cfg.epochs):
            checkpoint = save_checkpoint(
                os.path.join(log_dir, f"ckpt_epoch_{epoch}.pt"),
                trainer.model, trainer.optimizer, trainer.step)
    summary.update(steps=trainer.step, checkpoint=checkpoint,
                   trainer=trainer)
    print(f"trained {trainer.step} steps; checkpoint {checkpoint}",
          flush=True)
    return summary


if __name__ == "__main__":
    main()

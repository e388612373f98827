"""Offset-regression training on one card, and the epoch loop (:func:`fit`)
that full-cleaning and outlier-segmentation training
(``train_full_cleaning``, ``train_outlier_seg``) share.

Counterpart of ``scripts/train.py`` for one device: the same config file
and overrides, epochs of train steps over the ``train`` split with a
validation pass over the ``val`` split every ``val_freq`` epochs, and a
checkpoint per epoch.  Run it as::

    python -m deep3dpointclouddenoising_torch.train \\
        --config_file cfgs/l1.yaml --data_root D --log_dir L \\
        [--num_steps S] [--epochs E] [--batch_size B] [--device cuda] \\
        [--auto_resume] [--load_path P [--start_epoch E0]] \\
        [--load_weights_path W]

``D`` holds ``train/*.off`` and ``val/*.off``.  Checkpoints go to
``L/<experiment_name>/current.pt`` (every epoch) and ``ckpt_epoch_<E>.pt``
(every ``save_freq`` epochs and the last); ``infer --checkpoint`` reads
either.  A run continues from one with the JAX script's precedence
(:func:`restore_run`): ``--load_path P`` restores P's whole train state
(run on from ``--start_epoch``); else ``--load_weights_path W`` takes W's
weights and BatchNorm statistics under a fresh optimizer and schedule,
unless ``--auto_resume`` finds a checkpoint; ``--auto_resume`` restores
``current.pt`` (or the newest ``ckpt_epoch_<E>.pt``) of the run's
directory and goes on from the epoch after the last one it completed.
Batches, validation and checkpoints depend on the epoch number alone
(each patch draws from a generator seeded by its index), so a resumed run
repeats an unbroken one.  The loss is read back from the card only every
``print_freq`` steps, so the host prepares batches while the card
computes.  The JAX package's ``steps_per_dispatch`` (scan-fused steps, a
workaround for the TPU's remote link) is read from the config and
ignored: every step is its own dispatch.  ``remat: 1`` in the config
recomputes the encoder's bottlenecks in the backward
(``models/resnet.py``).
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
from ..utils.checkpoint import (load_checkpoint, load_weights,
                                resume_checkpoint, save_checkpoint)
from ..utils.device import resolve_device
from ..utils.metrics import AverageMeter
from .trainer import Trainer

_OVERRIDES = ("batch_size", "num_points", "width", "num_steps", "epochs",
              "base_learning_rate", "weight_decay", "rng_seed", "val_freq",
              "num_points_per_shape", "DEBUG", "start_epoch", "load_path")


_CLIS = {
    "offset": ("python -m deep3dpointclouddenoising_torch.train",
               "Offset-regression training on one card."),
    "full_cleaning": (
        "python -m deep3dpointclouddenoising_torch.train_full_cleaning",
        "Full-cleaning training (offsets and outlierness) on one card."),
    "segmentation": (
        "python -m deep3dpointclouddenoising_torch.train_outlier_seg",
        "Outlier-segmentation training on labelled scans on one card."),
    "gan": ("python -m deep3dpointclouddenoising_torch.train_gan",
            "Adversarial fine-tuning of the offset model on one card."),
    "discriminator": (
        "python -m deep3dpointclouddenoising_torch.train_discriminator",
        "Discriminator pre-training (clean against raw noisy) on one "
        "card."),
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
    if loss_mode == "segmentation":
        p.add_argument("--dataset_type",
                       help="EDFM | EDFS | EDFS{K}f{i} | PCN (default: the "
                            "config's datasets)")
        p.add_argument("--DEBUG", type=int,
                       help="1: the first two scans of each split")
    else:
        p.add_argument("--num_points_per_shape", type=int,
                       help="points of each processed training and "
                            "validation cloud")
    p.add_argument("--start_epoch", type=int,
                   help="first epoch to run (with --load_path)")
    if loss_mode == "gan":
        p.add_argument("--load_path_generator",
                       help="the generator's weights and BatchNorm "
                            "statistics from this checkpoint")
        p.add_argument("--load_path_discriminator",
                       help="the discriminator's weights and BatchNorm "
                            "statistics from this checkpoint")
    else:
        p.add_argument("--load_path",
                       help="restore this checkpoint's whole train state")
    if loss_mode not in ("gan", "discriminator"):
        p.add_argument("--load_weights_path",
                       help="warm-start the model's weights and BatchNorm "
                            "statistics from this checkpoint under a fresh "
                            "optimizer and schedule")
    p.add_argument("--auto_resume", action="store_true",
                   help="restore <log_dir>/<experiment_name>/current.pt (or "
                        "the newest ckpt_epoch_<E>.pt; for the GAN both "
                        "blocks' under generator/ and discriminator/) and "
                        "continue from the epoch after it")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--rng_seed", type=int)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run_dir(cfg, log_dir: str) -> str:
    """The directory of a run's checkpoints."""
    return os.path.join(log_dir, cfg.experiment_name or "run")


def restore_run(trainer: Trainer, cfg, directory: str, steps_per_epoch: int,
                load_weights_path: Optional[str] = None,
                auto_resume: bool = False) -> Optional[str]:
    """Restore ``trainer`` as ``scripts/train.py`` does
    (:167-197) and return what was read, or ``None``:

    1. ``cfg.load_path``: its whole train state; ``cfg.start_epoch`` stays;
    2. else ``load_weights_path``, unless ``auto_resume`` finds a
       checkpoint: its weights and BatchNorm statistics only;
    3. else with ``auto_resume``, ``directory``'s ``current.pt`` or, failing
       that, its newest ``ckpt_epoch_<E>.pt``: its whole train state, and
       ``cfg.start_epoch = step // steps_per_epoch + 1`` (checkpoints are
       written at epochs' ends).
    """
    current = resume_checkpoint(directory)
    if cfg.load_path:
        step = load_checkpoint(cfg.load_path, trainer)
        print(f"resumed from {cfg.load_path} at step {step}", flush=True)
        return cfg.load_path
    if load_weights_path and not (auto_resume and current):
        load_weights(load_weights_path, trainer)
        print(f"warm-started weights from {load_weights_path}", flush=True)
        return load_weights_path
    if auto_resume and current:
        step = load_checkpoint(current, trainer)
        cfg.start_epoch = step // steps_per_epoch + 1
        print(f"auto-resumed from {current} at step {step} -> start_epoch "
              f"{cfg.start_epoch}", flush=True)
        return current
    return None


def save_epoch(directory: str, trainer, epoch: int, cfg) -> str:
    """``trainer``'s checkpoint (its ``model``, ``optimizer`` and
    ``step``) at the end of ``epoch``: ``current.pt`` every epoch, and
    ``ckpt_epoch_<E>.pt`` every ``cfg.save_freq`` epochs and at the last;
    returns the last file written."""
    path = save_checkpoint(os.path.join(directory, "current.pt"),
                           trainer.model, trainer.optimizer, trainer.step)
    if epoch % int(cfg.save_freq) == 0 or epoch == int(cfg.epochs):
        path = save_checkpoint(
            os.path.join(directory, f"ckpt_epoch_{epoch}.pt"),
            trainer.model, trainer.optimizer, trainer.step)
    return path


def load_run_config(args: argparse.Namespace):
    """The config file with the command line's overrides, and its
    ``data_root``."""
    cfg = load_config(args.config_file,
                      {k: getattr(args, k) for k in _OVERRIDES
                       if getattr(args, k, None) is not None})
    cfg.data_root = args.data_root
    return cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _normed(batch: Dict[str, np.ndarray], norm_factor: Optional[float]):
    if norm_factor:
        for k in ("points", "offsets", "features"):
            batch[k] = batch[k] / norm_factor
    return batch


def offset_dataset(cfg, split: str, num_epochs: int,
                   transforms=None) -> OffsetDataset:
    """The offset dataset of a split of ``cfg.data_root``, as the
    training entry points build it."""
    return OffsetDataset(
        cfg.data_root, split, in_radius=cfg.in_radius,
        num_points=cfg.num_points, num_steps=cfg.num_steps,
        num_epochs=num_epochs, noise_type=cfg.noise_type,
        noise_level=cfg.noise_level,
        num_points_per_shape=cfg.num_points_per_shape,
        outlier_proportion=cfg.outlier_percentage, transforms=transforms,
        fourier_features=bool(cfg.fourier_features), seed=cfg.rng_seed,
        diverse_levels=list(cfg.diverse_levels) or None)


def main(argv: Optional[List[str]] = None,
         loss_mode: str = "offset") -> Dict[str, Any]:
    """Train the model of ``loss_mode`` (``"offset"`` or
    ``"full_cleaning"``) on a shape tree; returns :func:`fit`'s
    summary."""
    args = parse_args(argv, loss_mode)
    device = resolve_device(args.device)
    cfg = load_run_config(args)
    train_ds = offset_dataset(cfg, "train", int(cfg.epochs),
                              build_train_transforms(cfg))
    val_ds = offset_dataset(cfg, "val", 1)
    norm_factor = float(cfg.in_radius) / 100.0 if cfg.norm else None
    return fit(cfg, args.log_dir, device, train_ds, val_ds, loss_mode,
               norm_factor, args.load_weights_path, args.auto_resume)


def fit(cfg, log_dir: str, device: torch.device, train_ds, val_ds,
        loss_mode: str, norm_factor: Optional[float] = None,
        load_weights_path: Optional[str] = None, auto_resume: bool = False
        ) -> Dict[str, Any]:
    """Epochs ``cfg.start_epoch..cfg.epochs`` of train steps over
    ``train_ds`` (its ragged last batch dropped), a validation pass over
    ``val_ds`` every ``cfg.val_freq`` epochs, and a checkpoint per epoch
    under ``<log_dir>/<experiment_name>``, from the state that
    :func:`restore_run` restores (``cfg.load_path``,
    ``load_weights_path``, ``auto_resume``).  Returns a summary: every
    train loss, the val losses, ms per step of each epoch, the step count,
    val batches, the last checkpoint's path, what was restored and the
    trainer."""
    log_dir = run_dir(cfg, log_dir)
    batch_size = int(cfg.batch_size)
    train_loader = BatchLoader(train_ds, batch_size, drop_last=True)
    val_loader = BatchLoader(val_ds, batch_size)
    print(f"device {device}; train patches {len(train_ds)} "
          f"({len(train_loader)} steps per epoch), val patches "
          f"{len(val_ds)}", flush=True)
    trainer = Trainer(cfg, len(train_loader),
                      torch.Generator().manual_seed(int(cfg.rng_seed)),
                      device, loss_mode=loss_mode)
    restored = restore_run(trainer, cfg, log_dir, len(train_loader),
                           load_weights_path, auto_resume)
    summary: Dict[str, Any] = {"train_losses": [], "val_losses": [],
                               "ms_per_step": [], "val_batches": 0,
                               "restored": restored}
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
        checkpoint = save_epoch(log_dir, trainer, epoch, cfg)
    summary.update(steps=trainer.step, checkpoint=checkpoint,
                   trainer=trainer)
    print(f"trained {trainer.step} steps; checkpoint {checkpoint}",
          flush=True)
    return summary


if __name__ == "__main__":
    main()

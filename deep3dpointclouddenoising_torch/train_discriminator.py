"""Discriminator pre-training on one card, or data-parallel over
torchrun's processes: clean against raw noisy clouds.

Counterpart of ``scripts/train_discriminator.py``: the discriminator
learns to tell clean patches (points plus their true offsets) from the raw
noisy points (not a generator's output) by
``train.gan.GANTrainer.pretrain_step``, epoch after epoch over the
``train`` split (no transforms, as in the JAX script), with the
validation accuracy at the 0.5 threshold over the ``val`` split every
``val_freq`` epochs and a checkpoint per epoch::

    python -m deep3dpointclouddenoising_torch.train_discriminator \\
        --config_file cfgs/synthetic_quality_disc.yaml --data_root D \\
        --log_dir L [--num_steps S] [--epochs E] [--device cuda] \\
        [--auto_resume] [--load_path P [--start_epoch E0]]

    torchrun --nproc_per_node=<cards> -m \\
        deep3dpointclouddenoising_torch.train_discriminator --multihost \\
        [--dist_backend nccl|gloo] ...the same flags...

Checkpoints go to ``L/<experiment_name>/current.pt`` and
``ckpt_epoch_<E>.pt``, which ``train_gan --load_path_discriminator``
reads.  ``--load_path P`` restores P's whole train state, else
``--auto_resume`` the run directory's newest, as the train entry point
does (``train.__main__.restore_run``).  The printed lines also go to
``L/<experiment_name>/log.txt``, and each epoch appends ``train/loss`` and
``val/accuracy`` (step = the epoch) to ``metrics.jsonl`` there, as the JAX
script writes them.

``--multihost`` runs data-parallel as the train entry point does
(``train/__main__.py``): ``--batch_size`` stays the global batch, each
rank assembles its ``process_slice`` of every batch (the validation
loader drops a ragged last batch), the coordinator builds the datasets'
caches first and writes the logs and checkpoints alone, and the losses
and accuracies are the global batch's.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from .data.loader import BatchLoader
from .train import __main__ as _train_cli
from .parallel.dist import (coordinator_first, host_barrier, rank,
                            world_size)
from .train.gan import GANTrainer
from .utils.logger import run_logs
from .utils.metrics import AverageMeter


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Pre-train; returns a summary: every printed loss, the validation
    accuracies, ms per step of each epoch (host clock), the step count,
    the last checkpoint, what was restored and the trainer."""
    args = _train_cli.parse_args(argv, "discriminator")
    with _train_cli.run_device(args) as device:
        cfg = _train_cli.load_run_config(args)
        train_ds, val_ds = coordinator_first(lambda: (
            _train_cli.offset_dataset(cfg, "train", int(cfg.epochs)),
            _train_cli.offset_dataset(cfg, "val", 1)), "datasets")
        run = _train_cli.run_dir(cfg, args.log_dir)
        with run_logs(run) as (logger, writer):
            return _pretrain(cfg, args, device, train_ds, val_ds, run,
                             logger, writer)


def _pretrain(cfg, args, device, train_ds, val_ds, run, logger,
              writer) -> Dict[str, Any]:
    batch_size = int(cfg.batch_size)
    rows = _train_cli.process_slice(batch_size)  # raises unless it splits
    world = world_size()
    loader = BatchLoader(train_ds, batch_size, drop_last=True, rank=rank(),
                         world=world)
    val_loader = BatchLoader(val_ds, batch_size, drop_last=world > 1,
                             rank=rank(), world=world)
    logger.info(f"device {device}; train patches {len(train_ds)} "
                f"({len(loader)} steps per epoch), val patches "
                f"{len(val_ds)}")
    _train_cli.log_data_parallel(logger, rows, batch_size)
    trainer = GANTrainer(cfg, len(loader),
                         torch.Generator().manual_seed(int(cfg.rng_seed)),
                         device)
    block = trainer.blocks["discriminator"]
    restored = _train_cli.restore_run(block, cfg, run, len(loader),
                                      auto_resume=args.auto_resume)
    host_barrier("startup")
    summary: Dict[str, Any] = {"train_losses": [], "val_accuracy": [],
                               "ms_per_step": [], "val_batches": 0,
                               "restored": restored}
    checkpoint = None
    for epoch in range(int(cfg.start_epoch), int(cfg.epochs) + 1):
        meter = AverageMeter()
        pending: List = []  # (loss on the device, batch size)
        t0 = time.perf_counter()
        steps = 0
        for it, batch in enumerate(loader.epoch_iter(epoch - 1)):
            pending.append((trainer.pretrain_step(batch),
                            len(batch["points"])))
            steps += 1
            if it % int(cfg.print_freq) == 0:
                for value, n in pending:  # waits for the card here only
                    meter.update(value.item(), n)
                    summary["train_losses"].append(meter.val)
                pending.clear()
                logger.info(f"D [{epoch}/{cfg.epochs}][{it}/{len(loader)}] "
                            f"loss {meter.val:.6f} ({meter.avg:.6f})")
        for value, n in pending:
            meter.update(value.item(), n)
            summary["train_losses"].append(meter.val)
        _train_cli._sync(device)
        ms = (time.perf_counter() - t0) / max(steps, 1) * 1e3
        summary["ms_per_step"].append(ms)
        logger.info(f"epoch {epoch}: {steps} steps, loss {meter.avg:.6f}, "
                    f"{ms:.3f} ms per step (host clock, data loading "
                    f"included)")
        if writer is not None:  # the coordinator's
            writer.add_scalar("train/loss", meter.avg, epoch)
        if epoch % int(cfg.val_freq) == 0:
            acc = AverageMeter()
            accs = [(trainer.pretrain_accuracy(b), len(b["points"]))
                    for b in val_loader.epoch_iter(0)]
            for value, n in accs:
                acc.update(value.item(), n)
            summary["val_batches"] += len(accs)
            summary["val_accuracy"].append(acc.avg)
            logger.info(f"val [{epoch}] accuracy {acc.avg:.4f}")
            if writer is not None:
                writer.add_scalar("val/accuracy", acc.avg, epoch)
        checkpoint = _train_cli.save_epoch(run, block, epoch, cfg)
    summary.update(steps=trainer.step, checkpoint=checkpoint,
                   trainer=trainer)
    logger.info(f"trained {trainer.step} discriminator steps; checkpoint "
                f"{checkpoint}")
    host_barrier("shutdown")
    return summary


if __name__ == "__main__":
    main()

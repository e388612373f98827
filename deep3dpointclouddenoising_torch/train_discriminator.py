"""Discriminator pre-training on one card: clean against raw noisy clouds.

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

Checkpoints go to ``L/<experiment_name>/current.pt`` and
``ckpt_epoch_<E>.pt``, which ``train_gan --load_path_discriminator``
reads.  ``--load_path P`` restores P's whole train state, else
``--auto_resume`` the run directory's newest, as the train entry point
does (``train.__main__.restore_run``).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from .data.loader import BatchLoader
from .train import __main__ as _train_cli
from .train.gan import GANTrainer
from .utils.device import resolve_device
from .utils.metrics import AverageMeter


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Pre-train; returns a summary: every printed loss, the validation
    accuracies, ms per step of each epoch (host clock), the step count,
    the last checkpoint, what was restored and the trainer."""
    args = _train_cli.parse_args(argv, "discriminator")
    device = resolve_device(args.device)
    cfg = _train_cli.load_run_config(args)
    train_ds = _train_cli.offset_dataset(cfg, "train", int(cfg.epochs))
    val_ds = _train_cli.offset_dataset(cfg, "val", 1)
    batch_size = int(cfg.batch_size)
    loader = BatchLoader(train_ds, batch_size, drop_last=True)
    val_loader = BatchLoader(val_ds, batch_size)
    run = _train_cli.run_dir(cfg, args.log_dir)
    print(f"device {device}; train patches {len(train_ds)} ({len(loader)} "
          f"steps per epoch), val patches {len(val_ds)}", flush=True)
    trainer = GANTrainer(cfg, len(loader),
                         torch.Generator().manual_seed(int(cfg.rng_seed)),
                         device)
    block = trainer.blocks["discriminator"]
    restored = _train_cli.restore_run(block, cfg, run, len(loader),
                                      auto_resume=args.auto_resume)
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
                print(f"D [{epoch}/{cfg.epochs}][{it}/{len(loader)}] loss "
                      f"{meter.val:.6f} ({meter.avg:.6f})", flush=True)
        for value, n in pending:
            meter.update(value.item(), n)
            summary["train_losses"].append(meter.val)
        _train_cli._sync(device)
        ms = (time.perf_counter() - t0) / max(steps, 1) * 1e3
        summary["ms_per_step"].append(ms)
        print(f"epoch {epoch}: {steps} steps, loss {meter.avg:.6f}, "
              f"{ms:.3f} ms per step (host clock, data loading included)",
              flush=True)
        if epoch % int(cfg.val_freq) == 0:
            acc = AverageMeter()
            accs = [(trainer.pretrain_accuracy(b), len(b["points"]))
                    for b in val_loader.epoch_iter(0)]
            for value, n in accs:
                acc.update(value.item(), n)
            summary["val_batches"] += len(accs)
            summary["val_accuracy"].append(acc.avg)
            print(f"val [{epoch}] accuracy {acc.avg:.4f}", flush=True)
        checkpoint = _train_cli.save_epoch(run, block, epoch, cfg)
    summary.update(steps=trainer.step, checkpoint=checkpoint,
                   trainer=trainer)
    print(f"trained {trainer.step} discriminator steps; checkpoint "
          f"{checkpoint}", flush=True)
    return summary


if __name__ == "__main__":
    main()

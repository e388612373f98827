"""Adversarial fine-tuning of the offset model on one card.

Counterpart of ``scripts/train_gan.py``: the generator (the offset U-Net)
and the discriminator (the ResNet encoder and the discriminator head)
updated together by ``train.gan.GANTrainer`` over the ``train`` split
(with the config's train transforms), epoch after epoch, and both blocks'
checkpoints written per epoch::

    python -m deep3dpointclouddenoising_torch.train_gan \\
        --config_file cfgs/synthetic_quality_gan_tuned.yaml --data_root D \\
        --log_dir L [--load_path_generator G] [--load_path_discriminator P] \\
        [--num_steps S] [--epochs E] [--device cuda] [--auto_resume]

Checkpoints go to ``L/<experiment_name>/generator/`` and
``.../discriminator/``, each ``current.pt`` (every epoch) and
``ckpt_epoch_<E>.pt`` (every ``save_freq`` epochs and the last); ``infer
--checkpoint L/<experiment_name>/generator/current.pt`` serves the
generator.  ``--load_path_generator`` and ``--load_path_discriminator``
take a checkpoint's weights and BatchNorm statistics (the train entry
point's checkpoint and ``train_discriminator``'s, for instance) under
fresh optimizers.  ``--auto_resume`` restores both blocks' whole train
state from their directories and takes precedence over both, as in the
JAX script (:68-87); it goes on from the epoch after the one the
discriminator's checkpoint completed (the JAX script reads the
generator's step, which stays 0 under ``freeze_gen: 1``).  The random
draws of each update depend on its global step alone, so a resumed run
repeats an unbroken one bitwise.  The metrics are read back from the card
every ``print_freq`` updates.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import torch

from .data.loader import BatchLoader
from .data.transforms import build_train_transforms
from .train import __main__ as _train_cli
from .train.gan import METRICS, GANTrainer
from .utils.checkpoint import (load_checkpoint, load_weights,
                               resume_checkpoint)
from .utils.device import resolve_device
from .utils.metrics import AverageMeter


def restore_gan(trainer: GANTrainer, cfg, run: str, steps_per_epoch: int,
                load_path_generator: Optional[str] = None,
                load_path_discriminator: Optional[str] = None,
                auto_resume: bool = False) -> Dict[str, Optional[str]]:
    """With ``auto_resume`` and a checkpoint under ``run/generator``, both
    blocks' whole train state (``cfg.start_epoch`` set from the
    discriminator's step); else the weights of ``load_path_*``.  Returns
    what each block read."""
    restored: Dict[str, Optional[str]] = {k: None for k in trainer.blocks}
    if auto_resume and resume_checkpoint(os.path.join(run, "generator")):
        for name, block in trainer.blocks.items():
            path = resume_checkpoint(os.path.join(run, name))
            if path is None:
                raise FileNotFoundError(f"--auto_resume: {run}/generator "
                                        f"has a checkpoint, {run}/{name} "
                                        "none")
            load_checkpoint(path, block)
            restored[name] = path
        cfg.start_epoch = trainer.step // steps_per_epoch + 1
        print(f"auto-resumed from {run} at step {trainer.step} -> "
              f"start_epoch {cfg.start_epoch}", flush=True)
        return restored
    for name, path in (("generator", load_path_generator),
                       ("discriminator", load_path_discriminator)):
        if path:
            load_weights(path, trainer.blocks[name])
            restored[name] = path
            print(f"{name} weights from {path}", flush=True)
    return restored


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Fine-tune; returns a summary: each printed metric average, ms per
    update of each epoch (host clock), the update count, both blocks'
    last checkpoints, what was restored and the trainer."""
    args = _train_cli.parse_args(argv, "gan")
    device = resolve_device(args.device)
    cfg = _train_cli.load_run_config(args)
    train_ds = _train_cli.offset_dataset(cfg, "train", int(cfg.epochs),
                                         build_train_transforms(cfg))
    loader = BatchLoader(train_ds, int(cfg.batch_size), drop_last=True)
    run = _train_cli.run_dir(cfg, args.log_dir)
    print(f"device {device}; train patches {len(train_ds)} "
          f"({len(loader)} updates per epoch)", flush=True)
    trainer = GANTrainer(cfg, len(loader),
                         torch.Generator().manual_seed(int(cfg.rng_seed)),
                         device, freeze_generator=bool(cfg.freeze_gen))
    restored = restore_gan(trainer, cfg, run, len(loader),
                           args.load_path_generator,
                           args.load_path_discriminator, args.auto_resume)
    summary: Dict[str, Any] = {"metrics": {k: [] for k in METRICS},
                               "ms_per_update": [], "restored": restored}
    checkpoints: Dict[str, str] = {}
    for epoch in range(int(cfg.start_epoch), int(cfg.epochs) + 1):
        meters = {k: AverageMeter() for k in METRICS}
        pending: List = []  # (metrics on the device, batch size)

        def flush():
            for metrics, n in pending:  # waits for the card here only
                for k, m in meters.items():
                    m.update(metrics[k].item(), n)
                    summary["metrics"][k].append(m.val)
            pending.clear()

        t0 = time.perf_counter()
        updates = 0
        for it, batch in enumerate(loader.epoch_iter(epoch - 1)):
            pending.append((trainer.update(batch), len(batch["points"])))
            updates += 1
            if it % int(cfg.print_freq) == 0:
                flush()
                print(f"GAN [{epoch}/{cfg.epochs}][{it}/{len(loader)}] "
                      + " ".join(f"{k} {m.avg:.6f}"
                                 for k, m in meters.items()), flush=True)
        flush()
        _train_cli._sync(device)
        ms = (time.perf_counter() - t0) / max(updates, 1) * 1e3
        summary["ms_per_update"].append(ms)
        print(f"epoch {epoch}: {updates} updates, "
              + " ".join(f"{k} {m.avg:.6f}" for k, m in meters.items())
              + f", {ms:.3f} ms per update (host clock, data loading "
              "included)", flush=True)
        for name, block in trainer.blocks.items():
            checkpoints[name] = _train_cli.save_epoch(
                os.path.join(run, name), block, epoch, cfg)
    summary.update(steps=trainer.step, checkpoints=checkpoints,
                   trainer=trainer)
    print(f"trained {trainer.step} GAN updates; checkpoints "
          f"{checkpoints}", flush=True)
    return summary


if __name__ == "__main__":
    main()

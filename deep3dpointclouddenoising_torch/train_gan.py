"""Adversarial fine-tuning of the offset model on one card, or
data-parallel over torchrun's processes.

Counterpart of ``scripts/train_gan.py``: the generator (the offset U-Net)
and the discriminator (the ResNet encoder and the discriminator head)
updated together by ``train.gan.GANTrainer`` over the ``train`` split
(with the config's train transforms), epoch after epoch, and both blocks'
checkpoints written per epoch::

    python -m deep3dpointclouddenoising_torch.train_gan \\
        --config_file cfgs/synthetic_quality_gan_tuned.yaml --data_root D \\
        --log_dir L [--load_path_generator G] [--load_path_discriminator P] \\
        [--num_steps S] [--epochs E] [--device cuda] [--auto_resume]

    torchrun --nproc_per_node=<cards> -m \\
        deep3dpointclouddenoising_torch.train_gan --multihost \\
        [--dist_backend nccl|gloo] ...the same flags...

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
every ``print_freq`` updates.  The printed lines also go to
``L/<experiment_name>/log.txt``, and each epoch appends ``train/<metric>``
(each metric's average, step = the epoch) to ``metrics.jsonl`` there, as the
JAX script writes them.

``--multihost`` runs data-parallel as the train entry point does
(``train/__main__.py``): ``--batch_size`` stays the global batch, each
rank assembles its ``process_slice`` of every batch, the coordinator
builds the dataset's cache first, writes ``log.txt``, ``metrics.jsonl``
and both blocks' checkpoints alone, and every rank restores what it found
(``--auto_resume``); an update of W ranks equals the one-process update on
the global batch (``train.gan.GANTrainer``).
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import torch

from .data.loader import BatchLoader
from .data.transforms import build_train_transforms
from .train import __main__ as _train_cli
from .parallel.dist import (coordinator_first, coordinator_value,
                            host_barrier, rank, world_size)
from .train.gan import METRICS, GANTrainer
from .utils.checkpoint import (load_checkpoint, load_weights,
                               resume_checkpoint)
from .utils.logger import get_logger, run_logs
from .utils.metrics import AverageMeter


def restore_gan(trainer: GANTrainer, cfg, run: str, steps_per_epoch: int,
                load_path_generator: Optional[str] = None,
                load_path_discriminator: Optional[str] = None,
                auto_resume: bool = False) -> Dict[str, Optional[str]]:
    """With ``auto_resume`` and a checkpoint under ``run/generator``, both
    blocks' whole train state (``cfg.start_epoch`` set from the
    discriminator's step); else the weights of ``load_path_*``.  Returns
    what each block read.  In a process group every rank restores the
    files the coordinator found."""
    restored: Dict[str, Optional[str]] = {k: None for k in trainer.blocks}
    logger = get_logger()
    found = coordinator_value({name: resume_checkpoint(os.path.join(
        run, name)) for name in trainer.blocks}) if auto_resume else {}
    if found.get("generator"):
        for name, block in trainer.blocks.items():
            path = found[name]
            if path is None:
                raise FileNotFoundError(f"--auto_resume: {run}/generator "
                                        f"has a checkpoint, {run}/{name} "
                                        "none")
            load_checkpoint(path, block)
            restored[name] = path
        cfg.start_epoch = trainer.step // steps_per_epoch + 1
        logger.info(f"auto-resumed from {run} at step {trainer.step} -> "
                    f"start_epoch {cfg.start_epoch}")
        return restored
    for name, path in (("generator", load_path_generator),
                       ("discriminator", load_path_discriminator)):
        if path:
            load_weights(path, trainer.blocks[name])
            restored[name] = path
            logger.info(f"{name} weights from {path}")
    return restored


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Fine-tune; returns a summary: each printed metric average, ms per
    update of each epoch (host clock), the update count, both blocks'
    last checkpoints, what was restored and the trainer."""
    args = _train_cli.parse_args(argv, "gan")
    with _train_cli.run_device(args) as device:
        cfg = _train_cli.load_run_config(args)
        train_ds = coordinator_first(lambda: _train_cli.offset_dataset(
            cfg, "train", int(cfg.epochs), build_train_transforms(cfg)),
            "datasets")
        run = _train_cli.run_dir(cfg, args.log_dir)
        with run_logs(run) as (logger, writer):
            return _fine_tune(cfg, args, device, train_ds, run, logger,
                              writer)


def _fine_tune(cfg, args, device, train_ds, run, logger,
               writer) -> Dict[str, Any]:
    batch_size = int(cfg.batch_size)
    rows = _train_cli.process_slice(batch_size)  # raises unless it splits
    loader = BatchLoader(train_ds, batch_size, drop_last=True, rank=rank(),
                         world=world_size())
    logger.info(f"device {device}; train patches {len(train_ds)} "
                f"({len(loader)} updates per epoch)")
    _train_cli.log_data_parallel(logger, rows, batch_size)
    trainer = GANTrainer(cfg, len(loader),
                         torch.Generator().manual_seed(int(cfg.rng_seed)),
                         device, freeze_generator=bool(cfg.freeze_gen))
    restored = restore_gan(trainer, cfg, run, len(loader),
                           args.load_path_generator,
                           args.load_path_discriminator, args.auto_resume)
    host_barrier("startup")
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
                logger.info(f"GAN [{epoch}/{cfg.epochs}][{it}/{len(loader)}] "
                            + " ".join(f"{k} {m.avg:.6f}"
                                       for k, m in meters.items()))
        flush()
        _train_cli._sync(device)
        ms = (time.perf_counter() - t0) / max(updates, 1) * 1e3
        summary["ms_per_update"].append(ms)
        logger.info(f"epoch {epoch}: {updates} updates, "
                    + " ".join(f"{k} {m.avg:.6f}" for k, m in meters.items())
                    + f", {ms:.3f} ms per update (host clock, data loading "
                    "included)")
        for k, m in meters.items():
            if writer is not None:  # the coordinator's
                writer.add_scalar(f"train/{k}", m.avg, epoch)
        for name, block in trainer.blocks.items():
            checkpoints[name] = _train_cli.save_epoch(
                os.path.join(run, name), block, epoch, cfg)
    summary.update(steps=trainer.step, checkpoints=checkpoints,
                   trainer=trainer)
    logger.info(f"trained {trainer.step} GAN updates; checkpoints "
                f"{checkpoints}")
    host_barrier("shutdown")
    return summary


if __name__ == "__main__":
    main()

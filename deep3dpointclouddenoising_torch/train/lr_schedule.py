"""Per-iteration learning-rate schedules.

Counterpart of ``deep3dpointclouddenoising_tpu/train/lr_schedule.py:19-62``:
multi-step decay every ``lr_decay_steps`` epochs (stepped per iteration),
cosine annealing to 1e-6, the milestone-free ``step_PCN`` variant, and the
linear warmup from ``base_lr / warmup_multiplier`` over ``warmup_epoch``
epochs.  A schedule is a plain function from the step (0-based count of
updates done) to a float.
"""
from __future__ import annotations

import bisect
import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def get_lr_schedule(cfg, n_iter_per_epoch: int,
                    base_lr: Optional[float] = None) -> Schedule:
    base = float(base_lr if base_lr is not None else cfg.base_learning_rate)
    warmup_epoch = max(int(cfg.warmup_epoch), 0)
    warmup_steps = warmup_epoch * n_iter_per_epoch

    name = cfg.lr_scheduler
    if "cosine" in name:
        t_max = max((int(cfg.epochs) - warmup_epoch) * n_iter_per_epoch, 1)
        eta_min = 1e-6

        def after(step: int) -> float:
            t = min(step, t_max)
            return eta_min + (base - eta_min) * 0.5 * (
                1.0 + math.cos(math.pi * t / t_max))
    elif name == "step":
        decay_epochs = int(cfg.lr_decay_steps)
        rate = float(cfg.lr_decay_rate)
        n_milestones = max(int(cfg.epochs) // decay_epochs - 1, 0)
        boundaries = [(decay_epochs * i - warmup_epoch) * n_iter_per_epoch
                      for i in range(1, n_milestones + 1)]

        def after(step: int) -> float:
            # milestones passed: boundaries are ascending
            return base * rate ** bisect.bisect_right(boundaries, step)
    elif name == "step_PCN":
        def after(step: int) -> float:
            return base
    else:
        raise NotImplementedError(f"scheduler {name} not supported")

    if warmup_steps <= 0:
        return after

    mult = float(cfg.warmup_multiplier)

    def schedule(step: int) -> float:
        if step <= warmup_steps:
            return base / mult * ((mult - 1.0) * step / warmup_steps + 1.0)
        return after(step - warmup_steps)

    return schedule

"""Loss selection by config name.

Counterpart of ``get_offset_regression_loss`` in
``deep3dpointclouddenoising_tpu/losses/build.py:29-48``.  The losses are
callables ``loss(pred, target, mask, points=None) -> scalar``.
"""
from __future__ import annotations

from typing import Callable

import torch

from .masked import masked_l1_loss

LossFn = Callable[..., torch.Tensor]


def get_offset_regression_loss(name: str) -> LossFn:
    """loss(pred, target, mask, points) -> scalar.  Only ``"L1"`` is
    ported; the Chamfer losses are queued in ROADMAP.md."""
    if name == "L1":
        return lambda pred, target, mask, points=None: \
            masked_l1_loss(pred, target, mask)
    raise NotImplementedError(
        f"loss {name!r} is not ported yet; the port's queue (Chamfer "
        "losses and the rest) is in ROADMAP.md")

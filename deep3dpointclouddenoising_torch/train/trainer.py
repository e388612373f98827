"""The optimizer chain and the one-card Trainer.

Counterpart of ``deep3dpointclouddenoising_tpu/train/trainer.py``:
``make_optimizer`` (:35-70) and the ``Trainer``'s init, train, eval and
predict steps (:73-367), for one card.  The JAX package's device mesh, its
point-sharded path and its scan-chunked dispatch have no counterpart here;
data parallelism is queued in ROADMAP.md.

The optimizer applies optax's order: clip the gradients to their global
norm, add ``weight_decay * param`` (sgd, adam), then Adam or SGD momentum
(for adamW the decoupled decay after Adam), then ``-schedule(count)`` with
``count`` the number of updates done, starting at 0.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..losses.build import (get_complete_denoising_loss,
                            get_offset_regression_loss)
from ..losses.masked import masked_cross_entropy
from ..models import (build_complete_denoising, build_offset_regression,
                      build_scene_segmentation)
from ..utils.device import resolve_device
from .lr_schedule import Schedule, get_lr_schedule


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> None:
    """optax.clip_by_global_norm in place: every gradient times
    ``max_norm / norm`` when the global norm is at least ``max_norm``,
    unchanged below it (``clip_grad_norm_`` would divide by
    ``norm + 1e-6`` always).  Nothing waits for the device."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


class ChainedOptimizer:
    """Clip, then a torch optimizer stepped at ``lr = schedule(count)``.

    The torch optimizer carries the additive L2 (its ``weight_decay`` for
    sgd and adam) or the decoupled decay (AdamW)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 optimizer: torch.optim.Optimizer, schedule: Schedule,
                 grad_clip_norm: float):
        self.params = list(params)
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.count = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.grad_clip_norm > 0 and grads:
            clip_by_global_norm_(grads, self.grad_clip_norm)
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer.state_dict(),
                "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter],
                   n_iter_per_epoch: int, world_size: int = 1
                   ) -> Tuple[ChainedOptimizer, Schedule]:
    """Optimizer and per-iteration LR schedule.

    SGD scales the LR by ``batch_size * world_size / 8``;
    ``weight_decay`` is additive L2 for sgd and adam and decoupled for
    adamW; gradients are clipped to the global norm ``grad_clip_norm``
    first.
    """
    name = cfg.optimizer
    wd = float(cfg.weight_decay)
    if name == "sgd":
        base_lr = (float(cfg.batch_size) * world_size / 8.0
                   * float(cfg.base_learning_rate))
    else:
        base_lr = float(cfg.base_learning_rate)
    schedule = get_lr_schedule(cfg, n_iter_per_epoch, base_lr=base_lr)
    params = list(params)
    lr0 = schedule(0)
    if name == "sgd":
        opt = torch.optim.SGD(params, lr=lr0, momentum=float(cfg.momentum),
                              weight_decay=wd)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=lr0, weight_decay=wd)
    elif name == "adamW":
        opt = torch.optim.AdamW(params, lr=lr0, weight_decay=wd)
    else:
        raise NotImplementedError(f"Optimizer {name} not supported")
    return (ChainedOptimizer(params, opt, schedule,
                             float(cfg.grad_clip_norm)), schedule)


Batch = Dict[str, np.ndarray]


class Trainer:
    """A model, its loss and its optimizer on one device.

    ``loss_mode`` selects the task and the loss's call:

    * ``"offset"``: the offset-regression model,
      ``loss(pred, offsets, mask, points)``;
    * ``"full_cleaning"``: the full-cleaning model (four outputs),
      ``loss(pred, offsets, labels, mask)``;
    * ``"segmentation"``: the scene-segmentation model
      (``cfg.num_classes`` logits), ``loss(logits, labels, mask)``.

    ``batch`` is a dict of numpy arrays (or tensors) with ``points``
    (B, N, 3), ``mask`` (B, N), ``features`` (B, N, C), ``labels`` (B, N)
    and, but for segmentation, ``offsets`` (B, N, 3), as the datasets'
    ``get`` and ``collate`` make them.  The model's initial weights come
    from ``generator``.
    """

    def __init__(self, cfg: Config, n_iter_per_epoch: int,
                 generator: Optional[torch.Generator] = None, device=None,
                 loss_fn: Optional[Callable] = None,
                 loss_mode: str = "offset"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.loss_mode = loss_mode
        if loss_mode == "offset":
            model = build_offset_regression(cfg, generator)
            default_loss = get_offset_regression_loss(cfg.loss)
        elif loss_mode == "full_cleaning":
            model = build_complete_denoising(cfg, generator)
            default_loss = get_complete_denoising_loss(
                cfg.loss, float(cfg.in_radius))
        elif loss_mode == "segmentation":
            model = build_scene_segmentation(cfg, generator)
            default_loss = masked_cross_entropy
        else:
            raise ValueError(f"loss_mode {loss_mode!r} is not ported")
        self.model = model.to(self.device)
        self.loss_fn = loss_fn or default_loss
        self.optimizer, self.lr_schedule = make_optimizer(
            cfg, self.model.parameters(), n_iter_per_epoch)

    @property
    def step(self) -> int:
        """Updates done so far."""
        return self.optimizer.count

    def _inputs(self, batch: Batch, *keys: str) -> List[torch.Tensor]:
        return [torch.as_tensor(np.ascontiguousarray(batch[k])
                                if isinstance(batch[k], np.ndarray)
                                else batch[k]).to(self.device,
                                                  non_blocking=True)
                for k in keys]

    def _loss(self, batch: Batch) -> torch.Tensor:
        points, mask, features = self._inputs(batch, "points", "mask",
                                              "features")
        pred = self.model(points, mask, features)
        if self.loss_mode == "segmentation":
            labels, = self._inputs(batch, "labels")
            return self.loss_fn(pred, labels, mask)
        offsets, = self._inputs(batch, "offsets")
        if self.loss_mode == "full_cleaning":
            labels, = self._inputs(batch, "labels")
            return self.loss_fn(pred, offsets, labels, mask)
        return self.loss_fn(pred, offsets, mask, points)

    def train_step(self, batch: Batch) -> torch.Tensor:
        """One update; returns the loss on the device without waiting for
        it."""
        self.model.train()
        loss = self._loss(batch)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def eval_step(self, batch: Batch) -> torch.Tensor:
        """The loss in eval mode (running BatchNorm statistics)."""
        self.model.eval()
        with torch.no_grad():
            return self._loss(batch)

    def predict(self, batch: Batch) -> torch.Tensor:
        self.model.eval()
        with torch.no_grad():
            points, mask, features = self._inputs(batch, "points", "mask",
                                                  "features")
            return self.model(points, mask, features)

"""The PointCleanNet-baseline trainer on one card.

Counterpart of ``deep3dpointclouddenoising_tpu/train/pcn.py``: the
``ResPCPNet`` forward on raw patches, its prediction rotated back through
the point STN (``pred @ trans^T``), and the losses

* ``L1``: the mean absolute difference from the centre's offset (slot 0
  of a training patch's offsets, or a test patch's one offset);
* ``original`` / ``original_no_reg``: :func:`surface_dist` from the
  predicted point to the patch's clean points (points + offsets), with and
  without the 0.99 / 0.01 min / max regularisation;

losses other than ``L1`` see points and offsets divided by ``in_radius``.
The optimizer chain is ``trainer.make_optimizer``'s (``step_PCN``, sgd,
adam).  The JAX package's scan-chunked dispatch has no counterpart: every
step is its own dispatch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..models import build_offset_regression_PCN
from ..utils.device import resolve_device
from .trainer import make_optimizer

Batch = Dict[str, np.ndarray]


def surface_dist(pred: torch.Tensor, target: torch.Tensor,
                 regularization: bool = False) -> torch.Tensor:
    """Mean over the batch of the least squared distance from ``pred``
    (B, 3) to the points of ``target`` (B, N, 3), times 100; with
    ``regularization``, 0.99 of the least plus 0.01 of the largest."""
    d = torch.sum((target - pred[:, None, :]) ** 2, dim=-1)
    min_d = torch.amin(d, dim=1)
    if regularization:
        alpha = 0.99
        return torch.mean(alpha * min_d + (1 - alpha)
                          * torch.amax(d, dim=1)) * 100.0
    return torch.mean(min_d) * 100.0


def rotate_back(pred: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """The prediction in the patch's frame: ``pred @ trans^T`` per patch
    (``bd,bed->be``)."""
    return torch.bmm(trans, pred[:, :, None])[:, :, 0]


class PCNTrainer:
    """The ResPCPNet baseline, its loss (``cfg.loss``) and its optimizer
    on one device; the initial weights come from ``generator``.  A batch
    holds ``points`` (B, N, 3) and ``offsets`` ((B, N, 3), or (B, 3) in a
    test split), as the PCN ``OffsetDataset`` makes them."""

    def __init__(self, cfg: Config, n_iter_per_epoch: int,
                 generator: Optional[torch.Generator] = None, device=None):
        if cfg.loss not in ("L1", "original", "original_no_reg"):
            raise ValueError(
                f"Loss {cfg.loss} not implemented for the PCN pipeline")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.loss_name = cfg.loss
        self.in_radius = float(cfg.in_radius)
        self.model = build_offset_regression_PCN(cfg, generator).to(
            self.device)
        self.optimizer, self.lr_schedule = make_optimizer(
            cfg, self.model.parameters(), n_iter_per_epoch)

    @property
    def step(self) -> int:
        """Updates done so far."""
        return self.optimizer.count

    def _normalized(self, batch: Batch) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        points, offsets = (torch.as_tensor(batch[k]).to(self.device)
                           for k in ("points", "offsets"))
        if self.loss_name != "L1":
            points = points / self.in_radius
            offsets = offsets / self.in_radius
        return points, offsets

    def _loss(self, points: torch.Tensor, offsets: torch.Tensor
              ) -> torch.Tensor:
        pred, trans, _ = self.model(points)
        pred = rotate_back(pred, trans)
        if self.loss_name == "L1":
            target = offsets[:, 0, :] if offsets.ndim == 3 else offsets
            return torch.mean(torch.abs(pred - target))
        return surface_dist(pred, points + offsets,
                            regularization=self.loss_name == "original")

    def train_step(self, batch: Batch) -> torch.Tensor:
        """One update; returns the loss on the device without waiting for
        it."""
        self.model.train()
        loss = self._loss(*self._normalized(batch))
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def eval_step(self, batch: Batch) -> torch.Tensor:
        """The loss in eval mode (running BatchNorm statistics)."""
        self.model.eval()
        with torch.no_grad():
            return self._loss(*self._normalized(batch))

    def predict(self, points) -> torch.Tensor:
        """(B, 3) offsets of the patch centres, rotated back, in the
        units of ``points`` (no ``in_radius`` scaling)."""
        self.model.eval()
        with torch.no_grad():
            pred, trans, _ = self.model(torch.as_tensor(points).to(
                self.device))
            return rotate_back(pred, trans)

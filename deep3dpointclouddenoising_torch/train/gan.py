"""Adversarial fine-tuning and discriminator pre-training on one card.

Counterpart of ``deep3dpointclouddenoising_tpu/train/gan.py``'s
``GANTrainer``: ``init_states`` (:118-136), the joint update ``_update``
(:161-220), ``_pretrain_step`` (:258-278) and ``_pretrain_accuracy``
(:295-305).  Its scan-chunked dispatch and device mesh are TPU mechanisms
and have no counterpart here.

* D-step: the discriminator sees ``concat(clean, fake)``, ``clean =
  points + offsets`` and ``fake = points + G(points)`` (the generator in
  train mode, without gradient, its BatchNorm statistics discarded), under
  ``BCE * alpha``; it keeps its new statistics.
* G-step: ``err_g = alpha * BCE(D(points + G(points)), real labels with
  5% flipped) + task loss``, the discriminator in eval mode with the
  D-step's weights and statistics and out of autograd, so the backward
  asks no ``d_kernel_weights`` and no gradient of it; the generator keeps
  its new statistics.  The gradient reaches the generator through the
  discriminator's input features (the points) and through the relative
  positions of the level-0 neighbourhoods (``d_rel``).
* ``freeze_generator``: the generator's whole state stays as it was.
* Pre-training: clean against the raw noisy points, unscaled BCE; the
  accuracy at the 0.5 threshold.

The random draws of update ``s`` (the label flips, and the D-step's or a
pre-training step's dropout masks) come from generators seeded by
``(cfg.rng_seed, s)`` (:func:`step_generator`), with ``s`` the
discriminator's update count, so a resumed run draws what an unbroken run
draws.  The tests feed both packages JAX's draws instead.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..losses.build import get_offset_regression_loss
from ..losses.masked import masked_binary_cross_entropy
from ..models import build_discriminator, build_offset_regression
from ..utils.device import resolve_device
from .trainer import ChainedOptimizer, make_optimizer

REAL_LABEL = 1.0
FAKE_LABEL = 1.0 - REAL_LABEL
ALPHA = 0.01
LABEL_FLIP_P = 0.05
METRICS = ("err_g", "err_g1", "err_g2", "err_d", "disc_accuracy")
# the streams of one update's draws
FLIP_STREAM, DROPOUT_STREAM = 0, 1

Batch = Dict[str, np.ndarray]


def bce(prob: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The discriminator's loss: binary cross-entropy of probabilities,
    mean over the batch."""
    return masked_binary_cross_entropy(prob, target, torch.ones_like(prob))


def step_generator(seed: int, step: int, stream: int) -> torch.Generator:
    """A host generator seeded by (``seed``, ``step``, ``stream``)."""
    state = np.random.SeedSequence((int(seed), int(step), int(stream)))
    return torch.Generator().manual_seed(int(state.generate_state(1)[0]))


@contextlib.contextmanager
def kept_batch_stats(model: nn.Module) -> Iterator[None]:
    """Run ``model`` and leave its buffers (BatchNorm running statistics
    and counts) as they were: the JAX package applies a train-mode forward
    whose new statistics it throws away."""
    saved = [(b, b.clone()) for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for buf, value in saved:
                buf.copy_(value)


@contextlib.contextmanager
def out_of_autograd(model: nn.Module) -> Iterator[None]:
    """``model``'s parameters take no gradient inside the block."""
    flags = [p.requires_grad for p in model.parameters()]
    model.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(model.parameters(), flags):
            p.requires_grad_(flag)


class Block:
    """A model with its optimizer, the unit that a checkpoint holds
    (``utils.checkpoint`` reads ``model``, ``optimizer`` and ``step``)."""

    def __init__(self, model: nn.Module, optimizer: ChainedOptimizer):
        self.model = model
        self.optimizer = optimizer

    @property
    def step(self) -> int:
        return self.optimizer.count


class GANTrainer:
    """The generator (the offset U-Net) and the discriminator on one
    device, each with the config's optimizer and LR schedule.

    Both models' initial weights come from ``generator`` (the offset model
    first).  ``gen_loss`` is the generator's task loss (default the
    config's offset loss), ``loss(pred, offsets, mask, points)``.  The
    adversarial weight is ``cfg.gan_alpha``.  ``batch`` is a dict of numpy
    arrays (or tensors) with ``points``, ``mask``, ``features`` and
    ``offsets``, as the offset dataset's ``collate`` makes them.
    """

    def __init__(self, cfg: Config, n_iter_per_epoch: int,
                 generator: Optional[torch.Generator] = None, device=None,
                 gen_loss: Optional[Callable] = None,
                 freeze_generator: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = build_offset_regression(cfg, generator).to(
            self.device)
        self.discriminator = build_discriminator(cfg, generator).to(
            self.device)
        self.gen_loss = gen_loss or get_offset_regression_loss(cfg.loss)
        self.freeze_generator = freeze_generator
        self.alpha = float(getattr(cfg, "gan_alpha", ALPHA))
        self.seed = int(cfg.rng_seed)
        opt_g, self.lr_g = make_optimizer(cfg, self.generator.parameters(),
                                          n_iter_per_epoch)
        opt_d, self.lr_d = make_optimizer(
            cfg, self.discriminator.parameters(), n_iter_per_epoch)
        self.blocks = {"generator": Block(self.generator, opt_g),
                       "discriminator": Block(self.discriminator, opt_d)}

    @property
    def step(self) -> int:
        """Updates done: the discriminator's count, which advances at every
        update and pre-training step, the generator frozen or not."""
        return self.blocks["discriminator"].step

    def _inputs(self, batch: Batch, *keys: str) -> List[torch.Tensor]:
        return [torch.as_tensor(np.ascontiguousarray(batch[k])
                                if isinstance(batch[k], np.ndarray)
                                else batch[k]).to(self.device,
                                                  non_blocking=True)
                for k in keys]

    def _pairs(self, batch: Batch, fake: bool):
        """``concat(clean, x)`` with ``x`` the generator's output (``fake``:
        the points plus its offsets, without gradient) or the raw noisy
        points, their masks, labels (real, then fake) and the batch's
        tensors."""
        points, mask, features, offsets = self._inputs(
            batch, "points", "mask", "features", "offsets")
        b = points.shape[0]
        if fake:
            self.generator.train()
            with torch.no_grad(), kept_batch_stats(self.generator):
                other = points + self.generator(points, mask, features)
        else:
            other = points
        pts2 = torch.cat([points + offsets, other])
        labels2 = torch.cat([torch.full((b,), REAL_LABEL),
                             torch.full((b,), FAKE_LABEL)]).to(self.device)
        return pts2, torch.cat([mask, mask]), labels2, \
            (points, mask, features, offsets)

    def _disc(self, points: torch.Tensor, mask: torch.Tensor,
              dropout: Optional[torch.Generator] = None,
              keep_masks: Optional[Sequence[torch.Tensor]] = None
              ) -> torch.Tensor:
        """The discriminator's (B,) probabilities; its features are the
        points themselves."""
        return self.discriminator(points, mask, points, dropout,
                                  keep_masks).reshape(-1)

    def _disc_train_step(self, pts2, mask2, labels2, scale: float,
                         keep_masks):
        """One train-mode step of the discriminator under ``BCE * scale``;
        returns its output and the loss, without gradient."""
        d = self.blocks["discriminator"]
        self.discriminator.train()
        dropout = None if keep_masks is not None else step_generator(
            self.seed, self.step, DROPOUT_STREAM)
        out = self._disc(pts2, mask2, dropout, keep_masks)
        loss = bce(out, labels2) * scale
        d.optimizer.zero_grad()
        loss.backward()
        d.optimizer.step()
        return out.detach(), loss.detach()

    @staticmethod
    def _accuracy(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return 1.0 - torch.mean(torch.abs((out > 0.5).float() - labels))

    def update(self, batch: Batch, flip: Optional[torch.Tensor] = None,
               keep_masks: Optional[Sequence[torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
        """One GAN update (D-step, then G-step); returns the metrics
        ``METRICS`` as device scalars, without waiting for them.

        ``flip`` (B,) bool marks the G-step's flipped labels and
        ``keep_masks`` the D-step's three dropout keep-masks; by default
        both are drawn from :func:`step_generator` at this update."""
        step = self.step
        if flip is None:
            flip = torch.rand(len(batch["points"]), generator=step_generator(
                self.seed, step, FLIP_STREAM)) < LABEL_FLIP_P
        pts2, mask2, labels2, (points, mask, features, offsets) = \
            self._pairs(batch, fake=True)
        d_out, err_d = self._disc_train_step(pts2, mask2, labels2,
                                             self.alpha, keep_masks)
        d_acc = self._accuracy(d_out, labels2)

        g_labels = REAL_LABEL * (1.0 - flip.to(self.device).float())
        g = self.blocks["generator"]
        self.generator.train()
        self.discriminator.eval()
        frozen = self.freeze_generator
        with out_of_autograd(self.discriminator), \
                (kept_batch_stats(self.generator) if frozen
                 else contextlib.nullcontext()), \
                torch.set_grad_enabled(not frozen):
            pred = self.generator(points, mask, features)
            err_g1 = bce(self._disc(points + pred, mask), g_labels)
            err_g2 = self.gen_loss(pred, offsets, mask, points)
            err_g = err_g1 * self.alpha + err_g2
            if not frozen:
                g.optimizer.zero_grad()
                err_g.backward()
                g.optimizer.step()
        return {"disc_accuracy": d_acc, "err_d": err_d,
                "err_g1": err_g1.detach(), "err_g2": err_g2.detach(),
                "err_g": err_g.detach()}

    def pretrain_step(self, batch: Batch,
                      keep_masks: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
        """One pre-training step of the discriminator (clean against raw
        noisy, unscaled BCE); returns the loss on the device.
        ``keep_masks`` as for :meth:`update`."""
        pts2, mask2, labels2, _ = self._pairs(batch, fake=False)
        return self._disc_train_step(pts2, mask2, labels2, 1.0,
                                     keep_masks)[1]

    def pretrain_accuracy(self, batch: Batch) -> torch.Tensor:
        """The eval-mode discriminator's accuracy at 0.5 on clean against
        raw noisy."""
        pts2, mask2, labels2, _ = self._pairs(batch, fake=False)
        self.discriminator.eval()
        with torch.no_grad():
            return self._accuracy(self._disc(pts2, mask2), labels2)

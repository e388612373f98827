"""The optimizer chain and the Trainer, on one card or data-parallel.

Counterpart of ``deep3dpointclouddenoising_tpu/train/trainer.py``:
``make_optimizer`` (:35-70) and the ``Trainer``'s init, train, eval and
predict steps (:73-367).  JAX's 1-D ``data`` mesh is a process group here
(``parallel/dist.py``, one process per card under ``torchrun``): inside
one the Trainer wraps its model in ``DistributedDataParallel``, each rank
steps on its rows of the global batch, and a step of W ranks equals the
one-process step on the global batch, as JAX's sharded jit equals its
one-device jit.  With ``spatial=True`` (JAX's ``Trainer(spatial=True)``,
:91-96,119-121) the ranks split each cloud's point axis instead of the
batch (``parallel/spatial.py``); with ``spatial="2d"`` and a
``parallel.dist.make_mesh_2d`` layout (JAX :97-104,113-118) they split
the batch over the data axis and each cloud's points within the points
axis.  The scan-chunked dispatch has no counterpart here.

The optimizer applies optax's order: clip the gradients to their global
norm, add ``weight_decay * param`` (sgd, adam), then Adam or SGD momentum
(for adamW the decoupled decay after Adam), then ``-schedule(count)`` with
``count`` the number of updates done, starting at 0.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..config import Config
from ..losses.build import (get_complete_denoising_loss,
                            get_offset_regression_loss)
from ..losses.masked import masked_cross_entropy
from ..models import (build_complete_denoising, build_offset_regression,
                      build_scene_segmentation)
from ..parallel.dist import (Mesh2D, global_sum, is_distributed,
                             point_rows, world_size)
from ..parallel.spatial import build_spatial_model
from ..utils.device import resolve_device
from .lr_schedule import Schedule, get_lr_schedule


def _sum_hook(process_group, bucket):
    """DDP's gradient all-reduce without its division by the world size:
    each rank's loss is already its share of the global loss (its own
    numerator over the global denominator, ``losses/``), so the SUM of the
    ranks' gradients is the global loss's gradient."""
    return dist.all_reduce(bucket.buffer(), group=process_group,
                           async_op=True).get_future().then(
        lambda fut: fut.value()[0])


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

# the spatial model of each loss mode
SPATIAL_KINDS = {"offset": "offset_regression",
                 "full_cleaning": "complete_denoising",
                 "segmentation": "scene_segmentation"}


def _check_spatial() -> None:
    """Refuse what point-sharded training cannot do, as JAX does
    (``train/trainer.py:226-229``): a job of several hosts (torchrun's
    ``LOCAL_WORLD_SIZE`` below its ``WORLD_SIZE``)."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if is_distributed() and local is not None \
            and int(local) < world_size():
        raise NotImplementedError(
            "point-sharded training splits one cloud over the cards of one "
            "host; this job spans several (LOCAL_WORLD_SIZE "
            f"{local} < WORLD_SIZE {world_size()})")


class Trainer:
    """A model, its loss and its optimizer on one device, or on each rank
    of a process group.

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

    Inside a process group ``batch`` is this rank's rows of the global
    batch; the model trains through ``DistributedDataParallel``
    (``broadcast_buffers=False``: the cross-rank BatchNorm keeps the
    running statistics equal) with :func:`_sum_hook`, so every rank ends
    ``backward`` with the global batch's gradient, which the clip then
    sees; the LR scaling of SGD counts the world size, as JAX's
    (``train/trainer.py:123-126``).  ``model`` stays the module itself, so
    checkpoints keep their names across world sizes.  The losses that
    :meth:`train_step` and :meth:`eval_step` return are the global
    batch's, on every rank.

    ``spatial=True`` is point-sharded training (JAX's
    ``Trainer(spatial=True)``): every rank is given the whole batch, the
    model is ``parallel.spatial.build_spatial_model``'s, and each rank
    takes its ``point_rows`` of every cloud's point axis, not rows of the
    batch.  The cross-rank BatchNorm then spans every point, the losses'
    global denominators make the ranks' shares sum to the whole clouds'
    loss and DDP's :func:`_sum_hook` sums the gradients; the LR counts a
    world of 1 (JAX :120).  Every loss is taken: an offset loss is given
    this rank's rows of the prediction and the whole clouds' offsets,
    mask and points (``losses.build.get_offset_regression_loss`` with
    ``spatial``: the Chamfer losses search the whole clouds), the
    full-cleaning and segmentation losses, which are pointwise, this
    rank's rows of everything.  As in JAX (:226-229), a job that spans
    several hosts is refused.

    ``spatial="2d"`` with ``mesh`` (``parallel.dist.make_mesh_2d``) is
    JAX's ``Trainer(spatial="2d")`` on its ``(data, points)`` mesh:
    ``batch`` is this rank's ``mesh.batch_rows`` of the global batch, and
    each rank takes the ``point_rows`` of its points group of those
    clouds.  BatchNorm, the losses' denominators and the gradient sum
    still span every rank (JAX's batch is sharded over both axes); the LR
    of SGD counts ``mesh.n_data`` (JAX :113-114).
    """

    def __init__(self, cfg: Config, n_iter_per_epoch: int,
                 generator: Optional[torch.Generator] = None, device=None,
                 loss_fn: Optional[Callable] = None,
                 loss_mode: str = "offset", spatial=False,
                 mesh: Optional[Mesh2D] = None):
        if spatial not in (False, True, "2d"):
            raise ValueError(f"spatial {spatial!r}: False, True or '2d'")
        if (spatial == "2d") != (mesh is not None):
            raise ValueError("spatial='2d' takes the 2-D layout of "
                             "parallel.dist.make_mesh_2d as mesh, and only "
                             "it does")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.loss_mode = loss_mode
        self.spatial = spatial
        self.points_group = None if mesh is None else mesh.points_group
        if loss_mode == "offset":
            build = build_offset_regression
            default_loss = get_offset_regression_loss(
                cfg.loss, bool(spatial), self.points_group)
        elif loss_mode == "full_cleaning":
            build = build_complete_denoising
            default_loss = get_complete_denoising_loss(
                cfg.loss, float(cfg.in_radius))
        elif loss_mode == "segmentation":
            build = build_scene_segmentation
            default_loss = masked_cross_entropy
        else:
            raise ValueError(f"loss_mode {loss_mode!r} is not ported")
        if spatial:
            _check_spatial()
            model = build_spatial_model(cfg, SPATIAL_KINDS[loss_mode],
                                        generator, mesh)
        else:
            model = build(cfg, generator)
        self.model = model.to(self.device)
        self._train_model = self.model
        if is_distributed():
            self._train_model = DistributedDataParallel(
                self.model, device_ids=None if self.device.type == "cpu"
                else [self.device], broadcast_buffers=False)
            self._train_model.register_comm_hook(None, _sum_hook)
        self.loss_fn = loss_fn or default_loss
        lr_world = mesh.n_data if mesh is not None \
            else 1 if spatial else world_size()
        self.optimizer, self.lr_schedule = make_optimizer(
            cfg, self.model.parameters(), n_iter_per_epoch, lr_world)

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

    def _loss(self, batch: Batch, model: torch.nn.Module) -> torch.Tensor:
        points, mask, features = self._inputs(batch, "points", "mask",
                                              "features")
        pred = model(points, mask, features)
        if self.loss_mode == "offset":
            offsets, = self._inputs(batch, "offsets")
            return self.loss_fn(pred, offsets, mask, points)
        rows = point_rows(points.shape[1], group=self.points_group) \
            if self.spatial else slice(None)
        mask = mask[:, rows]
        labels, = self._inputs(batch, "labels")
        if self.loss_mode == "segmentation":
            return self.loss_fn(pred, labels[:, rows], mask)
        offsets, = self._inputs(batch, "offsets")
        return self.loss_fn(pred, offsets[:, rows], labels[:, rows], mask)

    def train_step(self, batch: Batch) -> torch.Tensor:
        """One update; returns the loss on the device without waiting for
        it (but for the all-reduce of a process group)."""
        self._train_model.train()
        loss = self._loss(batch, self._train_model)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        return global_sum(loss.detach())

    def eval_step(self, batch: Batch) -> torch.Tensor:
        """The loss in eval mode (running BatchNorm statistics)."""
        self.model.eval()
        with torch.no_grad():
            return global_sum(self._loss(batch, self.model))

    def predict(self, batch: Batch) -> torch.Tensor:
        """The model's eval-mode output (this rank's point rows of it when
        ``spatial``)."""
        self.model.eval()
        with torch.no_grad():
            points, mask, features = self._inputs(batch, "points", "mask",
                                                  "features")
            return self.model(points, mask, features)

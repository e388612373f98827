"""Spatial parallelism: one whole cloud in one U-Net forward, its point
axis split over the ranks of a process group.

Counterpart of ``deep3dpointclouddenoising_tpu/parallel/spatial.py``.
JAX shards every per-point axis of the geometry pyramid over its mesh and
lets GSPMD insert the all-gathers of the support rows that the neighbour
gathers read; its Pallas route writes the one before the KPConv kernel
out in ``shard_map`` (``kpconv_aggregate_sharded``, :101).  Here each
rank of a ``torch.distributed`` group (``parallel/dist.py``) holds its
``point_rows`` of every level and the gathers are explicit:

* :func:`point_sharded_pyramid`: every rank builds each level's positions
  and mask whole (deterministic grid subsampling, so every rank builds
  the same), and only its own query rows of every neighbourhood and
  upsample table, whose indices stay global support indices (JAX
  :117-119), so the O(N * N_i) ball queries split over the ranks;
* :func:`kpconv_aggregate_sharded`: :func:`..parallel.dist.all_gather_points`
  of the support features, then the port's ``kpconv_aggregate`` (the
  ``d3pcd_torch::kpconv_fwd`` / ``kpconv_bwd`` ops, the hand-written
  kernels on the card) on this rank's query rows against the whole
  support set.  Its ``d_features`` reach their owner ranks through the
  all-gather's adjoint; ``d_kernel_weights`` is this rank's share, which
  the trainer's gradient all-reduce sums; ``d_rel`` stays local;
* the strided blocks' max-pool and the decoder's 1-NN upsample all-gather
  the rows they read the same way (``models/resnet.py``,
  ``models/heads.py``), as do PosPool, AdaptiveWeight, PointWiseMLP and
  Point Transformer before their neighbour gathers
  (``models/local_aggregation.py``, ``models/attention.py``); every
  per-point layer (Dense, BatchNorm, heads) works on the local rows,
  train-mode BatchNorm with statistics over every rank's rows
  (``models/layers.py``);
* the global attention operators (``models/attention.py``) reduce over
  the whole point axis of a level (``Neighborhood.query_size``): the
  row-softmax ones all-gather their keys and values, Offset-attention
  all-reduces its column sums and reduce-scatters ``att^T v``
  (:func:`..parallel.dist.reduce_scatter_points`), CAM all-reduces its
  Gram matrix, SE and CBAM their sums and maxima over points
  (:func:`..parallel.dist.all_reduce_max`), CAA the partial products of
  its point-axis Dense layers, whose results every rank of the group
  then holds whole;
* :func:`build_spatial_model` / :func:`build_spatial_forward`: the three
  dense-prediction models with that pyramid, for every aggregation
  operator; their parameters and buffers are the plain model's, so a
  patch-trained checkpoint loads unchanged (but CAA's, whose point-axis
  layers take the slot counts they were built for, as a Flax CAA takes
  the width it was initialised at).

With a 2-D layout (``mesh``, :func:`..parallel.dist.make_mesh_2d`; JAX's
``axis=POINTS_AXIS, batch_axis=DATA_AXIS``, :140-208) each rank is given
the clouds of its data index (``mesh.batch_rows``) and splits their point
axes within its points group: the pyramid's rows and every all-gather
above are the points group's, while train-mode BatchNorm, the losses'
denominators and the gradient sum span every rank, as JAX's statistics
span its batch sharded over both axes.

JAX's GSPMD route takes every operator as this module does; its
``shard_map`` route is how its Pallas KPConv kernel enters the sharded
model, the counterpart of :func:`kpconv_aggregate_sharded`.  Outside a
process group, or in a group of one, every rank's rows are the whole cloud
and the spatial forward is the plain forward.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from ..ops.kpconv import kpconv_aggregate
from .dist import Mesh2D, all_gather_points, point_rows

KINDS = ("offset_regression", "complete_denoising", "scene_segmentation")


def point_sharded_pyramid(xyz: torch.Tensor, mask: torch.Tensor,
                          group=None, **kw):
    """``models.pyramid.build_pyramid`` (same keywords) with this rank's
    query rows (:func:`..parallel.dist.point_rows` in ``group``, every
    rank for ``None``) of every level."""
    from ..models.pyramid import build_pyramid
    return build_pyramid(xyz, mask, group=group,
                         rows=functools.partial(point_rows, group=group), **kw)


def kpconv_aggregate_sharded(features: torch.Tensor, support_size: int,
                             idx: torch.Tensor, rel: torch.Tensor,
                             mask: torch.Tensor, kpoints: torch.Tensor,
                             kernel_weights: torch.Tensor, extent: float,
                             influence: str = "linear",
                             group=None) -> torch.Tensor:
    """KPConv over a point-sharded level: ``features`` (B, n_r, C) this
    rank's rows of a support level of ``support_size`` points, ``idx``
    (B, m_r, K) global indices into it for this rank's query rows, ``rel``
    and ``mask`` those rows'; returns (B, m_r, C).  One all-gather of the
    support rows over ``group`` (every rank for ``None``), then
    ``kpconv_aggregate``; differentiable as both are."""
    full = all_gather_points(features, support_size, group)
    return kpconv_aggregate(full.contiguous(), idx, rel, mask, kpoints,
                            kernel_weights, extent, influence)


def build_spatial_model(cfg, kind: str = "offset_regression",
                        generator: Optional[torch.Generator] = None,
                        mesh: Optional[Mesh2D] = None):
    """The model of ``kind`` (``offset_regression``, ``complete_denoising``
    or ``scene_segmentation``) with the point-sharded pyramid: called on
    the whole clouds' ``(xyz, mask, features)`` by every rank, it returns
    this rank's :func:`..parallel.dist.point_rows` of the output.  With
    ``mesh`` (a 2-D layout) it is called on the clouds of this rank's data
    index (``mesh.batch_rows``) and its rows are those of ``mesh``'s
    points group.  Every aggregation operator is taken.  Its
    ``state_dict`` has the plain model's keys and shapes."""
    from ..models import (build_complete_denoising, build_offset_regression,
                          build_scene_segmentation)
    if kind not in KINDS:
        raise ValueError(f"spatial model kind {kind!r}: one of {KINDS}")
    build = {"offset_regression": build_offset_regression,
             "complete_denoising": build_complete_denoising,
             "scene_segmentation": build_scene_segmentation}[kind]
    model = build(cfg, generator)
    model.spatial = True
    model.points_group = None if mesh is None else mesh.points_group
    return model


def build_spatial_forward(cfg, kind: str = "offset_regression",
                          device=None,
                          generator: Optional[torch.Generator] = None,
                          mesh: Optional[Mesh2D] = None
                          ) -> Tuple[torch.nn.Module, Callable]:
    """``(model, forward)``: the spatial model of ``kind`` in eval mode on
    ``device`` and ``forward(points, mask, features)``, which takes the
    whole clouds (arrays or tensors, moved to the model's device) and
    returns this rank's rows of the output without gradient; gather them
    whole with :func:`gather_points`.  With ``mesh`` (a 2-D layout, JAX's
    ``axis=POINTS_AXIS, batch_axis=DATA_AXIS``) ``forward`` takes the
    whole batch, as JAX's does, and returns this rank's point rows of the
    clouds of its data index (``mesh.batch_rows``)."""
    model = build_spatial_model(cfg, kind, generator, mesh)
    if device is not None:
        model = model.to(device)
    model.eval()

    def forward(points, mask, features) -> torch.Tensor:
        dev = next(model.parameters()).device
        batch = slice(None) if mesh is None \
            else mesh.batch_rows(len(points))
        with torch.no_grad():
            return model(*(torch.as_tensor(x)[batch].to(dev)
                           for x in (points, mask, features)))

    return model, forward


def gather_points(rows: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """Every rank's rows (this rank's ``rows``) of an (B, n, ...) output,
    whole on every rank of ``group`` (every rank for ``None``; a 2-D
    layout's ``points_group``), without gradient."""
    with torch.no_grad():
        return all_gather_points(rows.contiguous(), n, group)

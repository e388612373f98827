"""Geometry pyramid: all subsamplings and neighbourhood indices, built once
per forward.

Counterpart of ``deep3dpointclouddenoising_tpu/models/pyramid.py``.  Level
i lives at resolution ``npoints[i-1]`` (level 0 is the input).  Radii and
voxel sizes double per level:

* self-aggregation at level i: radius ``r0 * 2**i``, capacity
  ``nsamples[i]``;
* transition i-1 -> i: grid voxel ``dl0 * 2**i``, pool query radius
  ``r0 * 2**(i-1)`` with capacity ``nsamples[i-1]``;
* decoder upsample i -> i-1: masked 1-NN.

With ``rows`` (the point-sharded spatial forward, ``parallel/spatial.py``)
every level's positions and mask are still built whole (the grid
subsampling is deterministic, so every rank builds the same), but the
pyramid keeps only this rank's query rows of each level, of each
neighbourhood and of each upsample table, whose indices stay global
indices into the whole support level; ``Neighborhood.support_size`` and
``Transition.coarse_size`` then give the whole support's count, which the
layers all-gather before they read support rows,
``Neighborhood.query_size`` the whole query level's (the global attention
operators' point axis) and ``group`` the ranks that split the level
(``None``: every rank; the points group of a 2-D ``(data, points)``
layout).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from ..ops import (
    group_xyz,
    masked_grid_subsampling,
    masked_nearest_query,
    masked_ordered_ball_query,
)
from ..parallel.dist import PointShard, is_distributed


class Neighborhood(NamedTuple):
    """A fixed-capacity neighbourhood query result."""
    idx: torch.Tensor       # (B, M, K) int32 into the support set
    mask: torch.Tensor      # (B, M, K) float {0,1}
    rel_xyz: torch.Tensor   # (B, M, K, 3) support - query positions
    radius: float           # query radius
    # the whole support level's count when the queries are one rank's rows
    # (the point-sharded spatial pyramid), else None
    support_size: Optional[int] = None
    # the process group whose ranks hold the support rows (None: all)
    group: Any = None
    # the whole query level's count when the queries are one rank's rows,
    # else None
    query_size: Optional[int] = None


def query_shard(nbr: Neighborhood) -> Optional[PointShard]:
    """The point-sharded query level of ``nbr`` (its whole count and the
    group that splits it); ``None`` in the plain pyramid
    and outside a process group, where the rows are the whole level."""
    if nbr.query_size is None or not is_distributed():
        return None
    return PointShard(nbr.query_size, nbr.group)


class Level(NamedTuple):
    xyz: torch.Tensor       # (B, N_i, 3)
    mask: torch.Tensor      # (B, N_i)
    self_nbr: Optional[Neighborhood]


class Transition(NamedTuple):
    pool_nbr: Neighborhood  # query = coarse level, support = fine level
    up_idx: torch.Tensor    # (B, N_{i-1}) nearest coarse index per fine point
    up_mask: torch.Tensor   # (B, N_{i-1})
    # the whole coarse level's count when the fine queries are one rank's
    # rows (the point-sharded spatial pyramid), else None
    coarse_size: Optional[int] = None
    # the process group whose ranks hold the coarse rows (None: all)
    group: Any = None


class Pyramid(NamedTuple):
    levels: Tuple[Level, ...]            # len = num_stages + 1
    transitions: Tuple[Transition, ...]  # len = num_stages


def _neighborhood(query_xyz, support_xyz, query_mask, support_mask,
                  radius: float, nsample: int,
                  chunk_size: Optional[int],
                  support_size: Optional[int] = None,
                  group: Any = None,
                  query_size: Optional[int] = None) -> Neighborhood:
    idx, msk = masked_ordered_ball_query(
        query_xyz, support_xyz, query_mask, support_mask,
        radius=radius, nsample=nsample, chunk_size=chunk_size)
    rel = group_xyz(support_xyz, query_xyz, idx).contiguous()
    return Neighborhood(idx=idx, mask=msk, rel_xyz=rel, radius=radius,
                        support_size=support_size, group=group,
                        query_size=query_size)


def build_pyramid(xyz: torch.Tensor, mask: torch.Tensor, *,
                  radius: float, sample_dl: float,
                  nsamples: List[int], npoints: List[int],
                  build_self: bool = True,
                  build_up: bool = True,
                  chunk_size: Optional[int] = None,
                  rows: Optional[Callable[[int], slice]] = None,
                  group: Any = None) -> Pyramid:
    """Build the geometry pyramid for one batch of padded clouds.

    Indices, masks and subsampled positions carry no gradient (the JAX
    package's ``stop_gradient``s); the relative positions do, so a loss
    reaches ``xyz`` through the level-0 and first pool neighbourhoods, as
    in JAX.

    Args:
      xyz: (B, N, 3); mask: (B, N) float {0,1}.
      radius: base ball radius (``config.radius``).
      sample_dl: base grid step (``config.sampleDl``); the first transition
        uses ``2 * sample_dl``.
      nsamples: per-level neighbour capacities (len = stages + 1).
      npoints: per-transition output sizes (len = stages).
      build_self: also build self-aggregation neighbourhoods for levels > 0.
      build_up: build the decoder's 1-NN upsampling indices.
      chunk_size: query chunk of every neighbour query (default: each
        query's own, sized by the support count); the result does not
        depend on it.
      rows: this rank's query rows of a level of n points (the spatial
        pyramid); each level, neighbourhood and upsample table then holds
        those rows only, against the whole support level.
      group: the process group whose ranks ``rows`` splits a level over,
        recorded for the layers' all-gathers (``None``: every rank).
    """
    mask = mask.float()

    def mine(x: torch.Tensor):
        """(x's query rows, the support count to record)."""
        if rows is None:
            return x, None
        return x[:, rows(x.shape[1])], x.shape[1]

    q_xyz, size = mine(xyz)
    q_mask, _ = mine(mask)
    levels: List[Level] = [
        Level(xyz=q_xyz, mask=q_mask,
              self_nbr=_neighborhood(q_xyz, xyz, q_mask, mask, radius,
                                     nsamples[0], chunk_size, size, group,
                                     size))
    ]
    transitions: List[Transition] = []
    cur_xyz, cur_mask = xyz, mask
    cur_q_xyz, cur_q_mask = q_xyz, q_mask
    for i in range(1, len(npoints) + 1):
        dl = sample_dl * (2.0 ** i)
        pool_radius = radius * (2.0 ** (i - 1))
        sub_xyz, sub_mask = masked_grid_subsampling(
            cur_xyz, cur_mask, npoint=npoints[i - 1], sample_dl=dl)
        sub_q_xyz, sub_size = mine(sub_xyz)
        sub_q_mask, _ = mine(sub_mask)
        pool_nbr = _neighborhood(sub_q_xyz, cur_xyz, sub_q_mask, cur_mask,
                                 pool_radius, nsamples[i - 1], chunk_size,
                                 size, group, sub_size)
        if build_up:
            up_idx, up_mask = masked_nearest_query(
                cur_q_xyz, sub_xyz, cur_q_mask, sub_mask,
                chunk_size=chunk_size)
        else:
            up_idx = torch.zeros(cur_q_xyz.shape[:2], dtype=torch.int32,
                                 device=xyz.device)
            up_mask = cur_q_mask
        self_nbr = None
        if build_self:
            self_nbr = _neighborhood(sub_q_xyz, sub_xyz, sub_q_mask,
                                     sub_mask, radius * (2.0 ** i),
                                     nsamples[i], chunk_size, sub_size,
                                     group, sub_size)
        levels.append(Level(xyz=sub_q_xyz, mask=sub_q_mask,
                            self_nbr=self_nbr))
        transitions.append(Transition(pool_nbr=pool_nbr, up_idx=up_idx,
                                      up_mask=up_mask,
                                      coarse_size=sub_size, group=group))
        cur_xyz, cur_mask = sub_xyz, sub_mask
        cur_q_xyz, cur_q_mask, size = sub_q_xyz, sub_q_mask, sub_size
    return Pyramid(levels=tuple(levels), transitions=tuple(transitions))

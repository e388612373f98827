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
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..ops import (
    group_xyz,
    masked_grid_subsampling,
    masked_nearest_query,
    masked_ordered_ball_query,
)


class Neighborhood(NamedTuple):
    """A fixed-capacity neighbourhood query result."""
    idx: torch.Tensor       # (B, M, K) int32 into the support set
    mask: torch.Tensor      # (B, M, K) float {0,1}
    rel_xyz: torch.Tensor   # (B, M, K, 3) support - query positions
    radius: float           # query radius


class Level(NamedTuple):
    xyz: torch.Tensor       # (B, N_i, 3)
    mask: torch.Tensor      # (B, N_i)
    self_nbr: Optional[Neighborhood]


class Transition(NamedTuple):
    pool_nbr: Neighborhood  # query = coarse level, support = fine level
    up_idx: torch.Tensor    # (B, N_{i-1}) nearest coarse index per fine point
    up_mask: torch.Tensor   # (B, N_{i-1})


class Pyramid(NamedTuple):
    levels: Tuple[Level, ...]            # len = num_stages + 1
    transitions: Tuple[Transition, ...]  # len = num_stages


def _neighborhood(query_xyz, support_xyz, query_mask, support_mask,
                  radius: float, nsample: int,
                  chunk_size: Optional[int]) -> Neighborhood:
    idx, msk = masked_ordered_ball_query(
        query_xyz, support_xyz, query_mask, support_mask,
        radius=radius, nsample=nsample, chunk_size=chunk_size)
    rel = group_xyz(support_xyz, query_xyz, idx).contiguous()
    return Neighborhood(idx=idx, mask=msk, rel_xyz=rel, radius=radius)


def build_pyramid(xyz: torch.Tensor, mask: torch.Tensor, *,
                  radius: float, sample_dl: float,
                  nsamples: List[int], npoints: List[int],
                  build_self: bool = True,
                  build_up: bool = True,
                  chunk_size: Optional[int] = None) -> Pyramid:
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
    """
    mask = mask.float()
    levels: List[Level] = [
        Level(xyz=xyz, mask=mask,
              self_nbr=_neighborhood(xyz, xyz, mask, mask, radius,
                                     nsamples[0], chunk_size))
    ]
    transitions: List[Transition] = []
    cur_xyz, cur_mask = xyz, mask
    for i in range(1, len(npoints) + 1):
        dl = sample_dl * (2.0 ** i)
        pool_radius = radius * (2.0 ** (i - 1))
        sub_xyz, sub_mask = masked_grid_subsampling(
            cur_xyz, cur_mask, npoint=npoints[i - 1], sample_dl=dl)
        pool_nbr = _neighborhood(sub_xyz, cur_xyz, sub_mask, cur_mask,
                                 pool_radius, nsamples[i - 1], chunk_size)
        if build_up:
            up_idx, up_mask = masked_nearest_query(
                cur_xyz, sub_xyz, cur_mask, sub_mask, chunk_size=chunk_size)
        else:
            up_idx = torch.zeros(cur_xyz.shape[:2], dtype=torch.int32,
                                 device=xyz.device)
            up_mask = cur_mask
        self_nbr = None
        if build_self:
            self_nbr = _neighborhood(sub_xyz, sub_xyz, sub_mask, sub_mask,
                                     radius * (2.0 ** i), nsamples[i],
                                     chunk_size)
        levels.append(Level(xyz=sub_xyz, mask=sub_mask, self_nbr=self_nbr))
        transitions.append(Transition(pool_nbr=pool_nbr, up_idx=up_idx,
                                      up_mask=up_mask))
        cur_xyz, cur_mask = sub_xyz, sub_mask
    return Pyramid(levels=tuple(levels), transitions=tuple(transitions))

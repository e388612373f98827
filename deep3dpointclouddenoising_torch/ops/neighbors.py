"""Masked neighbour queries and feature grouping.

Counterpart of ``deep3dpointclouddenoising_tpu/ops/neighbors.py``, with the
same contract:

* :func:`masked_ordered_ball_query` returns the true ``nsample`` nearest
  support points within the radius, sorted by distance (a stable sort, so
  exact ties keep index order), with padding slots that cycle through the
  real neighbours and an explicit validity mask;
* :func:`masked_nearest_query` is the masked 1-NN (first index on ties);
* :func:`group_features` / :func:`gather_rows` / :func:`group_xyz` gather
  rows by index.

Distances are exact subtract-square sums in float32 (the
``|q|^2 - 2 q.s + |s|^2`` form mis-orders near-tied neighbours).  Points are
``(B, N, 3)``, features channels-last ``(B, N, C)``, masks float32 ``{0,1}``
of shape ``(B, N)``, indices int32.
"""
from __future__ import annotations

from typing import Tuple

import torch

_BIG = 1e10


def _sqdist(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(B, M, 3), (B, N, 3) -> (B, M, N) exact squared distances, summed
    x, y, z in that order."""
    d = q[:, :, None, :] - s[:, None, :, :]
    d = d * d
    return (d[..., 0] + d[..., 1]) + d[..., 2]


@torch.no_grad()
def masked_ordered_ball_query(query_xyz: torch.Tensor,
                              support_xyz: torch.Tensor,
                              query_mask: torch.Tensor,
                              support_mask: torch.Tensor, *,
                              radius: float, nsample: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distance-sorted masked radius query.

    Returns ``idx`` (B, M, nsample) int32 support indices sorted by
    distance, cycling through the real neighbours past their count and all
    zero for a query with no neighbour; and ``idx_mask`` (B, M, nsample)
    float32, 1 for true neighbours of real queries.  The (B, M, N) distance
    matrix is formed whole; the 15000-point configs will need query chunks.
    """
    B, M = query_xyz.shape[:2]
    N = support_xyz.shape[1]
    d2 = _sqdist(query_xyz, support_xyz)
    # radius**2 is rounded to float32 once, as a weakly typed JAX scalar is
    r2 = torch.tensor(radius * radius, dtype=d2.dtype, device=d2.device)
    invalid = (support_mask <= 0.0)[:, None, :] | (d2 >= r2)
    big = torch.tensor(_BIG, dtype=d2.dtype, device=d2.device)
    d2 = torch.where(invalid, big, d2)
    if nsample > N:  # fewer support slots than capacity
        d2 = torch.cat([d2, big.expand(B, M, nsample - N)], dim=-1)
    sd2, sidx = torch.sort(d2.reshape(B * M, -1), dim=-1, stable=True)
    sd2, sidx = sd2[:, :nsample], sidx[:, :nsample]
    sidx = sidx.clamp(max=N - 1)  # pad columns
    cnt = (sd2 < _BIG * 0.5).sum(dim=-1)
    ar = torch.arange(nsample, device=d2.device)[None, :]
    # pad by cycling real neighbours; ar % cnt == ar for the first cnt slots
    src = ar % cnt.clamp(min=1)[:, None]
    idx = torch.gather(sidx, 1, src)
    idx = torch.where(cnt[:, None] > 0, idx, torch.zeros_like(idx))
    idx_mask = (ar < cnt[:, None]).float() \
        * query_mask.float().reshape(-1, 1)
    return (idx.to(torch.int32).reshape(B, M, nsample),
            idx_mask.reshape(B, M, nsample))


@torch.no_grad()
def masked_nearest_query(query_xyz: torch.Tensor, support_xyz: torch.Tensor,
                         query_mask: torch.Tensor, support_mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked 1-NN: ``idx`` (B, M) int32 of the nearest valid support point
    (first index on ties) and ``idx_mask`` (B, M) = ``query_mask``."""
    d2 = _sqdist(query_xyz, support_xyz)
    d2 = d2.masked_fill((support_mask <= 0.0)[:, None, :], _BIG)
    return torch.argmin(d2, dim=-1).to(torch.int32), query_mask.float()


def gather_rows(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, R) -> (B, R, C) row gather."""
    batch = torch.arange(features.shape[0], device=features.device)[:, None]
    return features[batch, idx.long()]


def group_features(features: torch.Tensor, idx: torch.Tensor
                   ) -> torch.Tensor:
    """Gather neighbour features: (B, N, C) x (B, M, K) -> (B, M, K, C)."""
    B, M, K = idx.shape
    out = gather_rows(features, idx.reshape(B, M * K))
    return out.reshape(B, M, K, features.shape[-1])


def group_xyz(support_xyz: torch.Tensor, query_xyz: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """Neighbour coordinates relative to their query point: (B, M, K, 3)."""
    return group_features(support_xyz, idx) - query_xyz[:, :, None, :]

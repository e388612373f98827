"""Masked neighbour queries and feature grouping.

Counterpart of ``deep3dpointclouddenoising_tpu/ops/neighbors.py``, with the
same contract:

* :func:`masked_ordered_ball_query` returns the true ``nsample`` nearest
  support points within the radius, sorted by distance (exact ties by
  lower index, as both of the JAX package's selections order them), with
  padding slots that cycle through the
  real neighbours and an explicit validity mask;
* :func:`masked_nearest_query` is the masked 1-NN (first index on ties);
* both go in query chunks, so that no (B, M, N) matrix is formed whole at
  the 15,000-point configs, and there first drop the invalid (padding)
  supports; neither changes a result;
* :func:`group_features` / :func:`gather_rows` / :func:`group_xyz` gather
  rows by index.

Distances are exact subtract-square sums in float32 (the
``|q|^2 - 2 q.s + |s|^2`` form mis-orders near-tied neighbours, and so
does ``torch.cdist``, which takes it above 25 rows).  Points are
``(B, N, 3)``, features channels-last ``(B, N, C)``, masks float32 ``{0,1}``
of shape ``(B, N)``, indices int32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_BIG = 1e10
# rows of at most this many columns are ordered by a stable sort, wider
# ones by a top-k over unique keys (the JAX package's _SORT_SELECT_MAX_N;
# both give the same order)
_SORT_SELECT_MAX_N = 4096
# default query chunk: (B, chunk, N, 3) coordinate-difference tiles of at
# most this many elements (256 MB in float32).  A query that takes more
# than one tile first drops the invalid supports (compact_supports).
_TILE_ELEMENTS = 1 << 26


def auto_chunk(b: int, m: int, n: int, budget: int = _TILE_ELEMENTS) -> int:
    """Queries per chunk so that a (b, chunk, n, 3) tile holds at most
    ``budget`` elements (at least 1, at most ``m``): one chunk at the
    500-point configs, 186 queries at B=8 and 15,000 supports.  A row's
    result does not depend on the chunk."""
    return max(1, min(m, budget // max(3 * b * n, 1)))


def auto_compact(b: int, m: int, n: int) -> bool:
    """Whether a query drops the invalid supports first: when it takes
    more than one tile (the 15,000-point configs, whose patches are
    mostly padding), not at the 500-point configs, which so keep a query
    free of host waits.  Never under ``torch.export``: compaction reads a
    count on the host, which a program of static shapes cannot hold, and
    the indices are the same without it (:func:`compact_supports`)."""
    return auto_chunk(b, m, n) < m and not torch.compiler.is_exporting()


def compact_supports(support_xyz: torch.Tensor, support_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each cloud's valid supports (mask > 0) moved to the front in index
    order, cut to the batch's largest valid count ``n`` (at least 1):
    ``(xyz (B, n, 3), mask (B, n), cols (B, n) int64)``, ``cols`` the
    original indices.  Invalid supports are never a query's neighbour, and
    the order of the rest is kept, so a query over the compacted set and
    ``cols`` gives the same indices, ties included; reading ``n`` waits
    for the device."""
    invalid = support_mask <= 0.0
    cols = torch.sort(invalid.to(torch.int32), dim=1, stable=True).indices
    n = max(int((~invalid).sum(dim=1).max()), 1)
    cols = cols[:, :n]
    return (gather_rows(support_xyz, cols),
            torch.gather(support_mask, 1, cols), cols)


def pairwise_sqdist(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(B, M, 3), (B, N, 3) -> (B, M, N) exact squared distances, summed
    x, y, z in that order, through one (B, M, N, 3) difference tensor
    (four launches; callers size M by :func:`auto_chunk`)."""
    d = (q[:, :, None, :] - s[:, None, :, :]).square_()
    return (d[..., 0] + d[..., 1]) + d[..., 2]


def _chunks(m: int, chunk: int):
    return [(s, min(s + chunk, m)) for s in range(0, m, chunk)]


def _cat(tiles, dim: int) -> torch.Tensor:
    return tiles[0] if len(tiles) == 1 else torch.cat(tiles, dim)


def _nearest_columns(d2: torch.Tensor, nsample: int) -> torch.Tensor:
    """(R, N') -> (R, nsample) column indices of each row's ``nsample``
    smallest entries, ascending, equal entries by lower column.  Up to
    ``_SORT_SELECT_MAX_N`` columns a stable sort; above, a top-k over the
    int64 keys ``(float32 bits << 32) | column``: the entries are
    non-negative, so their bit patterns order as their values, and unique
    keys leave ``topk`` no tie to break."""
    if d2.shape[-1] <= _SORT_SELECT_MAX_N or d2.dtype != torch.float32:
        return torch.sort(d2, dim=-1, stable=True).indices[:, :nsample]
    cols = torch.arange(d2.shape[-1], device=d2.device)
    keys = (d2.view(torch.int32).long() << 32) | cols
    keys = torch.topk(keys, nsample, dim=-1, largest=False,
                      sorted=True).values
    return keys & 0xFFFFFFFF


def _ball_query_tile(q, qmask, s, smask, cols, r2, nsample: int):
    """One chunk of queries: q (B, c, 3), qmask (B, c) against the whole
    support set (compacted when ``cols`` is given) -> idx (B, c, nsample)
    int32 original support indices, idx_mask (B, c, nsample)."""
    B, c = q.shape[:2]
    N = s.shape[1]
    d2 = pairwise_sqdist(q, s)
    invalid = (smask <= 0.0)[:, None, :] | (d2 >= r2)
    d2 = d2.masked_fill_(invalid, _BIG).reshape(B * c, N)
    if nsample > N:  # fewer support slots than capacity
        d2 = torch.cat([d2, d2.new_full((B * c, nsample - N), _BIG)], 1)
    sidx = _nearest_columns(d2, nsample)
    cnt = (torch.gather(d2, 1, sidx) < _BIG * 0.5).sum(dim=-1)
    sidx = sidx.clamp(max=N - 1)  # pad columns
    ar = torch.arange(nsample, device=d2.device)[None, :]
    # pad by cycling real neighbours; ar % cnt == ar for the first cnt slots
    src = ar % cnt.clamp(min=1)[:, None]
    idx = torch.gather(sidx, 1, src)
    if cols is not None:
        idx = torch.gather(cols, 1, idx.reshape(B, c * nsample)).reshape(
            B * c, nsample)
    idx = torch.where(cnt[:, None] > 0, idx, torch.zeros_like(idx))
    idx_mask = (ar < cnt[:, None]).float() * qmask.reshape(-1, 1)
    return (idx.to(torch.int32).reshape(B, c, nsample),
            idx_mask.reshape(B, c, nsample))


@torch.no_grad()
def masked_ordered_ball_query(query_xyz: torch.Tensor,
                              support_xyz: torch.Tensor,
                              query_mask: torch.Tensor,
                              support_mask: torch.Tensor, *,
                              radius: float, nsample: int,
                              chunk_size: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distance-sorted masked radius query.

    Returns ``idx`` (B, M, nsample) int32 support indices sorted by
    distance, cycling through the real neighbours past their count and all
    zero for a query with no neighbour; and ``idx_mask`` (B, M, nsample)
    float32, 1 for true neighbours of real queries.  Queries go in chunks
    of ``chunk_size`` (default :func:`auto_chunk`), each against the
    whole support set, or, where the query takes more than one tile
    (:func:`auto_compact`), against its valid part
    (:func:`compact_supports`); neither changes the result.
    """
    B, M = query_xyz.shape[:2]
    qmask, smask = query_mask.float(), support_mask.float()
    cols = None
    if auto_compact(B, M, support_xyz.shape[1]):
        support_xyz, smask, cols = compact_supports(support_xyz, smask)
    chunk = chunk_size or auto_chunk(B, M, support_xyz.shape[1])
    # radius**2 is rounded to float32 once, as a weakly typed JAX scalar is
    r2 = torch.tensor(radius * radius, dtype=query_xyz.dtype,
                      device=query_xyz.device)
    tiles = [_ball_query_tile(query_xyz[:, s:e], qmask[:, s:e],
                              support_xyz, smask, cols, r2, nsample)
             for s, e in _chunks(M, chunk)]
    return (_cat([t[0] for t in tiles], 1), _cat([t[1] for t in tiles], 1))


@torch.no_grad()
def masked_nearest_query(query_xyz: torch.Tensor, support_xyz: torch.Tensor,
                         query_mask: torch.Tensor, support_mask: torch.Tensor,
                         *, chunk_size: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked 1-NN: ``idx`` (B, M) int32 of the nearest valid support point
    (first index on ties) and ``idx_mask`` (B, M) = ``query_mask``.
    Queries go in chunks, against the compacted supports where the query
    takes more than one tile, as in :func:`masked_ordered_ball_query`."""
    B, M = query_xyz.shape[:2]
    smask, cols = support_mask, None
    if auto_compact(B, M, support_xyz.shape[1]):
        support_xyz, smask, cols = compact_supports(support_xyz, smask)
    chunk = chunk_size or auto_chunk(B, M, support_xyz.shape[1])
    invalid = (smask <= 0.0)[:, None, :]
    idx = _cat([torch.argmin(
        pairwise_sqdist(query_xyz[:, s:e], support_xyz)
        .masked_fill_(invalid, _BIG), dim=-1) for s, e in _chunks(M, chunk)],
        1)
    if cols is not None:
        idx = torch.gather(cols, 1, idx)
    return idx.to(torch.int32), query_mask.float()


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

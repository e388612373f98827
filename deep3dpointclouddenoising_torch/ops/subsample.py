"""Masked voxel-grid subsampling (barycentre pooling).

Counterpart of ``deep3dpointclouddenoising_tpu/ops/subsample.py``, with the
same contract:

1. voxel id ``iX + NX*iY + NX*NY*iZ`` on a grid anchored at
   ``floor(min/dl)*dl``;
2. the barycentre of all points sharing a voxel;
3. a deterministic pseudo-shuffle of the voxel order by the LCG
   ``k[i] = (17*k[i-1] + 139) % 256`` seeded from the smallest voxel id,
   then a stable sort by those keys, which decides which voxels survive
   truncation to ``npoint``;
4. the first ``npoint`` barycentres with mask 1, padded by cycling real
   ones with mask 0.

The batch is processed at once: stable sort by voxel id, segment sums by
``torch.segment_reduce`` over the sorted points, closed-form LCG keys from
:func:`_lcg_tables`.  Each segment is summed in point order, on the CPU
and on the card alike: a float ``scatter_add_`` adds by atomics on the
card, in an order that changes from run to run, and two runs of one
batch then differ by an ulp in a barycentre, enough to flip a near-tied
neighbour in the next level's ball query.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_LCG_A, _LCG_B, _LCG_MOD = 17, 139, 256
_INVALID = 2 ** 30


@functools.lru_cache(maxsize=32)
def _lcg_tables(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(17^i mod 256, 139*sum_{j<i} 17^j mod 256) for i in [0, n), so that
    ``k[i] = a_pow[i] * k0 + geo[i] (mod 256)``."""
    a_pow = np.empty(n, dtype=np.int64)
    geo = np.empty(n, dtype=np.int64)
    ap, g = 1, 0
    for i in range(n):
        a_pow[i] = ap
        geo[i] = g
        g = (_LCG_A * g + _LCG_B) % _LCG_MOD
        ap = (ap * _LCG_A) % _LCG_MOD
    return a_pow, geo


@torch.no_grad()
def masked_grid_subsampling(xyz: torch.Tensor, mask: torch.Tensor, *,
                            npoint: int, sample_dl: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched masked voxel-grid barycentre subsampling.

    Args:
      xyz: (B, N, 3) points; padding slots replicate real points.
      mask: (B, N) float {0,1}.
      npoint: output capacity.
      sample_dl: voxel edge length.

    Returns (B, npoint, 3) barycentres and their (B, npoint) float mask.
    """
    B, n, _ = xyz.shape
    dev = xyz.device
    # a float32 tensor divisor: CUDA turns division by a Python scalar into
    # a multiply by its reciprocal, which can move points across voxel
    # boundaries
    dl = torch.tensor(sample_dl, dtype=torch.float32, device=dev)
    valid = mask > 0.0
    inf = torch.tensor(float("inf"), dtype=xyz.dtype, device=dev)
    mins = torch.where(valid[..., None], xyz, inf).amin(dim=1)
    maxs = torch.where(valid[..., None], xyz, -inf).amax(dim=1)
    origin = torch.floor(mins / dl) * dl                       # (B, 3)
    nx = torch.floor((maxs[:, 0] - origin[:, 0]) / dl).long() + 1
    ny = torch.floor((maxs[:, 1] - origin[:, 1]) / dl).long() + 1

    cell = torch.floor((xyz - origin[:, None, :]) / dl).long()  # (B, N, 3)
    vid = cell[..., 0] + nx[:, None] * cell[..., 1] \
        + (nx * ny)[:, None] * cell[..., 2]
    vid = torch.where(valid, vid, torch.full_like(vid, _INVALID))

    svid, order = torch.sort(vid, dim=1, stable=True)  # invalid points last
    spts = torch.gather(xyz, 1, order[..., None].expand(B, n, 3))
    pos = torch.arange(n, device=dev)
    sval = svid < _INVALID
    is_new = sval & ((pos == 0)[None, :]
                     | (svid != torch.roll(svid, 1, dims=1)))
    seg = torch.cumsum(is_new.long(), dim=1) - 1
    seg = torch.where(sval, seg, torch.full_like(seg, n - 1))
    w = sval.to(xyz.dtype)
    # seg is nondecreasing along the sorted points (the invalid ones last,
    # in segment n - 1), so each segment is a run of them; integer counts
    # add exactly in any order
    lengths = torch.zeros_like(seg).scatter_add_(1, seg, torch.ones_like(seg))
    sums = torch.segment_reduce(spts * w[..., None], "sum", lengths=lengths,
                                axis=1, unsafe=True)
    cnts = torch.zeros_like(w).scatter_add_(1, seg, w)
    centroids = sums / cnts.clamp(min=1.0)[..., None]
    end = is_new.sum(dim=1)                                    # (B,)

    a_pow_np, geo_np = _lcg_tables(n)
    a_pow = torch.from_numpy(a_pow_np).to(dev)
    geo = torch.from_numpy(geo_np).to(dev)
    k0 = torch.where(end > 0, svid[:, 0], torch.zeros_like(end)) % _LCG_MOD
    keys = (a_pow[None, :] * k0[:, None] + geo[None, :]) % _LCG_MOD
    keys = torch.where(pos[None, :] < end[:, None], keys,
                       torch.full_like(keys, _INVALID))
    shuffled = torch.sort(keys, dim=1, stable=True).indices

    out_pos = torch.arange(npoint, device=dev)[None, :]
    src = torch.where(out_pos < end[:, None], out_pos,
                      out_pos % end.clamp(min=1)[:, None])
    pick = torch.gather(shuffled, 1, src)
    sub_xyz = torch.gather(centroids, 1, pick[..., None].expand(B, npoint, 3))
    sub_mask = (out_pos < end[:, None]).to(xyz.dtype)
    return sub_xyz, sub_mask


def grid_subsample_numpy(points: np.ndarray, sample_dl: float,
                         features: np.ndarray | None = None,
                         labels: np.ndarray | None = None):
    """CPU voxel-grid barycentre subsampling for the data pipeline:
    barycentre of points (and features) per voxel, majority label per
    voxel, in ascending voxel-id order."""
    pts = np.asarray(points, dtype=np.float32)
    mins = pts.min(axis=0)
    origin = np.floor(mins / sample_dl) * sample_dl
    cell = np.floor((pts - origin) / sample_dl).astype(np.int64)
    dims = cell.max(axis=0) + 1
    vid = cell[:, 0] + dims[0] * cell[:, 1] + dims[0] * dims[1] * cell[:, 2]
    uniq, inv, cnt = np.unique(vid, return_inverse=True, return_counts=True)
    nvox = uniq.shape[0]
    sub = np.zeros((nvox, 3), dtype=np.float64)
    np.add.at(sub, inv, pts)
    sub = (sub / cnt[:, None]).astype(np.float32)
    out = [sub]
    if features is not None:
        f = np.asarray(features, dtype=np.float64)
        sf = np.zeros((nvox, f.shape[1]), dtype=np.float64)
        np.add.at(sf, inv, f)
        out.append((sf / cnt[:, None]).astype(np.float32))
    if labels is not None:
        lab = np.asarray(labels).astype(np.int64).ravel()
        nlab = int(lab.max()) + 1 if lab.size else 1
        hist = np.zeros((nvox, nlab), dtype=np.int64)
        np.add.at(hist, (inv, lab), 1)
        out.append(hist.argmax(axis=1).astype(np.int32))
    return out[0] if len(out) == 1 else tuple(out)

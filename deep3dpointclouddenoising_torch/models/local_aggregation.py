"""Local aggregation over precomputed neighbourhoods.

Counterpart of ``deep3dpointclouddenoising_tpu/models/local_aggregation.py``:
PseudoGrid (KPConv), PosPool, AdaptiveWeight, PointWiseMLP and the
attention wrapper (``models/attention.py``), dispatched by
``cfg.local_aggregation_type``.  Submodules keep the Flax tree's names.

Every PseudoGrid call goes through :func:`..ops.kpconv.kpconv_aggregate`,
which on the card is the CUDA kernel at every level, with no size
threshold.  Under ``cfg.compute_dtype: bfloat16`` the support features go
in as bfloat16 and the aggregation comes out in bfloat16 (the JAX
package's fused path, ``local_aggregation.py:119-126``), which the
BatchNorm after it promotes back to float32.  The other operators are
plain torch ops (no Pallas kernel in the JAX package either); under
bfloat16 only their ``ConvBN``s compute in bfloat16, where JAX passes them
``compute_dtype``.

In the point-sharded spatial model (``parallel/spatial.py``) a
neighbourhood's queries are one rank's rows of a level and its indices
name rows of the whole support level (``Neighborhood.support_size``):
every operator then all-gathers the support features first
(:func:`gather_support`; PseudoGrid through
:func:`..parallel.spatial.kpconv_aggregate_sharded`, the JAX package's
``shard_map`` route), and the rest of it works on the local query rows,
as GSPMD partitions the JAX package's gathers over the point axis.

A max over the neighbours is ``amax``: padding slots cycle real
neighbours, so it meets exact ties, and ``amax`` splits the gradient among
them evenly, as ``jnp.max`` does (``torch.max(dim=)`` gives it all to one
slot).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..config import Config
from ..ops import group_features
from ..ops.kpconv import kpconv_aggregate
from ..parallel.dist import all_gather_points
from ..parallel.spatial import kpconv_aggregate_sharded
from .kernel_points import create_kernel_points
from .layers import BNReLU, ConvBN, compute_dtype, dense
from .pyramid import Neighborhood


def gather_support(features: torch.Tensor, nbr: Neighborhood
                   ) -> torch.Tensor:
    """The support level's features whole: ``features`` itself in the
    plain pyramid, every rank's rows of it all-gathered over
    ``nbr.group`` in the point-sharded one."""
    if nbr.support_size is None:
        return features
    return all_gather_points(features.contiguous(), nbr.support_size,
                             nbr.group)


def _feature_mask(nbr: Neighborhood, query_mask: torch.Tensor
                  ) -> torch.Tensor:
    """(B, M, K) neighbourhood mask, all ones for padding queries."""
    return nbr.mask + (1.0 - query_mask[:, :, None])


REDUCTIONS = ("max", "avg", "mean", "sum")


def _check_reduction(reduction: str) -> str:
    if reduction not in REDUCTIONS:
        raise NotImplementedError(f"Reduction {reduction} not implemented")
    return reduction


def masked_reduce(agg: torch.Tensor, nbr: Neighborhood,
                  query_mask: torch.Tensor, reduction: str) -> torch.Tensor:
    """Reduce (B, M, K, C) over K: ``max`` over every slot (padding slots
    cycle real neighbours), ``sum`` of the masked slots, ``avg``/``mean``
    that sum over the live count (at least 1)."""
    if _check_reduction(reduction) == "max":
        return agg.amax(dim=2)
    fmask = _feature_mask(nbr, query_mask)[..., None]
    summed = (agg * fmask).sum(dim=2)
    if reduction == "sum":
        return summed
    return summed / fmask.sum(dim=2).clamp(min=1.0)


def _relative(nbr: Neighborhood, radius: float, like: torch.Tensor
              ) -> torch.Tensor:
    """Neighbour positions over the query radius (the reference grouper's
    ``normalize_xyz``), in ``like``'s dtype."""
    return nbr.rel_xyz.to(like.dtype) / radius


def closing_layer(module: nn.Module, flag: bool, in_channels: int,
          out_channels: int, cfg: Config,
          generator: Optional[torch.Generator],
          dtype: Optional[torch.dtype]) -> None:
    """An operator's closing layer: ``ConvBN_0`` when ``flag`` is set or
    the channel counts differ, else ``BNReLU_0``; its name in
    ``module.post``."""
    if flag or in_channels != out_channels:
        module.post = "ConvBN_0"
        module.ConvBN_0 = ConvBN(in_channels, out_channels, cfg.bn_momentum,
                                 generator=generator, dtype=dtype)
    else:
        module.post = "BNReLU_0"
        module.BNReLU_0 = BNReLU(out_channels, cfg.bn_momentum)


class PseudoGrid(nn.Module):
    """KPConv-style pseudo-grid aggregation: each neighbour's feature is
    weighted by every kernel point's influence (linear, gaussian or
    constant in the distance between the neighbour's relative position and
    the kernel point) and by that kernel point's channel weights, then
    summed over neighbours and kernel points."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        pg = cfg.pseudo_grid
        if pg.KP_influence not in ("constant", "linear", "gaussian"):
            raise ValueError(f"Unknown KP_influence {pg.KP_influence}")
        if pg.convolution_mode != "sum":
            raise NotImplementedError(
                f"convolution_mode {pg.convolution_mode} not supported")
        self.influence = pg.KP_influence
        self.compute_dtype = compute_dtype(cfg)
        self.extent = float(2.0 * pg.KP_extent * radius
                            / cfg.density_parameter)
        kpoints = create_kernel_points(
            1.5 * self.extent, int(pg.num_kernel_points),
            fixed=pg.fixed_kernel_points, seed=int(cfg.rng_seed))
        self.register_buffer("kpoints", torch.from_numpy(kpoints),
                             persistent=False)
        std = math.sqrt(2.0 / in_channels)
        self.kernel_weights = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(int(pg.num_kernel_points), in_channels), std=std,
            a=-2 * std, b=2 * std, generator=generator))
        closing_layer(self, pg.output_conv, in_channels, out_channels, cfg,
              generator, self.compute_dtype)

    def forward(self, support_features: torch.Tensor, nbr: Neighborhood,
                query_mask: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            support_features = support_features.to(self.compute_dtype)
        args = (nbr.idx, nbr.rel_xyz,
                _feature_mask(nbr, query_mask).contiguous(), self.kpoints,
                self.kernel_weights, self.extent, self.influence)
        if nbr.support_size is None:
            out = kpconv_aggregate(support_features.contiguous(), *args)
        else:
            out = kpconv_aggregate_sharded(support_features,
                                           nbr.support_size, *args,
                                           group=nbr.group)
        return getattr(self, self.post)(out)


class PosPool(nn.Module):
    """Parameter-free position-modulated pooling: each neighbour's feature
    times an embedding of its position over the radius (``xyz``: a third
    of the channels per coordinate; ``sin_cos``: sines and cosines at
    C/6 wave lengths per coordinate), reduced over the neighbours."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        pp = cfg.pospool
        parts = {"xyz": 3, "sin_cos": 6}.get(pp.position_embedding)
        if parts is None:
            raise NotImplementedError(f"Position embedding "
                                      f"{pp.position_embedding} not "
                                      "implemented")
        if in_channels % parts:
            raise ValueError(f"PosPool {pp.position_embedding}: "
                             f"{in_channels} channels, not a multiple of "
                             f"{parts}")
        self.embedding = pp.position_embedding
        self.reduction = _check_reduction(pp.reduction)
        self.in_channels, self.radius = in_channels, float(radius)
        closing_layer(self, pp.output_conv, in_channels, out_channels, cfg,
              generator, compute_dtype(cfg))

    def forward(self, support_features: torch.Tensor, nbr: Neighborhood,
                query_mask: torch.Tensor) -> torch.Tensor:
        C = self.in_channels
        grouped = group_features(gather_support(support_features, nbr),
                                 nbr.idx)  # (B,M,K,C)
        B, M, K, _ = grouped.shape
        rel = _relative(nbr, self.radius, grouped)
        if self.embedding == "xyz":
            agg = (grouped.reshape(B, M, K, C // 3, 3)
                   * rel[..., None, :]).reshape(B, M, K, C)
        else:
            feat_dim = C // 6
            steps = torch.arange(feat_dim, dtype=rel.dtype,
                                 device=rel.device)
            dim_mat = torch.pow(1000.0, steps / feat_dim)
            pos = (100.0 * rel)[..., None] / dim_mat   # (B,M,K,3,feat)
            emb = torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)
            agg = grouped * emb.reshape(B, M, K, C)
        out = masked_reduce(agg, nbr, query_mask, self.reduction)
        return getattr(self, self.post)(out)


class AdaptiveWeight(nn.Module):
    """Adaptive weighting (weight type ``dp`` only, as the reference): a
    chain of ``num_mlps`` Dense layers (bias, He-normal; ReLU between)
    maps each neighbour's position over the radius to C/S weights,
    optionally softmaxed over the neighbours, each scaling S channels."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        aw = cfg.adaptive_weight
        if aw.weight_type != "dp":
            raise NotImplementedError(
                f"Weight type {aw.weight_type} not implemented")
        S = int(aw.shared_channels)
        if in_channels % S:
            raise ValueError(f"AdaptiveWeight: {in_channels} channels, not "
                             f"a multiple of shared_channels {S}")
        self.shared = S
        self.num_mlps = int(aw.num_mlps)
        self.softmax = bool(aw.weight_softmax)
        self.reduction = _check_reduction(aw.reduction)
        self.radius = float(radius)
        for i in range(self.num_mlps):
            self.add_module(f"Dense_{i}", dense(
                3 if i == 0 else in_channels // S, in_channels // S, True,
                generator, init="he"))
        closing_layer(self, aw.output_conv, in_channels, out_channels, cfg,
              generator, compute_dtype(cfg))

    def forward(self, support_features: torch.Tensor, nbr: Neighborhood,
                query_mask: torch.Tensor) -> torch.Tensor:
        grouped = group_features(gather_support(support_features, nbr),
                                 nbr.idx)  # (B,M,K,C)
        B, M, K, C = grouped.shape
        w = _relative(nbr, self.radius, grouped)
        for i in range(self.num_mlps):
            if i > 0:
                w = F.relu(w)
            w = getattr(self, f"Dense_{i}")(w)
        if self.softmax:
            w = torch.softmax(w, dim=2)
        S = self.shared
        agg = (grouped.reshape(B, M, K, C // S, S)
               * w[..., None]).reshape(B, M, K, C)
        out = masked_reduce(agg, nbr, query_mask, self.reduction)
        return getattr(self, self.post)(out)


class PointWiseMLP(nn.Module):
    """Shared-MLP aggregation: per neighbour, its position over the radius
    and its feature relative to the centre (``dp_fj``), or those and the
    centre's feature (``dp_fi_df``), through one ``ConvBN`` or a chain at
    ``max(C/2, 9)`` channels, then reduced over the neighbours, with no
    BatchNorm after.  The centre is slot 0: the nearest neighbour of a
    self-aggregation, the query point itself."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        pw = cfg.pointwisemlp
        widths = {"dp_fj": 3 + in_channels,
                  "dp_fi_df": 3 + 2 * in_channels}
        if pw.feature_type not in widths:
            raise NotImplementedError(
                f"Feature type {pw.feature_type} not implemented")
        self.feature_type = pw.feature_type
        self.reduction = _check_reduction(pw.reduction)
        self.radius = float(radius)
        n_mlps = int(pw.num_mlps)
        mfdim = max(in_channels // 2, 9)
        dims = [widths[pw.feature_type]] + [mfdim] * (n_mlps - 1) \
            + [out_channels]
        self.num_mlps = n_mlps
        for i in range(n_mlps):
            self.add_module(f"ConvBN_{i}", ConvBN(
                dims[i], dims[i + 1], cfg.bn_momentum, generator=generator,
                dtype=compute_dtype(cfg)))

    def forward(self, support_features: torch.Tensor, nbr: Neighborhood,
                query_mask: torch.Tensor) -> torch.Tensor:
        grouped = group_features(gather_support(support_features, nbr),
                                 nbr.idx)  # (B,M,K,C)
        rel = _relative(nbr, self.radius, grouped)
        center = grouped[:, :, :1, :]
        relative = grouped - center
        if self.feature_type == "dp_fj":
            x = torch.cat([rel, relative], dim=-1)
        else:
            x = torch.cat([rel, center.expand_as(grouped), relative],
                          dim=-1)
        for i in range(self.num_mlps):
            x = getattr(self, f"ConvBN_{i}")(x)
        return masked_reduce(x, nbr, query_mask, self.reduction)


OPERATORS = {"pseudo_grid": PseudoGrid, "pospool": PosPool,
             "adaptive_weight": AdaptiveWeight,
             "pointwisemlp": PointWiseMLP}


class LocalAggregation(nn.Module):
    """Dispatch over aggregation operators, the operator under its class's
    name (``PseudoGrid_0``, ..., ``AttentionAggregation_0``).
    ``num_queries``, the query slots of the level it runs at, sizes the
    point-axis layers of the ``CAA`` attention (Flax infers them from the
    input)."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 cfg: Config, generator: Optional[torch.Generator] = None,
                 num_queries: Optional[int] = None):
        super().__init__()
        kind = cfg.local_aggregation_type
        if kind == "attention":
            from .attention import AttentionAggregation
            op = AttentionAggregation(in_channels, out_channels, radius, cfg,
                                      generator, num_queries)
        elif kind in OPERATORS:
            op = OPERATORS[kind](in_channels, out_channels, radius, cfg,
                                 generator)
        else:
            raise NotImplementedError(
                f"LocalAggregation {kind} not implemented")
        self.op = type(op).__name__ + "_0"
        self.add_module(self.op, op)

    def forward(self, support_features: torch.Tensor, nbr: Neighborhood,
                query_mask: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.op)(support_features, nbr, query_mask)

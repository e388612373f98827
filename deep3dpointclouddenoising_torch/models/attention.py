"""The attention operators and the attention local-aggregation wrapper.

Counterpart of ``deep3dpointclouddenoising_tpu/models/attention.py``, in
channels-last ``(B, N, C)`` layout.  Every global operator is dense
``O(N^2)`` over one padded patch: it attends over every slot, padding
included, with no mask, and its BatchNorms take their statistics over
every slot, as JAX's do.  Submodules keep the Flax tree's names (Flax
numbers ``Dense`` and ``BatchNorm`` separately, in creation order); the
scalar gates ``gamma`` and ``alpha`` start at zero, so a fresh operator is
the identity on its residual path.

BatchNorms use torch momentum 0.1 (Flax 0.9, ``_BN_MOM``), CBAM's spatial
one 0.01 (Flax 0.99).  ``Dense`` layers start as Flax's default
(``lecun_normal`` kernel, zero bias).  A max is ``amax`` (an even split of
the gradient among ties, as ``jnp.max``).

In the point-sharded spatial model (``parallel/spatial.py``) a global
operator is given this rank's rows of a level and its
:class:`..parallel.dist.PointShard` (``shard``), and reduces over the
whole level, as GSPMD partitions JAX's: the row-softmax operators
(Non-local, A-SCN, Point-attention, PAM, Criss-cross) all-gather their
keys and values in one call and take each local query's softmax over
every key (Criss-cross's ``-inf`` at the query's global column);
Offset-attention all-reduces its column sums and hands each rank its rows
of ``att^T v`` (:func:`..parallel.dist.reduce_scatter_points`); CAM
all-reduces ``x^T x``; SE and CBAM take their mean over every slot
(padding included) and CBAM its max by
:func:`..parallel.dist.all_reduce_max`; CAA multiplies its rows by its
point-axis kernels' rows and all-reduces the partial products, which every
rank then holds whole: their train-mode BatchNorms take the statistics of
every rank's copies, which are the batch's (equal copies leave the mean
and variance as they are, and the points group's gradient sum gives back
each copy's share of the statistics' gradient).  Point
Transformer all-gathers its support rows, as the local operators do.
Without a shard (the plain model, or one process) every operator runs its
plain form.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..config import Config
from ..ops import group_features
from ..parallel.dist import (PointShard, all_gather_points, all_reduce_max,
                             all_reduce_sum, reduce_scatter_points)
from .layers import ChannelsLastBatchNorm, dense
from .local_aggregation import PointWiseMLP, closing_layer, gather_support
from .pyramid import Neighborhood, query_shard

_BN_MOMENTUM = 0.1     # torch convention; Flax 0.9
_CBAM_BN_MOMENTUM = 0.01  # Flax 0.99


def _bn(channels: int) -> ChannelsLastBatchNorm:
    return ChannelsLastBatchNorm(channels, _BN_MOMENTUM)


def _gate(name: str, module: nn.Module) -> None:
    """A scalar gate ``name`` of shape (1,), zero at start."""
    module.register_parameter(name, nn.Parameter(torch.zeros(1)))


def _add(module: nn.Module, kind: str, layers) -> None:
    """Register ``layers`` as ``{kind}_0``, ``{kind}_1``, ..."""
    for i, layer in enumerate(layers):
        module.add_module(f"{kind}_{i}", layer)


def _branch(module: nn.Module, i: int, x: torch.Tensor) -> torch.Tensor:
    """ReLU(BatchNorm_i(Dense_i(x)))."""
    return F.relu(getattr(module, f"BatchNorm_{i}")(
        getattr(module, f"Dense_{i}")(x)))


def _whole(shard: Optional[PointShard], *xs: torch.Tensor):
    """The point axes of ``xs`` whole: ``xs`` in the plain model, every
    rank's rows all-gathered over ``shard.group`` in one call (joined on
    the channels, split after) in the point-sharded one."""
    if shard is None:
        return xs
    widths = [x.shape[-1] for x in xs]
    whole = all_gather_points(torch.cat(xs, dim=-1), shard.n, shard.group)
    return torch.split(whole, widths, dim=-1)


def _point_mean(x: torch.Tensor, shard: Optional[PointShard],
                keepdim: bool = False) -> torch.Tensor:
    """The mean over every slot of the point axis (padding included)."""
    if shard is None:
        return x.mean(dim=1, keepdim=keepdim)
    return all_reduce_sum(x.sum(dim=1, keepdim=keepdim),
                          shard.group) / shard.n


class OffsetAttention(nn.Module):
    """PCT-style offset attention: q and k share ``Dense_0`` under two
    BatchNorms; softmax over keys, then each column over its sum; the
    offset ``x - x_r`` through a transform layer, added back."""

    def __init__(self, channels: int, ratio: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c_lat = channels // ratio
        _add(self, "Dense", [
            dense(channels, c_lat, False, generator),
            dense(channels, channels, True, generator),
            dense(channels, channels, True, generator)])
        _add(self, "BatchNorm", [_bn(c_lat), _bn(c_lat), _bn(channels),
                                 _bn(channels)])

    def forward(self, x: torch.Tensor,
                shard: Optional[PointShard] = None) -> torch.Tensor:
        qk = self.Dense_0(x)
        x_q = F.relu(self.BatchNorm_0(qk))
        x_k, = _whole(shard, F.relu(self.BatchNorm_1(qk)))
        x_v = F.relu(self.BatchNorm_2(self.Dense_1(x)))
        att = torch.softmax(x_q @ x_k.transpose(1, 2), dim=-1)
        if shard is None:
            att = att / (1e-9 + att.sum(dim=1, keepdim=True))
            x_r = att.transpose(1, 2) @ x_v
        else:
            # columns over every rank's queries; the rows of att^T x_v
            # are keys, summed over the ranks and handed to their owners
            att = att / (1e-9 + all_reduce_sum(
                att.sum(dim=1, keepdim=True), shard.group))
            x_r = reduce_scatter_points(att.transpose(1, 2) @ x_v, shard.n,
                                        shard.group)
        x_r = F.relu(self.BatchNorm_3(self.Dense_2(x - x_r)))
        return x + x_r


class _QKV(nn.Module):
    """q, k (``c_lat`` channels) and v branches, each ReLU(BN(Dense(x)))
    without bias, as ``Dense_0..2`` / ``BatchNorm_0..2``."""

    def __init__(self, channels: int, ratio: int, v_channels: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        c_lat = channels // ratio
        widths = [c_lat, c_lat, v_channels]
        _add(self, "Dense", [dense(channels, w, False, generator)
                             for w in widths])
        _add(self, "BatchNorm", [_bn(w) for w in widths])

    def qkv(self, x: torch.Tensor):
        return tuple(_branch(self, i, x) for i in range(3))


class PointAttentionNetwork(_QKV):
    """x + softmax(a b^T) d."""

    def __init__(self, channels: int, ratio: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__(channels, ratio, channels, generator)

    def forward(self, x: torch.Tensor,
                shard: Optional[PointShard] = None) -> torch.Tensor:
        a, b, d = self.qkv(x)
        b, d = _whole(shard, b, d)
        return x + torch.softmax(a @ b.transpose(1, 2), dim=-1) @ d


class ShapeContext(_QKV):
    """A-SCN: softmax(q k^T) v + v."""

    def __init__(self, channels: int, ratio: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__(channels, ratio, channels, generator)

    def forward(self, x: torch.Tensor,
                shard: Optional[PointShard] = None) -> torch.Tensor:
        q, k, v = self.qkv(x)
        k_all, v_all = _whole(shard, k, v)
        return torch.softmax(q @ k_all.transpose(1, 2), dim=-1) @ v_all + v


class CrissCrossAttention(_QKV):
    """Criss-cross attention on the (N, 1) grid: row attention over every
    other point (the diagonal at ``-inf``) and a self branch, softmaxed
    jointly; ``gamma * (out_h + out_w) + x``."""

    def __init__(self, channels: int, ratio: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__(channels, ratio, channels, generator)
        _gate("gamma", self)

    def forward(self, x: torch.Tensor,
                shard: Optional[PointShard] = None) -> torch.Tensor:
        q, k, v = self.qkv(x)
        k_all, v_all = _whole(shard, k, v)
        n = k_all.shape[1]
        # each query's own column: its row of the whole level
        row0 = 0 if shard is None else shard.rows.start
        eye = (torch.arange(x.shape[1], device=x.device) + row0)[:, None] \
            == torch.arange(n, device=x.device)[None, :]
        energy_h = (q @ k_all.transpose(1, 2)).masked_fill(eye,
                                                           float("-inf"))
        energy_w = (q * k).sum(dim=-1, keepdim=True)
        att = torch.softmax(torch.cat([energy_h, energy_w], dim=-1), dim=-1)
        out = att[..., :n] @ v_all + v * att[..., n:]
        return self.gamma * out + x


class PAM(nn.Module):
    """Position attention: ``gamma * softmax(a b^T) d + x``, the three
    Dense layers with bias."""

    def __init__(self, channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c_lat = channels // 8
        _add(self, "Dense", [dense(channels, w, True, generator)
                             for w in (c_lat, c_lat, channels)])
        _gate("gamma", self)

    def forward(self, x: torch.Tensor,
                shard: Optional[PointShard] = None) -> torch.Tensor:
        k, v = _whole(shard, self.Dense_1(x), self.Dense_2(x))
        att = torch.softmax(self.Dense_0(x) @ k.transpose(1, 2), dim=-1)
        return self.gamma * (att @ v) + x


class CAM(nn.Module):
    """Channel attention: g = x^T x (B, C, C), softmax of ``max(g) - g``
    over axis 1 (torch ``Softmax(dim=1)`` in the reference), applied to
    the channels; ``gamma * out + x``."""

    def __init__(self, channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _gate("gamma", self)

    def forward(self, x: torch.Tensor,
                shard: Optional[PointShard] = None) -> torch.Tensor:
        g = x.transpose(1, 2) @ x
        if shard is not None:
            g = all_reduce_sum(g, shard.group)
        att = torch.softmax(g.amax(dim=-1, keepdim=True) - g, dim=1)
        return self.gamma * (x @ att.transpose(1, 2)) + x


class DualAttention(nn.Module):
    """CAM + PAM."""

    def __init__(self, channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.CAM_0 = CAM(channels, generator)
        self.PAM_0 = PAM(channels, generator)

    def forward(self, x: torch.Tensor,
                shard: Optional[PointShard] = None) -> torch.Tensor:
        return self.CAM_0(x, shard) + self.PAM_0(x, shard)


class CBAMAttention(nn.Module):
    """CBAM: channel attention (a shared two-layer MLP, ``Dense_0`` and
    ``Dense_1``, over the mean and max over points), then spatial
    attention (``Dense_2`` over each point's channel max and mean, BN,
    ReLU)."""

    def __init__(self, channels: int, ratio: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _add(self, "Dense", [
            dense(channels, channels // ratio, False, generator),
            dense(channels // ratio, channels, False, generator),
            dense(2, 1, False, generator)])
        self.BatchNorm_0 = ChannelsLastBatchNorm(1, _CBAM_BN_MOMENTUM)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(x)))

    def forward(self, x: torch.Tensor,
                shard: Optional[PointShard] = None) -> torch.Tensor:
        avg = _point_mean(x, shard, keepdim=True)
        mx = x.amax(dim=1, keepdim=True) if shard is None \
            else all_reduce_max(x, 1, shard.group)
        x = x * torch.sigmoid(self._mlp(avg) + self._mlp(mx))
        stats = torch.cat([x.amax(dim=-1, keepdim=True),
                           x.mean(dim=-1, keepdim=True)], dim=-1)
        s = F.relu(self.BatchNorm_0(self.Dense_2(stats)))
        return x * torch.sigmoid(s)


class NonLocalModule(_QKV):
    """Non-local block with a latent-channel value path:
    ``gamma * ReLU(BN(Dense_3(softmax(q k^T) v))) + x``."""

    def __init__(self, channels: int, latent: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__(channels, latent, channels // latent, generator)
        self.Dense_3 = dense(channels // latent, channels, False, generator)
        self.BatchNorm_3 = _bn(channels)
        _gate("gamma", self)

    def forward(self, x: torch.Tensor,
                shard: Optional[PointShard] = None) -> torch.Tensor:
        q, k, v = self.qkv(x)
        k, v = _whole(shard, k, v)
        agg = torch.softmax(q @ k.transpose(1, 2), dim=-1) @ v
        return self.gamma * _branch(self, 3, agg) + x


class CAA_Module(nn.Module):  # noqa: N801 (the Flax tree's name)
    """Channel-wise affinity attention: the q and k layers run over the
    point axis of ``(B, C, N)`` (so their width depends on the level's
    ``num_points``), their BatchNorms over its ``max(N/8, 1)`` outputs;
    ``alpha * out + x``.  Point-sharded, each rank multiplies its rows by
    its rows of the two kernels and one all-reduce adds the partial
    products; a level of another slot count than the one it was built
    for is refused."""

    def __init__(self, channels: int, num_points: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n_lat = max(num_points // 8, 1)
        _add(self, "Dense", [
            dense(num_points, n_lat, False, generator),
            dense(num_points, n_lat, False, generator),
            dense(channels, channels, False, generator)])
        _add(self, "BatchNorm", [_bn(n_lat), _bn(n_lat), _bn(channels)])
        _gate("alpha", self)

    def forward(self, x: torch.Tensor,
                shard: Optional[PointShard] = None) -> torch.Tensor:
        xt = x.transpose(1, 2)                        # (B, C, N)
        if shard is None:
            q, k = _branch(self, 0, xt), _branch(self, 1, xt)
        else:
            n, n_lat = self.Dense_0.in_features, self.Dense_0.out_features
            if shard.n != n:
                raise ValueError(
                    f"CAA was built for levels of {n} slots; this one has "
                    f"{shard.n} (its point-axis Dense layers take the slot "
                    "count they were built for)")
            rows = shard.rows
            w = torch.cat([self.Dense_0.weight[:, rows],
                           self.Dense_1.weight[:, rows]])
            qk = all_reduce_sum(F.linear(xt, w), shard.group)
            q, k = (F.relu(getattr(self, f"BatchNorm_{i}")(part))
                    for i, part in enumerate(qk.split(n_lat, dim=-1)))
        sim = k @ q.transpose(1, 2)                   # (B, C, C)
        aff = torch.softmax(sim.amax(dim=-1, keepdim=True) - sim, dim=-1)
        v = _branch(self, 2, x)                       # (B, N, C)
        return self.alpha * (v @ aff.transpose(1, 2)) + x


class SE(nn.Module):
    """Squeeze-and-excitation over the mean over points."""

    def __init__(self, channels: int, r: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _add(self, "Dense", [
            dense(channels, channels // r, False, generator),
            dense(channels // r, channels, False, generator)])

    def forward(self, x: torch.Tensor,
                shard: Optional[PointShard] = None) -> torch.Tensor:
        s = F.relu(self.Dense_0(_point_mean(x, shard)))
        return x * torch.sigmoid(self.Dense_1(s))[:, None, :]


class PointTransformer(nn.Module):
    """Vector attention over ball neighbourhoods: x_i is slot 0 of the
    distance-sorted neighbourhood; the softmax is over the neighbours and
    the sum over the live ones (all slots of a padding query)."""

    def __init__(self, channels: int, radius: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        C = channels
        self.radius = float(radius)
        # delta (2), lin_i, lin_j, relation (2), feats; all with bias
        _add(self, "Dense", [dense(3 if i == 0 else C, C, True, generator)
                             for i in range(7)])
        _add(self, "BatchNorm", [_bn(C), _bn(C)])

    def forward(self, support_features: torch.Tensor, nbr: Neighborhood,
                query_mask: torch.Tensor) -> torch.Tensor:
        x_j = group_features(gather_support(support_features, nbr),
                             nbr.idx)  # (B,M,K,C)
        rel = nbr.rel_xyz.to(x_j.dtype) / self.radius
        delta = F.relu(self.BatchNorm_0(self.Dense_1(self.Dense_0(rel))))
        # Dense_2 of the broadcast centre, taken once per query
        relation = self.Dense_2(x_j[:, :, :1, :]) - self.Dense_3(x_j) + delta
        relation = F.relu(self.BatchNorm_1(self.Dense_5(
            self.Dense_4(relation))))
        weights = torch.softmax(relation, dim=2)
        feats = self.Dense_6(x_j) + delta
        fmask = (nbr.mask + (1.0 - query_mask[:, :, None]))[..., None]
        return (weights * feats * fmask).sum(dim=2)


_GLOBAL_ATTENTION = {
    "Non-local": NonLocalModule,
    "Criss-cross": CrissCrossAttention,
    "SE": SE,
    "CBAM": CBAMAttention,
    "Dual-attention": DualAttention,
    "A-SCN": ShapeContext,
    "Point-attention": PointAttentionNetwork,
    "Offset-attention": OffsetAttention,
}
ATTENTION_TYPES = tuple(_GLOBAL_ATTENTION) + ("CAA", "Point-transformer")


class AttentionAggregation(nn.Module):
    """The attention local aggregation: ``Point-transformer``, or a
    PointWiseMLP aggregation followed by a global attention operator
    (``cfg.attention.type``); then BN + ReLU, or a ``ConvBN`` (which, as
    in JAX, gets no compute dtype) when the channel counts differ.
    ``num_queries``, the level's query slots, sizes ``CAA``."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 cfg: Config, generator: Optional[torch.Generator] = None,
                 num_queries: Optional[int] = None):
        super().__init__()
        kind = cfg.attention.type
        if kind not in ATTENTION_TYPES:
            raise NotImplementedError(f"Attention type {kind}")
        if kind == "Point-transformer":
            self.PointTransformer_0 = PointTransformer(in_channels, radius,
                                                       generator)
            self.ops = ["PointTransformer_0"]
        else:
            if in_channels != out_channels:
                raise ValueError(
                    f"attention {kind}: its operator takes the "
                    f"{in_channels} channels it was built for and gets "
                    f"PointWiseMLP's {out_channels}")
            self.PointWiseMLP_0 = PointWiseMLP(in_channels, out_channels,
                                               radius, cfg, generator)
            if kind == "CAA":
                if num_queries is None:
                    raise ValueError("attention CAA needs the level's "
                                     "num_queries")
                mod = CAA_Module(in_channels, int(num_queries), generator)
            else:
                mod = _GLOBAL_ATTENTION[kind](in_channels,
                                              generator=generator)
            name = type(mod).__name__ + "_0"
            self.add_module(name, mod)
            self.ops = ["PointWiseMLP_0", name]
        closing_layer(self, False, in_channels, out_channels, cfg, generator,
                      None)

    def forward(self, support_features: torch.Tensor, nbr: Neighborhood,
                query_mask: torch.Tensor) -> torch.Tensor:
        first, *rest = self.ops
        out = getattr(self, first)(support_features, nbr, query_mask)
        shard = query_shard(nbr)
        for name in rest:
            out = getattr(self, name)(out, shard)
        return getattr(self, self.post)(out)

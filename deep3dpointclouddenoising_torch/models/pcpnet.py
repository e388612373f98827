"""PCPNet / PointCleanNet baseline models.

Counterpart of ``deep3dpointclouddenoising_tpu/models/pcpnet.py``:
quaternion spatial transformers, PointNet feature extractors, the
small-init residual ``BasicBlock`` and the four model variants
(``ResPCPNet``, which ``build_offset_regression_PCN`` builds, ``PCPNet``,
``ResMSPCPNet`` and ``MSPCPNet``).  Points come in as (B, N, 3), or the
scales concatenated along the point axis (B, S*N, 3) for the multi-scale
models; each model returns ``(pred (B, out), trans (B, 3, 3), trans2
(B, 64, 64))`` (``None`` for a transformer it does not use).

Submodule names follow the Flax tree (``PointNetFeat_0.STN_0.BasicBlock_2.
Dense_1``), so ``convert.params_from_flax`` maps a Flax tree one to one.
BatchNorm momentums are torch's, one minus Flax's: 0.01 in a
``BasicBlock`` (Flax 0.99), 0.1 in its projected shortcut (Flax 0.9) and
``bn_momentum`` (0.1) in a ``DenseBN``.  The symmetric max over points is
``amax``, whose gradient, like JAX's, is shared equally among tied
maxima.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn
import torch.nn.functional as F

from .layers import ChannelsLastBatchNorm, Dropout, dense

# a BasicBlock's BatchNorms and its shortcut's, in torch's convention
_BLOCK_MOM = 0.01
_SHORTCUT_MOM = 0.1
_SMALL_INIT = 1e-3
_DROPOUT = 0.3


def batch_quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(B, 4) quaternions [a, b, c, d] -> (B, 3, 3) rotations."""
    s = 2.0 / torch.sum(q * q, dim=1)
    a, b, c, d = q.unbind(1)
    r = torch.stack([
        1 - (c * c + d * d) * s, (b * c - d * a) * s, (b * d + c * a) * s,
        (b * c + d * a) * s, 1 - (b * b + d * d) * s, (c * d - b * a) * s,
        (b * d - c * a) * s, (c * d + b * a) * s, 1 - (b * b + c * c) * s,
    ], dim=-1)
    return r.reshape(-1, 3, 3)


def small_dense(in_features: int, out_features: int,
                generator: Optional[torch.Generator] = None) -> nn.Linear:
    """A Dense whose kernel and bias are uniform in +-1e-3 (drawn without
    torch's default initialisation before them)."""
    layer = nn.utils.skip_init(nn.Linear, in_features, out_features)
    for p in (layer.weight, layer.bias):
        nn.init.uniform_(p, -_SMALL_INIT, _SMALL_INIT, generator=generator)
    return layer


class DenseBN(nn.Module):
    """Dense, BatchNorm, ReLU."""

    def __init__(self, in_features: int, features: int,
                 bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = dense(in_features, features, generator=generator)
        self.BatchNorm_0 = ChannelsLastBatchNorm(features, bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Dense_0(x)))


class BasicBlock(nn.Module):
    """Small-init residual MLP block: two Dense + BatchNorm layers and an
    identity shortcut, or a projected one where the width changes."""

    def __init__(self, in_features: int, planes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = small_dense(in_features, planes, generator)
        self.BatchNorm_0 = ChannelsLastBatchNorm(planes, _BLOCK_MOM)
        self.Dense_1 = small_dense(planes, planes, generator)
        self.BatchNorm_1 = ChannelsLastBatchNorm(planes, _BLOCK_MOM)
        self.project = in_features != planes
        if self.project:
            self.Dense_2 = small_dense(in_features, planes, generator)
            self.BatchNorm_2 = ChannelsLastBatchNorm(planes, _SHORTCUT_MOM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.BatchNorm_0(self.Dense_0(x)))
        out = self.BatchNorm_1(self.Dense_1(out))
        sc = self.BatchNorm_2(self.Dense_2(x)) if self.project else x
        return F.relu(out + sc)


def _per_scale_max(x: torch.Tensor, num_scales: int) -> torch.Tensor:
    """(B, S*N, C) -> (B, S*C): the max within each scale's segment."""
    B, SN, C = x.shape
    return torch.amax(x.reshape(B, num_scales, SN // num_scales, C),
                      dim=2).reshape(B, -1)


def _add_blocks(owner: nn.Module, kind: str, widths: List[int],
                in_features: int, make) -> int:
    """Add ``kind_0``, ``kind_1``, ... of the given widths to ``owner``,
    numbered after those it has; returns the last width."""
    start = sum(1 for n, _ in owner.named_children()
                if n.startswith(kind + "_"))
    for i, w in enumerate(widths):
        owner.add_module(f"{kind}_{start + i}", make(in_features, w))
        in_features = w
    return in_features


class STN(nn.Module):
    """Spatial transformer: quaternion mode adds the identity quaternion
    and converts it to a rotation; matrix mode adds the identity matrix.
    With ``num_scales > 1`` the max runs per scale and a 1024 layer merges
    the scales' features."""

    def __init__(self, in_features: int, dim: int = 3,
                 quaternion: bool = False, residual: bool = False,
                 num_scales: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.quaternion = dim, quaternion
        self.num_scales = num_scales
        out = 4 if quaternion else dim * dim
        if residual:
            kind, make = "BasicBlock", lambda i, o: BasicBlock(i, o,
                                                                generator)
        else:
            kind, make = "DenseBN", lambda i, o: DenseBN(
                i, o, generator=generator)
        c = _add_blocks(self, kind, [64, 128, 1024], in_features, make)
        self.n_pre = 3
        c *= num_scales
        post = ([1024] if num_scales > 1 else []) + [512, 256]
        if residual:
            post.append(out)
        _add_blocks(self, kind, post, c, make)
        if not residual:
            self.Dense_0 = dense(256, out, generator=generator)
        self.blocks = [m for n, m in self.named_children()
                       if n.startswith(kind + "_")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for block in self.blocks[:self.n_pre]:
            h = block(h)
        h = _per_scale_max(h, self.num_scales)
        for block in self.blocks[self.n_pre:]:
            h = block(h)
        if hasattr(self, "Dense_0"):
            h = self.Dense_0(h)
        if self.quaternion:
            return batch_quat_to_rotmat(
                h + h.new_tensor([1.0, 0.0, 0.0, 0.0]))
        h = h + torch.eye(self.dim, dtype=h.dtype,
                          device=h.device).reshape(-1)
        return h.reshape(-1, self.dim, self.dim)


class PointNetFeat(nn.Module):
    """PointNet global feature: the point STN (a rotation), two layers,
    the feature STN (64 x 64), three layers (a fourth of width
    1024 * S with S scales), the symmetric op per scale: (B, 1024 * S^2).
    Both transforms multiply the points on the right."""

    def __init__(self, use_point_stn: bool = True, use_feat_stn: bool = True,
                 sym_op: str = "max", residual: bool = True,
                 num_scales: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if sym_op not in ("max", "sum"):
            raise ValueError(f"Unsupported symmetric op {sym_op}")
        self.sym_op, self.num_scales = sym_op, num_scales
        kind = "BasicBlock" if residual else "DenseBN"
        make = (lambda i, o: BasicBlock(i, o, generator)) if residual \
            else (lambda i, o: DenseBN(i, o, generator=generator))
        stns = []
        if use_point_stn:
            stns.append(STN(3, dim=3, quaternion=True, residual=residual,
                            num_scales=num_scales, generator=generator))
        _add_blocks(self, kind, [64, 64], 3, make)
        if use_feat_stn:
            stns.append(STN(64, dim=64, residual=residual,
                            num_scales=num_scales, generator=generator))
        widths = [64, 128, 1024] + ([1024 * num_scales]
                                    if num_scales > 1 else [])
        _add_blocks(self, kind, widths, 64, make)
        for i, stn in enumerate(stns):
            self.add_module(f"STN_{i}", stn)
        # the transformers by role (a list, so that they are not
        # registered twice)
        self.stns = [stns[0] if use_point_stn else None,
                     stns[-1] if use_feat_stn else None]
        self.blocks = [m for n, m in self.named_children()
                       if n.startswith(kind + "_")]

    def forward(self, x: torch.Tensor):
        point_stn, feat_stn = self.stns
        trans = trans2 = None
        if point_stn is not None:
            trans = point_stn(x)
            x = torch.bmm(x, trans)
        for block in self.blocks[:2]:
            x = block(x)
        if feat_stn is not None:
            trans2 = feat_stn(x)
            x = torch.bmm(x, trans2)
        for block in self.blocks[2:]:
            x = block(x)
        B, SN, C = x.shape
        x = x.reshape(B, self.num_scales, SN // self.num_scales, C)
        x = torch.amax(x, dim=2) if self.sym_op == "max" \
            else torch.sum(x, dim=2)
        return x.reshape(B, -1), trans, trans2


class ResPCPNet(nn.Module):
    """Residual PCPNet: one output vector per patch, the PCN-baseline
    generator.  ``linear_output`` (the default, as in the JAX package)
    ends in a small-init linear Dense; without it the head is a
    ``BasicBlock``, whose final ReLU lets it emit non-negative offsets
    only."""

    def __init__(self, output_dim: int = 3, use_point_stn: bool = True,
                 use_feat_stn: bool = True, sym_op: str = "max",
                 linear_output: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.PointNetFeat_0 = PointNetFeat(use_point_stn, use_feat_stn,
                                           sym_op, True, 1, generator)
        self.BasicBlock_0 = BasicBlock(1024, 512, generator)
        self.BasicBlock_1 = BasicBlock(512, 256, generator)
        if linear_output:
            self.Dense_0 = small_dense(256, output_dim, generator)
        else:
            self.BasicBlock_2 = BasicBlock(256, output_dim, generator)

    def forward(self, x: torch.Tensor):
        feat, trans, trans2 = self.PointNetFeat_0(x)
        h = self.BasicBlock_1(self.BasicBlock_0(feat))
        h = self.Dense_0(h) if hasattr(self, "Dense_0") \
            else self.BasicBlock_2(h)
        return h, trans, trans2


class _DropoutHead(nn.Module):
    """DenseBN layers of ``widths`` with a Dropout after the last two, then
    a Dense: the head of the vanilla PCPNets.  In train mode the Dropouts
    draw from ``generator``, or take ``keep_masks`` (one per Dropout)."""

    def __init__(self, in_features: int, widths: List[int], output_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = in_features
        for i, w in enumerate(widths):
            self.add_module(f"DenseBN_{i}", DenseBN(c, w,
                                                    generator=generator))
            c = w
        self.Dense_0 = dense(c, output_dim, generator=generator)
        self.drop = Dropout(_DROPOUT)
        self.n_dense = len(widths)

    def head(self, feat: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             keep_masks: Optional[List[torch.Tensor]] = None
             ) -> torch.Tensor:
        h, k = feat, 0
        for i in range(self.n_dense):
            h = getattr(self, f"DenseBN_{i}")(h)
            if i >= self.n_dense - 2:
                h = self.drop(h, generator,
                              None if keep_masks is None else keep_masks[k])
                k += 1
        return self.Dense_0(h)


class PCPNet(_DropoutHead):
    """Vanilla PCPNet: DenseBN 512, Dropout, DenseBN 256, Dropout,
    Dense."""

    def __init__(self, output_dim: int = 3, use_point_stn: bool = True,
                 use_feat_stn: bool = True, sym_op: str = "max",
                 generator: Optional[torch.Generator] = None):
        feat = PointNetFeat(use_point_stn, use_feat_stn, sym_op, False, 1,
                            generator)
        super().__init__(1024, [512, 256], output_dim, generator)
        self.PointNetFeat_0 = feat

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                keep_masks: Optional[List[torch.Tensor]] = None):
        feat, trans, trans2 = self.PointNetFeat_0(x)
        return self.head(feat, generator, keep_masks), trans, trans2


class ResMSPCPNet(nn.Module):
    """Multi-scale residual PCPNet: the scales concatenated along the
    point axis; four BasicBlocks (1024, 512, 256, out) on the
    (B, 1024 * S^2) feature."""

    def __init__(self, num_scales: int = 2, output_dim: int = 3,
                 use_point_stn: bool = True, use_feat_stn: bool = True,
                 sym_op: str = "max",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.PointNetFeat_0 = PointNetFeat(use_point_stn, use_feat_stn,
                                           sym_op, True, num_scales,
                                           generator)
        _add_blocks(self, "BasicBlock", [1024, 512, 256, output_dim],
                    1024 * num_scales * num_scales,
                    lambda i, o: BasicBlock(i, o, generator))

    def forward(self, x: torch.Tensor):
        h, trans, trans2 = self.PointNetFeat_0(x)
        for i in range(4):
            h = getattr(self, f"BasicBlock_{i}")(h)
        return h, trans, trans2


class MSPCPNet(_DropoutHead):
    """Multi-scale vanilla PCPNet: DenseBN 1024, DenseBN 512, Dropout,
    DenseBN 256, Dropout, Dense."""

    def __init__(self, num_scales: int = 2, output_dim: int = 3,
                 use_point_stn: bool = True, use_feat_stn: bool = True,
                 sym_op: str = "max",
                 generator: Optional[torch.Generator] = None):
        feat = PointNetFeat(use_point_stn, use_feat_stn, sym_op, False,
                            num_scales, generator)
        super().__init__(1024 * num_scales * num_scales, [1024, 512, 256],
                         output_dim, generator)
        self.PointNetFeat_0 = feat

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                keep_masks: Optional[List[torch.Tensor]] = None):
        feat, trans, trans2 = self.PointNetFeat_0(x)
        return self.head(feat, generator, keep_masks), trans, trans2

"""KPConv-style ResNet encoder over a precomputed geometry pyramid.

Counterpart of ``deep3dpointclouddenoising_tpu/models/resnet.py``: a stem
at width/2, then strided stages that double width, radius and voxel size.
Blocks are named ``Bottleneck_N`` in creation order, as in the Flax tree.

With ``cfg.remat`` every bottleneck runs under
``torch.utils.checkpoint`` while gradients are recorded (the JAX package's
``nn.remat``): its activations are dropped after the forward and
recomputed in the backward, so a train step launches the aggregation's
forward kernel once more per bottleneck (19 times at depth 2, not 10).
The parameter names stay those of the Flax tree.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Optional

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..ops import group_features
from .layers import ConvBN, compute_dtype
from .local_aggregation import LocalAggregation
from .pyramid import Neighborhood, Pyramid


def masked_max_pool(features: torch.Tensor, nbr: Neighborhood
                    ) -> torch.Tensor:
    """Strided max-pool: fine features gathered at the coarse queries'
    neighbours, max over the neighbourhood (padding slots cycle real
    neighbours, so no mask is needed)."""
    return group_features(features, nbr.idx).amax(dim=2)


class Bottleneck(nn.Module):
    """Residual bottleneck: conv1 (1x1, C_out/ratio) -> local aggregation ->
    conv2 (1x1, C_out) + shortcut.  The strided variant max-pools the
    identity path to the coarse level."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 cfg: Config, strided: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mid = out_channels // int(cfg.bottleneck_ratio)
        dt = compute_dtype(cfg)
        self.strided = strided
        self.ConvBN_0 = ConvBN(in_channels, mid, cfg.bn_momentum,
                               generator=generator, dtype=dt)
        self.LocalAggregation_0 = LocalAggregation(mid, mid, radius, cfg,
                                                   generator)
        self.ConvBN_1 = ConvBN(mid, out_channels, cfg.bn_momentum,
                               relu=False, generator=generator, dtype=dt)
        if in_channels != out_channels:
            self.ConvBN_2 = ConvBN(in_channels, out_channels,
                                   cfg.bn_momentum, relu=False,
                                   generator=generator, dtype=dt)

    def forward(self, features: torch.Tensor, nbr: Neighborhood,
                query_mask: torch.Tensor) -> torch.Tensor:
        identity = masked_max_pool(features, nbr) if self.strided \
            else features
        x = self.ConvBN_0(features)
        x = self.LocalAggregation_0(x, nbr, query_mask)
        x = self.ConvBN_1(x)
        if hasattr(self, "ConvBN_2"):
            identity = self.ConvBN_2(identity)
        return F.relu(x + identity)


_BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


@contextlib.contextmanager
def _scratch_bn_stats(block: nn.Module):
    """Give ``block``'s BatchNorms copies of their running statistics for
    the backward's second forward, and put the originals back after it:
    the step's first forward has updated them once, as Flax's
    ``nn.remat`` does, and the recomputation normalises by the batch's
    statistics alone."""
    norms = [m for m in block.modules() if isinstance(m, nn.BatchNorm1d)]
    kept = [[getattr(m, name) for name in _BN_STATS] for m in norms]
    for m, stats in zip(norms, kept):
        for name, t in zip(_BN_STATS, stats):
            setattr(m, name, t.clone())
    try:
        yield
    finally:
        for m, stats in zip(norms, kept):
            for name, t in zip(_BN_STATS, stats):
                setattr(m, name, t)


def _remat_contexts(block: nn.Module):
    return contextlib.nullcontext(), _scratch_bn_stats(block)


class ResNetEncoder(nn.Module):
    """Five-resolution encoder emitting the res1..res5 feature pyramid."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width, depth = int(cfg.width), int(cfg.depth)
        r0 = float(cfg.radius)
        in_dim = int(cfg.input_features_dim)
        self.depth = depth
        self.remat = bool(int(cfg.remat))
        self.ConvBN_0 = ConvBN(in_dim, width // 2, cfg.bn_momentum,
                               generator=generator, dtype=compute_dtype(cfg))
        self.LocalAggregation_0 = LocalAggregation(width // 2, width // 2,
                                                   r0, cfg, generator)
        blocks = [Bottleneck(width // 2, width, r0, cfg,
                             generator=generator)]
        ch = width
        for i in range(1, len(cfg.npoints) + 1):
            blocks.append(Bottleneck(ch, ch * 2, r0 * (2.0 ** (i - 1)), cfg,
                                     strided=True, generator=generator))
            ch *= 2
            for _ in range(depth - 1):
                blocks.append(Bottleneck(ch, ch, r0 * (2.0 ** i), cfg,
                                         generator=generator))
        self.num_blocks = len(blocks)
        for n, block in enumerate(blocks):
            self.add_module(f"Bottleneck_{n}", block)

    def _run(self, block: nn.Module, x: torch.Tensor, nbr: Neighborhood,
             mask: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return block(x, nbr, mask)
        # the blocks draw no random numbers: no RNG state to keep
        return checkpoint(block, x, nbr, mask, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=functools.partial(_remat_contexts,
                                                       block))

    def forward(self, pyramid: Pyramid, features: torch.Tensor
                ) -> List[torch.Tensor]:
        L0 = pyramid.levels[0]
        x = self.ConvBN_0(features)
        x = self.LocalAggregation_0(x, L0.self_nbr, L0.mask)
        blocks = iter(getattr(self, f"Bottleneck_{n}")
                      for n in range(self.num_blocks))
        x = self._run(next(blocks), x, L0.self_nbr, L0.mask)
        outs = [x]
        for i, tr in enumerate(pyramid.transitions, start=1):
            lvl = pyramid.levels[i]
            x = self._run(next(blocks), x, tr.pool_nbr, lvl.mask)
            for _ in range(self.depth - 1):
                x = self._run(next(blocks), x, lvl.self_nbr, lvl.mask)
            outs.append(x)
        return outs

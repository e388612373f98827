"""U-Net decoder, the per-point regression head, the scene-segmentation
head and the GAN discriminator's head.

Counterpart of ``deep3dpointclouddenoising_tpu/models/heads.py:23-124``
and :147-196 (``_PooledMLPHead``, ``DiscriminatorHead``).
Nearest-neighbour upsampling uses the 1-NN indices of the pyramid.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..config import Config
from ..ops.neighbors import gather_rows
from .layers import (ChannelsLastBatchNorm, ConvBN, Dropout, compute_dtype,
                     dense, he_normal_, linear, masked_global_avg_pool)
from .pyramid import Pyramid


def nearest_upsample(coarse_features: torch.Tensor, up_idx: torch.Tensor
                     ) -> torch.Tensor:
    """(B, N_coarse, C), (B, N_fine) -> (B, N_fine, C): each fine point takes
    its nearest coarse point's feature."""
    return gather_rows(coarse_features, up_idx)


class UNetDecoder(nn.Module):
    """Four nearest-upsample + skip-concat + 1x1 conv steps,
    16w(+8w) -> 4w -> 2w -> w -> w/2."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = int(cfg.width)
        skips = [w * 2 ** i for i in range(4)]  # res1..res4 channels
        prev = w * 16                           # res5
        for step, out_w in enumerate([4 * w, 2 * w, w, w // 2]):
            self.add_module(f"ConvBN_{step}", ConvBN(
                prev + skips[3 - step], out_w, cfg.bn_momentum,
                generator=generator, dtype=compute_dtype(cfg)))
            prev = out_w

    def forward(self, pyramid: Pyramid, feats: Sequence[torch.Tensor]
                ) -> torch.Tensor:
        x = feats[-1]
        for step in range(4):
            lvl = 4 - step  # upsample level -> level-1
            x = nearest_upsample(x, pyramid.transitions[lvl - 1].up_idx)
            x = torch.cat([x, feats[lvl - 1]], dim=-1)
            x = getattr(self, f"ConvBN_{step}")(x)
        return x  # (B, N, w/2) at input resolution


def small_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> None:
    """A regression head's final projection: normal, std 1e-4, so the
    initial prediction is the zero offset."""
    nn.init.normal_(weight, std=1e-4, generator=generator)


def final_he_normal_(weight: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> None:
    """A classification head's final projection: He normal over its
    inputs (the logits start at O(1))."""
    he_normal_(weight, weight.shape[1], generator)


FinalInit = Callable[[torch.Tensor, Optional[torch.Generator]], None]


class MultiDimHead(nn.Module):
    """Per-point head of dimension ``num_out``; ``final_init`` draws the
    final projection's weight (its bias starts at zero)."""

    def __init__(self, num_out: int, cfg: Config,
                 generator: Optional[torch.Generator] = None,
                 final_init: FinalInit = small_normal_):
        super().__init__()
        w = int(cfg.width)
        self.UNetDecoder_0 = UNetDecoder(cfg, generator)
        self.ConvBN_0 = ConvBN(w // 2, w // 2, cfg.bn_momentum,
                               generator=generator, dtype=compute_dtype(cfg))
        self.Dense_0 = linear(w // 2, num_out, True, generator)
        final_init(self.Dense_0.weight, generator)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, pyramid: Pyramid, feats: Sequence[torch.Tensor]
                ) -> torch.Tensor:
        x = self.UNetDecoder_0(pyramid, feats)
        return self.Dense_0(self.ConvBN_0(x)).float()


class SceneSegHead(nn.Module):
    """Per-point class logits (B, N, num_classes): a ``MultiDimHead`` whose
    final projection is He-normal initialised."""

    def __init__(self, num_classes: int, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.MultiDimHead_0 = MultiDimHead(num_classes, cfg, generator,
                                           final_init=final_he_normal_)

    def forward(self, pyramid: Pyramid, feats: Sequence[torch.Tensor]
                ) -> torch.Tensor:
        return self.MultiDimHead_0(pyramid, feats)


class PooledMLPHead(nn.Module):
    """Three blocks of Dense (He normal, zero bias), BatchNorm (torch
    momentum 0.1), the activation and Dropout(0.5), at widths 8w, 4w and
    2w, then Dense(``num_out``) and, with ``final_sigmoid``, a sigmoid:
    the MLP shared by the JAX package's classifier and discriminator heads
    (``_PooledMLPHead``).  ``negative_slope`` > 0 makes the activation a
    leaky ReLU.

    In train mode the three Dropouts draw their keep-masks from
    ``generator`` in block order, or take ``keep_masks`` (three boolean
    tensors) where given (:class:`layers.Dropout`)."""

    def __init__(self, in_features: int, num_out: int, cfg: Config,
                 negative_slope: float = 0.0, final_sigmoid: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = int(cfg.width)
        prev = in_features
        for i, hidden in enumerate((8 * w, 4 * w, 2 * w)):
            self.add_module(f"Dense_{i}",
                            dense(prev, hidden, True, generator, init="he"))
            self.add_module(f"BatchNorm_{i}",
                            ChannelsLastBatchNorm(hidden, 0.1))
            self.add_module(f"Dropout_{i}", Dropout(0.5))
            prev = hidden
        self.Dense_3 = dense(prev, num_out, True, generator, init="he")
        self.negative_slope = float(negative_slope)
        self.final_sigmoid = final_sigmoid

    def forward(self, pooled: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                keep_masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        x = pooled
        for i in range(3):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Dense_{i}")(x))
            x = F.leaky_relu(x, self.negative_slope) if self.negative_slope \
                else F.relu(x)
            x = getattr(self, f"Dropout_{i}")(
                x, generator, None if keep_masks is None else keep_masks[i])
        x = self.Dense_3(x)
        return torch.sigmoid(x) if self.final_sigmoid else x


class DiscriminatorHead(nn.Module):
    """The GAN discriminator's head: the masked global average pool of the
    deepest level's features (16w channels), then a
    :class:`PooledMLPHead` with leaky ReLU (slope 0.01) and a sigmoid:
    (B, 1) probabilities that each cloud is clean.  The submodule keeps
    the Flax name ``_PooledMLPHead_0``, so ``convert.py`` maps it."""

    def __init__(self, cfg: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._PooledMLPHead_0 = PooledMLPHead(
            16 * int(cfg.width), 1, cfg, negative_slope=0.01,
            final_sigmoid=True, generator=generator)

    def forward(self, pyramid: Pyramid, feats: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                keep_masks: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
        pooled = masked_global_avg_pool(feats[-1], pyramid.levels[-1].mask)
        return self._PooledMLPHead_0(pooled, generator, keep_masks)

"""U-Net decoder and the per-point regression head.

Counterpart of ``deep3dpointclouddenoising_tpu/models/heads.py:23-108``.
Nearest-neighbour upsampling uses the 1-NN indices of the pyramid.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..config import Config
from ..ops.neighbors import gather_rows
from .layers import ConvBN
from .pyramid import Pyramid


def nearest_upsample(coarse_features: torch.Tensor, up_idx: torch.Tensor
                     ) -> torch.Tensor:
    """(B, N_coarse, C), (B, N_fine) -> (B, N_fine, C): each fine point takes
    its nearest coarse point's feature."""
    return gather_rows(coarse_features, up_idx)


class UNetDecoder(nn.Module):
    """Four nearest-upsample + skip-concat + 1x1 conv steps,
    16w(+8w) -> 4w -> 2w -> w -> w/2."""

    def __init__(self, cfg: Config):
        super().__init__()
        w = int(cfg.width)
        skips = [w * 2 ** i for i in range(4)]  # res1..res4 channels
        prev = w * 16                           # res5
        for step, out_w in enumerate([4 * w, 2 * w, w, w // 2]):
            self.add_module(f"ConvBN_{step}", ConvBN(
                prev + skips[3 - step], out_w, cfg.bn_momentum))
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


class MultiDimHead(nn.Module):
    """Per-point head of dimension ``num_out``.  The final projection of a
    regression head starts near zero (normal, std 1e-4), so the initial
    prediction is the zero offset."""

    def __init__(self, num_out: int, cfg: Config):
        super().__init__()
        w = int(cfg.width)
        self.UNetDecoder_0 = UNetDecoder(cfg)
        self.ConvBN_0 = ConvBN(w // 2, w // 2, cfg.bn_momentum)
        self.Dense_0 = nn.Linear(w // 2, num_out, bias=True)
        nn.init.normal_(self.Dense_0.weight, std=1e-4)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, pyramid: Pyramid, feats: Sequence[torch.Tensor]
                ) -> torch.Tensor:
        x = self.UNetDecoder_0(pyramid, feats)
        return self.Dense_0(self.ConvBN_0(x)).float()

"""Basic building blocks in channels-last (B, N, C) layout.

Counterpart of ``deep3dpointclouddenoising_tpu/models/layers.py``.  A 1x1
convolution is a ``Linear`` over the trailing channel axis; BatchNorm takes
its statistics over (batch, points) per channel.  Submodule names follow the
Flax parameter tree (``Dense_0``, ``BatchNorm_0``) so that ``convert.py``
maps names one to one.

Under ``cfg.compute_dtype: bfloat16`` (:func:`compute_dtype`) a ``ConvBN``
runs its ``Dense_0`` in bfloat16, inputs and weight cast as Flax's
``nn.Dense(dtype=bfloat16)`` casts them, and its BatchNorm takes the
bfloat16 product and computes in float32, as Flax's ``BatchNorm`` promotes
it to its float32 parameters; parameters and statistics stay float32.

Initialisers draw from the ``torch.Generator`` they are given (the global
one when it is ``None``).  A ``Linear`` draws torch's default
initialisation from it first, as ``nn.Linear`` does from the global one, so
a generator seeded with ``s`` gives the weights that ``torch.manual_seed(s)``
gave before initialisers took a generator.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

def compute_dtype(cfg) -> Optional[torch.dtype]:
    """``cfg.compute_dtype`` as the dtype of the matmuls and the KPConv
    aggregation: ``torch.bfloat16`` for ``bfloat16``, ``None`` (float32)
    for ``float32``."""
    name = str(getattr(cfg, "compute_dtype", "float32"))
    if name == "bfloat16":
        return torch.bfloat16
    if name != "float32":
        raise ValueError(f"compute_dtype {name!r}: float32 or bfloat16")
    return None


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]
                      ) -> nn.Module:
    """Set the compute dtype of every module of ``model`` that has one
    (``ConvBN``, ``PseudoGrid``); ``None`` computes in the parameters'
    dtype.  Returns ``model``."""
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return model


# jax.nn.initializers.he_normal is variance scaling over a normal truncated
# at two standard deviations; this constant restores the variance lost to
# the truncation
_TRUNC_STD = 0.87962566103423978


def he_normal_(weight: torch.Tensor, fan_in: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """jax.nn.initializers.lecun_normal (Flax's default ``Dense`` kernel):
    he_normal's truncated normal at half its variance."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def linear(in_features: int, out_features: int, bias: bool,
           generator: Optional[torch.Generator] = None) -> nn.Linear:
    """``nn.Linear`` with its default initialisation drawn from
    ``generator`` (``nn.Linear.reset_parameters``'s draws, in its order)."""
    layer = nn.utils.skip_init(nn.Linear, in_features, out_features,
                               bias=bias)
    nn.init.kaiming_uniform_(layer.weight, a=math.sqrt(5),
                             generator=generator)
    if bias:
        bound = 1.0 / math.sqrt(in_features) if in_features > 0 else 0.0
        nn.init.uniform_(layer.bias, -bound, bound, generator=generator)
    return layer


def dense(in_features: int, out_features: int, bias: bool = True,
          generator: Optional[torch.Generator] = None,
          init: str = "lecun") -> nn.Linear:
    """A Flax ``nn.Dense``: kernel ``lecun_normal`` (Flax's default) or
    ``he_normal``, bias zero.  Drawn after :func:`linear`'s defaults, as
    every ``Linear`` of the port is."""
    layer = linear(in_features, out_features, bias, generator)
    init_ = {"lecun": lecun_normal_, "he": he_normal_}[init]
    init_(layer.weight, in_features, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class ChannelsLastBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of a (..., C) tensor, eps 1e-5, with
    Flax's statistics.

    ``momentum`` is torch's (the weight of the new batch statistic), which
    is one minus Flax's.  In train mode the input is normalised with the
    biased variance over all leading slots (padding included), and the
    running variance is updated with that same biased variance, as Flax
    does.  ``F.batch_norm`` stores the unbiased one, ``n / (n - 1)`` times
    the biased, so its running variance is corrected in place from the
    value before the step: one pass over the input, not two.  A bfloat16
    input is normalised in float32 (the output is float32)."""

    def __init__(self, channels: int, momentum: float = 0.1):
        super().__init__(channels, eps=1e-5, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        # a bfloat16 input is promoted to the parameters' dtype, as Flax
        # promotes it
        x = x.reshape(-1, shape[-1]).to(
            torch.promote_types(x.dtype, self.weight.dtype))
        if self.training:
            n = x.shape[0]
            old_var = self.running_var.clone()
            out = F.batch_norm(x, self.running_mean, self.running_var,
                               self.weight, self.bias, True, self.momentum,
                               self.eps)
            # r = (1 - m) r_old + m v n/(n-1)  ->  (1 - m) r_old + m v;
            # through .data, since autograd saved running_var at its
            # version after the update (train-mode backward never reads it)
            self.running_var.data.mul_((n - 1) / n).add_(
                old_var, alpha=(1.0 - self.momentum) / n)
            self.num_batches_tracked.add_(1)
        else:
            out = F.batch_norm(x, self.running_mean, self.running_var,
                               self.weight, self.bias, False, 0.0, self.eps)
        return out.reshape(shape)


class ConvBN(nn.Module):
    """1x1 conv (Linear, no bias) + BatchNorm, optional ReLU.  With
    ``dtype`` (bfloat16) the conv takes its input and weight cast to it and
    gives its product in it; the BatchNorm's output is float32."""

    def __init__(self, in_features: int, features: int,
                 bn_momentum: float = 0.1, relu: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Dense_0 = linear(in_features, features, False, generator)
        he_normal_(self.Dense_0.weight, in_features, generator)
        self.BatchNorm_0 = ChannelsLastBatchNorm(features, bn_momentum)
        self.relu = relu
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = self.Dense_0(x) if dt is None \
            else F.linear(x.to(dt), self.Dense_0.weight.to(dt))
        x = self.BatchNorm_0(x)
        return F.relu(x) if self.relu else x


class BNReLU(nn.Module):
    def __init__(self, features: int, bn_momentum: float = 0.1):
        super().__init__()
        self.BatchNorm_0 = ChannelsLastBatchNorm(features, bn_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(x))


def masked_global_avg_pool(features: torch.Tensor, mask: torch.Tensor
                           ) -> torch.Tensor:
    """(B, N, C), (B, N) -> (B, C): the sum over all N slots (padding
    slots hold cycled real features) over the true point count, at least
    1, as the JAX package's ``masked_global_avg_pool``."""
    total = torch.sum(features, dim=1)
    count = torch.sum(mask, dim=1, keepdim=True)
    return total / torch.clamp(count, min=1.0)


class Dropout(nn.Module):
    """Flax's ``nn.Dropout(rate)``: in train mode each element is kept with
    probability ``1 - rate`` and divided by it, the others are zero; in
    eval mode the identity.

    The keep-mask is ``keep`` where given, else ``torch.rand(shape,
    generator=generator) >= rate`` drawn on the host (the global generator
    when ``generator`` is ``None``) and moved to the input's device, so one
    seed gives the same mask on the CPU and on the card."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if keep is None:
            keep = torch.rand(x.shape, generator=generator) >= self.rate
        keep = keep.to(device=x.device, dtype=torch.bool)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))

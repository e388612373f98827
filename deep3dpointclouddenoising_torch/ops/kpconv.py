"""KPConv (pseudo-grid) aggregation: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py``.  The
function is

    out[b,m,c] = sum_k sum_p infl(|rel[b,m,k] - kp[p]|) * mask[b,m,k]
                             * kw[p,c] * feat[b, idx[b,m,k], c]

:func:`kpconv_aggregate` launches ``csrc/kpconv_fwd.cu`` for CUDA tensors
and computes :func:`kpconv_aggregate_plain` for CPU tensors.  The kernel is
forward only: the backward kernel comes with the training slice, so the
wrapper refuses inputs that would need a gradient.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .neighbors import group_features

INFLUENCES = {"constant": 0, "linear": 1, "gaussian": 2}
MAX_KERNEL_POINTS = 16  # kPPad in csrc/kpconv_fwd.cu


def influence_weights(sq: torch.Tensor, extent: float,
                      influence: str) -> torch.Tensor:
    """Kernel-point influence from squared distances."""
    if influence == "constant":
        return torch.ones_like(sq)
    if influence == "linear":
        # where-guarded sqrt: zero subgradient where a neighbour coincides
        # with a kernel point; the value is unchanged
        pos = sq > 0.0
        d = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
        return torch.clamp(1.0 - d / extent, min=0.0)
    if influence == "gaussian":
        return torch.exp(-sq / gaussian_denominator(extent))
    raise ValueError(f"Unknown KP_influence {influence}")


def gaussian_denominator(extent: float) -> float:
    sigma = extent * 0.3
    return 2.0 * sigma * sigma + 1e-9


def kpconv_aggregate_reference(grouped: torch.Tensor, rel: torch.Tensor,
                               mask: torch.Tensor, kpoints: torch.Tensor,
                               kernel_weights: torch.Tensor, *,
                               extent: float, influence: str = "linear"
                               ) -> torch.Tensor:
    """KPConv aggregation over pre-gathered neighbours.

    grouped (B, M, K, C), rel (B, M, K, 3), mask (B, M, K), kpoints (P, 3),
    kernel_weights (P, C) -> (B, M, C).
    """
    diff = rel[..., None, :] - kpoints[None, None, None, :, :]
    sq = torch.sum(diff * diff, dim=-1)                        # (B,M,K,P)
    w = influence_weights(sq, extent, influence) * mask[..., None]
    per_kp = torch.einsum("bmkp,bmkc->bmpc", w, grouped)
    return torch.einsum("bmpc,pc->bmc", per_kp, kernel_weights)


def kpconv_aggregate_plain(features, idx, rel, mask, kpoints, kernel_weights,
                           extent: float, influence: str = "linear"
                           ) -> torch.Tensor:
    """The plain version of the kernel, over ungathered support features."""
    return kpconv_aggregate_reference(
        group_features(features, idx), rel, mask, kpoints, kernel_weights,
        extent=extent, influence=influence)


def _library() -> ctypes.CDLL:
    lib = _cuda.load("kpconv_fwd")
    if lib.kpconv_fwd.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.kpconv_fwd.argtypes = [vp] * 7 + [i] * 7 + [
            ctypes.c_float, ctypes.c_float, i, vp]
        lib.kpconv_fwd.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"kpconv_aggregate: {name} is on {t.device}, "
                         f"features on {device}")
    if t.dtype != dtype:
        raise TypeError(f"kpconv_aggregate: {name} must be {dtype}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"kpconv_aggregate: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"kpconv_aggregate: {name} must be contiguous")


def kpconv_aggregate(features: torch.Tensor, idx: torch.Tensor,
                     rel: torch.Tensor, mask: torch.Tensor,
                     kpoints: torch.Tensor, kernel_weights: torch.Tensor,
                     extent: float, influence: str = "linear"
                     ) -> torch.Tensor:
    """KPConv aggregation over ungathered support features.

    Args:
      features: (B, N, C) float32 support features.
      idx: (B, M, K) int32 neighbour indices into the support set.
      rel: (B, M, K, 3) neighbour positions relative to the query.
      mask: (B, M, K) float32 feature mask.
      kpoints: (P, 3) kernel points, P <= 16.
      kernel_weights: (P, C) per-kernel-point channel weights.
      extent: influence extent.
      influence: 'linear' | 'gaussian' | 'constant'.

    Returns (B, M, C) float32.  CUDA tensors go through the kernel
    (``kpconv_aggregate.launches`` counts its launches), CPU tensors through
    the plain version.
    """
    if influence not in INFLUENCES:
        raise ValueError(f"Unknown KP_influence {influence}")
    if features.device.type == "cpu":
        return kpconv_aggregate_plain(features, idx, rel, mask, kpoints,
                                      kernel_weights, extent, influence)
    if features.device.type != "cuda":
        raise ValueError(f"kpconv_aggregate: no kernel for device "
                         f"{features.device}")
    if torch.is_grad_enabled() and (features.requires_grad
                                    or kernel_weights.requires_grad):
        raise NotImplementedError(
            "kpconv_aggregate has no backward kernel yet (training slice, "
            "ROADMAP.md); call it under torch.no_grad()")
    B, N, C = features.shape
    M, K = idx.shape[1:]
    P = kpoints.shape[0]
    if not 1 <= P <= MAX_KERNEL_POINTS:
        raise ValueError(f"kpconv_aggregate: {P} kernel points, the kernel "
                         f"takes 1..{MAX_KERNEL_POINTS}")
    dev = features.device
    _check("features", features, torch.float32, (B, N, C), dev)
    _check("idx", idx, torch.int32, (B, M, K), dev)
    _check("rel", rel, torch.float32, (B, M, K, 3), dev)
    _check("mask", mask, torch.float32, (B, M, K), dev)
    _check("kpoints", kpoints, torch.float32, (P, 3), dev)
    _check("kernel_weights", kernel_weights, torch.float32, (P, C), dev)
    out = torch.empty((B, M, C), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _library()
    rc = lib.kpconv_fwd(
        features.data_ptr(), idx.data_ptr(), rel.data_ptr(), mask.data_ptr(),
        kpoints.data_ptr(), kernel_weights.data_ptr(), out.data_ptr(),
        B, N, M, K, C, P, INFLUENCES[influence], float(extent),
        gaussian_denominator(float(extent)), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kpconv_fwd kernel launch failed: CUDA error {rc}")
    kpconv_aggregate.launches += 1
    return out


kpconv_aggregate.launches = 0

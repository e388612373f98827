"""KPConv (pseudo-grid) aggregation: the CUDA kernels' wrappers, their plain
PyTorch versions and the autograd function that joins them.

Counterpart of ``deep3dpointclouddenoising_tpu/ops/pallas_kpconv.py``.  The
function is

    out[b,m,c] = sum_k sum_p infl(|rel[b,m,k] - kp[p]|) * mask[b,m,k]
                             * kw[p,c] * feat[b, idx[b,m,k], c]

:func:`kpconv_aggregate` is differentiable in ``features`` and
``kernel_weights``, and in ``rel`` as the JAX package's oracle path is
(its jnp reference differentiated by ``jax.grad``; the Pallas ``custom_vjp``
returns zeros for ``rel``); ``idx``, ``mask`` and ``kpoints`` are
constants.  For CUDA tensors the
forward launches ``csrc/kpconv_fwd.cu`` and the backward
``csrc/kpconv_bwd.cu``; for CPU tensors both are the plain versions
:func:`kpconv_aggregate_plain` and :func:`kpconv_aggregate_backward_plain`.
``kpconv_aggregate.launches`` and ``kpconv_aggregate_backward.launches``
count the float32 kernels' launches, ``.launches_bf16`` those of their
bfloat16 forms, and ``kpconv_aggregate_backward.launches_drel`` the
backward calls that launch ``kpconv_bwd_drel`` for ``d_rel``.

Features may be float32 or bfloat16 (the JAX package's ``compute_dtype:
bfloat16``, where the Pallas kernels run in ``features.dtype``).  In
bfloat16 the output and ``d_features`` are bfloat16 and ``grad_out`` must
be; ``rel``, ``mask``, ``kpoints``, ``kernel_weights`` and
``d_kernel_weights`` stay float32, every sum is float32, and the output and
``d_features`` are rounded to bfloat16 once (``kpconv_fwd_bf16``,
``kpconv_bwd_bf16``; the plain versions upcast, compute in float32 and
round).  The gradient in ``rel`` has no bfloat16 form.

The backward kernel works on inverted neighbourhoods (the edges that name
each support, :func:`invert_neighbors_plain`);
:func:`kpconv_aggregate_backward_inverted_plain` is its form in plain
tensor ops, for the CPU tests.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _cuda
from .neighbors import group_features

INFLUENCES = {"constant": 0, "linear": 1, "gaussian": 2}
MAX_KERNEL_POINTS = 16  # kPPad in csrc/kpconv_fwd.cu and csrc/kpconv_bwd.cu
# the feature dtypes the kernels take, and each one's entry-point suffix
FEATURE_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}


def _check_no_bf16_rel(features: torch.Tensor) -> None:
    if features.dtype == torch.bfloat16:
        raise NotImplementedError(
            "kpconv_aggregate: the gradient in rel has no bfloat16 form "
            "(only the GAN's G-step needs it, and every GAN config is "
            "float32); run the aggregation in float32 to differentiate in "
            "rel")


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


def _masked_weights(rel, mask, kpoints, extent: float, influence: str):
    """(B, M, K, P) influence of every kernel point on every neighbour,
    times the neighbour's mask."""
    diff = rel[..., None, :] - kpoints[None, None, None, :, :]
    sq = torch.sum(diff * diff, dim=-1)
    return influence_weights(sq, extent, influence) * mask[..., None]


def _weight_slopes(rel, mask, kpoints, extent: float, influence: str):
    """``(dw, diff)``: ``diff`` (B, M, K, P, 3) = rel - kp and ``dw``
    (B, M, K, P) with d w / d rel = dw * diff, w the masked influence.

    Linear: -1 / (extent d) where 0 < d and the influence is not clamped,
    else 0 (the where-guarded sqrt's subgradient at d = 0, as in JAX);
    gaussian: -2 infl / gauss_denom; constant: 0."""
    diff = rel[..., None, :] - kpoints[None, None, None, :, :]
    sq = torch.sum(diff * diff, dim=-1)
    if influence == "linear":
        pos = sq > 0.0
        d = torch.sqrt(torch.where(pos, sq, 1.0))
        live = pos & (1.0 - d / extent > 0.0)
        dw = torch.where(live, -1.0 / (extent * d), 0.0)
    elif influence == "gaussian":
        denom = gaussian_denominator(extent)
        dw = -2.0 * torch.exp(-sq / denom) / denom
    else:
        dw = torch.zeros_like(sq)
    return dw * mask[..., None], diff


def kpconv_aggregate_reference(grouped: torch.Tensor, rel: torch.Tensor,
                               mask: torch.Tensor, kpoints: torch.Tensor,
                               kernel_weights: torch.Tensor, *,
                               extent: float, influence: str = "linear"
                               ) -> torch.Tensor:
    """KPConv aggregation over pre-gathered neighbours.

    grouped (B, M, K, C), rel (B, M, K, 3), mask (B, M, K), kpoints (P, 3),
    kernel_weights (P, C) -> (B, M, C).
    """
    w = _masked_weights(rel, mask, kpoints, extent, influence)
    per_kp = torch.einsum("bmkp,bmkc->bmpc", w, grouped)
    return torch.einsum("bmpc,pc->bmc", per_kp, kernel_weights)


def kpconv_aggregate_plain(features, idx, rel, mask, kpoints, kernel_weights,
                           extent: float, influence: str = "linear"
                           ) -> torch.Tensor:
    """The plain version of the forward kernel, over ungathered support
    features.  bfloat16 features are upcast, the output computed in
    float32 and rounded to bfloat16 once."""
    if features.dtype == torch.bfloat16:
        return kpconv_aggregate_plain(
            features.float(), idx, rel, mask, kpoints, kernel_weights,
            extent, influence).to(torch.bfloat16)
    return kpconv_aggregate_reference(
        group_features(features, idx), rel, mask, kpoints, kernel_weights,
        extent=extent, influence=influence)


def kpconv_aggregate_backward_plain(
        features, idx, rel, mask, kpoints, kernel_weights, grad_out,
        extent: float, influence: str = "linear", need_features: bool = True,
        need_kernel_weights: bool = True, need_rel: bool = False
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """The plain version of the backward kernel: ``(d_features,
    d_kernel_weights, d_rel)`` for the upstream gradient ``grad_out``
    (B, M, C), ``None`` for what is not needed.  The closed form of
    ``_vjp_bwd``'s jnp path (``pallas_kpconv.py:545-572``):

    * ``wc = einsum(w, kw)``, ``d_feat`` = ``wc * g`` added back to the
      neighbours' support rows by ``index_add_`` over the flattened
      ``(B, M*K)`` indices;
    * ``d_kw = einsum(w, grouped, g)``;
    * ``d_rel = sum_p dw * (rel - kp) * einsum(grouped, g, kw)``, the
      gradient ``jax.grad`` takes through ``kpconv_aggregate_reference``
      (``_weight_slopes`` gives ``dw``).

    bfloat16 ``features`` and ``grad_out`` are upcast and ``d_features``
    rounded to bfloat16 once; ``d_kernel_weights`` stays float32 and
    ``d_rel`` raises.
    """
    if features.dtype == torch.bfloat16:
        if need_rel:
            _check_no_bf16_rel(features)
        d_features, d_kw, _ = kpconv_aggregate_backward_plain(
            features.float(), idx, rel, mask, kpoints, kernel_weights,
            grad_out.float(), extent, influence, need_features,
            need_kernel_weights)
        if d_features is not None:
            d_features = d_features.to(torch.bfloat16)
        return d_features, d_kw, None
    B, M, K = idx.shape
    N, C = features.shape[1:]
    w = _masked_weights(rel, mask, kpoints, extent, influence)
    d_features = d_kw = d_rel = None
    if need_features:
        wc = torch.einsum("bmkp,pc->bmkc", w, kernel_weights)
        d_grouped = (wc * grad_out[:, :, None, :]).reshape(B * M * K, C)
        rows = (idx.reshape(B, M * K).long()
                + N * torch.arange(B, device=idx.device)[:, None])
        d_features = torch.zeros(B * N, C, dtype=features.dtype,
                                 device=features.device)
        d_features.index_add_(0, rows.reshape(-1),
                              d_grouped.to(features.dtype))
        d_features = d_features.reshape(B, N, C)
    if need_kernel_weights:
        per_kp = torch.einsum("bmkp,bmkc->bmpc", w,
                              group_features(features, idx))
        d_kw = torch.einsum("bmpc,bmc->pc", per_kp, grad_out).to(
            kernel_weights.dtype)
    if need_rel:
        dw, diff = _weight_slopes(rel, mask, kpoints, extent, influence)
        # h[b,m,k,p] = sum_c kw[p,c] g[b,m,c] feat[b, idx[b,m,k], c]
        h = torch.einsum("bmkc,bmpc->bmkp", group_features(features, idx),
                         grad_out[:, :, None, :] * kernel_weights)
        d_rel = torch.einsum("bmkp,bmkpx->bmkx", dw * h, diff).to(rel.dtype)
    return d_features, d_kw, d_rel


def invert_neighbors_plain(idx: torch.Tensor, mask: torch.Tensor, N: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the backward's inversion kernel: the live edges
    (``mask != 0``) of each cloud grouped by the support they name.

    Returns ``offsets`` (B, N + 1) int32, the CSR offsets, and ``edges``
    (B, M*K) int32: cloud b's flat edge ids ``m*K + k`` of support n at
    ``edges[b, offsets[b, n]:offsets[b, n + 1]]``, ascending (the kernel's
    order), and -1 past ``offsets[b, N]``.  Indices outside ``[0, N)`` are
    dropped, as the kernel drops them.  The kernel stores the same lists
    cut by slices of 4096 edge ids (a support's list is its slices' lists
    in slice order) and the backward kernel reads them so.
    """
    B, M, K = idx.shape
    E = M * K
    keys = idx.reshape(B, E).long()
    live = (mask.reshape(B, E) != 0) & (keys >= 0) & (keys < N)
    keys = torch.where(live, keys, N)  # dead edges sort last
    order = torch.sort(keys, dim=1, stable=True).indices
    counts = torch.zeros(B, N + 1, dtype=torch.long, device=idx.device)
    counts.scatter_add_(1, keys, torch.ones_like(keys))
    offsets = torch.zeros(B, N + 1, dtype=torch.long, device=idx.device)
    offsets[:, 1:] = torch.cumsum(counts[:, :N], dim=1)
    slot = torch.arange(E, device=idx.device)[None, :]
    edges = torch.where(slot < offsets[:, N:], order, -1)
    return offsets.to(torch.int32), edges.to(torch.int32)


def kpconv_aggregate_backward_inverted_plain(
        features, idx, rel, mask, kpoints, kernel_weights, grad_out,
        extent: float, influence: str = "linear", need_features: bool = True,
        need_kernel_weights: bool = True
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(d_features, d_kernel_weights)`` in the backward kernel's form, in
    plain tensor ops: over the inverted neighbourhoods of
    :func:`invert_neighbors_plain`,

        H[b,n,p,c]    = sum_{(m,k): idx[b,m,k] = n} w[b,m,k,p] g[b,m,c]
        d_feat[b,n,c] = sum_p kw[p,c] H[b,n,p,c]
        d_kw[p,c]     = sum_{b,n} feat[b,n,c] H[b,n,p,c]

    ``None`` for what is not needed.  The same function as
    :func:`kpconv_aggregate_backward_plain`, summed in another order.
    """
    B, M, K = idx.shape
    N, C = features.shape[1:]
    P = kpoints.shape[0]
    offsets, edges = invert_neighbors_plain(idx, mask, N)
    # one row per listed edge, cloud by cloud in list order: its cloud,
    # support and flat edge id
    dev = idx.device
    degree = (offsets[:, 1:] - offsets[:, :-1]).long()
    cloud = torch.repeat_interleave(torch.arange(B, device=dev),
                                    degree.sum(1))
    support = torch.repeat_interleave(
        torch.arange(N, device=dev).repeat(B), degree.reshape(-1))
    listed = torch.arange(M * K, device=dev)[None, :] \
        < offsets[:, N:].long()
    edge = edges[listed].long()
    w = _masked_weights(rel, mask, kpoints, extent, influence).reshape(
        B, M * K, P)[cloud, edge]                                # (L, P)
    g = grad_out[cloud, edge // K]                               # (L, C)
    H = torch.zeros(B * N, P, C, dtype=grad_out.dtype, device=grad_out.device)
    H.index_add_(0, cloud * N + support, w[:, :, None] * g[:, None, :])
    H = H.reshape(B, N, P, C)
    d_features = d_kw = None
    if need_features:
        d_features = torch.einsum("pc,bnpc->bnc", kernel_weights, H).to(
            features.dtype)
    if need_kernel_weights:
        d_kw = torch.einsum("bnc,bnpc->pc", features, H).to(
            kernel_weights.dtype)
    return d_features, d_kw


def _library(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with the argument types of its
    entry points (``<name>`` and ``<name>_bf16``) set."""
    lib = _cuda.load(name)
    if getattr(lib, name).argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for suffix in FEATURE_DTYPES.values():
            fn = getattr(lib, name + suffix)
            if name == "kpconv_fwd":
                fn.argtypes = [vp] * 7 + [i] * 7 + [f, f, i, vp]
            else:
                fn.argtypes = [vp] * 12 + [i] * 7 + [f, f, i, i, i, i, vp]
            fn.restype = i
        if name == "kpconv_bwd":
            lib.kpconv_bwd_num_slots.argtypes = [i, i]
            lib.kpconv_bwd_num_slots.restype = i
            lib.kpconv_bwd_scratch_ints.argtypes = [i] * 4
            lib.kpconv_bwd_scratch_ints.restype = ctypes.c_longlong
    return lib


def _count_launch(wrapper, dtype: torch.dtype) -> None:
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


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


def _check_cuda_inputs(features, idx, rel, mask, kpoints, kernel_weights,
                       influence: str):
    """Raise on what the kernels do not take; return (B, N, M, K, C, P)."""
    if influence not in INFLUENCES:
        raise ValueError(f"Unknown KP_influence {influence}")
    if features.device.type != "cuda":
        raise ValueError(f"kpconv_aggregate: no kernel for device "
                         f"{features.device}")
    B, N, C = features.shape
    M, K = idx.shape[1:]
    P = kpoints.shape[0]
    if not 1 <= P <= MAX_KERNEL_POINTS:
        raise ValueError(f"kpconv_aggregate: {P} kernel points, the kernel "
                         f"takes 1..{MAX_KERNEL_POINTS}")
    dev = features.device
    if features.dtype not in FEATURE_DTYPES:
        raise TypeError(f"kpconv_aggregate: features must be float32 or "
                        f"bfloat16, got {features.dtype}")
    _check("features", features, features.dtype, (B, N, C), dev)
    _check("idx", idx, torch.int32, (B, M, K), dev)
    _check("rel", rel, torch.float32, (B, M, K, 3), dev)
    _check("mask", mask, torch.float32, (B, M, K), dev)
    _check("kpoints", kpoints, torch.float32, (P, 3), dev)
    _check("kernel_weights", kernel_weights, torch.float32, (P, C), dev)
    return B, N, M, K, C, P


def _forward_kernel(features, idx, rel, mask, kpoints, kernel_weights,
                    extent: float, influence: str) -> torch.Tensor:
    B, N, M, K, C, P = _check_cuda_inputs(features, idx, rel, mask, kpoints,
                                          kernel_weights, influence)
    dev = features.device
    out = torch.empty((B, M, C), dtype=features.dtype, device=dev)
    if out.numel() == 0:
        return out
    fn = getattr(_library("kpconv_fwd"),
                 "kpconv_fwd" + FEATURE_DTYPES[features.dtype])
    rc = fn(
        features.data_ptr(), idx.data_ptr(), rel.data_ptr(), mask.data_ptr(),
        kpoints.data_ptr(), kernel_weights.data_ptr(), out.data_ptr(),
        B, N, M, K, C, P, INFLUENCES[influence], float(extent),
        gaussian_denominator(float(extent)), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kpconv_fwd kernel launch failed: CUDA error {rc}")
    _count_launch(kpconv_aggregate, features.dtype)
    return out


def kpconv_aggregate_backward(
        features, idx, rel, mask, kpoints, kernel_weights, grad_out,
        extent: float, influence: str = "linear", need_features: bool = True,
        need_kernel_weights: bool = True, need_rel: bool = False
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """``(d_features, d_kernel_weights, d_rel)`` of the aggregation for
    the upstream gradient ``grad_out`` (B, M, C); ``None`` for what is not
    needed.

    CUDA tensors go through ``csrc/kpconv_bwd.cu``: one call launches the
    inversion of ``idx`` (``kpconv_bwd_invert``), the per-support gather and
    contraction (``kpconv_bwd_kernel``) and, for ``d_kernel_weights``, its
    fixed-order reduction (``kpconv_bwd_reduce``), with no float atomics, so
    ``d_features`` and ``d_kernel_weights`` are bitwise reproducible;
    ``kpconv_aggregate_backward.launches`` counts calls that launch.  CPU
    tensors go through :func:`kpconv_aggregate_backward_plain`.  Asking for
    ``d_rel`` adds ``kpconv_bwd_drel`` (counted by ``.launches_drel``),
    which writes every row of ``d_rel`` once, each a sum over the channels
    in a fixed order: bitwise reproducible too.  bfloat16 ``features`` take a
    bfloat16 ``grad_out`` and give bfloat16 ``d_features``
    (``kpconv_bwd_bf16``, counted by ``.launches_bf16``), and no ``d_rel``.
    """
    if need_rel:
        _check_no_bf16_rel(features)
    if features.device.type == "cpu":
        return kpconv_aggregate_backward_plain(
            features, idx, rel, mask, kpoints, kernel_weights, grad_out,
            extent, influence, need_features, need_kernel_weights, need_rel)
    B, N, M, K, C, P = _check_cuda_inputs(features, idx, rel, mask, kpoints,
                                          kernel_weights, influence)
    dev = features.device
    grad_out = grad_out.contiguous()
    _check("grad_out", grad_out, features.dtype, (B, M, C), dev)
    d_features = torch.empty_like(features) if need_features else None
    d_kw = torch.empty((P, C), dtype=torch.float32, device=dev) \
        if need_kernel_weights else None
    d_rel = torch.empty_like(rel) if need_rel else None
    if not (need_features or need_kernel_weights or need_rel):
        return d_features, d_kw, d_rel
    if B * N * C == 0 or M * K == 0:
        for t in (d_features, d_kw, d_rel):
            if t is not None:
                t.zero_()
        return d_features, d_kw, d_rel
    lib = _library("kpconv_bwd")
    part = torch.empty((lib.kpconv_bwd_num_slots(B, N), P, C),
                       dtype=torch.float32, device=dev) \
        if need_kernel_weights else None
    scratch = torch.empty(lib.kpconv_bwd_scratch_ints(B, N, M, K),
                          dtype=torch.int32, device=dev) \
        if need_features or need_kernel_weights else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = getattr(lib, "kpconv_bwd" + FEATURE_DTYPES[features.dtype])
    rc = fn(
        features.data_ptr(), idx.data_ptr(), rel.data_ptr(), mask.data_ptr(),
        kpoints.data_ptr(), kernel_weights.data_ptr(), grad_out.data_ptr(),
        ptr(d_features), ptr(d_kw), ptr(part), ptr(d_rel), ptr(scratch), B,
        N, M, K, C, P, INFLUENCES[influence], float(extent),
        gaussian_denominator(float(extent)), int(need_features),
        int(need_kernel_weights), int(need_rel), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kpconv_bwd kernel launch failed: CUDA error {rc}")
    _count_launch(kpconv_aggregate_backward, features.dtype)
    if need_rel:
        kpconv_aggregate_backward.launches_drel += 1
    return d_features, d_kw, d_rel


class _KPConvAggregate(torch.autograd.Function):
    """Forward and backward of the aggregation, kernel or plain by device."""

    @staticmethod
    def forward(ctx, features, idx, rel, mask, kpoints, kernel_weights,
                extent: float, influence: str):
        ctx.save_for_backward(features, idx, rel, mask, kpoints,
                              kernel_weights)
        ctx.extent, ctx.influence = extent, influence
        if features.device.type == "cpu":
            return kpconv_aggregate_plain(features, idx, rel, mask, kpoints,
                                          kernel_weights, extent, influence)
        return _forward_kernel(features, idx, rel, mask, kpoints,
                               kernel_weights, extent, influence)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        features, idx, rel, mask, kpoints, kernel_weights = ctx.saved_tensors
        d_features, d_kw, d_rel = kpconv_aggregate_backward(
            features, idx, rel, mask, kpoints, kernel_weights, grad_out,
            ctx.extent, ctx.influence, ctx.needs_input_grad[0],
            ctx.needs_input_grad[5], ctx.needs_input_grad[2])
        return d_features, None, d_rel, None, None, d_kw, None, None


def kpconv_aggregate(features: torch.Tensor, idx: torch.Tensor,
                     rel: torch.Tensor, mask: torch.Tensor,
                     kpoints: torch.Tensor, kernel_weights: torch.Tensor,
                     extent: float, influence: str = "linear"
                     ) -> torch.Tensor:
    """KPConv aggregation over ungathered support features.

    Args:
      features: (B, N, C) float32 or bfloat16 support features.
      idx: (B, M, K) int32 neighbour indices into the support set.
      rel: (B, M, K, 3) neighbour positions relative to the query.
      mask: (B, M, K) float32 feature mask.
      kpoints: (P, 3) kernel points, P <= 16.
      kernel_weights: (P, C) per-kernel-point channel weights.
      extent: influence extent.
      influence: 'linear' | 'gaussian' | 'constant'.

    Returns (B, M, C) in ``features.dtype``, differentiable in
    ``features``, ``kernel_weights`` and (float32 only) ``rel``.  CUDA
    tensors go through the kernels (``kpconv_aggregate.launches`` and
    ``.launches_bf16`` count the forward's launches), CPU tensors through
    the plain versions.
    """
    if influence not in INFLUENCES:
        raise ValueError(f"Unknown KP_influence {influence}")
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kpconv_aggregate: no kernel for device "
                         f"{features.device}")
    return _KPConvAggregate.apply(features, idx, rel, mask, kpoints,
                                  kernel_weights, extent, influence)


kpconv_aggregate.launches = 0
kpconv_aggregate_backward.launches = 0
kpconv_aggregate.launches_bf16 = 0
kpconv_aggregate_backward.launches_bf16 = 0
kpconv_aggregate_backward.launches_drel = 0

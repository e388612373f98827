"""Whole-model outputs and gradients through the KPConv kernels against the
plain path, each held to its own float32 noise.

:func:`check_forward` holds a forward's output element by element to the
larger of a fixed tolerance and ``NOISE_FACTOR`` times that element's own
float32 noise (the plain float32 path against the plain float64 path on
the same pyramid): outputs of thousands carry float32 rounding of ~1e-4
of themselves through the network, so a fixed rtol alone fails on some
weights for no fault of the kernel.

In bfloat16 an element's own noise is no limit for it: the two paths
round their aggregations' float32 sums once each, so where the sums fall
on either side of a rounding boundary they differ by one bf16 ulp (2^-8 of
the value), and such a flip moves the outputs downstream by as much as
the bf16 rounding of the whole path does, element for element.
:func:`check_forward_tensor` holds such a forward as the gradients below
are held: by the whole tensor's max-abs and L2 distances from the plain
path, each within ``NOISE_FACTOR`` times the plain path's own distance
from float64.

The rest of this module does the same for gradients.

Every parameter's train-mode gradient under a loss (the masked L1 loss
unless another is given), on one batch and one neighbour pyramid, four
ways:

* ``kernel``: forward and backward kernels, as training runs them;
* ``same_graph``: the kernel path's forward graph, its aggregations'
  backward swapped for ``kpconv_aggregate_backward_plain``, so the
  activations and every ReLU and max-pool choice are the same;
* ``plain``: forward ``kpconv_aggregate_plain`` and torch's autograd of it,
  which shares no code with either backward above;
* ``float64``: the plain path in float64, the yardstick of float32 noise.

Under ``compute_dtype: bfloat16`` the first three run in bfloat16, as the
model does, and the yardstick is the same model in float64 with its
bfloat16 casts taken out (:func:`float64_copy`): so each tensor is held to
three times its own bfloat16-vs-float64 distance, the same rule at the
bfloat16 scale.

Each tensor's limit comes from its own float32 noise: ``NOISE_FACTOR``
times how far its float32 plain gradient lies from the float64 one, with a
floor.  A train-mode BatchNorm's scale gradient sums ``dy * x_hat`` over all
slots with ``x_hat`` of zero mean, so it cancels to a small part of its
terms, and float32 (atomics in the plain path's own ``index_add_`` and
gathers' backward included) pins it only to about 1e-2 of its max-abs; a
Dense or kernel-weights gradient it pins about a thousand times tighter.

* ``same_graph`` is compared by the largest difference over the tensor's
  max-abs, floor ``SAME_GRAPH_FLOOR``: on one graph only the order of the
  sums differs.
* ``plain`` is compared by the relative L2 norm of the difference, floor
  ``FULL_PATH_FLOOR``.  The two forwards differ by float32 rounding, so a
  pre-activation or a max-pool candidate within that rounding of its rival
  switches between them and moves a few elements of a gradient by up to a
  few percent of its max-abs: a discrete event that the float64 yardstick
  may not share.  The L2 norm spreads such an event over the tensor, while
  a systematic error (a wrong factor, a wrong saved tensor) moves the whole
  tensor and shows at its full size.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..losses.masked import masked_l1_loss
from ..models import local_aggregation
from ..models.layers import set_compute_dtype
from ..ops import kpconv as kpconv_ops

NOISE_FACTOR = 3.0
SAME_GRAPH_FLOOR = 1e-5
FULL_PATH_FLOOR = 2e-2


def check_forward(got: torch.Tensor, plain: torch.Tensor,
                  float64: torch.Tensor, rtol: float, atol: float) -> Dict:
    """Hold ``got`` to the float32 plain output ``plain``, element by
    element, within the larger of ``atol + rtol |plain|`` and
    ``NOISE_FACTOR |plain - float64|``; raises AssertionError naming the
    element furthest over its limit and its three readings.  Returns the
    element nearest its limit: ``index``, ``diff``, ``limit``, ``got``,
    ``plain``, ``float64`` and the largest ``max_abs`` difference."""
    if not torch.isfinite(got).all():
        raise AssertionError("forward: non-finite output")
    got, plain, ref = got.double(), plain.double(), float64.double()
    diff = (got - plain).abs()
    limit = torch.maximum(atol + rtol * plain.abs(),
                          NOISE_FACTOR * (plain - ref).abs())
    flat = int(torch.argmax(diff / limit))
    index = tuple(int(i) for i in torch.unravel_index(
        torch.tensor(flat), diff.shape))
    worst = dict(index=index, diff=diff[index].item(),
                 limit=limit[index].item(), got=got[index].item(),
                 plain=plain[index].item(), float64=ref[index].item(),
                 max_abs=diff.max().item())
    if worst["diff"] > worst["limit"]:
        raise AssertionError(
            f"forward: output {index} = {worst['got']:.7g} differs from "
            f"plain {worst['plain']:.7g} by {worst['diff']:.3e} (limit "
            f"{worst['limit']:.3e}; float64 {worst['float64']:.9g})")
    return worst


def bf16_ulp(x) -> torch.Tensor:
    """The spacing of bfloat16 values (8 significant bits) at |x|, in
    float64; at zero, that of the smallest normal."""
    m = torch.as_tensor(x).double().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def check_bf16(got: torch.Tensor, want: torch.Tensor, atol: float,
               what: str) -> Tuple[float, int]:
    """A bfloat16 kernel output against its bfloat16 plain version: each
    element within one bf16 ulp of the plain value, plus ``atol`` (for
    elements whose float32 sum cancels to less than the two float32 sums'
    difference allows one ulp).  Both round a float32 sum once, so where
    the sums agree to float32 noise the roundings are equal or one ulp
    apart.  Raises AssertionError naming the element furthest over;
    returns the max abs error and the number of elements that differ."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise AssertionError(f"{what}: {got.dtype}, plain {want.dtype}, "
                             "not bfloat16")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    diff = (got.double() - want.double()).abs()
    over = diff - bf16_ulp(want) - atol
    if over.max().item() > 0:
        i = int(torch.argmax(over))
        raise AssertionError(
            f"{what}: element {i} = {got.reshape(-1)[i].item():.6g}, plain "
            f"{want.reshape(-1)[i].item():.6g}: over one bf16 ulp + atol "
            f"{atol:.3e}")
    return diff.max().item(), int((diff > 0).sum().item())


def state_difference(a, b, where: str = "") -> str:
    """The first place where two nested states (dicts, lists, tensors,
    numbers) differ, tensors bitwise and in dtype, or ''."""
    if isinstance(a, torch.Tensor):
        same = isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())
        return "" if same else where or "/"
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return f"{where} keys"
        return next((d for k in a
                     for d in [state_difference(a[k], b[k], f"{where}/{k}")]
                     if d), "")
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return f"{where} length"
        return next((d for i, (x, y) in enumerate(zip(a, b))
                     for d in [state_difference(x, y, f"{where}/{i}")]
                     if d), "")
    return "" if a == b else where or "/"


def float64_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A float64 copy of ``model`` that computes in float64 throughout:
    the modules' bfloat16 compute dtype (``ConvBN``, ``PseudoGrid``)
    cleared."""
    return set_compute_dtype(copy.deepcopy(model).double(), None)


def draw_gates_and_head(model: torch.nn.Module, rng,
                        other: Optional[Callable] = None) -> None:
    """Set ``model``'s parameters in place, in ``named_parameters`` order,
    from the numpy generator ``rng``: the attention gates (``gamma``,
    ``alpha``; zero at init, which makes each gated operator the
    identity) from U(0.5, 1.5), the offset head's final Dense
    (``MultiDimHead_0.Dense_0``; 1e-4 at init) from N(0, 1), and any other
    parameter from ``other(name, shape)`` where it gives an array (left as
    it is where it gives ``None``)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            shape = tuple(p.shape)
            if "MultiDimHead_0.Dense_0" in name:
                a = rng.normal(size=shape)
            elif name.rsplit(".", 1)[-1] in ("gamma", "alpha"):
                a = rng.uniform(0.5, 1.5, size=shape)
            else:
                a = None if other is None else other(name, shape)
            if a is not None:
                p.copy_(torch.from_numpy(a.astype(np.float32)))


def launches() -> Tuple[int, int]:
    """(forward, backward) kernel launches so far, both dtypes (a wrapper
    swapped in by a test may count float32 launches only)."""
    return tuple(w.launches + getattr(w, "launches_bf16", 0)
                 for w in (kpconv_ops.kpconv_aggregate,
                           kpconv_ops.kpconv_aggregate_backward))


def check_forward_tensor(got: torch.Tensor, plain: torch.Tensor,
                         float64: torch.Tensor) -> Dict:
    """Hold ``got`` to ``plain`` by the whole tensor: the largest
    difference over the largest entry of ``plain`` within ``NOISE_FACTOR``
    times that of ``plain`` from ``float64`` (floor ``SAME_GRAPH_FLOOR``),
    and the L2 norm of the difference over that of ``plain`` likewise
    (floor ``FULL_PATH_FLOOR``); raises AssertionError over either.
    Returns each distance with its limit."""
    if not torch.isfinite(got).all():
        raise AssertionError("forward: non-finite output")
    out = {}
    for what, distance, floor in (("max_abs", max_abs_distance,
                                   SAME_GRAPH_FLOOR),
                                  ("l2", l2_distance, FULL_PATH_FLOOR)):
        d = distance(got, plain)
        limit = max(NOISE_FACTOR * distance(plain, float64), floor)
        if d > limit:
            raise AssertionError(f"forward: {what} distance {d:.3e} from "
                                 f"the plain path (limit {limit:.3e})")
        out[what] = (d, limit)
    return out


def max_abs_distance(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest difference over the largest entry of ``want``."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max()).item()


def l2_distance(got: torch.Tensor, want: torch.Tensor) -> float:
    """L2 norm of the difference over the L2 norm of ``want``."""
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def model_gradients(model, pyramid, features: torch.Tensor,
                    target: torch.Tensor, mask: torch.Tensor,
                    loss_fn: Callable = masked_l1_loss) -> Dict:
    """The four gradients of every parameter of ``model`` (in train mode,
    on the card) under ``loss_fn(pred, target, mask)`` and the kernel
    path's launches.  A floating-point ``target`` (offsets) goes to float64
    with the float64 path; integer labels stay as they are.

    Returns ``names``, the gradient lists ``kernel``, ``same_graph``,
    ``plain`` and ``float64``, the ``loss``, ``plain_loss`` and
    ``float64_loss``, and
    ``launches`` = (forward, backward) kernel launches of the kernel path's
    one forward and backward."""
    names, params = zip(*model.named_parameters())

    def loss_of(m, feats, target):
        return loss_fn(m.head(pyramid, m.ResNetEncoder_0(pyramid, feats)),
                       target, mask)

    fwd0, bwd0 = launches()
    loss = loss_of(model, features, target)
    kernel = torch.autograd.grad(loss, params, retain_graph=True)
    torch.cuda.synchronize()
    fwd1, bwd1 = launches()
    backward = kpconv_ops.kpconv_aggregate_backward
    kpconv_ops.kpconv_aggregate_backward = \
        kpconv_ops.kpconv_aggregate_backward_plain
    try:
        same_graph = torch.autograd.grad(loss, params)
    finally:
        kpconv_ops.kpconv_aggregate_backward = backward
    aggregate = local_aggregation.kpconv_aggregate
    local_aggregation.kpconv_aggregate = kpconv_ops.kpconv_aggregate_plain
    try:
        plain_loss = loss_of(model, features, target)
        plain = torch.autograd.grad(plain_loss, params)
        model64 = float64_copy(model)
        loss64 = loss_of(model64, features.double(),
                         target.double() if target.is_floating_point()
                         else target)
        float64 = torch.autograd.grad(loss64, list(model64.parameters()))
    finally:
        local_aggregation.kpconv_aggregate = aggregate
    return dict(names=list(names), kernel=kernel, same_graph=same_graph,
                plain=plain, float64=float64, loss=loss.detach(),
                plain_loss=plain_loss.detach(),
                float64_loss=loss64.detach(),
                launches=(fwd1 - fwd0, bwd1 - bwd0))


def check_model_gradients(grads: Dict) -> List[Tuple[str, float, float,
                                                      str]]:
    """Hold ``kernel`` against ``same_graph`` and ``plain`` with the
    per-tensor limits above; raises AssertionError naming the first tensor
    over its limit.  Returns, per comparison, (what, worst distance, its
    limit, tensor) for the tensor nearest its limit."""
    worst = {}
    for i, name in enumerate(grads["names"]):
        got, ref = grads["kernel"][i], grads["float64"][i]
        if not torch.isfinite(got).all() or ref.abs().max() == 0:
            raise AssertionError(f"gradient of {name} is non-finite or "
                                 "zero")
        plain = grads["plain"][i]
        for what, want, distance, floor in (
                ("backward kernel vs plain backward (max-abs)",
                 grads["same_graph"][i], max_abs_distance, SAME_GRAPH_FLOOR),
                ("kernel path vs plain path (L2)", plain, l2_distance,
                 FULL_PATH_FLOOR)):
            limit = max(NOISE_FACTOR * distance(plain, ref), floor)
            d = distance(got, want)
            if d > limit:
                raise AssertionError(
                    f"{what}: gradient of {name} differs by {d:.3e} "
                    f"(limit {limit:.3e})")
            if what not in worst or d / limit > worst[what][0]:
                worst[what] = (d / limit, d, limit, name)
    return [(what, d, limit, name)
            for what, (_, d, limit, name) in worst.items()]


# the card's float64 gradients against the CPU's, relative L2: the same
# function in float64, where even amplified rounding stays far below it
DEVICE_FLOAT64_TOL = 1e-6


def check_device_gradients(names: List[str], card: List[torch.Tensor],
                           cpu: List[torch.Tensor],
                           cpu64: List[torch.Tensor],
                           card64: List[torch.Tensor]) -> Dict:
    """Hold gradients computed on the card to the CPU's, tensor by tensor.
    ``card`` and ``cpu`` are float32, ``card64`` and ``cpu64`` the same
    model in float64.  Every ``card64`` within ``DEVICE_FLOAT64_TOL`` of
    ``cpu64``, by the L2 norm of the difference over that of ``cpu64``
    or over a thousandth of the largest ``cpu64`` norm, whichever is
    larger (a Dense bias before a train-mode BatchNorm has a gradient of
    exactly zero, which both give as rounding); every ``card`` finite and,
    by the
    full-path rule above, within ``NOISE_FACTOR`` times the CPU's own
    float32 distance from float64 (floor ``FULL_PATH_FLOOR``) of
    ``cpu64``, except a tensor that float32 does not pin so far (a
    train-mode BatchNorm over a small batch amplifies rounding by up to
    1/sqrt(eps), and one float32 noise sample then says little of
    another): that one is decided by its float64 comparison alone.
    Raises AssertionError naming the first tensor over its limit; returns
    the float32 tensor nearest its limit, the largest float64 distance and
    the tensors decided in float64."""
    nearest, worst64, by64 = (0.0, ""), 0.0, []
    floor = 1e-3 * max(ref.double().norm().item() for ref in cpu64)
    for name, got, plain, ref, got64 in zip(names, card, cpu, cpu64,
                                            card64):
        if not torch.isfinite(got).all():
            raise AssertionError(f"gradient of {name} is not finite")
        ref = ref.double()
        d64 = ((got64.double() - ref).norm()
               / max(ref.norm().item(), floor)).item()
        if d64 > DEVICE_FLOAT64_TOL:
            raise AssertionError(f"float64 gradient of {name}: {d64:.3e} "
                                 f"from the CPU's (limit "
                                 f"{DEVICE_FLOAT64_TOL:.0e})")
        worst64 = max(worst64, d64)
        limit = max(NOISE_FACTOR * l2_distance(plain, ref), FULL_PATH_FLOOR)
        ratio = l2_distance(got, ref) / limit
        if ratio > 1.0:
            by64.append(name)
        else:
            nearest = max(nearest, (ratio, name))
    return {"nearest": nearest, "float64_max_l2": worst64,
            "decided_in_float64": by64}

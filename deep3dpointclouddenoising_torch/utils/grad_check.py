"""Whole-model outputs and gradients through the KPConv kernels against the
plain path, each held to its own float32 noise.

:func:`check_forward` holds a forward's output element by element to the
larger of a fixed tolerance and ``NOISE_FACTOR`` times that element's own
float32 noise (the plain float32 path against the plain float64 path on
the same pyramid): outputs of thousands carry float32 rounding of ~1e-4
of themselves through the network, so a fixed rtol alone fails on some
weights for no fault of the kernel.

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
from typing import Callable, Dict, List, Tuple

import torch

from ..losses.masked import masked_l1_loss
from ..models import local_aggregation
from ..ops import kpconv as kpconv_ops

NOISE_FACTOR = 3.0
SAME_GRAPH_FLOOR = 1e-5
FULL_PATH_FLOOR = 2e-2


def check_forward(got: torch.Tensor, plain: torch.Tensor,
                  float64: torch.Tensor, rtol: float, atol: float) -> Dict:
    """Hold ``got`` to the float32 plain output ``plain``, element by
    element, within the larger of ``atol + rtol |plain|`` and
    ``NOISE_FACTOR |plain - float64|``; raises AssertionError naming the
    element furthest over its limit.  Returns the element nearest its
    limit: ``index``, ``diff``, ``limit``, ``got``, ``plain`` and the
    largest ``max_abs`` difference."""
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
                 plain=plain[index].item(), max_abs=diff.max().item())
    if worst["diff"] > worst["limit"]:
        raise AssertionError(
            f"forward: output {index} = {worst['got']:.7g} differs from "
            f"plain {worst['plain']:.7g} by {worst['diff']:.3e} (limit "
            f"{worst['limit']:.3e})")
    return worst


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
    ``plain`` and ``float64``, the float32 ``loss`` and ``plain_loss``, and
    ``launches`` = (forward, backward) kernel launches of the kernel path's
    one forward and backward."""
    names, params = zip(*model.named_parameters())

    def loss_of(m, feats, target):
        return loss_fn(m.head(pyramid, m.ResNetEncoder_0(pyramid, feats)),
                       target, mask)

    fwd0 = kpconv_ops.kpconv_aggregate.launches
    bwd0 = kpconv_ops.kpconv_aggregate_backward.launches
    loss = loss_of(model, features, target)
    kernel = torch.autograd.grad(loss, params, retain_graph=True)
    torch.cuda.synchronize()
    launches = (kpconv_ops.kpconv_aggregate.launches - fwd0,
                kpconv_ops.kpconv_aggregate_backward.launches - bwd0)
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
        model64 = copy.deepcopy(model).double()
        float64 = torch.autograd.grad(
            loss_of(model64, features.double(),
                    target.double() if target.is_floating_point()
                    else target),
            list(model64.parameters()))
    finally:
        local_aggregation.kpconv_aggregate = aggregate
    return dict(names=list(names), kernel=kernel, same_graph=same_graph,
                plain=plain, float64=float64, loss=loss.detach(),
                plain_loss=plain_loss.detach(), launches=launches)


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

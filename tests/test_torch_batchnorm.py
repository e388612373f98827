"""The one-process train-mode ``ChannelsLastBatchNorm`` on CPU tensors.

On ``cfgs/l1.yaml`` at width 8 (64 points, batch 4, ``chip_smoke.py``'s
``patch_batch(cfg, 17)``, weights of generator seed 0), torch's train-mode
``F.batch_norm`` put the stem ``BNReLU``'s bias gradient 4.3e-4 from
float64 on a gradient of 7.06e-3.  Per layer, on the float64 run's own
inputs, torch's CPU kernel is as close to float64 as the two-pass form;
in the whole model its float32 rounding left one
pre-activation of ``Bottleneck_4``'s ``BNReLU`` at +2.49e-6 where float64
has -2.35e-6 (the two passes: -1.86e-6), so a ReLU let a gradient through
that float64 stops.  One process on CPU tensors now takes the two passes
of the cross-rank form (``models/layers.py``), as Flax computes them.
"""
import copy

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke
from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.losses.build import \
    get_offset_regression_loss
from deep3dpointclouddenoising_torch.models import build_offset_regression
from deep3dpointclouddenoising_torch.models.layers import \
    ChannelsLastBatchNorm

STEM = "ResNetEncoder_0.LocalAggregation_0.PseudoGrid_0.BNReLU_0.BatchNorm_0"


def _bias_grad(model, batch, dtype):
    model.train()
    t = {k: torch.tensor(v, dtype=dtype) for k, v in batch.items()}
    out = model(t["points"], t["mask"], t["features"])
    get_offset_regression_loss("L1")(out, t["offsets"], t["mask"],
                                     t["points"]).backward()
    return model.get_submodule(STEM).bias.grad.double()


def test_stem_bias_gradient_is_within_1e6_of_float64():
    cfg = load_config(chip_smoke.CONFIG, {"width": 8, "num_points": 64,
                                          "batch_size": 4})
    batch = chip_smoke.patch_batch(cfg, 17)
    model = build_offset_regression(cfg, torch.Generator().manual_seed(0))
    want = _bias_grad(copy.deepcopy(model).double(), batch, torch.float64)
    got = _bias_grad(model, batch, torch.float32)
    err = float((got - want).abs().max())
    assert float(want.abs().max()) > 5e-3
    assert err <= 1e-6, f"stem bias gradient {err:.3g} from float64"


def _batch_norm_forward(self, x):
    """The train-mode ``F.batch_norm`` call that one process ran on CPU
    tensors before (the running variance's correction to the biased one
    left out: nothing here reads it)."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                        self.bias, True, self.momentum,
                        self.eps).reshape(shape)


def _pre_activations(model, batch, dtype):
    """Every BatchNorm's train-mode output of one forward that records
    gradients (as a train step's does: torch's CPU kernel rounds
    otherwise without them), by name."""
    out, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, ChannelsLastBatchNorm):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o, name=name: out.__setitem__(
                    name, o.detach())))
    model.train()
    t = {k: torch.tensor(v, dtype=dtype) for k, v in batch.items()}
    model(t["points"], t["mask"], t["features"])
    for h in hooks:
        h.remove()
    return out


def _layer_backward(x, g, weight, bias, two_pass: bool):
    """One train-mode BatchNorm's (dx, dweight, dbias) for the upstream
    gradient ``g`` at the (n, C) input ``x``: ``F.batch_norm`` or the two
    passes."""
    x = x.clone().requires_grad_()
    weight, bias = weight.clone().requires_grad_(), \
        bias.clone().requires_grad_()
    if two_pass:
        mean = x.sum(0) / x.shape[0]
        centred = x - mean
        var = (centred * centred).sum(0) / x.shape[0]
        out = centred * torch.rsqrt(var + 1e-5) * weight + bias
    else:
        out = F.batch_norm(x, None, None, weight, bias, True, 0.1, 1e-5)
    return torch.autograd.grad(out, (x, weight, bias), g)


def _per_layer_errors(model, batch):
    """Each BatchNorm's backward on the float64 run's own input and
    upstream gradient, in float32 by each form: the largest distance from
    float64 over the layers, over that gradient's largest float64 value,
    for each of the three gradients (a scale gradient that cancels to
    1e-9 in float64 has no correct digit in either form)."""
    caught, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, ChannelsLastBatchNorm):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o, name=name: caught.__setitem__(
                    (name, "x"), i[0].detach())))
            hooks.append(m.register_full_backward_hook(
                lambda mod, gi, go, name=name: caught.__setitem__(
                    (name, "g"), go[0].detach())))
    _bias_grad(model, batch, torch.float64)
    for h in hooks:
        h.remove()
    worst = {(form, k): 0.0 for form in (False, True)
             for k in ("dx", "dweight", "dbias")}
    for name, m in model.named_modules():
        if not isinstance(m, ChannelsLastBatchNorm):
            continue
        c = m.num_features
        x, g = (caught[(name, k)].reshape(-1, c) for k in ("x", "g"))
        w, b = m.weight.detach(), m.bias.detach()
        ref = _layer_backward(x, g, w, b, False)
        for form in (False, True):
            got = _layer_backward(x.float(), g.float(), w.float(),
                                  b.float(), form)
            for k, a, r in zip(("dx", "dweight", "dbias"), got, ref):
                worst[(form, k)] = max(worst[(form, k)], float(
                    (a.double() - r).abs().max() / r.abs().max()))
    return worst


def test_diagnosis_of_the_f_batch_norm_miss(monkeypatch):
    """Prints what the module docstring states (``pytest -s``): per layer,
    on the float64 run's own inputs, the largest relative distance from
    float64 of each form's backward; the stem bias gradient's distance
    from float64 with ``F.batch_norm`` and with the two passes; and every
    pre-activation whose sign differs from float64's in either float32
    run, with its three values."""
    cfg = load_config(chip_smoke.CONFIG, {"width": 8, "num_points": 64,
                                          "batch_size": 4})
    batch = chip_smoke.patch_batch(cfg, 17)
    model = build_offset_regression(cfg, torch.Generator().manual_seed(0))
    m64 = copy.deepcopy(model).double()
    want = _bias_grad(copy.deepcopy(m64), batch, torch.float64)
    ref = _pre_activations(m64, batch, torch.float64)
    runs = {"two passes": (copy.deepcopy(model), None)}
    with monkeypatch.context() as m:
        m.setattr(ChannelsLastBatchNorm, "forward", _batch_norm_forward)
        plain = copy.deepcopy(model)
        runs["F.batch_norm"] = (_bias_grad(plain, batch, torch.float32),
                                _pre_activations(plain, batch,
                                                 torch.float32))
    two = runs["two passes"][0]
    runs["two passes"] = (_bias_grad(two, batch, torch.float32),
                          _pre_activations(two, batch, torch.float32))
    per_layer = _per_layer_errors(copy.deepcopy(m64), batch)
    lines = ["per layer, its own float64 inputs, largest distance from "
             "float64 over a gradient's largest: " + "; ".join(
                 f"{k} F.batch_norm {per_layer[(False, k)]:.3g}, two "
                 f"passes {per_layer[(True, k)]:.3g}"
                 for k in ("dx", "dweight", "dbias"))]
    for form, (grad, _) in runs.items():
        lines.append(f"{form}: stem bias gradient "
                     f"{float((grad - want).abs().max()):.3g} from float64 "
                     f"(largest {float(want.abs().max()):.3g})")
        assert torch.isfinite(grad).all()
    for name, r in ref.items():
        flips = ((runs["F.batch_norm"][1][name] > 0) != (r > 0)) \
            | ((runs["two passes"][1][name] > 0) != (r > 0))
        for i in flips.nonzero().tolist():
            lines.append(f"{name}{i}: float64 {float(r[tuple(i)]):.3g}, "
                         "F.batch_norm "
                         f"{float(runs['F.batch_norm'][1][name][tuple(i)]):.3g}"
                         ", two passes "
                         f"{float(runs['two passes'][1][name][tuple(i)]):.3g}")
    print("\n".join(lines))


def test_cpu_train_mode_is_the_two_pass_form():
    """Output, gradients and running statistics (the biased variance, as
    Flax keeps it) of the two-pass form over the (n, C) slots."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(3, 7, 4)).astype(np.float32) * 2 + 5,
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(3, 7, 4)).astype(np.float32))
    bn = ChannelsLastBatchNorm(4, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 4))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, 4))
    out = bn(x)
    (out * w).sum().backward()
    flat = x.detach().reshape(-1, 4).double()
    mean = flat.mean(0)
    var = ((flat - mean) ** 2).mean(0)
    want = (flat - mean) / torch.sqrt(var + 1e-5) \
        * bn.weight.detach().double() + bn.bias.detach().double()
    np.testing.assert_allclose(out.detach().reshape(-1, 4).numpy(),
                               want.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               w.reshape(-1, 4).sum(0).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               (0.1 * mean).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 + 0.1 * var).numpy(), rtol=1e-6)
    assert int(bn.num_batches_tracked) == 1

"""The shape classification and part-segmentation heads in the port against
the JAX package, on the CPU: both models through convert.py, their eval
forwards and the gradients of their losses through them, both losses with
their gradients, and the six classification and part-segmentation
metrics.

Tolerances: the eval forward rtol 5e-4 / atol 5e-5 (the whole-model
tolerance, BatchNorm statistics at O(1); the final Dense layers are He
normal, so O(1) already); each parameter's gradient through the eval model
within 1e-4 of its max-abs (a float32 sum over a few thousand terms); the
losses and their gradients rtol 1e-5; the metrics at 1e-12 (float64 numpy
on both sides).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.losses import masked as jax_masked
from deep3dpointclouddenoising_tpu.models.build import (
    build_classification as jax_build_cls,
    build_multi_part_segmentation as jax_build_part)
from deep3dpointclouddenoising_tpu.utils import metrics as jmet
from deep3dpointclouddenoising_torch.config import default_config
from deep3dpointclouddenoising_torch.convert import (flax_from_params,
                                                     params_from_flax)
from deep3dpointclouddenoising_torch.losses.masked import (
    label_smoothing_cross_entropy, multi_shape_cross_entropy)
from deep3dpointclouddenoising_torch.models import (
    ClassificationModel, MultiPartSegmentationModel, build_classification,
    build_multi_part_segmentation)
from deep3dpointclouddenoising_torch.utils import metrics as tmet
from test_torch_model import small_config, small_inputs

MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-8)
METRIC_TOL = dict(rtol=1e-12, atol=1e-12)
NUM_PARTS = [3, 2, 4]
# name: (torch builder, JAX builder, torch class, head output check)
MODELS = {
    "classification": (build_classification, jax_build_cls,
                       ClassificationModel),
    "part segmentation": (build_multi_part_segmentation, jax_build_part,
                          MultiPartSegmentationModel),
}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _config(cfg, name):
    small_config(cfg)
    cfg.num_classes = 5 if name == "classification" else len(NUM_PARTS)
    cfg.num_parts = list(NUM_PARTS)
    return cfg


def _o1_stats(variables, rng):
    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "mean":
                tree[k] = (rng.normal(size=v.shape) * 0.5).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 2.0, size=v.shape).astype(
                    np.float32)
    walk(variables["batch_stats"])
    return variables


def _labels(name, rng, B, N):
    """The loss's targets: class labels, or (point part labels, shape
    labels) with every shape's part labels inside its part count."""
    if name == "classification":
        return (rng.integers(0, 5, size=B).astype(np.int32),)
    shapes = rng.integers(0, len(NUM_PARTS), size=B).astype(np.int32)
    parts = np.stack([rng.integers(0, NUM_PARTS[s], size=N)
                      for s in shapes]).astype(np.int32)
    return parts, shapes


@pytest.mark.parametrize("name", sorted(MODELS))
def test_head_model_converts_and_matches_jax(name):
    """The JAX model's Flax tree converts with no new mapping; the eval
    forward agrees at the whole-model tolerance; the loss through the
    eval model and its gradient in every parameter agree."""
    build, jax_build, cls = MODELS[name]
    rng = np.random.default_rng(7)
    xyz, mask = small_inputs(rng)
    jcfg = _config(jax_cfg(), name)
    jcfg.use_pallas = 0
    jmodel, jloss = jax_build(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), xyz, mask, xyz, train=False))
    tmodel = build(_config(default_config(), name),
                   torch.Generator().manual_seed(0)).eval()
    assert isinstance(tmodel, cls) and not (name == "classification"
                                            and tmodel.build_up)
    flat = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: tuple(v.shape), t)
    assert flat(flax_from_params(tmodel.state_dict())) == flat(
        {k: dict(v) for k, v in shapes.items()})
    variables = _o1_stats(flax_from_params(tmodel.state_dict()), rng)
    tmodel.load_state_dict(params_from_flax(variables, tmodel))
    labels = _labels(name, rng, *xyz.shape[:2])

    def jax_loss(params):
        out = jmodel.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           xyz, mask, xyz, train=False)
        return jloss(out, *map(jnp.asarray, labels)), out

    (want_loss, want), want_g = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(variables["params"])
    out = tmodel(*_t(xyz, mask, xyz))
    loss = (label_smoothing_cross_entropy(out, *_t(*labels))
            if name == "classification"
            else multi_shape_cross_entropy(out, *_t(*labels)))
    loss.backward()
    if name == "classification":
        assert out.shape == (2, 5)
        pairs = [(out, want)]
    else:
        assert [o.shape for o in out] == [(2, 64, p) for p in NUM_PARTS]
        pairs = list(zip(out, want))
    for got, w in pairs:
        assert np.abs(np.asarray(w)).max() > 0.5
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w),
                                   **MODEL_TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = params_from_flax({"params": jax.tree_util.tree_map(
        np.asarray, want_g)})
    for pname, p in tmodel.named_parameters():
        g = grads[pname].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-12,
                                   err_msg=pname)


def _loss_case(name, rng):
    """(torch loss, JAX loss, differentiable inputs, targets)."""
    if name == "label smoothing":
        logits = [(rng.normal(size=(6, 40)) * 3).astype(np.float32)]
        return (label_smoothing_cross_entropy,
                jax_masked.label_smoothing_cross_entropy, logits,
                [rng.integers(0, 40, size=6).astype(np.int32)])
    logits = [(rng.normal(size=(4, 30, p)) * 3).astype(np.float32)
              for p in NUM_PARTS]
    parts, shapes = _labels("part", rng, 4, 30)
    return (multi_shape_cross_entropy, jax_masked.multi_shape_cross_entropy,
            logits, [parts, shapes])


@pytest.mark.parametrize("name", ["label smoothing", "multi-shape"])
def test_classification_losses_match_jax(name):
    loss, jax_loss, inputs, targets = _loss_case(
        name, np.random.default_rng(3))
    single = name == "label smoothing"

    def jfn(xs):
        return jax_loss(xs[0] if single else xs, *map(jnp.asarray, targets))

    want, want_g = jax.value_and_grad(jfn)([jnp.asarray(x) for x in inputs])
    xs = [x.requires_grad_(True) for x in _t(*inputs)]
    got = loss(xs[0] if single else xs, *_t(*targets))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    for x, g in zip(xs, want_g):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   **LOSS_TOL)


# -- the metrics --------------------------------------------------------------

def _metric_args(name, rng):
    """Seeded inputs of each metric function, numpy only."""
    if name == "topk_accuracy":
        logits = rng.normal(size=(50, 10))
        return (logits, rng.integers(0, 10, size=50), (1, 3, 5))
    if name == "iou_from_confusions":
        conf = rng.integers(0, 20, size=(3, 6, 6)).astype(np.float64)
        conf[1, 2, :] = 0.0  # a class absent from the targets
        return (conf,)
    if name == "s3dis_metrics":
        logits = [rng.normal(size=(5, 30)) for _ in range(3)]
        proj = [rng.integers(0, 30, size=80) for _ in range(3)]
        labels = [rng.integers(0, 5, size=80) for _ in range(3)]
        return (5, logits, proj, labels)
    if name == "sub_s3dis_metrics":
        logits = [rng.normal(size=(5, 40)) for _ in range(3)]
        labels = [rng.integers(0, 5, size=40) for _ in range(3)]
        return (5, logits, labels, rng.integers(100, 1000, size=5))
    parts = [4, 3, 5]
    objects = rng.integers(0, 3, size=8)
    preds = [rng.normal(size=(parts[o], 60)) for o in objects]
    targets = [rng.integers(0, parts[o], size=60) for o in objects]
    if name == "partnet_metrics":
        return (3, parts, objects, preds, targets)
    masks = [rng.random(60) > 0.2 for _ in objects]
    return (3, parts, objects, preds, targets, masks)


def _close(got, want, path="result"):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   **METRIC_TOL, err_msg=path)


@pytest.mark.parametrize("name", [
    "topk_accuracy", "iou_from_confusions", "s3dis_metrics",
    "sub_s3dis_metrics", "partnet_metrics", "shapenetpart_metrics"])
def test_metric_matches_jax(name):
    args = _metric_args(name, np.random.default_rng(11))
    want = getattr(jmet, name)(*args)
    got = getattr(tmet, name)(*args)
    _close(got, want)
    assert getattr(tmet, name).__module__ == tmet.__name__

"""The port's PosPool, AdaptiveWeight and PointWiseMLP aggregations and
their masked reduction against the JAX package's, on the CPU.

Each operator runs on the geometry of tests/test_attention.py (two clouds
of 48 points, radius 0.4, eight neighbours; here the second cloud's last
eight slots are padding that repeats real points, so padding queries,
masked slots and the exact ties of cycled neighbours all occur) with one
set of weights, built by the port and carried to Flax by convert.py, then
perturbed so that nothing hides an error: BatchNorm statistics and scales
O(1), biases and the attention gates nonzero (:func:`perturb`).  In eval
and in train mode:

* the forward: rtol 2e-4 / atol 2e-5 (the forward tolerance of
  tests/test_pallas_kpconv.py); a failure prints each side's distance
  from the port's float64 output, so that it names the side that moved;
* in train mode, the updated running statistics: rtol 1e-4 / atol 1e-6;
* the gradients of every parameter and of the input features under one
  random cotangent (``jax.vjp`` against autograd): rtol 1e-3 and an atol
  of 1e-3 of each tensor's max-abs (the gradient tolerance of
  tests/test_pallas_kpconv.py).  A gradient that vanishes by construction
  (a bias in front of a train-mode BatchNorm, or in front of a softmax
  over an axis it is constant on), told by the port's float64 gradient
  being below 1e-10 of the largest, is float32 rounding on both sides,
  seen up to 1.2e-5 of the largest gradient: each side is held within
  1e-4 of it instead.
"""
import copy
import glob
import os
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.models import \
    local_aggregation as jax_la
from deep3dpointclouddenoising_tpu.models.pyramid import \
    build_pyramid as jax_pyramid
from deep3dpointclouddenoising_torch.config import default_config, \
    load_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.models import (
    build_offset_regression, build_scene_segmentation, local_aggregation)
from deep3dpointclouddenoising_torch.models.local_aggregation import \
    LocalAggregation
from deep3dpointclouddenoising_torch.models.pyramid import Neighborhood
from deep3dpointclouddenoising_torch.train.trainer import Trainer

RADIUS = 0.4
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
STATS_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-3, 1e-3
VANISHING, NOISE_FRAC = 1e-10, 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


@lru_cache(maxsize=None)
def geometry():
    """The JAX level-0 neighbourhood of two 48-point clouds (the second
    with eight padding slots) and the port's copy of it."""
    rng = np.random.default_rng(0)
    xyz = rng.random((2, 48, 3), dtype=np.float32) * 2 - 1
    mask = np.ones((2, 48), np.float32)
    mask[1, 40:] = 0.0
    xyz[1, 40:] = xyz[1, :8]
    level = jax_pyramid(jnp.asarray(xyz), jnp.asarray(mask), radius=RADIUS,
                        sample_dl=0.1, nsamples=[8], npoints=[],
                        build_self=False, build_up=False).levels[0]
    nbr = level.self_nbr
    tnbr = Neighborhood(T(nbr.idx), T(nbr.mask), T(nbr.rel_xyz), RADIUS)
    return level, tnbr, T(level.mask)


def configs(kind: str, **sub):
    """JAX and port configs with ``local_aggregation_type`` ``kind`` and
    the ``section__key`` entries of ``sub``."""
    out = []
    for c in (jax_cfg(), default_config()):
        c.local_aggregation_type = kind
        for k, v in sub.items():
            section, key = k.split("__")
            c[section][key] = v
        out.append(c)
    return out


def perturb(variables, rng):
    """O(1) BatchNorm statistics and scales, nonzero biases and gates."""
    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
                continue
            shape = np.shape(v)
            if k == "mean":
                tree[k] = rng.normal(size=shape) * 0.5
            elif k == "var" or k == "scale":
                tree[k] = rng.uniform(0.5, 2.0, size=shape)
            elif k in ("gamma", "alpha"):
                tree[k] = rng.uniform(0.5, 1.5, size=shape)
            elif k == "bias":
                tree[k] = rng.normal(size=shape) * 0.1
            else:
                continue
            tree[k] = tree[k].astype(np.float32)
    walk(variables["params"])
    walk(variables["batch_stats"])
    return variables


def shape_tree(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)),
                                  {k: dict(v) for k, v in tree.items()})


def run_operator(kind: str, channels: int, seed: int = 0, **sub):
    """One operator of each package from one set of weights, in eval and
    train mode: ``{train: dict(jax=..., torch=...)}`` of outputs, updated
    statistics and gradients (by parameter name and ``"features"``), and
    the two variable trees' shapes."""
    level, tnbr, tmask = geometry()
    jc, tc = configs(kind, **sub)
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2, 48, channels)).astype(np.float32)
    cot = rng.normal(size=(2, 48, channels)).astype(np.float32)
    top = LocalAggregation(channels, channels, RADIUS, tc,
                           torch.Generator().manual_seed(seed),
                           num_queries=48)
    jop = jax_la.LocalAggregation(channels, channels, RADIUS, jc)
    flax_shapes = jax.eval_shape(lambda: jop.init(
        jax.random.PRNGKey(0), jnp.asarray(feats), level.self_nbr,
        level.mask, False))
    variables = perturb(flax_from_params(top.state_dict()), rng)
    top.load_state_dict(params_from_flax(variables, top))
    start = {k: v.clone() for k, v in top.state_dict().items()}
    out = {"shapes": (shape_tree(flax_shapes), shape_tree(variables))}
    for train in (False, True):
        def f(params, x):
            v = {"params": params, "batch_stats": variables["batch_stats"]}
            if train:
                y, new = jop.apply(v, x, level.self_nbr, level.mask, True,
                                   mutable=["batch_stats"])
                return y, new["batch_stats"]
            return jop.apply(v, x, level.self_nbr, level.mask, False), {}
        (jy, jstats), vjp = _vjp_with_aux(f, variables["params"], feats)
        d_params, d_x = vjp(jnp.asarray(cot))
        want_grads = params_from_flax(
            {"params": jax.tree_util.tree_map(np.asarray, d_params)})
        want_grads["features"] = T(d_x)

        top.load_state_dict(start)
        top.train(train)
        x = T(feats).requires_grad_(True)
        y = top(x, tnbr, tmask)
        names, params = zip(*top.named_parameters())
        grads = torch.autograd.grad(y, list(params) + [x], T(cot))
        got_grads = dict(zip(names + ("features",), grads))
        # the float64 gradients, only to tell which vanish by construction
        top64 = copy.deepcopy(top).double()
        top64.load_state_dict(start)
        x64 = T(feats).double().requires_grad_(True)
        y64 = top64(x64, tnbr, tmask)
        grads64 = torch.autograd.grad(
            y64, list(top64.parameters()) + [x64], T(cot).double())
        want_stats = {k: v for k, v in params_from_flax(
            {"batch_stats": jax.tree_util.tree_map(np.asarray, jstats)}
        ).items() if "running_" in k}
        got_stats = {k: v.clone() for k, v in top.state_dict().items()
                     if "running_" in k}
        out[train] = dict(
            jax=dict(y=np.asarray(jy), grads=want_grads, stats=want_stats),
            torch=dict(y=y.detach().numpy(), grads=got_grads,
                       stats=got_stats),
            float64=dict(zip(names + ("features",), grads64)),
            float64_y=y64.detach().numpy())
    top.load_state_dict(start)
    return out


def _vjp_with_aux(f, params, feats):
    """``jax.vjp`` of the output of ``f``, its second result (the updated
    statistics) carried along."""
    (y, stats), vjp_all = jax.vjp(f, params, jnp.asarray(feats))

    def vjp(cot):
        zero = jax.tree_util.tree_map(jnp.zeros_like, stats)
        return vjp_all((cot, zero))
    return (y, stats), vjp


def assert_forward(res):
    assert res["shapes"][0] == res["shapes"][1]
    for train in (False, True):
        want, got = res[train]["jax"], res[train]["torch"]
        assert np.abs(want["y"]).max() > 0.1
        ref = res[train]["float64_y"]
        np.testing.assert_allclose(
            got["y"], want["y"], **FWD_TOL, err_msg=(
                f"train={train}; from the port's float64 output: port "
                f"{np.abs(got['y'] - ref).max():.3e}, JAX "
                f"{np.abs(want['y'] - ref).max():.3e}"))
        if not train:
            continue
        assert want["stats"] and set(got["stats"]) == set(want["stats"])
        for k, w in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k].numpy(), w.numpy(),
                                       **STATS_TOL, err_msg=k)


def assert_gradients(res):
    for train in (False, True):
        want, got = res[train]["jax"]["grads"], res[train]["torch"]["grads"]
        exact = res[train]["float64"]
        assert set(want) == set(got) == set(exact)
        largest = max(float(w.abs().max()) for w in exact.values())
        assert largest > 0.0
        for k, w in want.items():
            w = w.numpy()
            if float(exact[k].abs().max()) <= VANISHING * largest:
                # zero by construction: float32 noise on both sides
                for side in (w, got[k].numpy()):
                    assert np.abs(side).max() <= NOISE_FRAC * largest, k
                continue
            np.testing.assert_allclose(got[k].numpy(), w, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL_FRAC * np.abs(w).max(),
                                       err_msg=f"{k} train={train}")


@lru_cache(maxsize=None)
def cached(kind: str, channels: int, form):
    return run_operator(kind, channels, **dict(form))


def _form(**kw):
    return tuple(sorted(kw.items()))


POSPOOL_FORMS = [
    _form(pospool__position_embedding=e, pospool__reduction=r)
    for e in ("xyz", "sin_cos") for r in ("avg", "sum", "max")] + [
    _form(pospool__position_embedding="sin_cos", pospool__reduction="mean",
          pospool__output_conv=True)]
ADAPTIVE_FORMS = [
    _form(),
    _form(adaptive_weight__num_mlps=2, adaptive_weight__weight_softmax=True,
          adaptive_weight__shared_channels=2,
          adaptive_weight__reduction="max"),
    _form(adaptive_weight__num_mlps=3, adaptive_weight__shared_channels=3,
          adaptive_weight__reduction="sum",
          adaptive_weight__output_conv=True)]
POINTWISE_FORMS = [
    _form(pointwisemlp__feature_type="dp_fj"),
    _form(pointwisemlp__feature_type="dp_fj", pointwisemlp__num_mlps=2,
          pointwisemlp__reduction="avg"),
    _form(pointwisemlp__feature_type="dp_fi_df"),
    _form(pointwisemlp__feature_type="dp_fi_df", pointwisemlp__num_mlps=3,
          pointwisemlp__reduction="sum")]
FAMILIES = {"pospool": (24, POSPOOL_FORMS),
            "adaptive_weight": (24, ADAPTIVE_FORMS),
            "pointwisemlp": (16, POINTWISE_FORMS)}


def _ids(forms):
    return ["-".join(f"{k.split('__')[1]}={v}" for k, v in f) or "default"
            for f in forms]


@pytest.mark.parametrize("form", POSPOOL_FORMS, ids=_ids(POSPOOL_FORMS))
@pytest.mark.parametrize("what", ["forward", "gradients"])
def test_pospool_matches_jax(form, what):
    res = cached("pospool", 24, form)
    (assert_forward if what == "forward" else assert_gradients)(res)


@pytest.mark.parametrize("form", ADAPTIVE_FORMS, ids=_ids(ADAPTIVE_FORMS))
@pytest.mark.parametrize("what", ["forward", "gradients"])
def test_adaptive_weight_matches_jax(form, what):
    res = cached("adaptive_weight", 24, form)
    (assert_forward if what == "forward" else assert_gradients)(res)


@pytest.mark.parametrize("form", POINTWISE_FORMS, ids=_ids(POINTWISE_FORMS))
@pytest.mark.parametrize("what", ["forward", "gradients"])
def test_pointwisemlp_matches_jax(form, what):
    res = cached("pointwisemlp", 16, form)
    (assert_forward if what == "forward" else assert_gradients)(res)


@pytest.mark.parametrize("reduction", ["max", "avg", "mean", "sum"])
def test_masked_reduce_matches_jax_at_ties(reduction):
    """The reduction alone on values with exact ties across the cycled
    padding slots: value and gradient against JAX's ``_masked_reduce``
    (rtol 1e-6; the max's gradient split evenly among the tied slots, as
    ``jnp.max``'s is, which ``torch.max(dim=)`` would not do)."""
    level, tnbr, tmask = geometry()
    rng = np.random.default_rng(5)
    B, M, K = np.shape(level.self_nbr.idx)
    # the value of each slot is its support point's: cycled slots tie
    base = rng.normal(size=(B, 48, 6)).astype(np.float32)
    agg = np.take_along_axis(
        base[:, None], np.asarray(level.self_nbr.idx)[..., None], axis=2)
    cot = rng.normal(size=(B, M, 6)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_la._masked_reduce(
        a, level.self_nbr, level.mask, reduction), jnp.asarray(agg))
    (want_grad,) = vjp(jnp.asarray(cot))
    x = T(agg).requires_grad_(True)
    got = local_aggregation.masked_reduce(x, tnbr, tmask, reduction)
    (got_grad,) = torch.autograd.grad(got, x, T(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-7)
    if reduction == "max":
        tied = (np.asarray(level.self_nbr.mask) == 0).any()
        assert tied  # the geometry has cycled slots
        # a slot holding the max with a twin gets half its cotangent
        g = got_grad.numpy()
        assert np.any(np.isclose(np.abs(g), 0.5 * np.abs(cot[:, :, None]))
                      & (g != 0))


def test_unknown_reduction_and_forms_raise():
    _, tc = configs("pospool", pospool__reduction="median")
    with pytest.raises(NotImplementedError, match="median"):
        LocalAggregation(24, 24, RADIUS, tc)
    _, tc = configs("pospool", pospool__position_embedding="fourier")
    with pytest.raises(NotImplementedError, match="fourier"):
        LocalAggregation(24, 24, RADIUS, tc)
    _, tc = configs("pospool", pospool__position_embedding="sin_cos")
    with pytest.raises(ValueError, match="multiple of 6"):
        LocalAggregation(16, 16, RADIUS, tc)
    _, tc = configs("adaptive_weight", adaptive_weight__weight_type="df")
    with pytest.raises(NotImplementedError, match="df"):
        LocalAggregation(24, 24, RADIUS, tc)
    _, tc = configs("pointwisemlp", pointwisemlp__feature_type="fj")
    with pytest.raises(NotImplementedError, match="fj"):
        LocalAggregation(24, 24, RADIUS, tc)


def test_bf16_compute_dtype_where_jax_passes_it():
    """Under ``compute_dtype: bfloat16`` every ConvBN of the three
    operators computes in bfloat16 (JAX passes them ``compute_dtype``);
    AdaptiveWeight's Dense chain stays float32 (JAX's ``nn.Dense`` has no
    dtype there)."""
    for kind, sub in (("pospool", dict(pospool__output_conv=True)),
                      ("adaptive_weight",
                       dict(adaptive_weight__output_conv=True)),
                      ("pointwisemlp", dict(pointwisemlp__num_mlps=3))):
        _, tc = configs(kind, **sub)
        tc.compute_dtype = "bfloat16"
        op = LocalAggregation(24, 24, RADIUS, tc)
        convs = [m for m in op.modules() if type(m).__name__ == "ConvBN"]
        assert convs and all(m.compute_dtype == torch.bfloat16
                             for m in convs), kind
        for m in op.modules():
            if isinstance(m, torch.nn.Linear) and m not in [
                    c.Dense_0 for c in convs]:
                assert m.weight.dtype == torch.float32


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILES = sorted(glob.glob(os.path.join(ROOT, "cfgs", "*.yaml"))
                      + glob.glob(os.path.join(ROOT, "cfgs", "custom_cfgs",
                                               "*.yaml")))
NEW_CONFIGS = [p for p in CONFIG_FILES
               if load_config(p).local_aggregation_type != "pseudo_grid"]


def small(cfg):
    """``cfg`` at width 24, depth 1 and 64 points on the small geometry of
    tests/test_pallas_kpconv.py, batch 2."""
    for k, v in dict(num_points=64, width=24, depth=1, radius=0.2,
                     sampleDl=0.05, nsamples=[8] * 5, npoints=[16, 8, 4, 2],
                     in_radius=1.0, batch_size=2).items():
        cfg[k] = v
    return cfg


def build_model(cfg, seed: int = 0):
    """The config's model: the segmentation model for ``resnet_scene_seg``,
    else the offset regressor."""
    build = build_scene_segmentation if cfg.head == "resnet_scene_seg" \
        else build_offset_regression
    return build(cfg, torch.Generator().manual_seed(seed))


def operator_settings(cfg):
    """What a config's model depends on beyond the geometry: the
    aggregation, its section (with PointWiseMLP's under a global
    attention operator) and the head."""
    kind = cfg.local_aggregation_type
    section = cfg[kind].to_dict() if kind != "pseudo_grid" else {}
    if kind == "attention" and section["type"] != "Point-transformer":
        section["pointwisemlp"] = cfg.pointwisemlp.to_dict()
    return kind, repr(sorted(section.items())), cfg.head


def test_every_aggregation_type_of_the_configs_is_ported():
    """Every ``local_aggregation_type`` (and attention type) that a config
    names builds; the 29 configs that use the operators of this module and
    models/attention.py (15 of 500 points, ``outlier_seg_edf_katz`` and 13
    of ``cfgs/custom_cfgs``) build their whole model at a small size.
    Those 29 hold 19 distinct operator settings, each trained by a test
    below or in tests/test_torch_attention.py."""
    kinds = set()
    for path in CONFIG_FILES:
        cfg = load_config(path)
        kinds.add(cfg.local_aggregation_type)
        LocalAggregation(24, 24, 0.1, cfg, num_queries=32)
    assert kinds == {"pseudo_grid", "pospool", "adaptive_weight",
                     "pointwisemlp", "attention"}
    names = [os.path.relpath(p, ROOT) for p in NEW_CONFIGS]
    assert len(names) == 29
    assert sum(n.startswith("cfgs/custom_cfgs/") for n in names) == 13
    for path in NEW_CONFIGS:
        model = build_model(small(load_config(path)))
        assert sum(p.numel() for p in model.parameters()) > 0
    assert {operator_settings(load_config(p)) for p in NEW_CONFIGS} == {
        operator_settings(load_config(p)) for p in TRAINED_CONFIGS}
    assert len(TRAINED_CONFIGS) == 19


def _first_of_each_setting(paths):
    seen, out = set(), []
    for p in paths:
        key = operator_settings(load_config(p))
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


TRAINED_CONFIGS = _first_of_each_setting(NEW_CONFIGS)
ATTENTION_CONFIGS = [p for p in TRAINED_CONFIGS
                     if load_config(p).local_aggregation_type == "attention"]
OTHER_CONFIGS = [p for p in TRAINED_CONFIGS if p not in ATTENTION_CONFIGS]


def check_config_trains(path: str):
    """The config's model at :func:`small`'s size: one train step on the
    CPU through the Trainer, a finite loss and finite gradients, and every
    parameter with a nonzero gradient moved (the parameters behind an
    attention gate, zero at init, get none in the first step)."""
    cfg = small(load_config(path))
    seg = cfg.head == "resnet_scene_seg"
    tt = Trainer(cfg, 10, torch.Generator().manual_seed(0), "cpu",
                 loss_mode="segmentation" if seg else "offset")
    rng = np.random.default_rng(1)
    xyz = rng.random((2, 64, 3), dtype=np.float32) * 2 - 1
    mask = np.ones((2, 64), np.float32)
    mask[1, 50:] = 0.0
    xyz[1, 50:] = xyz[1, :14]
    batch = {"points": xyz, "mask": mask,
             "features": rng.normal(size=(2, 64, int(
                 cfg.input_features_dim))).astype(np.float32)}
    if seg:
        batch["labels"] = rng.integers(0, 2, (2, 64)).astype(np.int64)
    else:
        batch["offsets"] = rng.normal(size=(2, 64, 3)).astype(
            np.float32) * 0.02
    start = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    assert np.isfinite(tt.train_step(batch).item())
    moved = 0
    for n, p in tt.model.named_parameters():
        assert torch.isfinite(p.grad).all(), n
        if p.grad.abs().max() > 0:
            assert not torch.equal(p.detach(), start[n]), n
            moved += 1
    assert moved > 0.5 * len(start)


def _config_ids(paths):
    return [os.path.basename(p)[:-5] for p in paths]


@pytest.mark.parametrize("path", OTHER_CONFIGS,
                         ids=_config_ids(OTHER_CONFIGS))
def test_config_trains(path):
    """One config per operator setting over PosPool, AdaptiveWeight or
    PointWiseMLP (the attention ones: tests/test_torch_attention.py)."""
    check_config_trains(path)

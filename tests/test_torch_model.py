"""The port's model against the JAX package's: the Flax -> torch converter,
the eval forward at the small config of tests/test_pallas_kpconv.py
(rtol 5e-4 / atol 5e-5), and the geometry pyramid level by level at the
l1.yaml geometry (indices and masks exact)."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.models.build import \
    OffsetRegressionModel as JaxModel
from deep3dpointclouddenoising_tpu.models.kernel_points import \
    create_kernel_points as jax_kernel_points
from deep3dpointclouddenoising_tpu.models.pyramid import \
    build_pyramid as jax_pyramid
from deep3dpointclouddenoising_torch.config import default_config, \
    load_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.models import OffsetRegressionModel
from deep3dpointclouddenoising_torch.models.kernel_points import \
    create_kernel_points
from deep3dpointclouddenoising_torch.models.pyramid import build_pyramid
from deep3dpointclouddenoising_torch.ops import (
    masked_grid_subsampling, masked_nearest_query, masked_ordered_ball_query)


L1_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cfgs", "l1.yaml")


def small_config(cfg):
    """tests/test_pallas_kpconv.py:80-96."""
    cfg.num_points = 64
    cfg.width = 16
    cfg.depth = 2
    cfg.bottleneck_ratio = 2
    cfg.radius = 0.2
    cfg.sampleDl = 0.05
    cfg.nsamples = [8, 8, 8, 8, 8]
    cfg.npoints = [16, 8, 4, 2]
    cfg.in_radius = 1.0
    cfg.local_aggregation_type = "pseudo_grid"
    cfg.head = "offset_reg_head"
    cfg.input_features_dim = 3
    return cfg


def perturb(variables, rng):
    """O(1) running stats and final Dense: the head's 1e-4 init would make
    the output ~0 and let atol hide every error."""
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
    dense = variables["params"]["MultiDimHead_0"]["Dense_0"]
    for k in ("kernel", "bias"):
        dense[k] = rng.normal(size=dense[k].shape).astype(np.float32)
    return variables


def small_inputs(rng, B=2, N=64):
    xyz = (rng.random((B, N, 3), dtype=np.float32) * 2 - 1)
    mask = np.ones((B, N), np.float32)
    mask[1, 50:] = 0.0
    xyz[1, 50:] = xyz[1, :14]  # padding replicates real points
    return xyz, mask


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tuple(v.shape)
    return out


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    xyz, mask = small_inputs(rng)
    jcfg = small_config(jax_cfg())
    jcfg.use_pallas = 0
    jmodel = JaxModel(cfg=jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), xyz, mask, xyz, train=False))
    torch.manual_seed(0)
    tmodel = OffsetRegressionModel(small_config(default_config())).eval()
    variables = perturb(flax_from_params(tmodel.state_dict()), rng)
    tmodel.load_state_dict(params_from_flax(variables, tmodel))
    return dict(xyz=xyz, mask=mask, jmodel=jmodel, shapes=shapes,
                tmodel=tmodel, variables=variables)


def test_torch_tree_is_the_flax_tree(models):
    """Every Flax variable has exactly one torch counterpart of its shape."""
    got = _flat(flax_from_params(models["tmodel"].state_dict()))
    want = _flat({k: dict(v) for k, v in models["shapes"].items()})
    assert got == want


def test_converter_round_trip(models):
    model = models["tmodel"]
    sd = model.state_dict()
    back = params_from_flax(flax_from_params(sd), model)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # Dense kernels are (in, out) in Flax, (out, in) in torch
    enc = models["variables"]["params"]["ResNetEncoder_0"]
    np.testing.assert_array_equal(
        enc["ConvBN_0"]["Dense_0"]["kernel"],
        sd["ResNetEncoder_0.ConvBN_0.Dense_0.weight"].numpy().T)


def test_converter_rejects_unmatched_keys(models):
    variables = flax_from_params(models["tmodel"].state_dict())
    variables["params"]["ResNetEncoder_0"]["Extra_0"] = {
        "kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        params_from_flax(variables, models["tmodel"])
    del variables["params"]["ResNetEncoder_0"]["Extra_0"]
    del variables["params"]["MultiDimHead_0"]["Dense_0"]["bias"]
    with pytest.raises(KeyError):
        params_from_flax(variables, models["tmodel"])
    with pytest.raises(KeyError):
        params_from_flax({"params": {"A_0": {"odd": np.zeros(1)}}})


def test_eval_forward_matches_jax(models):
    xyz, mask = models["xyz"], models["mask"]
    variables = models["variables"]
    want = np.asarray(jax.jit(lambda v: models["jmodel"].apply(
        v, xyz, mask, xyz, train=False))(variables))
    with torch.no_grad():
        got = models["tmodel"](*[torch.from_numpy(a)
                                 for a in (xyz, mask, xyz)]).numpy()
    assert np.abs(want).max() > 1.0  # the perturbed head is O(1)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)


def test_kernel_points_match_jax(models):
    # the radii of the small model's five levels; the JAX package cached
    # them while tracing its model
    for level in range(5):
        extent = 2.0 * 1.0 * (0.2 * 2.0 ** level) / 5.0
        np.testing.assert_array_equal(
            create_kernel_points(1.5 * extent, 15, fixed="center", seed=0),
            jax_kernel_points(1.5 * extent, 15, fixed="center", seed=0))


def test_unported_options_raise():
    cfg = small_config(default_config())
    cfg.local_aggregation_type = "pospool"
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        OffsetRegressionModel(cfg)
    # bfloat16 is ported (tests/test_torch_bf16.py); another compute
    # dtype raises
    cfg = small_config(default_config())
    cfg.compute_dtype = "bfloat16"
    model = OffsetRegressionModel(cfg)
    assert model.ResNetEncoder_0.ConvBN_0.compute_dtype == torch.bfloat16
    cfg.compute_dtype = "float16"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        OffsetRegressionModel(cfg)


def l1_patches(rng, B=2, N=500):
    """Patch-like clouds at the l1.yaml geometry: points of a sphere of
    radius 0.3 within the 0.05 patch radius of a surface point, the last
    slots of the second cloud padding."""
    clouds, masks = [], []
    for b in range(B):
        s = rng.normal(size=(40000, 3))
        s = 0.3 * s / np.linalg.norm(s, axis=1, keepdims=True)
        s = s + rng.normal(size=s.shape) * 0.001
        near = s[np.linalg.norm(s - s[0], axis=1) < 0.05] - s[0]
        n_real = min(len(near), N - 40 * b)
        pts = np.concatenate([near[:n_real], near[:N - n_real]])
        m = np.zeros(N, np.float32)
        m[:n_real] = 1.0
        clouds.append(pts)
        masks.append(m)
    return np.stack(clouds).astype(np.float32), np.stack(masks)


def _assert_nbr_equal(got_idx, got_mask, want):
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want.mask))


def test_pyramid_levels_match_jax_at_l1_geometry():
    cfg = load_config(L1_YAML)
    xyz, mask = l1_patches(np.random.default_rng(1))
    geo = dict(radius=float(cfg.radius), sample_dl=float(cfg.sampleDl),
               nsamples=list(cfg.nsamples), npoints=list(cfg.npoints))
    want = jax.jit(lambda x, m: jax_pyramid(x, m, **geo))(
        jnp.asarray(xyz), jnp.asarray(mask))
    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    lv0 = want.levels[0]
    got = masked_ordered_ball_query(T(xyz), T(xyz), T(mask), T(mask),
                                    radius=geo["radius"],
                                    nsample=geo["nsamples"][0])
    _assert_nbr_equal(*got, lv0.self_nbr)
    for i in range(1, 5):
        fine, coarse = want.levels[i - 1], want.levels[i]
        tr = want.transitions[i - 1]
        sub_xyz, sub_mask = masked_grid_subsampling(
            T(fine.xyz), T(fine.mask), npoint=geo["npoints"][i - 1],
            sample_dl=geo["sample_dl"] * 2.0 ** i)
        np.testing.assert_array_equal(sub_mask.numpy(),
                                      np.asarray(coarse.mask))
        np.testing.assert_allclose(sub_xyz.numpy(), np.asarray(coarse.xyz),
                                   rtol=1e-6, atol=1e-9)
        # from here on JAX's positions, so one tie flip cannot cascade
        got = masked_ordered_ball_query(
            T(coarse.xyz), T(fine.xyz), T(coarse.mask), T(fine.mask),
            radius=geo["radius"] * 2.0 ** (i - 1),
            nsample=geo["nsamples"][i - 1])
        _assert_nbr_equal(*got, tr.pool_nbr)
        up_idx, up_mask = masked_nearest_query(
            T(fine.xyz), T(coarse.xyz), T(fine.mask), T(coarse.mask))
        np.testing.assert_array_equal(up_idx.numpy(), np.asarray(tr.up_idx))
        np.testing.assert_array_equal(up_mask.numpy(),
                                      np.asarray(tr.up_mask))
        got = masked_ordered_ball_query(
            T(coarse.xyz), T(coarse.xyz), T(coarse.mask), T(coarse.mask),
            radius=geo["radius"] * 2.0 ** i, nsample=geo["nsamples"][i])
        _assert_nbr_equal(*got, coarse.self_nbr)
    # the port's own pyramid: the same levels, relative positions included
    mine = build_pyramid(T(xyz), T(mask), **geo)
    for a, b in zip(mine.levels, want.levels):
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
        np.testing.assert_allclose(a.xyz.numpy(), np.asarray(b.xyz),
                                   rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(mine.levels[0].self_nbr.rel_xyz.numpy(),
                               np.asarray(lv0.self_nbr.rel_xyz), rtol=1e-6,
                               atol=1e-9)

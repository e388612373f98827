"""The whole model at the 15k schedule against the JAX package, on the
same numpy inputs and converted weights:
``cfgs/synthetic_quality_chamfer15k.yaml`` at width 16, B=1
(nsamples [26, 31, 38, 41, 39], npoints [4096, 1152, 304, 88]) on a real
15,000-slot patch (a 140,000-point cloud, mostly padding), with O(1)
running statistics and final Dense: the pyramid level by level (indices
and masks exact, positions rtol 1e-6 / atol 1e-7), the 1-NN upsample at
15000 x 4096 included, and the eval forward at rtol 5e-4 / atol 5e-5.
The JAX model runs its jnp reference (``use_pallas: 0``): its Pallas
kernels in interpret mode are held to the port at N > 2048 in
tests/test_torch_15k_ops.py.
"""
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu.config import load_config as jax_load
from deep3dpointclouddenoising_tpu.models.build import \
    OffsetRegressionModel as JaxModel
from deep3dpointclouddenoising_tpu.models.pyramid import \
    build_pyramid as jax_pyramid
from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.data.offset_dataset import OffsetDataset
from deep3dpointclouddenoising_torch.data.synthetic import make_cylinder
from test_torch_remat import _init

CHAMFER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cfgs", "synthetic_quality_chamfer15k.yaml")


def patches_15k(root, n):
    """``n`` validation patches of the Chamfer 15k config, each a batch of
    one: 15,000 slots of a 140,000-point cylinder, mostly padding."""
    cfg = load_config(CHAMFER)
    ds = OffsetDataset(str(root), "val", in_radius=cfg.in_radius,
                       num_points=cfg.num_points, num_steps=2 * n,
                       noise_type=cfg.noise_type,
                       noise_level=cfg.noise_level,
                       num_points_per_shape=cfg.num_points_per_shape,
                       seed=cfg.rng_seed,
                       shapes={"val/cylinder": make_cylinder(40, 12, 0.65,
                                                             1.6)})
    out = []
    for i in range(n):
        patch = ds.get(i)
        assert 100 < patch["mask"].sum() < 15000
        out.append({k: patch[k][None] for k in (
            "points", "mask", "features", "offsets", "labels")})
    return out


@pytest.fixture(scope="module")
def patch_15k(tmp_path_factory):
    return patches_15k(tmp_path_factory.mktemp("ds"), 1)[0]


def test_15k_schedule_pyramid_and_forward_match_jax(patch_15k):
    overrides = {"width": 16, "batch_size": 1}
    tc, jc = load_config(CHAMFER, overrides), jax_load(CHAMFER, overrides)
    assert list(tc.nsamples) == list(jc.nsamples) == [26, 31, 38, 41, 39]
    assert list(tc.npoints) == list(jc.npoints) == [4096, 1152, 304, 88]
    jc.use_pallas = 0  # the jnp reference: interpret mode at 15k is slow
    tmodel, variables = _init(tc)
    tmodel.eval()
    xyz, mask = patch_15k["points"], patch_15k["mask"]
    with torch.no_grad():
        tpyr = tmodel.make_pyramid(torch.from_numpy(xyz),
                                   torch.from_numpy(mask))
        got = tmodel(torch.from_numpy(xyz), torch.from_numpy(mask),
                     torch.from_numpy(patch_15k["features"])).numpy()
    jpyr = jax.jit(functools.partial(
        jax_pyramid, radius=float(jc.radius), sample_dl=float(jc.sampleDl),
        nsamples=list(jc.nsamples), npoints=list(jc.npoints),
        build_self=True, build_up=True))(jnp.asarray(xyz), jnp.asarray(mask))
    sizes = [lvl.xyz.shape[1] for lvl in tpyr.levels]
    assert sizes == [15000, 4096, 1152, 304, 88]
    for tl, jl in zip(tpyr.levels, jpyr.levels):
        np.testing.assert_allclose(tl.xyz.numpy(), np.asarray(jl.xyz),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(tl.mask.numpy(), np.asarray(jl.mask))
        np.testing.assert_array_equal(tl.self_nbr.idx.numpy(),
                                      np.asarray(jl.self_nbr.idx))
        np.testing.assert_array_equal(tl.self_nbr.mask.numpy(),
                                      np.asarray(jl.self_nbr.mask))
    for tt, jt in zip(tpyr.transitions, jpyr.transitions):
        np.testing.assert_array_equal(tt.pool_nbr.idx.numpy(),
                                      np.asarray(jt.pool_nbr.idx))
        np.testing.assert_array_equal(tt.up_idx.numpy(),
                                      np.asarray(jt.up_idx))
    # the 1-NN upsample at 15000 x 4096
    assert tpyr.transitions[0].up_idx.shape == (1, 15000)
    want = jax.jit(functools.partial(JaxModel(cfg=jc).apply, train=False))(
        variables, xyz, mask, patch_15k["features"])
    assert got.shape == (1, 15000, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=5e-4, atol=5e-5)

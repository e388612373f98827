"""The port's 15,000-slot patches against the JAX package's, patch by
patch, on 140,000-point clouds of the synthetic shapes (exact):

* the ``train`` split of ``cfgs/outliers_40_1e3.yaml`` (40% uniform-box
  outliers, gaussian sigma 0.1%, its train transforms): the processed
  clouds, the balanced interleave of outlier and inlier centres, and
  patches of two epochs;
* the ``qualitative_test`` split of
  ``cfgs/synthetic_quality_chamfer15k.yaml`` at gaussian sigma 0.5%, the
  patches its inference serves (``sample_Dl_patches`` 0.03).

Both packages read the scipy path (the JAX package's native 1-NN ranks
float32 distances and may pick another test-split centre at a near-tie,
``tests/test_torch_deploy.py``).
"""
import os

import numpy as np
import pytest

from deep3dpointclouddenoising_tpu.config import load_config as jax_load
from deep3dpointclouddenoising_tpu.data import synthetic as jax_synthetic
from deep3dpointclouddenoising_tpu.data.offset_dataset import \
    OffsetDataset as JaxDataset
from deep3dpointclouddenoising_tpu.data.transforms import \
    build_train_transforms as jax_transforms
from deep3dpointclouddenoising_tpu.utils import native as jax_native
from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.data import synthetic
from deep3dpointclouddenoising_torch.data.offset_dataset import OffsetDataset
from deep3dpointclouddenoising_torch.data.transforms import \
    build_train_transforms

CFGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cfgs")
OUTLIERS = os.path.join(CFGS, "outliers_40_1e3.yaml")
CHAMFER = os.path.join(CFGS, "synthetic_quality_chamfer15k.yaml")


@pytest.fixture(autouse=True)
def scipy_path(monkeypatch):
    monkeypatch.setattr(jax_native, "_load_lib", lambda: None)


def _kwargs(cfg, **extra):
    kw = dict(in_radius=cfg.in_radius, num_points=cfg.num_points,
              noise_type=cfg.noise_type, noise_level=cfg.noise_level,
              num_points_per_shape=cfg.num_points_per_shape,
              outlier_proportion=cfg.outlier_percentage, seed=cfg.rng_seed)
    kw.update(extra)
    return kw


def _assert_same_clouds(tds, jds):
    assert tds.cloud_names == jds.cloud_names
    for a, b in zip(tds.shapes, jds.shapes):
        for key in ("points", "labels", "offsets"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    np.testing.assert_array_equal(tds.point_inds, jds.point_inds)
    np.testing.assert_array_equal(tds.cloud_inds, jds.cloud_inds)


def _assert_same_patches(tds, jds, indices, epochs=(0,)):
    for epoch in epochs:
        for i in indices:
            got, want = tds.get(i, epoch), jds.get(i, epoch)
            assert set(got) == set(want)
            assert got["points"].shape == (15000, 3)
            for key in got:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{key}, patch {i}")


def test_train_split_with_outliers_matches_jax(tmp_path):
    cfg, jcfg = load_config(OUTLIERS), jax_load(OUTLIERS)
    assert (cfg.num_points, cfg.outlier_percentage) == (15000, 0.4)
    kw = _kwargs(cfg, num_steps=16)

    def shapes(mod):
        return {"train/torus_thin": mod.make_torus(1.0, 0.2),
                "train/box": mod.make_box(10, (1.0, 0.8, 0.6))}

    jds = JaxDataset(str(tmp_path / "jax"), "train", num_epochs=2,
                     native_patches=False, transforms=jax_transforms(jcfg),
                     shapes=shapes(jax_synthetic), **kw)
    tds = OffsetDataset(str(tmp_path / "torch"), "train", num_epochs=2,
                        transforms=build_train_transforms(cfg),
                        shapes=shapes(synthetic), **kw)
    _assert_same_clouds(tds, jds)
    labels = [s.labels for s in tds.shapes]
    assert np.mean(labels[0]) == pytest.approx(0.4, abs=1e-4)
    # the centres alternate outlier, inlier
    centre = np.array([labels[c][p] for c, p in zip(tds.cloud_inds,
                                                    tds.point_inds)])
    assert (centre[0::2] == 1).all() and (centre[1::2] == 0).all()
    _assert_same_patches(tds, jds, (0, 1, 6, 15), epochs=(0, 1))
    real = [int(tds.get(i)["mask"].sum()) for i in (0, 1)]
    assert 0 < min(real) and max(real) < 15000  # mostly padding


def test_test_split_patches_match_jax(tmp_path):
    cfg = load_config(CHAMFER)
    assert (cfg.num_points, cfg.sample_Dl_patches) == (15000, 0.03)
    kw = _kwargs(cfg, noise_type="gaussian", noise_level=0.005,
                 sample_dl_patches=cfg.sample_Dl_patches)

    def shapes(mod):
        return {"qualitative_test/cylinder_t":
                mod.make_cylinder(56, 20, 0.4, 2.2)}

    jds = JaxDataset(str(tmp_path / "jax"), "qualitative_test",
                     native_patches=False, shapes=shapes(jax_synthetic),
                     **kw)
    tds = OffsetDataset(str(tmp_path / "torch"), "qualitative_test",
                        shapes=shapes(synthetic), **kw)
    _assert_same_clouds(tds, jds)
    n = len(tds)
    assert n == len(jds) == 2227  # chip_smoke.py's BATCHES_15K = 279 of 8
    _assert_same_patches(tds, jds, (0, 1, n // 2, n - 1))

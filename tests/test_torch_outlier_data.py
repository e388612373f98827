"""The port's outlier-segmentation data against the JAX package's, on
stand-in scans of a few hundred points (exact, bitwise):

* Katz visibility, ``pad_features_to_3`` and the K-fold splits;
* ``OutlierSegmentationDataset`` for the EDFS, EDFS3f1 and PCN layouts,
  with and without voxel pre-subsampling: split names, full and sub-clouds,
  features, labels, density, projections, the patch table and ``get()`` of
  train (with the train transforms, two epochs), val and test patches,
  against JAX's numpy path (``native_patches=False``, the scipy index);
* the stand-in scans of ``data.scans`` against
  ``scripts/run_custom_sweep.make_scans``, and the batch transforms of
  the voting evaluation;
* the voting evaluation over a test split through one converted model in
  each package: the metric dict exactly, the written probabilities rtol
  1e-5.
"""
import os
import sys

import numpy as np
import jax
import pytest
import torch

from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.data import outlier_dataset as jod
from deep3dpointclouddenoising_tpu.data import transforms as jtr
from deep3dpointclouddenoising_tpu.data.transforms import \
    build_train_transforms as jax_transforms
from deep3dpointclouddenoising_tpu.evaluate import \
    evaluate_outlier_segmentation as jax_evaluate
from deep3dpointclouddenoising_tpu.models.build import \
    SceneSegmentationModel as JaxSegModel
from deep3dpointclouddenoising_tpu.utils import native as jax_native
from deep3dpointclouddenoising_torch.config import default_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.data import outlier_dataset as tod
from deep3dpointclouddenoising_torch.data import transforms as ttr
from deep3dpointclouddenoising_torch.data.loader import collate
from deep3dpointclouddenoising_torch.data.meshio import read_ply, write_ply
from deep3dpointclouddenoising_torch.data.scans import make_scans
from deep3dpointclouddenoising_torch.data.transforms import \
    build_train_transforms
from deep3dpointclouddenoising_torch.evaluate import \
    evaluate_outlier_segmentation
from deep3dpointclouddenoising_torch.infer import make_predict_fn
from deep3dpointclouddenoising_torch.models import build_scene_segmentation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def scipy_path(monkeypatch):
    monkeypatch.setattr(jax_native, "_load_lib", lambda: None)


def make_scan(rng, n=300, n_out=30, gt_outlier=2.0):
    """tests/test_outlier_dataset.py's stand-in: a unit-sphere shell and
    uniform box outliers (``GT == gt_outlier``), normals and intensity."""
    u = rng.normal(size=(n - n_out, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    outliers = rng.uniform(-1.5, 1.5, size=(n_out, 3))
    pts = np.concatenate([u, outliers]).astype(np.float32)
    gt = np.concatenate([np.zeros(n - n_out), np.full(n_out, gt_outlier)])
    normals = pts / np.maximum(np.linalg.norm(pts, axis=1, keepdims=True),
                               1e-9)
    intensity = rng.random(n).astype(np.float32) * 255
    order = rng.permutation(n)
    return pts[order], gt[order], normals[order], intensity[order]


def write_edf(root, rng, n=300):
    for i in range(14):
        pts, gt, normals, intensity = make_scan(rng, n, n // 10)
        write_ply(os.path.join(root, f"pointcloud_{i:02d}.ply"),
                  [pts, gt, normals, intensity],
                  ["vertex", "GT", "normal", "intensity"])


def write_pcn(root, rng, n=300):
    names = {"outliers_TRAIN_W_NOR": {"trainingset.txt": ["a", "b", "c"],
                                      "validationset.txt": ["d"]},
             "outliers_TEST_W_NOR": {"testset.txt": ["e", "f"]}}
    for sub, lists in names.items():
        os.makedirs(os.path.join(root, sub))
        for fname, clouds in lists.items():
            with open(os.path.join(root, sub, fname), "w") as f:
                f.write("\n".join(clouds) + "\n")
            for c in clouds:
                pts, gt, normals, intensity = make_scan(rng, n, n // 10, 1.0)
                write_ply(os.path.join(root, sub, c + ".ply"),
                          [pts, gt, normals, intensity],
                          ["vertex", "GT", "normal", "intensity"])


# -- features and splits ------------------------------------------------------

@pytest.mark.parametrize("ktype,params", [("std", [2.0, 2.5, 3.0]),
                                          ("std", [0.5]), ("exp", [0.3])])
def test_katz_matches_jax(ktype, params):
    rng = np.random.default_rng(1)
    pts, *_ = make_scan(rng, 400, 40)
    pts[0] *= 2.0  # behind the shell
    for p in params:
        np.testing.assert_array_equal(
            tod.hpr_visible_indices(pts, p, ktype),
            jod.hpr_visible_indices(pts, p, ktype))
    got = tod.compute_katz(pts, params, ktype)
    assert got.dtype == np.float32 and 0 < got.mean() < 1
    np.testing.assert_array_equal(got, jod.compute_katz(pts, params, ktype))


def test_pad_features_and_kfold_match_jax():
    rng = np.random.default_rng(2)
    for dim in range(1, 8):
        f = rng.normal(size=(5, dim)).astype(np.float32)
        np.testing.assert_array_equal(tod.pad_features_to_3(f),
                                      jod.pad_features_to_3(f))
    for n in (13, 14, 5):
        for k in (2, 3, 4, 5):
            assert tod._kfold_splits(list(range(n)), k) == \
                jod._kfold_splits(list(range(n)), k)


# -- the dataset --------------------------------------------------------------

CASES = {
    # dataset_type, features, katz params, pre-subsampling voxel
    "EDFS_katz": ("EDFS", ["katz_std"], [2.0, 2.5, 3.0], 0.0),
    "EDFS_katz_voxel": ("EDFS", ["katz_std"], [2.0, 2.5, 3.0], 0.15),
    "EDFS3f1_intensity_normal_voxel": ("EDFS3f1", ["intensity", "normal"],
                                       [], 0.15),
    "PCN_katz_intensity": ("PCN", ["intensity", "katz_std"], [2.0], 0.0),
    "PCN_none_voxel": ("PCN", [], [], 0.15),
}
SPLIT_ARRAYS = ("clouds_points", "clouds_features", "clouds_labels",
                "sub_points", "sub_features", "sub_labels", "sub_density",
                "projections")


def _pair(root, split, case, **kw):
    dataset_type, features, katz, voxel = CASES[case]
    common = dict(dataset_type=dataset_type, input_features=features,
                  katz_params=katz, subsampling_parameter=voxel,
                  in_radius=0.5, num_points=64, num_steps=8, seed=3, **kw)
    jds = jod.OutlierSegmentationDataset(root, split, native_patches=False,
                                         **common)
    tds = tod.OutlierSegmentationDataset(root, split, **common)
    return tds, jds


def _assert_same(tds, jds, indices, epochs=(0,)):
    assert tds.cloud_names == jds.cloud_names
    assert tds.input_features_dim == jds.input_features_dim
    for key in SPLIT_ARRAYS:
        for a, b in zip(getattr(tds, key), getattr(jds, key)):
            np.testing.assert_array_equal(a, b, err_msg=key)
    for key in ("point_inds", "cloud_inds", "center_noise"):
        np.testing.assert_array_equal(getattr(tds, key), getattr(jds, key))
    assert len(tds) == len(jds)
    for epoch in epochs:
        for i in indices:
            got, want = tds.get(i, epoch), jds.get(i, epoch)
            assert set(got) == set(want)
            for key in got:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{key}, patch {i}")


@pytest.mark.parametrize("case", list(CASES))
def test_dataset_matches_jax(tmp_path, case):
    rng = np.random.default_rng(4)
    root = str(tmp_path)
    (write_pcn if CASES[case][0] == "PCN" else write_edf)(root, rng)
    cfg, jcfg = default_config(), jax_cfg()
    for c in (cfg, jcfg):
        c.jitter = 1
    # train: the train transforms, two epochs, half the centres outliers
    tds, jds = _pair(root, "train", case, num_epochs=2)
    tds.transforms, jds.transforms = (build_train_transforms(cfg),
                                      jax_transforms(jcfg))
    _assert_same(tds, jds, range(8), epochs=(0, 1))
    labels = [tds.sub_labels[c][p] for c, p in
              zip(tds.cloud_inds, tds.point_inds)]
    assert labels[0::2] == [1] * 8 and labels[1::2] == [0] * 8
    # val, then test (covering centres), in a second process's order
    _assert_same(*_pair(root, "val", case), range(8))
    tds, jds = _pair(root, "test", case)
    assert len(tds) > 8
    _assert_same(tds, jds, range(0, len(tds), max(1, len(tds) // 12)))
    # the caches: the port's npz under processed_torch reloads the same
    again = tod.OutlierSegmentationDataset(
        root, "test", dataset_type=CASES[case][0],
        input_features=CASES[case][1], katz_params=CASES[case][2],
        subsampling_parameter=CASES[case][3], in_radius=0.5, num_points=64,
        seed=3)
    assert os.path.isdir(os.path.join(root, "processed_torch"))
    for key in SPLIT_ARRAYS:
        for a, b in zip(getattr(again, key), getattr(tds, key)):
            np.testing.assert_array_equal(a, b)


def test_dataset_debug_split_names(tmp_path):
    write_edf(str(tmp_path), np.random.default_rng(5), n=60)
    for split, want in (("train", ["pointcloud_00", "pointcloud_01"]),
                        ("val", ["pointcloud_09", "pointcloud_10"]),
                        ("test", ["pointcloud_11", "pointcloud_12"])):
        ds = tod.OutlierSegmentationDataset(
            str(tmp_path), split, dataset_type="EDFS", debug=True,
            in_radius=0.5, num_points=16, num_steps=4)
        assert ds.cloud_names == want
    with pytest.raises(ValueError, match="Unknown dataset type"):
        tod.OutlierSegmentationDataset(str(tmp_path), "train",
                                       dataset_type="EDFX")


def test_collate_keeps_labels_and_indices(tmp_path):
    write_edf(str(tmp_path), np.random.default_rng(6), n=60)
    ds = tod.OutlierSegmentationDataset(
        str(tmp_path), "train", dataset_type="EDFS", debug=True,
        in_radius=0.5, num_points=16, num_steps=4)
    samples = [ds.get(i) for i in range(4)]
    batch = collate(samples)
    assert batch["labels"].dtype == np.int32
    assert batch["cloud_ind"].dtype == np.int64
    assert batch["input_inds"].dtype == np.int64
    for key in ("labels", "cloud_ind", "input_inds"):
        np.testing.assert_array_equal(batch[key],
                                      np.stack([s[key] for s in samples]))


# -- stand-in scans and the vote transforms -----------------------------------

def test_scans_are_the_sweep_scripts_at_diameter_10(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        from run_custom_sweep import make_scans as jax_make_scans
    finally:
        sys.path.pop(0)
    jax_make_scans(str(tmp_path / "jax"), n_scans=3, n=500, seed=7)
    make_scans(str(tmp_path / "torch"), n_scans=3, n=500, seed=7)
    for i in range(3):
        got = read_ply(str(tmp_path / "torch" / f"pointcloud_{i:02d}.ply"))
        want = read_ply(str(tmp_path / "jax" / f"pointcloud_{i:02d}.ply"))
        assert set(got) == set(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])
    # diameter 1: the same draws scaled by 0.1; a cut keeps the scan's
    # points past the corner, at the same density
    make_scans(str(tmp_path / "small"), n_scans=3, n=500, seed=7,
               diameter=1.0, write=(1, 2), cut=(2,),
               corner=(0.0, 0.0, 0.0))
    assert not os.path.exists(str(tmp_path / "small" / "pointcloud_00.ply"))
    full = read_ply(str(tmp_path / "jax" / "pointcloud_01.ply"))
    small = read_ply(str(tmp_path / "small" / "pointcloud_01.ply"))
    np.testing.assert_allclose(small["vertex"], full["vertex"] * 0.1,
                               rtol=1e-6)
    np.testing.assert_array_equal(small["GT"], full["GT"])
    cut = read_ply(str(tmp_path / "small" / "pointcloud_02.ply"))
    whole = read_ply(str(tmp_path / "jax" / "pointcloud_02.ply"))
    keep = (whole["vertex"] * np.float32(0.1) >= 0).all(axis=1)
    assert 0 < len(cut["vertex"]) == keep.sum() < 500
    np.testing.assert_array_equal(cut["GT"], whole["GT"][keep])


def test_batch_transforms_match_jax():
    rng = np.random.default_rng(8)
    pc = rng.normal(size=(3, 40, 6)).astype(np.float32)
    for tcls, jcls, kw in (
            (ttr.BatchPointcloudRandomRotate,
             jtr.BatchPointcloudRandomRotate, dict(x_range=0.0,
                                                   y_range=0.0)),
            (ttr.BatchPointcloudRandomRotate,
             jtr.BatchPointcloudRandomRotate, {}),
            (ttr.BatchPointcloudScaleAndJitter,
             jtr.BatchPointcloudScaleAndJitter,
             dict(augment_symmetries=(1, 0, 0)))):
        got = tcls(**kw)(pc, np.random.default_rng(9))
        want = jcls(**kw)(pc, np.random.default_rng(9))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- the voting evaluation ----------------------------------------------------

@pytest.mark.parametrize("num_votes", [1, 2])
def test_voting_evaluation_matches_jax(tmp_path, num_votes):
    """The test split's covering patches through one converted model in
    each package: the metric dict equal, the written probabilities within
    rtol 1e-5 (the second round rotates and jitters each batch from one
    seeded generator in both).  Intensity and normal features (six
    channels) make the seeded model predict both classes."""
    from test_torch_outlier_seg import _o1_stats, _seg_config
    os.makedirs(tmp_path / "scans")
    write_edf(str(tmp_path / "scans"), np.random.default_rng(4), n=200)
    common = dict(dataset_type="EDFS", in_radius=2.0, num_points=64,
                  seed=3, input_features=["intensity", "normal"])
    tds = tod.OutlierSegmentationDataset(str(tmp_path / "scans"), "test",
                                         **common)
    jds = jod.OutlierSegmentationDataset(str(tmp_path / "scans"), "test",
                                         native_patches=False, **common)
    assert 8 < len(tds) < 250
    cfg = _seg_config(default_config())
    cfg.in_radius, cfg.input_features_dim = 2.0, tds.input_features_dim
    tmodel = build_scene_segmentation(cfg, torch.Generator().manual_seed(5))
    variables = _o1_stats(flax_from_params(tmodel.state_dict()),
                          np.random.default_rng(6))
    tmodel.load_state_dict(params_from_flax(variables, tmodel))
    jcfg = _seg_config(jax_cfg())
    jcfg.use_pallas = 0
    jmodel = JaxSegModel(cfg=jcfg)
    jpredict = jax.jit(lambda p, m, f: jmodel.apply(variables, p, m, f,
                                                    train=False))
    want = jax_evaluate(jpredict, jds, batch_size=8, num_votes=num_votes,
                        write_dir=str(tmp_path / "jax"))
    got = evaluate_outlier_segmentation(
        make_predict_fn(tmodel), tds, batch_size=8, num_votes=num_votes,
        write_dir=str(tmp_path / "torch"))
    assert got == want
    assert 0 < got["TP"] + got["FP"] and 0 < got["TN"] + got["FN"]
    for name in tds.cloud_names:
        a = read_ply(str(tmp_path / "torch" / f"{name}_eval.ply"))
        b = read_ply(str(tmp_path / "jax" / f"{name}_eval.ply"))
        for key in ("vertex", "pred", "GT"):
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_allclose(a["proba"], b["proba"], rtol=1e-5,
                                   atol=1e-7)

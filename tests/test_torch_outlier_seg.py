"""Outlier segmentation in the port against the JAX package, on the CPU:
the masked cross-entropy, the scene-segmentation model through
convert.py, three ``loss_mode="segmentation"`` train steps, the metric
suite, and the two entry points (the data and the voting evaluation:
test_torch_outlier_data.py).

Tolerances: the loss and its gradient rtol 1e-5; the model's eval forward
rtol 5e-4 / atol 5e-5 (the whole-model tolerance, BatchNorm statistics at
O(1)); train-step losses rtol 1e-5 at the first step and 1e-3 after it
(test_torch_train.py says why); the metrics exactly.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.losses import masked as jax_masked
from deep3dpointclouddenoising_tpu.models.build import \
    SceneSegmentationModel as JaxSegModel
from deep3dpointclouddenoising_tpu.models.build import \
    build_scene_segmentation as jax_build_seg
from deep3dpointclouddenoising_tpu.parallel.mesh import make_mesh
from deep3dpointclouddenoising_tpu.train import Trainer as JaxTrainer
from deep3dpointclouddenoising_tpu.train.trainer import \
    TrainState as JaxTrainState
from deep3dpointclouddenoising_tpu.utils import metrics as jmet
from deep3dpointclouddenoising_torch import evaluate_outlier_seg, \
    train_outlier_seg
from deep3dpointclouddenoising_torch.config import default_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.data.loader import BatchLoader
from deep3dpointclouddenoising_torch.data.meshio import read_ply
from deep3dpointclouddenoising_torch.data.outlier_dataset import \
    OutlierSegmentationDataset
from deep3dpointclouddenoising_torch.data.scans import make_scans
from deep3dpointclouddenoising_torch.losses.masked import \
    masked_cross_entropy
from deep3dpointclouddenoising_torch.models import SceneSegmentationModel
from deep3dpointclouddenoising_torch.train.trainer import Trainer
from deep3dpointclouddenoising_torch.utils import metrics as tmet
from test_torch_model import small_config, small_inputs
from test_torch_outlier_data import write_edf
from test_torch_train import _configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDF_YAML = os.path.join(ROOT, "cfgs", "outlier_seg_edf.yaml")
KATZ = dict(input_features=["katz_std"], katz_params=[2.0, 2.5, 3.0])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- the loss -----------------------------------------------------------------

def test_masked_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 40, 2)) * 4).astype(np.float32)
    labels = rng.integers(0, 2, size=(3, 40)).astype(np.int32)
    mask = (rng.random((3, 40)) > 0.3).astype(np.float32)
    want, want_g = jax.value_and_grad(jax_masked.masked_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    x, y, m = _t(logits, labels, mask)
    x.requires_grad_(True)
    got = masked_cross_entropy(x, y, m)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-8)
    zero = masked_cross_entropy(x, y, torch.zeros_like(m))
    assert zero.item() == 0.0


# -- the model ----------------------------------------------------------------

def _seg_config(cfg):
    small_config(cfg)
    cfg.num_classes = 2
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


def test_seg_model_converts_and_matches_jax():
    """The Flax tree of the JAX model (``SceneSegHead_0/MultiDimHead_0``)
    converts with no new mapping; the eval forward agrees at the
    whole-model tolerance; the logit layer starts He-normal."""
    rng = np.random.default_rng(1)
    xyz, mask = small_inputs(rng)
    jcfg = _seg_config(jax_cfg())
    jcfg.use_pallas = 0
    jmodel = JaxSegModel(cfg=jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), xyz, mask, xyz, train=False))
    tmodel = SceneSegmentationModel(_seg_config(default_config()),
                                    torch.Generator().manual_seed(0)).eval()
    flat = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: tuple(v.shape), t)
    assert flat(flax_from_params(tmodel.state_dict())) == flat(
        {k: dict(v) for k, v in shapes.items()})
    dense = tmodel.SceneSegHead_0.MultiDimHead_0.Dense_0
    assert dense.out_features == 2 and 0.5 < dense.weight.std() * 2 < 2.0
    variables = _o1_stats(flax_from_params(tmodel.state_dict()), rng)
    tmodel.load_state_dict(params_from_flax(variables, tmodel))
    want = np.asarray(jax.jit(lambda v: jmodel.apply(
        v, xyz, mask, xyz, train=False))(variables))
    with torch.no_grad():
        out = tmodel(*_t(xyz, mask, xyz)).numpy()
    assert out.shape == (2, 64, 2) and np.abs(want).max() > 1.0
    np.testing.assert_allclose(out, want, rtol=5e-4, atol=5e-5)


# -- three train steps --------------------------------------------------------

def test_three_segmentation_steps_losses_match_jax(tmp_path):
    """Three train steps of each package from one converted init on the
    same batches of Katz-feature patches (half of them outlier-centred)."""
    write_edf(str(tmp_path), np.random.default_rng(2))
    ds = OutlierSegmentationDataset(
        str(tmp_path), "train", dataset_type="EDFS", in_radius=0.5,
        num_points=64, num_steps=24, seed=3, **KATZ)
    keys = ("points", "mask", "features", "labels")
    batches = [{k: b[k] for k in keys}
               for b in BatchLoader(ds, 8, drop_last=True).epoch_iter(0)]
    assert len(batches) == 3 and all(b["labels"].any() for b in batches)
    assert all((b["mask"] == 0).any() for b in batches)
    jc, tc = _configs(num_classes=2, loss="CE")
    tt = Trainer(tc, 10, torch.Generator().manual_seed(0), "cpu",
                 loss_mode="segmentation")
    assert isinstance(tt.model, SceneSegmentationModel)
    jmodel, jloss = jax_build_seg(jc)
    jt = JaxTrainer(jc, jmodel, jloss, n_iter_per_epoch=10,
                    mesh=make_mesh(1), loss_mode="segmentation")
    init = flax_from_params(tt.model.state_dict())
    state = jt.put_replicated(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=init["params"],
        batch_stats=init["batch_stats"],
        opt_state=jt.tx.init(init["params"])))
    key = jax.random.PRNGKey(0)
    want = []
    for i, b in enumerate(batches):
        state, loss = jt.train_step(state, b, jax.random.fold_in(key, i))
        want.append(float(loss))
    got = [tt.train_step(b).item() for b in batches]
    assert tt.step == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(tt.eval_step(batches[0]).item(),
                               float(jt.eval_step(state, batches[0])),
                               rtol=1e-3)


# -- metrics ------------------------------------------------------------------

@pytest.mark.parametrize("conf", [
    [[50, 7], [3, 11]], [[10, 0], [0, 0]], [[0, 0], [0, 10]],
    [[0, 5], [0, 0]], [[0, 0], [5, 0]], [[4, 0], [6, 0]], [[0, 0], [0, 0]],
    [[0, 3], [0, 4]], "random"])
def test_metrics_match_jax(conf):
    if conf == "random":
        rng = np.random.default_rng(3)
        t, p = rng.integers(0, 2, 500), rng.integers(0, 2, 500)
        got = tmet.confusion_matrix(t, p, 2)
        np.testing.assert_array_equal(got, jmet.confusion_matrix(t, p, 2))
        conf = got
        t, p = rng.integers(0, 5, 300), rng.integers(0, 5, 300)
        c5 = tmet.confusion_matrix(t, p, 5)
        c5[3] = 0
        c5[:, 3] = 0
        for missing in (False, True):
            assert tmet.mean_iou(c5, missing) == jmet.mean_iou(c5, missing)
        for a, b in zip(tmet.iou_per_class(c5), jmet.iou_per_class(c5)):
            np.testing.assert_array_equal(a, b)
    conf = np.asarray(conf, np.int64)
    got, want = tmet.metrics_from_confusion(conf), \
        jmet.metrics_from_confusion(conf)
    assert got == want
    assert tmet.format_metric_table(got, "test") == \
        jmet.format_metric_table(want, "test")


# -- the entry points ---------------------------------------------------------

def test_seg_entry_points_on_cpu(tmp_path, capsys):
    """train_outlier_seg then evaluate_outlier_seg at width 8 on stand-in
    scans at the config's scale (diameter 1), --DEBUG 1: two scans per
    split, the held-out ones cut to a section of the shell and box."""
    scans = str(tmp_path / "scans")
    make_scans(scans, n=400, diameter=1.0, cut=(11, 12),
               corner=(0.0, 0.0, 0.0))
    log = str(tmp_path / "log")
    tiny = ["--config_file", EDF_YAML, "--data_root", scans, "--width", "8",
            "--num_points", "64", "--batch_size", "8", "--DEBUG", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_outlier_seg.main(tiny + ["--log_dir", log])
    summary = train_outlier_seg.main(tiny + [
        "--log_dir", log, "--num_steps", "16", "--epochs", "1",
        "--val_freq", "1", "--device", "cpu"])
    assert summary["steps"] == 2 and summary["val_batches"] == 2
    assert np.isfinite(summary["train_losses"] + summary["val_losses"]).all()
    trainer = summary["trainer"]
    assert isinstance(trainer.model, SceneSegmentationModel)
    ckpt = os.path.join(log, "outlier_seg_edfs", "current.pt")
    assert summary["checkpoint"] == os.path.join(
        log, "outlier_seg_edfs", "ckpt_epoch_1.pt") and os.path.exists(ckpt)
    out = evaluate_outlier_seg.main(tiny + [
        "--load_path", ckpt, "--write_dir", str(tmp_path / "eval"),
        "--device", "cpu"])
    text = capsys.readouterr().out
    assert "val [1] loss" in text and "macc" in text and "f_b" in text
    ds = out["dataset"]
    assert ds.cloud_names == ["pointcloud_11", "pointcloud_12"]
    assert out["batches"] == -(-len(ds) // 8)
    assert set(out["metrics"]) >= {"miou", "prec", "rec", "TP", "TN"}
    assert sum(out["metrics"][k] for k in ("TN", "FP", "FN", "TP")) == sum(
        len(p) for p in ds.clouds_points)
    for name in ds.cloud_names:
        ply = read_ply(str(tmp_path / "eval" / f"{name}_eval.ply"))
        assert ((ply["proba"] >= 0) & (ply["proba"] <= 1)).all()

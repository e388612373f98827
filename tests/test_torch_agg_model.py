"""Whole models over the other aggregations and the attention operators,
the port against the JAX package, on the CPU.

* Whole models through convert.py (PosPool sin_cos, adaptive weight,
  PointWiseMLP dp_fi_df, CAA, CBAM, offset attention and the point
  transformer): the configs' aggregation settings at the
  small geometry of tests/test_pallas_kpconv.py at depth 1 and width 24
  (PosPool needs channel counts that 3 and 6 divide, at every level), the
  tree the same as Flax's, the eval forward at the whole-model tolerance
  rtol 5e-4 / atol 5e-5, with BatchNorm statistics and scales, biases,
  the attention gates and the head's final Dense at O(1) values.
* Three train steps of ``cfgs/POTR.yaml`` and
  ``cfgs/pospool_sincos_avg.yaml`` against the JAX Trainer from one
  converted init, at that geometry with batch 8 and
  tests/test_torch_train.py's learning rate 1e-3: the losses at rtol 1e-5
  at the first step and 1e-3 after it, and every parameter's change within
  2 * lr * k of JAX's (test_torch_train.py says why).
* Three segmentation steps of ``cfgs/outlier_seg_edf_katz.yaml``
  (intensity and Katz features, adaptive weight) at that geometry, on
  stand-in EDF scans: the losses as above.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu.config import load_config as jax_load
from deep3dpointclouddenoising_tpu.models import build_offset_regression \
    as jax_build
from deep3dpointclouddenoising_tpu.models.build import \
    OffsetRegressionModel as JaxModel
from deep3dpointclouddenoising_tpu.models.build import \
    build_scene_segmentation as jax_build_seg
from deep3dpointclouddenoising_tpu.parallel.mesh import make_mesh
from deep3dpointclouddenoising_tpu.train import Trainer as JaxTrainer
from deep3dpointclouddenoising_tpu.train.trainer import \
    TrainState as JaxTrainState
from deep3dpointclouddenoising_torch import train_outlier_seg
from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.data.loader import BatchLoader
from deep3dpointclouddenoising_torch.data.outlier_dataset import \
    OutlierSegmentationDataset
from deep3dpointclouddenoising_torch.models import OffsetRegressionModel
from deep3dpointclouddenoising_torch.train.trainer import Trainer
from test_torch_aggregation import perturb, shape_tree
from test_torch_model import small_inputs
from test_torch_outlier_data import write_edf
from test_torch_train import _batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_pallas_kpconv.py:80-96's geometry at width 24 and depth 1
# (five bottlenecks, one per level: each level's operator, at half the
# JAX compile time of depth 2)
SMALL = dict(num_points=64, width=24, depth=1, bottleneck_ratio=2,
             radius=0.2, sampleDl=0.05, nsamples=[8, 8, 8, 8, 8],
             npoints=[16, 8, 4, 2], in_radius=1.0, input_features_dim=3)
# tests/test_torch_train.py's optimiser scale, so that three steps stay
# comparable
STEPS = dict(batch_size=8, base_learning_rate=1e-3, epochs=10,
             warmup_epoch=-1)


def configs(name: str, **extra):
    """``cfgs/<name>.yaml`` in both packages, cut to SMALL."""
    path = os.path.join(ROOT, "cfgs", name + ".yaml")
    out = []
    for load in (jax_load, load_config):
        c = load(path)
        for k, v in {**SMALL, **extra}.items():
            c[k] = v
        out.append(c)
    return out


MODELS = ["pospool_sincos_avg", "adaptiveweight_dp_fc1_avg",
          "pointwisemlp_dp_fi_df_fc1", "CAA", "CBAM", "OFAT", "POTR"]


def check_whole_model(name: str):
    """``cfgs/<name>.yaml``'s model at SMALL through convert.py: the tree
    the same as Flax's and the eval forward at the whole-model tolerance,
    everything perturbed to O(1)."""
    jc, tc = configs(name)
    jc.use_pallas = 0
    rng = np.random.default_rng(4)
    xyz, mask = small_inputs(rng)
    jmodel = JaxModel(cfg=jc)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), xyz, mask, xyz, train=False))
    tmodel = OffsetRegressionModel(tc,
                                   torch.Generator().manual_seed(0)).eval()
    variables = perturb(flax_from_params(tmodel.state_dict()), rng)
    assert shape_tree(variables) == shape_tree(shapes)
    head = variables["params"]["MultiDimHead_0"]["Dense_0"]
    for k in ("kernel", "bias"):
        head[k] = rng.normal(size=np.shape(head[k])).astype(np.float32)
    tmodel.load_state_dict(params_from_flax(variables, tmodel))
    want = np.asarray(jax.jit(lambda v: jmodel.apply(
        v, xyz, mask, xyz, train=False))(variables))
    with torch.no_grad():
        got = tmodel(*[torch.from_numpy(a) for a in (xyz, mask, xyz)])
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("name", MODELS)
def test_whole_model_converts_and_matches_jax(name):
    check_whole_model(name)


def _jax_state(jt, init):
    return jt.put_replicated(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=init["params"],
        batch_stats=init["batch_stats"],
        opt_state=jt.tx.init(init["params"])))


@pytest.mark.parametrize("name", ["POTR", "pospool_sincos_avg"])
def test_three_train_steps_match_jax(name):
    jc, tc = configs(name, **STEPS)
    rng = np.random.default_rng(3)
    batches = [_batch(rng) for _ in range(3)]
    tt = Trainer(tc, 10, torch.Generator().manual_seed(0), "cpu")
    jmodel, jloss = jax_build(jc)
    jt = JaxTrainer(jc, jmodel, jloss, n_iter_per_epoch=10,
                    mesh=make_mesh(1))
    init = flax_from_params(tt.model.state_dict())
    state = _jax_state(jt, init)
    key = jax.random.PRNGKey(0)
    want = []
    for i, b in enumerate(batches):
        state, loss = jt.train_step(state, b, jax.random.fold_in(key, i))
        want.append(float(loss))
    start = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    got = [tt.train_step(b).item() for b in batches]
    assert tt.step == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    lr = float(tc.base_learning_rate)
    after = params_from_flax({"params": jax.tree_util.tree_map(
        np.asarray, jax.device_get(state.params))})
    moved_any = False
    for n, p in tt.model.named_parameters():
        moved = (p.detach() - start[n]).numpy()
        np.testing.assert_allclose(moved, (after[n] - start[n]).numpy(),
                                   rtol=0, atol=2 * lr * 3, err_msg=n)
        moved_any |= bool(np.abs(moved).max() > 0)
    assert moved_any


def test_three_segmentation_steps_match_jax(tmp_path):
    """``outlier_seg_edf_katz`` (intensity + katz_1 at std 3.3, adaptive
    weight) at width 24: three steps of each package from one converted
    init on the same batches of stand-in EDF patches."""
    jc, tc = configs("outlier_seg_edf_katz", num_classes=2, **STEPS)
    write_edf(str(tmp_path), np.random.default_rng(2))
    kwargs = train_outlier_seg.dataset_kwargs(tc, "EDFS")
    kwargs.update(in_radius=0.5, num_points=64)
    ds = OutlierSegmentationDataset(str(tmp_path), "train", num_steps=24,
                                    **kwargs)
    assert ds.input_features_dim == 3   # ones, intensity, katz_1
    for c in (jc, tc):
        c.input_features_dim = ds.input_features_dim
    keys = ("points", "mask", "features", "labels")
    batches = [{k: b[k] for k in keys}
               for b in BatchLoader(ds, 8, drop_last=True).epoch_iter(0)]
    assert len(batches) == 3 and all(b["labels"].any() for b in batches)
    tt = Trainer(tc, 10, torch.Generator().manual_seed(0), "cpu",
                 loss_mode="segmentation")
    jmodel, jloss = jax_build_seg(jc)
    jt = JaxTrainer(jc, jmodel, jloss, n_iter_per_epoch=10,
                    mesh=make_mesh(1), loss_mode="segmentation")
    state = _jax_state(jt, flax_from_params(tt.model.state_dict()))
    key = jax.random.PRNGKey(0)
    want = []
    for i, b in enumerate(batches):
        state, loss = jt.train_step(state, b, jax.random.fold_in(key, i))
        want.append(float(loss))
    got = [tt.train_step(b).item() for b in batches]
    assert tt.step == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)

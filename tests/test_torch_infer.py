"""The port's test-split data and voting inference against the JAX
package's: the same seed gives the same clouds and patches (exactly), and
denoise_clouds agrees at the small model config with converted weights
(rtol 5e-4 / atol 5e-5)."""
import os

import numpy as np
import jax
import pytest
import torch

from deep3dpointclouddenoising_tpu import infer as jax_infer
from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.data.offset_dataset import \
    OffsetDataset as JaxDataset
from deep3dpointclouddenoising_tpu.data.synthetic import \
    make_icosphere as jax_icosphere
from deep3dpointclouddenoising_tpu.data.synthetic import \
    make_torus as jax_torus
from deep3dpointclouddenoising_tpu.models.build import \
    OffsetRegressionModel as JaxModel
from deep3dpointclouddenoising_torch import infer
from deep3dpointclouddenoising_torch.config import default_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.data.loader import BatchLoader
from deep3dpointclouddenoising_torch.data.meshio import save_off
from deep3dpointclouddenoising_torch.data.offset_dataset import OffsetDataset
from deep3dpointclouddenoising_torch.data.synthetic import (make_icosphere,
                                                            make_torus)
from deep3dpointclouddenoising_torch.models import OffsetRegressionModel
from deep3dpointclouddenoising_torch.utils.device import resolve_device
from test_torch_model import L1_YAML, perturb, small_config

DATA = dict(in_radius=0.4, noise_type="gaussian", noise_level=5e-3,
            num_points_per_shape=2000, outlier_proportion=0.05, seed=3,
            sample_dl_patches=0.3)


def _shapes(icosphere, torus):
    return {"qualitative_test/sphere": icosphere(2),
            "qualitative_test/torus": torus()}


def _datasets(tmp_path, num_points):
    jds = JaxDataset(str(tmp_path / "jax"), "qualitative_test",
                     num_points=num_points, native_patches=False,
                     shapes=_shapes(jax_icosphere, jax_torus), **DATA)
    tds = OffsetDataset(str(tmp_path / "torch"), "qualitative_test",
                        num_points=num_points,
                        shapes=_shapes(make_icosphere, make_torus), **DATA)
    return jds, tds


def test_meshes_match_jax():
    for got, want in ((make_icosphere(2), jax_icosphere(2)),
                      (make_torus(), jax_torus())):
        np.testing.assert_array_equal(got.vertices, want.vertices)
        np.testing.assert_array_equal(got.faces, want.faces)


@pytest.mark.parametrize("num_points", [64, 1024])  # truncate / pad
def test_test_split_patches_match_jax(tmp_path, num_points):
    jds, tds = _datasets(tmp_path, num_points)
    assert tds.cloud_names == jds.cloud_names
    for a, b in zip(tds.shapes, jds.shapes):
        for key in ("points", "labels", "offsets"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    np.testing.assert_array_equal(tds.point_inds, jds.point_inds)
    np.testing.assert_array_equal(tds.cloud_inds, jds.cloud_inds)
    assert len(tds) == len(jds) > 8
    for i in range(len(tds)):
        got, want = tds.get(i), jds.get(i)
        assert set(got) == set(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the .npz cache gives back the same clouds
    again = OffsetDataset(str(tmp_path / "torch"), "qualitative_test",
                          num_points=num_points,
                          shapes=_shapes(make_icosphere, make_torus), **DATA)
    for a, b in zip(again.shapes, tds.shapes):
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.mesh.faces, b.mesh.faces)
    assert os.listdir(tmp_path / "torch" / "processed_torch")


def test_batch_loader_order_and_ragged_tail(tmp_path):
    _, tds = _datasets(tmp_path, 64)
    batches = list(BatchLoader(tds, 5))
    assert len(batches) == -(-len(tds) // 5)
    inds = np.concatenate([b["input_inds"] for b in batches])
    want = np.stack([tds.get(i)["input_inds"] for i in range(len(tds))])
    np.testing.assert_array_equal(inds, want)


@pytest.fixture(scope="module")
def predictors():
    rng = np.random.default_rng(0)
    jcfg = small_config(jax_cfg())
    jcfg.use_pallas = 0
    torch.manual_seed(0)
    tmodel = OffsetRegressionModel(small_config(default_config())).eval()
    variables = perturb(flax_from_params(tmodel.state_dict()), rng)
    tmodel.load_state_dict(params_from_flax(variables, tmodel))
    jpredict = jax_infer.make_predict_fn(JaxModel(cfg=jcfg), variables)
    return jpredict, infer.make_predict_fn(tmodel)


@pytest.mark.parametrize("num_votes", [1, 2])
def test_denoise_clouds_matches_jax(tmp_path, predictors, num_votes):
    jds, tds = _datasets(tmp_path, 64)
    jpredict, tpredict = predictors
    want = jax_infer.denoise_clouds(jpredict, jds, batch_size=16,
                                    num_votes=num_votes)
    got = infer.denoise_clouds(tpredict, tds, batch_size=16,
                               num_votes=num_votes)
    for g, w in zip(got, want):
        assert np.abs(w["offsets"]).max() > 1.0  # O(1) perturbed head
        np.testing.assert_allclose(g["offsets"], w["offsets"], rtol=5e-4,
                                   atol=5e-5)
        np.testing.assert_allclose(g["denoised"], w["denoised"], rtol=5e-4,
                                   atol=5e-5)
        np.testing.assert_array_equal(g["noisy"], w["noisy"])


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.run(L1_YAML, "unused", "unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.main(["--config_file", L1_YAML, "--data_root", "x"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_writes_ply_trees_on_cpu(tmp_path, capsys):
    root = tmp_path / "data"
    (root / "qualitative_test").mkdir(parents=True)
    save_off(str(root / "qualitative_test" / "sphere.off"), make_icosphere(2))
    with open(L1_YAML) as f:
        text = f.read().replace("width: 144", "width: 8")
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(text + "num_points_per_shape: 1500\n"
                        "sample_Dl_patches: 0.4\nbatch_size: 4\n")
    out = tmp_path / "out"
    infer.main(["--config_file", str(cfg_path), "--data_root", str(root),
                "--out_dir", str(out), "--device", "cpu", "--seed", "1"])
    log = capsys.readouterr().out
    assert "initialised from --seed 1" in log
    for sub in ("noisy", "denoised", "clean"):
        assert os.listdir(out / sub) == ["sphere.ply"]
    # a checkpoint gives the same result as the seed it was saved from
    torch.manual_seed(1)
    from deep3dpointclouddenoising_torch.config import load_config
    model = OffsetRegressionModel(load_config(str(cfg_path)))
    torch.save(model.state_dict(), tmp_path / "ckpt.pt")
    infer.main(["--config_file", str(cfg_path), "--data_root", str(root),
                "--out_dir", str(tmp_path / "out2"), "--device", "cpu",
                "--checkpoint", str(tmp_path / "ckpt.pt")])
    assert (out / "denoised" / "sphere.ply").read_bytes() == \
        (tmp_path / "out2" / "denoised" / "sphere.ply").read_bytes()

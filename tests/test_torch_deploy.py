"""The deployed protocol in the port against the JAX package: the synthetic
shape tree, ``diverse_levels`` datasets and training, routed inference and
device voting.

Tolerances: the shape tree's files are byte-identical; the datasets,
their patch tables and the routed oracle predictions are exact; device
voting on the CPU equals the port's host voting exactly (the same patches,
the same float64 sums in the same order) and the JAX host voting to rtol
1e-5 / atol 1e-6 (the JAX package rotates vote rounds in float32, the port
in float64); device voting through a small model equals the JAX package's
device voting to rtol 5e-4 / atol 5e-5, the whole-model tolerance.
"""
import importlib.util
import os
import re
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu import infer as jax_infer
from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.data.offset_dataset import \
    OffsetDataset as JaxDataset
from deep3dpointclouddenoising_tpu.data.synthetic import (
    make_icosphere as jax_icosphere, make_torus as jax_torus)
from deep3dpointclouddenoising_tpu.evaluate import \
    estimate_noise_sigma as jax_sigma
from deep3dpointclouddenoising_tpu.models.build import \
    OffsetRegressionModel as JaxModel
from deep3dpointclouddenoising_tpu.utils import native as jax_native
from deep3dpointclouddenoising_torch import infer, make_synthetic_dataset
from deep3dpointclouddenoising_torch.config import default_config, \
    load_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.data.meshio import read_ply, save_off
from deep3dpointclouddenoising_torch.data.offset_dataset import OffsetDataset
from deep3dpointclouddenoising_torch.data.synthetic import (make_icosphere,
                                                            make_torus)
from deep3dpointclouddenoising_torch.models import OffsetRegressionModel
from deep3dpointclouddenoising_torch.train import __main__ as train_cli
from test_torch_model import perturb, small_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = os.path.join(ROOT, "cfgs")
LEVELS = [0.05, 0.1, 0.25]
DATA = dict(in_radius=0.4, noise_type="gaussian", noise_level=5e-3,
            num_points_per_shape=2000, seed=3, sample_dl_patches=0.3)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the synthetic shape tree -------------------------------------------------

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    argv = sys.argv
    sys.argv = ["make_synthetic_dataset.py", "--out", str(root / "jax")]
    try:
        _script("make_synthetic_dataset").main()
    finally:
        sys.argv = argv
    written = make_synthetic_dataset.main(["--out", str(root / "port")])
    return root, written


@pytest.mark.parametrize("split,count", [("train", 8), ("val", 3),
                                         ("test", 4),
                                         ("qualitative_test", 4)])
def test_synthetic_tree_matches_jax_script(trees, split, count):
    root, written = trees
    names = sorted(os.listdir(root / "jax" / split))
    assert sorted(os.listdir(root / "port" / split)) == names
    assert len(names) == count
    assert sum(os.path.dirname(w).endswith(os.sep + split)
               for w in written) == count
    for name in names:
        assert (root / "port" / split / name).read_bytes() == \
            (root / "jax" / split / name).read_bytes(), name


# -- diverse_levels -----------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "qualitative_test"])
@pytest.mark.parametrize("noise_type", ["diverse", "diverse_stable"])
def test_diverse_levels_dataset_matches_jax(tmp_path, monkeypatch,
                                            noise_type, split):
    # the JAX package's scipy path, which the port copies: its native
    # 1-NN ranks distances in float32 and, at a near-tie of two points,
    # may pick another test-split centre than the float64 KD-tree (one of
    # 261 centres of the 0.05% cloud here)
    monkeypatch.setattr(jax_native, "_load_lib", lambda: None)
    kw = dict(DATA, noise_type=noise_type, num_steps=10,
              diverse_levels=LEVELS)
    shapes = lambda ico, tor: {f"{split}/sphere": ico(2),  # noqa: E731
                               f"{split}/torus": tor()}
    jds = JaxDataset(str(tmp_path / "jax"), split, native_patches=False,
                     shapes=shapes(jax_icosphere, jax_torus), **kw)
    tds = OffsetDataset(str(tmp_path / "torch"), split,
                        shapes=shapes(make_icosphere, make_torus), **kw)
    n_levels = len(LEVELS) if noise_type == "diverse_stable" else 1
    assert len(tds.shapes) == len(jds.shapes) == 2 * n_levels
    for a, b in zip(tds.shapes, jds.shapes):
        for key in ("points", "labels", "offsets"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    if noise_type == "diverse":
        # labels: offsets beyond the largest of the levels, not of 2.5%
        norms = np.linalg.norm(tds.shapes[0].offsets, axis=1)
        np.testing.assert_array_equal(tds.shapes[0].labels,
                                      norms > max(LEVELS) / 100.0)
        assert tds.shapes[0].labels.any()
    np.testing.assert_array_equal(tds.point_inds, jds.point_inds)
    np.testing.assert_array_equal(tds.cloud_inds, jds.cloud_inds)
    for i in range(len(tds)):
        got, want = tds.get(i), jds.get(i)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the cache tags name the levels of a custom mix, as the JAX package's
    stems = lambda d, ext: sorted(  # noqa: E731
        f[:-len(ext)] for f in os.listdir(d) if f.endswith(ext))
    assert stems(tmp_path / "torch" / "processed_torch", ".npz") == \
        stems(tmp_path / "jax" / "processed", ".pkl")
    if noise_type == "diverse":
        assert all("_lv0.05-0.1-0.25" in f for f in os.listdir(
            tmp_path / "torch" / "processed_torch"))


def test_train_cli_trains_the_stable_low_config_on_cpu(tmp_path, capsys):
    root = tmp_path / "shapes"
    make_synthetic_dataset.write_tree(str(root), verbose=False)
    summary = train_cli.main([
        "--config_file", os.path.join(CFGS, "synthetic_quality_stable_low"
                                      ".yaml"),
        "--data_root", str(root), "--log_dir", str(tmp_path / "log"),
        "--width", "8", "--num_points", "64", "--num_points_per_shape",
        "1200", "--num_steps", "8", "--epochs", "1", "--batch_size", "4",
        "--val_freq", "1", "--device", "cpu"])
    assert summary["steps"] == 2 and summary["val_batches"] == 2
    assert np.isfinite(summary["train_losses"]
                       + summary["val_losses"]).all()
    assert os.path.exists(tmp_path / "log" / "synthetic_quality_stable_low"
                          / "current.pt")
    cached = os.listdir(root / "processed_torch")
    # 8 train and 3 val shapes, one cloud per level of diverse_levels
    assert len(cached) == 3 * 11
    for lvl in LEVELS:
        assert sum(f"_gaussian_{lvl / 100:.2e}_001200_" in f
                   for f in cached) == 11
    assert "train patches 8 (2 steps per epoch)" in capsys.readouterr().out


# -- routing ------------------------------------------------------------------

def test_routed_predict_matches_jax_and_skips_unrouted_models():
    rng = np.random.default_rng(0)
    calls = []

    def port(scale, shift, tag):
        def predict(batch):
            calls.append(tag)
            return torch.from_numpy(batch["points"] * scale + shift)
        return predict

    def jax_fn(scale, shift):
        return lambda batch: jnp.asarray(batch["points"]) * scale + shift

    route_low = np.array([True, False, True])
    got_fn = infer.make_routed_predict_fn(port(2.0, 0.1, "hi"),
                                          port(-1.0, 0.5, "lo"), route_low)
    want_fn = jax_infer.make_routed_predict_fn(
        jax_fn(2.0, 0.1), jax_fn(-1.0, 0.5), route_low)
    for cloud_ind, ran in (([0, 2, 2, 0], ["lo"]), ([1, 1, 1, 1], ["hi"]),
                           ([0, 1, 2, 1], ["hi", "lo"])):
        batch = {"points": rng.normal(size=(4, 16, 3)).astype(np.float32),
                 "cloud_ind": np.asarray(cloud_ind, np.int64)}
        calls.clear()
        got = got_fn(batch).numpy()
        assert calls == ran
        np.testing.assert_array_equal(got, np.asarray(want_fn(batch)))


@pytest.mark.parametrize("sibling", ["exp_diverse_stable",
                                     "exp_diverse_stable_low",
                                     "exp_stable_low", None])
def test_auto_low_checkpoint_finds_each_sibling(tmp_path, sibling):
    main = tmp_path / "log" / "exp_diverse" / "current.pt"
    main.parent.mkdir(parents=True)
    main.write_bytes(b"")
    (tmp_path / "log" / "unrelated_stable").mkdir()
    (tmp_path / "log" / "unrelated_stable" / "current.pt").write_bytes(b"")
    if sibling is None:
        assert infer._auto_low_checkpoint(str(main)) is None
        return
    (tmp_path / "log" / sibling).mkdir()
    want = tmp_path / "log" / sibling / "current.pt"
    assert infer._auto_low_checkpoint(str(main)) is None  # no leaf yet
    want.write_bytes(b"")
    assert infer._auto_low_checkpoint(str(main)) == str(want)


def _tiny_cfg(tmp_path):
    with open(os.path.join(CFGS, "synthetic_quality_diverse.yaml")) as f:
        text = f.read().replace("width: 144", "width: 8")
    path = tmp_path / "tiny.yaml"
    path.write_text(text + "num_points_per_shape: 4000\n"
                    "sample_Dl_patches: 0.4\nbatch_size: 4\n")
    return str(path)


def _save_model(cfg_path, seed, path):
    torch.manual_seed(seed)
    torch.save(OffsetRegressionModel(load_config(cfg_path)).state_dict(),
               path)
    return str(path)


@pytest.mark.parametrize("noise_level,route_sigma,device_voting", [
    (0.001, 0.002, False), (0.005, 0.002, True), (0.003, "mid", True)])
def test_infer_cli_routes_clouds_as_the_jax_estimate_does(
        tmp_path, capsys, noise_level, route_sigma, device_voting):
    root = tmp_path / "data"
    (root / "qualitative_test").mkdir(parents=True)
    save_off(str(root / "qualitative_test" / "sphere.off"), make_icosphere(3))
    save_off(str(root / "qualitative_test" / "torus.off"), make_torus())
    cfg_path = _tiny_cfg(tmp_path)
    (tmp_path / "log" / "m_diverse").mkdir(parents=True)
    (tmp_path / "log" / "m_stable_low").mkdir()
    hi = _save_model(cfg_path, 1,
                     tmp_path / "log" / "m_diverse" / "current.pt")
    lo = _save_model(cfg_path, 2,
                     tmp_path / "log" / "m_stable_low" / "current.pt")
    cfg = load_config(cfg_path)
    cfg.noise_type, cfg.noise_level = "gaussian", noise_level
    sigmas = [jax_sigma(s.points)
              for s in infer.make_dataset(cfg, str(root)).shapes]
    if route_sigma == "mid":
        route_sigma = float(np.mean(sigmas))
    common = ["--config_file", cfg_path, "--data_root", str(root),
              "--noise_type", "gaussian", "--noise_level", str(noise_level),
              "--device", "cpu"]
    capsys.readouterr()
    summary = infer.main(common + [
        "--checkpoint", hi, "--route_sigma", str(route_sigma),
        "--out_dir", str(tmp_path / "routed")]
        + (["--device_voting"] if device_voting else []))
    log = capsys.readouterr().out
    assert f"auto-discovered low-noise checkpoint {lo}" in log
    want = [s < route_sigma for s in sigmas]
    assert summary["route_low"] == want
    routes = re.findall(r"route (\w+): est sigma (\S+) -> (LOW|HIGH)", log)
    assert [(n, r == "LOW") for n, _, r in routes] == \
        list(zip(["sphere", "torus"], want))
    assert [float(s) for _, s, _ in routes] == \
        [float(f"{s:.2e}") for s in sigmas]
    for ckpt, name in ((hi, "hi"), (lo, "lo")):
        infer.main(common + ["--checkpoint", ckpt, "--checkpoint_low",
                             "none", "--out_dir", str(tmp_path / name)])
    for cloud, low in zip(("sphere", "torus"), want):
        got = read_ply(str(tmp_path / "routed" / "denoised"
                           / f"{cloud}.ply"))["vertex"]
        one = read_ply(str(tmp_path / ("lo" if low else "hi") / "denoised"
                           / f"{cloud}.ply"))["vertex"]
        np.testing.assert_array_equal(got, one)
    if route_sigma != 0.002:
        assert want in ([True, False], [False, True])  # a mixed batch


# -- device voting ------------------------------------------------------------

def _datasets(tmp_path, fourier=False):
    shapes = lambda ico, tor: {  # noqa: E731
        "qualitative_test/sphere": ico(2), "qualitative_test/torus": tor()}
    jds = JaxDataset(str(tmp_path / "jax"), "qualitative_test",
                     num_points=64, native_patches=False,
                     fourier_features=fourier,
                     shapes=shapes(jax_icosphere, jax_torus), **DATA)
    tds = OffsetDataset(str(tmp_path / "torch"), "qualitative_test",
                        num_points=64, fourier_features=fourier,
                        shapes=shapes(make_icosphere, make_torus), **DATA)
    return jds, tds


def _oracle(batch):
    """A deterministic function of the patch, for numpy or torch."""
    p, f = batch["points"], batch["features"]
    return p * 0.5 + f[..., [1, 2, 0]] * 0.25 + 0.01 * batch["mask"][..., None]


@pytest.mark.parametrize("fourier", [False, True])
@pytest.mark.parametrize("num_votes", [1, 3])
def test_device_voting_matches_host_voting_with_an_oracle(tmp_path,
                                                          num_votes,
                                                          fourier):
    jds, tds = _datasets(tmp_path, fourier)
    got = infer.predict_offsets_voting_device(_oracle, tds, 16, num_votes,
                                              device="cpu")
    host = infer.predict_offsets_voting(_oracle, tds, 16, num_votes)
    want = jax_infer.predict_offsets_voting(_oracle, jds, 16,
                                            num_votes=num_votes)
    for g, h, w, s in zip(got, host, want, tds.shapes):
        assert g.shape == s.points.shape and g.dtype == np.float32
        if fourier:  # sin and cos of torch against numpy's
            np.testing.assert_allclose(g, h, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, h)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        assert np.abs(g).max() > 0.01


def test_device_voting_matches_jax_device_voting_small_model(tmp_path):
    rng = np.random.default_rng(0)
    jcfg = small_config(jax_cfg())
    jcfg.use_pallas = 0
    torch.manual_seed(0)
    tmodel = OffsetRegressionModel(small_config(default_config())).eval()
    variables = perturb(flax_from_params(tmodel.state_dict()), rng)
    tmodel.load_state_dict(params_from_flax(variables, tmodel))
    jds, tds = _datasets(tmp_path)
    want = jax_infer.denoise_clouds_device(JaxModel(cfg=jcfg), variables,
                                           jcfg, jds, batch_size=16)
    got = infer.denoise_clouds_device(infer.make_predict_fn(tmodel), tds,
                                      16, device="cpu")
    for g, w in zip(got, want):
        assert np.abs(w["offsets"]).max() > 1.0  # O(1) perturbed head
        np.testing.assert_allclose(g["offsets"], w["offsets"], rtol=5e-4,
                                   atol=5e-5)
        np.testing.assert_array_equal(g["noisy"], w["noisy"])


def test_device_voting_needs_a_card_unless_cpu_is_asked(tmp_path,
                                                        monkeypatch):
    _, tds = _datasets(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.predict_offsets_voting_device(_oracle, tds)

"""Full cleaning in the port against the JAX package, on the CPU: the
masked offset and outlier losses, the three cleaning losses, the
four-output model, three train steps per loss, host and device cleaning
by voting, the predictor's channel scaling, and the two entry points.

Tolerances: losses and their gradients rtol 1e-5 / atol 1e-7; the model's
eval forward through convert.py rtol 5e-4 / atol 5e-5 (the whole-model
tolerance, final Dense and BatchNorm statistics at O(1)); train-step
losses rtol 1e-5 at the first step and 1e-3 after it
(test_torch_train.py says why); cleaning by voting against the JAX
package's rtol 1e-5 / atol 1e-6 on offsets and outlier probabilities, and
``keep`` identical but within 1e-6 of the threshold; device voting on the
CPU equal to host voting exactly.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu import infer as jax_infer
from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.data.offset_dataset import \
    OffsetDataset as JaxDataset
from deep3dpointclouddenoising_tpu.data.synthetic import (
    make_icosphere as jax_icosphere, make_torus as jax_torus)
from deep3dpointclouddenoising_tpu.losses import build as jax_build
from deep3dpointclouddenoising_tpu.losses import masked as jax_masked
from deep3dpointclouddenoising_tpu.models.build import \
    CompleteDenoisingModel as JaxCleaningModel
from deep3dpointclouddenoising_tpu.models.build import \
    build_complete_denoising as jax_build_cleaning
from deep3dpointclouddenoising_tpu.models.build import \
    build_offset_regression as jax_build_offset
from deep3dpointclouddenoising_tpu.parallel.mesh import make_mesh
from deep3dpointclouddenoising_tpu.train import Trainer as JaxTrainer
from deep3dpointclouddenoising_tpu.train.trainer import \
    TrainState as JaxTrainState
from deep3dpointclouddenoising_torch import compute_cd, infer, \
    train_full_cleaning
from deep3dpointclouddenoising_torch.config import default_config, \
    load_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.data.loader import BatchLoader
from deep3dpointclouddenoising_torch.data.meshio import read_ply, save_off
from deep3dpointclouddenoising_torch.data.offset_dataset import OffsetDataset
from deep3dpointclouddenoising_torch.data.synthetic import (make_icosphere,
                                                            make_torus)
from deep3dpointclouddenoising_torch.losses import masked
from deep3dpointclouddenoising_torch.losses.build import \
    get_complete_denoising_loss
from deep3dpointclouddenoising_torch.models import (CompleteDenoisingModel,
                                                    build_complete_denoising)
from deep3dpointclouddenoising_torch.train.trainer import Trainer
from test_torch_model import perturb, small_config, small_inputs
from test_torch_train import _configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLEANING_YAML = os.path.join(ROOT, "cfgs", "synthetic_quality_cleaning.yaml")
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
CLEANING_LOSSES = ["L1_classification", "Weighted_L1_classification",
                   "double_weight"]


def _t(*arrays, grad=False):
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if grad:
        out[0].requires_grad_(True)
    return out


# -- losses --------------------------------------------------------------------

def _loss_inputs(rng, B=3, N=40):
    """Raw head outputs with logits beyond +-30, zero target offsets, and
    padding slots whose logits say outlier."""
    raw = rng.normal(size=(B, N, 4)).astype(np.float32)
    raw[..., 3] *= 4.0
    raw[0, :4, 3] = [-45.0, 31.5, 60.0, -30.5]
    offsets = (rng.normal(size=(B, N, 3)) * 0.3).astype(np.float32)
    offsets[1, :5] = 0.0
    labels = (rng.random((B, N)) < 0.4).astype(np.int32)
    mask = np.ones((B, N), np.float32)
    mask[-1, N - 12:] = 0.0
    raw[-1, N - 12:N - 6, 3] = 3.0     # padding predicted as outliers
    raw[-1, N - 6:, 3] = -3.0
    return raw, offsets, labels, mask


@pytest.mark.parametrize("name", CLEANING_LOSSES)
def test_cleaning_losses_and_gradients_match_jax(name):
    raw, offsets, labels, mask = _loss_inputs(np.random.default_rng(1))
    in_radius = 0.4
    jloss = jax_build.get_complete_denoising_loss(name, in_radius)
    want, want_g = jax.value_and_grad(
        lambda r: jloss(r, offsets, labels, mask))(jnp.asarray(raw))
    traw, toff, tlab, tmask = _t(raw, offsets, labels, mask, grad=True)
    got = get_complete_denoising_loss(name, in_radius)(traw, toff, tlab,
                                                       tmask)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    g = traw.grad.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, np.asarray(want_g), **LOSS_TOL)
    # logits beyond +-30 are clipped: no gradient reaches them
    assert (g[0, :4, 3] == 0).all()
    with pytest.raises(ValueError):
        get_complete_denoising_loss("no_such_loss", in_radius)


def test_weighted_l1_counts_padding_predicted_as_outlier():
    """A padding slot whose probability is at least 0.5 enters the L1 mean
    of Weighted_L1_classification, with no gradient through that mask."""
    raw, offsets, labels, mask = _loss_inputs(np.random.default_rng(2))
    weighted = get_complete_denoising_loss("Weighted_L1_classification", 1.0)
    plain = get_complete_denoising_loss("L1_classification", 1.0)
    traw, toff, tlab, tmask = _t(raw, offsets, labels, mask)
    assert weighted(traw, toff, tlab, tmask).item() != \
        plain(traw, toff, tlab, tmask).item()
    flipped = raw.copy()
    flipped[-1, -12:-6, 3] = -3.0    # no padding predicted as outlier now
    traw2, = _t(flipped)
    np.testing.assert_allclose(
        weighted(traw2, toff, tlab, tmask).item()
        - plain(traw2, toff, tlab, tmask).item(), 0.0, atol=1e-7)


@pytest.mark.parametrize("fn", ["offset", "bce", "outlier"])
def test_masked_losses_and_gradients_match_jax(fn):
    rng = np.random.default_rng(3)
    raw, offsets, labels, mask = _loss_inputs(rng)
    prob = 1.0 / (1.0 + np.exp(-raw[..., 3]))   # 0 and 1 at the extremes
    labels = labels.astype(np.float32)
    if fn == "offset":
        args, jf, tf = ((raw[..., :3], offsets, mask),
                        jax_masked.masked_offset_loss,
                        masked.masked_offset_loss)
    elif fn == "bce":
        args, jf, tf = ((prob, labels, mask),
                        jax_masked.masked_binary_cross_entropy,
                        masked.masked_binary_cross_entropy)
    else:
        args, jf, tf = ((prob, labels, offsets, mask),
                        jax_masked.masked_outlier_loss,
                        masked.masked_outlier_loss)
    want, want_g = jax.value_and_grad(lambda a: jf(a, *args[1:]))(
        jnp.asarray(args[0]))
    targs = _t(*args, grad=True)
    got = tf(*targs)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    assert np.isfinite(targs[0].grad.numpy()).all()
    np.testing.assert_allclose(targs[0].grad.numpy(), np.asarray(want_g),
                               **LOSS_TOL)


# -- the model -------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    xyz, mask = small_inputs(rng)
    jcfg = small_config(jax_cfg())
    jcfg.use_pallas = 0
    jmodel = JaxCleaningModel(cfg=jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), xyz, mask, xyz, train=False))
    tmodel = CompleteDenoisingModel(
        small_config(default_config()),
        torch.Generator().manual_seed(0)).eval()
    variables = perturb(flax_from_params(tmodel.state_dict()), rng)
    tmodel.load_state_dict(params_from_flax(variables, tmodel))
    return dict(xyz=xyz, mask=mask, jmodel=jmodel, shapes=shapes,
                tmodel=tmodel, variables=variables)


def test_cleaning_model_converts_and_matches_jax(models):
    """The Flax tree of the JAX model converts with no new mapping, and
    the eval forward agrees at the whole-model tolerance."""
    flat = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: tuple(v.shape), t)
    got = flat(flax_from_params(models["tmodel"].state_dict()))
    want = flat({k: dict(v) for k, v in models["shapes"].items()})
    assert got == want
    xyz, mask = models["xyz"], models["mask"]
    want = np.asarray(jax.jit(lambda v: models["jmodel"].apply(
        v, xyz, mask, xyz, train=False))(models["variables"]))
    with torch.no_grad():
        out = models["tmodel"](*_t(xyz, mask, xyz)).numpy()
    assert out.shape == (2, 64, 4) and np.abs(want).max() > 1.0
    np.testing.assert_allclose(out, want, rtol=5e-4, atol=5e-5)


def test_predict_fn_scales_offset_channels_only(models):
    """make_predict_fn(norm_factor=f) equals f * model(x / f) on channels
    0-2 and model(x / f) on the outlierness channel; without
    scale_outputs nothing is scaled."""
    model, f = models["tmodel"], 0.05
    pts = models["xyz"] * 0.1
    batch = {"points": pts, "mask": models["mask"], "features": pts}
    train_scale = dict(batch, points=pts / f, features=pts / f)
    plain = infer.make_predict_fn(model)(train_scale).numpy()
    got = infer.make_predict_fn(model, norm_factor=f)(batch).numpy()
    np.testing.assert_allclose(got[..., :3], f * plain[..., :3], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(got[..., 3], plain[..., 3])
    raw = infer.make_predict_fn(model, f, scale_outputs=False)(batch).numpy()
    np.testing.assert_array_equal(raw, plain)


# -- three train steps -----------------------------------------------------------

def train_batches(tmp_path, outliers, n=3):
    """``n`` batches of 8 train patches of 64 points from the port's
    dataset (held equal to the JAX one's by test_torch_train.py), the last
    patch's tail turned to padding."""
    ds = OffsetDataset(str(tmp_path / "ds"), "train", in_radius=0.4,
                       num_points=64, num_steps=8 * n, noise_type="gaussian",
                       noise_level=5e-3, num_points_per_shape=2000,
                       outlier_proportion=outliers, seed=3,
                       shapes={"train/sphere": make_icosphere(2),
                               "train/torus": make_torus()})
    keys = ("points", "mask", "features", "offsets", "labels")
    batches = [{k: b[k] for k in keys}
               for b in BatchLoader(ds, 8, drop_last=True).epoch_iter(0)]
    for b in batches:
        b["mask"][-1, 50:] = 0.0
        for k in ("points", "features", "offsets"):
            b[k][-1, 50:] = b[k][-1, :14]
        b["labels"][-1, 50:] = b["labels"][-1, :14]
    assert len(batches) == n
    return batches


def three_steps(batches, loss_mode, **extra):
    """Losses of three train steps of each package from one converted
    init on the same batches; returns (port's, JAX's)."""
    jc, tc = _configs(**extra)
    tt = Trainer(tc, 10, torch.Generator().manual_seed(0), "cpu",
                 loss_mode=loss_mode)
    build = jax_build_cleaning if loss_mode == "full_cleaning" \
        else jax_build_offset
    jmodel, jloss = build(jc)
    jt = JaxTrainer(jc, jmodel, jloss, n_iter_per_epoch=10,
                    mesh=make_mesh(1), loss_mode=loss_mode)
    init = flax_from_params(tt.model.state_dict())
    state = jt.put_replicated(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=init["params"],
        batch_stats=init["batch_stats"],
        opt_state=jt.tx.init(init["params"])))
    key = jax.random.PRNGKey(0)
    jlosses = []
    for i, b in enumerate(batches):
        state, loss = jt.train_step(state, b, jax.random.fold_in(key, i))
        jlosses.append(float(loss))
    tlosses = [tt.train_step(b).item() for b in batches]
    assert tt.step == len(batches)
    return tlosses, jlosses


@pytest.mark.parametrize("loss", CLEANING_LOSSES)
def test_three_cleaning_steps_losses_match_jax(tmp_path, loss):
    batches = train_batches(tmp_path, 0.4)
    assert all(b["labels"].any() for b in batches)
    got, want = three_steps(batches, "full_cleaning", loss=loss,
                            in_radius=0.4, depth=1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_trainer_builds_the_cleaning_model():
    _, tc = _configs(loss="double_weight")
    tt = Trainer(tc, 10, torch.Generator().manual_seed(0), "cpu",
                 loss_mode="full_cleaning")
    assert isinstance(tt.model, CompleteDenoisingModel)
    assert tt.model.MultiDimHead_0.Dense_0.out_features == 4
    with pytest.raises(ValueError):
        Trainer(tc, 10, device="cpu", loss_mode="gan")


# -- cleaning by voting ----------------------------------------------------------

DATA = dict(in_radius=0.4, noise_type="gaussian", noise_level=5e-3,
            num_points_per_shape=2000, outlier_proportion=0.4, seed=3,
            sample_dl_patches=0.3)


def _datasets(tmp_path):
    shapes = lambda ico, tor: {  # noqa: E731
        "qualitative_test/sphere": ico(2), "qualitative_test/torus": tor()}
    jds = JaxDataset(str(tmp_path / "jax"), "qualitative_test",
                     num_points=64, native_patches=False,
                     shapes=shapes(jax_icosphere, jax_torus), **DATA)
    tds = OffsetDataset(str(tmp_path / "torch"), "qualitative_test",
                        num_points=64,
                        shapes=shapes(make_icosphere, make_torus), **DATA)
    return jds, tds


def _tensors(batch, *keys):
    """The batch's arrays as tensors (host voting hands numpy arrays to
    the predictor, device voting tensors)."""
    return [torch.as_tensor(batch[k]) for k in keys]


def _oracle4(batch):
    """A deterministic four-channel function of the patch, computed in
    torch in float32 as the model's output would be (the outlierness
    logit spans both sides of 0)."""
    p, f, m = _tensors(batch, "points", "features", "mask")
    off = p * 2.0 + f[..., [1, 2, 0]] * 0.5
    logit = (p[..., 0] - p[..., 1]) * 20.0 + 0.1 * m
    return torch.cat([off, logit[..., None]], dim=-1)


def _np_oracle4(batch):
    return _oracle4(batch).numpy()


def _assert_cleaned_close(got, want, tol):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_allclose(g["offsets"], w["offsets"], **tol)
        np.testing.assert_allclose(g["outlier_prob"], w["outlier_prob"],
                                   **tol)
        edge = np.abs(w["outlier_prob"] - 0.5) < 1e-6
        np.testing.assert_array_equal(g["keep"][~edge], w["keep"][~edge])
        np.testing.assert_array_equal(g["noisy"], w["noisy"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        if not edge.any():
            np.testing.assert_allclose(g["denoised"], w["denoised"], **tol)


@pytest.mark.parametrize("norm_factor", [None, 0.004])
@pytest.mark.parametrize("num_votes", [1, 2])
def test_clean_clouds_matches_jax(tmp_path, num_votes, norm_factor):
    jds, tds = _datasets(tmp_path)
    want = jax_infer.clean_clouds(_np_oracle4, jds, batch_size=16,
                                  norm_factor=norm_factor,
                                  num_votes=num_votes)
    got = infer.clean_clouds(_oracle4, tds, 16, norm_factor=norm_factor,
                             num_votes=num_votes)
    _assert_cleaned_close(got, want, dict(rtol=1e-5, atol=1e-6))
    for g, s in zip(got, tds.shapes):
        assert g["offsets"].shape == s.points.shape
        assert 0 < g["keep"].sum() < len(g["keep"])   # both kinds
        assert g["denoised"].shape == (g["keep"].sum(), 3)
        assert np.abs(g["offsets"]).max() <= (norm_factor or 1.0)


@pytest.mark.parametrize("num_votes", [1, 2])
def test_clean_clouds_device_equals_host_on_cpu(tmp_path, num_votes):
    _, tds = _datasets(tmp_path)
    host = infer.clean_clouds(_oracle4, tds, 16, num_votes=num_votes,
                              norm_factor=0.004)
    dev = infer.clean_clouds_device(_oracle4, tds, 16, num_votes=num_votes,
                                    norm_factor=0.004, device="cpu")
    for g, w in zip(dev, host):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_multi_vote_cleaning_votes_physical_offsets(tmp_path):
    """tests/test_infer_eval.py:253 on both paths: with logits
    arctanh(0.1 * points) the physical offset turns with the patch, so 3
    votes equal 1 vote; voting the logits before tanh would not."""
    _, tds = _datasets(tmp_path)

    def pred(batch):
        pts, = _tensors(batch, "points")
        logits = torch.atanh(torch.clamp(0.1 * pts, -0.99, 0.99))
        return torch.cat([logits, torch.full_like(pts[..., :1], -2.0)], -1)

    for voting in (infer.predict_offsets_voting,
                   lambda *a, **k: infer.predict_offsets_voting_device(
                       *a, device="cpu", **k)):
        one, three = (voting(pred, tds, 16, votes, num_outputs=4,
                             tanh_offsets=True) for votes in (1, 3))
        for o, t in zip(one, three):
            np.testing.assert_allclose(t, o, rtol=1e-5, atol=1e-6)
            assert np.abs(o[:, :3]).max() <= 0.1 * 1.001
            assert np.abs(o[:, :3]).max() > 0.01
        raw_vote = infer.predict_offsets_voting(pred, tds, 16, 3,
                                                num_outputs=4)
        assert not np.allclose(np.tanh(raw_vote[0][:, :3]), one[0][:, :3],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("device_voting", [False, True])
def test_routed_cleaning_equals_each_checkpoint_per_cloud(tmp_path,
                                                          device_voting):
    """Routing per patch gives each cloud the cleaning of the predictor it
    routes to, as the JAX package's per-cloud selection does."""
    _, tds = _datasets(tmp_path)

    def other(batch):
        return _oracle4(batch) * -0.5

    clean = (infer.clean_clouds_device if device_voting
             else infer.clean_clouds)
    kw = {"device": "cpu"} if device_voting else {}
    routed = clean(infer.make_routed_predict_fn(_oracle4, other,
                                                [True, False]), tds, 16,
                   **kw)
    lo, hi = (clean(p, tds, 16, **kw) for p in (other, _oracle4))
    for key in ("offsets", "outlier_prob", "keep", "denoised"):
        np.testing.assert_array_equal(routed[0][key], lo[0][key])
        np.testing.assert_array_equal(routed[1][key], hi[1][key])


# -- the entry points ------------------------------------------------------------

def _tiny_cleaning_cfg(tmp_path):
    with open(CLEANING_YAML) as f:
        text = f.read().replace("width: 144", "width: 8")
    path = tmp_path / "tiny_cleaning.yaml"
    path.write_text(text + "num_points_per_shape: 3000\n"
                    "sample_Dl_patches: 0.4\nbatch_size: 4\n")
    return str(path)


def test_cleaning_clis_write_trees_compute_cd_reads(tmp_path, capsys):
    root = tmp_path / "data"
    for split in ("train", "val", "qualitative_test"):
        (root / split).mkdir(parents=True)
        save_off(str(root / split / "sphere.off"), make_icosphere(2))
    save_off(str(root / "train" / "torus.off"), make_torus())
    cfg_path = _tiny_cleaning_cfg(tmp_path)
    summary = train_full_cleaning.main([
        "--config_file", cfg_path, "--data_root", str(root),
        "--log_dir", str(tmp_path / "log"), "--num_steps", "12",
        "--num_points", "64", "--epochs", "1", "--val_freq", "1",
        "--device", "cpu"])
    assert summary["steps"] == 3
    assert isinstance(summary["trainer"].model, CompleteDenoisingModel)
    assert np.isfinite(summary["train_losses"] + summary["val_losses"]).all()
    ckpt = str(tmp_path / "log" / "synthetic_quality_cleaning" / "current.pt")
    assert os.path.exists(ckpt)
    outs = {}
    for voting in ("host", "device"):
        out = tmp_path / f"out_{voting}"
        outs[voting] = infer.main(
            ["--config_file", cfg_path, "--data_root", str(root),
             "--out_dir", str(out), "--checkpoint", ckpt,
             "--checkpoint_low", "none", "--full_cleaning",
             "--noise_type", "gaussian", "--noise_level", "0.005",
             "--device", "cpu"]
            + (["--device_voting"] if voting == "device" else []))
        log = capsys.readouterr().out
        assert "full cleaning removed" in log
        res = outs[voting]["results"][0]
        kept = read_ply(str(out / "denoised" / "sphere.ply"))["vertex"]
        np.testing.assert_array_equal(kept, res["denoised"])
        assert len(kept) == res["keep"].sum()
        noisy = read_ply(str(out / "noisy" / "sphere.ply"))
        np.testing.assert_array_equal(noisy["gt_outlier"],
                                      res["labels"].astype(np.float32))
        table = compute_cd.main(["--in_dir", str(out)])
        assert np.isfinite(table["sphere"]["ratio"])
    for key in ("offsets", "outlier_prob", "keep"):
        np.testing.assert_array_equal(outs["device"]["results"][0][key],
                                      outs["host"]["results"][0][key])
    # the checkpoint is the four-output model; the offset model refuses it
    cfg = load_config(cfg_path)
    model = infer.load_model(cfg, "cpu", ckpt, full_cleaning=True)
    assert model.MultiDimHead_0.Dense_0.out_features == 4
    with pytest.raises(RuntimeError):
        infer.load_model(cfg, "cpu", ckpt)
    assert isinstance(build_complete_denoising(cfg), CompleteDenoisingModel)

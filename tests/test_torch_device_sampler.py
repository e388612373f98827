"""The port's device sampler against the JAX package's, on the CPU:

* ``DeviceSampler.sample`` fed JAX's draws (recomputed here from the same
  keys and splits as JAX's ``_sample_one`` takes them) against JAX's
  ``DeviceSampler.sample``: without augmentation the indices, mask,
  labels, points and offsets exactly; with augmentation (rotation, and
  with ``jitter`` the scale, symmetry flips and jitter) points and offsets
  within rtol 1e-5 and an atol of 1e-6 of their max-abs (the rotation's
  3x3 products round in another order), with ``norm`` and with Fourier
  features (the port computes the projection in float64, as the host
  dataset does, JAX in float32: atol 2e-5 at projections up to ~40);
* the pad semantics of an underfilled patch (reals first, pads repeating
  reals with mask 0, every real within the radius, the centre in slot 0)
  and the real sets against the host dataset's patches; ``centers``
  equal to JAX's;
* two device-sampled train steps of test_torch_train.py's tiny model
  against JAX's ``build_sampled_train_chunk`` fed the same draws: the
  losses (rtol 1e-5 at the first step, 1e-3 at the second) and the
  parameters' change within 2 * lr * k (Adam, test_torch_train.py);
* the train entry point with ``device_sampler: 1``: two runs bitwise
  equal, and a run killed one step into epoch 2 and run again with
  ``--auto_resume`` bitwise equal to an unbroken one.

Test clouds are noisy spheres and tori: no two points lie at an exactly
equal distance from a centre, and none within float32 rounding of the
radius, so JAX's and the port's top-k pick the same points in the same
order.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.data.device_sampler import \
    DeviceSampler as JaxSampler
from deep3dpointclouddenoising_tpu.data.device_sampler import \
    build_sampled_train_chunk
from deep3dpointclouddenoising_tpu.data.offset_dataset import \
    OffsetDataset as JaxDataset
from deep3dpointclouddenoising_tpu.data.synthetic import \
    make_icosphere as jax_icosphere
from deep3dpointclouddenoising_tpu.data.synthetic import \
    make_torus as jax_torus
from deep3dpointclouddenoising_tpu.models import \
    build_offset_regression as jax_build
from deep3dpointclouddenoising_tpu.parallel.mesh import make_mesh
from deep3dpointclouddenoising_tpu.train import Trainer as JaxTrainer
from deep3dpointclouddenoising_tpu.train.trainer import \
    TrainState as JaxTrainState
from deep3dpointclouddenoising_torch.config import default_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.data.device_sampler import (
    DeviceSampler, SamplerDraws, torch_draws)
from deep3dpointclouddenoising_torch.data.offset_dataset import OffsetDataset
from deep3dpointclouddenoising_torch.data.synthetic import (make_icosphere,
                                                            make_torus)
from deep3dpointclouddenoising_torch.train import __main__ as train_cli
from deep3dpointclouddenoising_torch.train.trainer import Trainer
from deep3dpointclouddenoising_torch.utils.grad_check import \
    state_difference
from test_torch_resume import (Killed, _shape_tree, _tiny_yaml,
                               kill_at_step, train_state)
from test_torch_train import _configs

B = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """This file's torch ops in one thread (six workers share the host's
    cores under the Tier-1 command)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _datasets(tmp_path, fourier=False, in_radius=0.3, num_points=64):
    kwargs = dict(in_radius=in_radius, num_points=num_points, num_steps=8,
                  num_epochs=2, num_points_per_shape=3000,
                  noise_type="gaussian", noise_level=0.005, seed=0,
                  fourier_features=fourier)
    jds = JaxDataset(str(tmp_path / "jax"), "train",
                     shapes={"sphere": jax_icosphere(2),
                             "torus": jax_torus(12, 8)}, **kwargs)
    tds = OffsetDataset(str(tmp_path / "torch"), "train",
                        shapes={"sphere": make_icosphere(2),
                                "torus": make_torus(12, 8)}, **kwargs)
    return jds, tds


def _cfgs(num_points=64, in_radius=0.3, jitter=0, norm=0, fourier=0):
    """tests/test_device_sampler.py's make_cfg, for both packages."""
    out = []
    for c in (jax_cfg(), default_config()):
        c.num_points, c.in_radius, c.jitter = num_points, in_radius, jitter
        c.z_angle_range = np.pi
        c.augment_symmetries = [1, 0, 0]
        c.scale_low, c.scale_high = 0.8, 1.2
        c.noise_std, c.noise_clip = 1e-3, 2e-3
        c.norm, c.fourier_features = norm, fourier
        out.append(c)
    return out


def jax_draws(sampler: JaxSampler, rng):
    """The seam filled with JAX's draws of ``sampler.sample(data, centers,
    rng)``: each patch's key of ``split(rng, B)``, split as
    ``_sample_one`` and ``_augment`` split it; the pad picks drawn in
    [0, cur) of the port's real counts."""
    N = sampler.num_points
    ranges = sampler.angle_ranges

    def draws(cur):
        keys = jax.random.split(rng, len(cur))
        out = {k: [] for k in ("perm", "picks", "angles", "scale", "sym",
                               "n1", "n2")}
        for b, key in enumerate(keys):
            k_perm, k_pad, k_aug = jax.random.split(key, 3)
            out["perm"].append(jax.random.uniform(k_perm, (N - 1,)))
            out["picks"].append(jax.random.randint(
                k_pad, (N - 1,), 0, max(int(cur[b]), 1)))
            k_rot, k_scale, k_sym, k_j1, k_j2 = jax.random.split(k_aug, 5)
            out["angles"].append(jnp.stack([
                jax.random.uniform(k, (), minval=-r, maxval=r)
                for k, r in zip(jax.random.split(k_rot, 3), ranges)]))
            out["scale"].append(jax.random.uniform(
                k_scale, (3,), minval=sampler.scale_low,
                maxval=sampler.scale_high))
            out["sym"].append(jax.random.uniform(k_sym, (3,)))
            out["n1"].append(jax.random.normal(k_j1, (N, 3)))
            out["n2"].append(jax.random.normal(k_j2, (N, 3)))
        t = {k: torch.from_numpy(np.stack([np.asarray(x) for x in v]))
             for k, v in out.items()}
        return SamplerDraws(t["perm"], t["picks"].long(), t["angles"],
                            t["scale"], t["sym"], t["n1"], t["n2"])

    return draws


CASES = {
    # name: (augment, jitter, norm, fourier)
    "plain": (False, 0, 0, 0),
    "augmented_norm": (True, 1, 1, 0),
    "augmented_fourier": (True, 0, 0, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_with_jax_draws_matches_jax(tmp_path, case):
    augment, jitter, norm, fourier = CASES[case]
    # radius 0.08: some of the batch's patches underfill
    jds, tds = _datasets(tmp_path, fourier=bool(fourier), in_radius=0.08)
    jc, tc = _cfgs(in_radius=0.08, jitter=jitter, norm=norm,
                   fourier=fourier)
    js, ts = JaxSampler(jds, jc), DeviceSampler(tds, tc, "cpu")
    centers = ts.centers(1, B)[0]
    np.testing.assert_array_equal(centers, js.centers(1, B)[0])
    key = jax.random.PRNGKey(5)
    # jitted: eager JAX compiles each op of the vmapped sampler on its own
    want = jax.device_get(jax.jit(
        lambda d, c, k: js.sample(d, c, k, augment=augment))(
        js.cloud_data(), jnp.asarray(centers, jnp.int32), key))
    got = ts.sample(centers, jax_draws(js, key), augment=augment)
    for k in ("mask", "input_inds", "labels", "cloud_ind"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert 0 < got["mask"].sum() < got["mask"].numel()  # pads and reals
    for k in ("points", "offsets", "features"):
        g, w = got[k].numpy(), np.asarray(want[k])
        if not augment:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        atol = 2e-5 if k == "features" and fourier \
            else 1e-6 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol, err_msg=k)


def test_sample_pad_semantics_and_host_patches(tmp_path):
    """256 slots at radius 0.08: every patch underfills.  Reals take the
    prefix, pads repeat reals with mask 0, reals lie within the radius,
    the centre is slot 0, and each patch's reals are the host dataset's
    patch's points."""
    _, tds = _datasets(tmp_path, in_radius=0.08, num_points=256)
    _, tc = _cfgs(num_points=256, in_radius=0.08)
    ts = DeviceSampler(tds, tc, "cpu")
    centers = ts.centers(0, B)[0]
    batch = ts.sample(centers, torch_draws(
        ts, torch.Generator().manual_seed(1), B, augment=False),
        augment=False)
    mask = batch["mask"].numpy()
    for b in range(B):
        cur = int(mask[b].sum())
        assert 0 < cur < 256
        assert (mask[b, :cur] == 1).all() and (mask[b, cur:] == 0).all()
        pts = batch["points"][b].numpy()
        np.testing.assert_array_equal(pts[0], 0.0)
        assert np.linalg.norm(pts[:cur], axis=1).max() <= 0.08
        inds = batch["input_inds"][b].numpy()
        assert inds[0] == centers[b, 1]
        assert set(inds[cur:]) <= set(inds[:cur])
        host = tds.get(b, 0)
        assert host["mask"].sum() == cur
        assert set(host["input_inds"][:cur]) == set(inds[:cur])


def test_centers_match_jax(tmp_path):
    jds, tds = _datasets(tmp_path)
    jc, tc = _cfgs()
    js, ts = JaxSampler(jds, jc), DeviceSampler(tds, tc, "cpu")
    for epoch in (0, 1, 2):
        for drop_last, batch in ((True, 3), (False, 3), (True, 4)):
            np.testing.assert_array_equal(
                ts.centers(epoch, batch, drop_last),
                js.centers(epoch, batch, drop_last))


def test_sampled_train_steps_match_jax(tmp_path):
    """Two steps of a tiny model (test_torch_train.py's at width 8, depth
    1, 32 points, 5 kernel points, whose optimisation at trace time takes
    seconds where 15 take a quarter of a minute; Adam) on batches sampled
    with augmentation and jitter:
    JAX's
    ``build_sampled_train_chunk`` (its draws from ``fold_in(fold_in(rng,
    0x5A17), step)``) against the port's ``Trainer`` on the port's
    samples of the same draws."""
    jds, tds = _datasets(tmp_path, num_points=32)
    jc, tc = _configs(num_points=32, width=8, depth=1, radius=0.3,
                      sampleDl=0.08, nsamples=[4] * 5, npoints=[8, 4, 2, 1],
                      in_radius=0.3, jitter=1, z_angle_range=np.pi,
                      augment_symmetries=[1, 0, 0], scale_low=0.8,
                      scale_high=1.2, noise_std=1e-3, noise_clip=2e-3)
    for c in (jc, tc):
        c.pseudo_grid.num_kernel_points = 5
    js, ts = JaxSampler(jds, jc), DeviceSampler(tds, tc, "cpu")
    jmodel, jloss = jax_build(jc)
    jt = JaxTrainer(jc, jmodel, jloss, n_iter_per_epoch=10,
                    mesh=make_mesh(1))
    tt = Trainer(tc, 10, torch.Generator().manual_seed(0), "cpu")
    init = flax_from_params(tt.model.state_dict())
    init_params = {n: p.detach().clone()
                   for n, p in tt.model.named_parameters()}
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=init["params"],
                          batch_stats=init["batch_stats"],
                          opt_state=jt.tx.init(init["params"]))
    centers = ts.centers(0, B)[:2]
    rng = jax.random.PRNGKey(3)
    state, jlosses = build_sampled_train_chunk(jt, js)(
        state, jnp.asarray(centers, jnp.int32), js.cloud_data(), rng)
    tlosses = []
    for step, c in enumerate(centers):
        key = jax.random.fold_in(jax.random.fold_in(rng, 0x5A17), step)
        batch = ts.sample(c, jax_draws(js, key))
        tlosses.append(tt.train_step(batch).item())
    np.testing.assert_allclose(tlosses[0], float(jlosses[0]), rtol=1e-5)
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-3)
    lr, k = float(tc.base_learning_rate), 2
    want = params_from_flax(jax.device_get({"params": state.params}))
    for name, p in tt.model.named_parameters():
        moved = (p.detach() - init_params[name]).numpy()
        want_moved = (want[name] - init_params[name]).numpy()
        np.testing.assert_allclose(moved, want_moved, rtol=0,
                                   atol=2 * lr * k, err_msg=name)
        assert np.abs(moved).max() > 0, name


def test_train_cli_with_device_sampler_is_reproducible(tmp_path, capsys,
                                                      monkeypatch):
    """``device_sampler: 1`` through the train entry point: two unbroken
    runs bitwise equal, and a run killed one step into epoch 2 and run
    again with ``--auto_resume`` equal to them."""
    common = ["--config_file", _tiny_yaml(
        tmp_path, "l1", "num_points_per_shape: 1500\nbatch_size: 4\n"
        "device_sampler: 1\n"), "--data_root", _shape_tree(tmp_path),
        "--num_steps", "8", "--num_points", "64", "--epochs", "2",
        "--val_freq", "2", "--device", "cpu", "--auto_resume"]
    runs = [train_cli.main(common + ["--log_dir", str(tmp_path / f"r{i}")])
            for i in range(2)]
    assert "device sampler" in capsys.readouterr().out
    assert runs[0]["steps"] == 4 and runs[0]["val_batches"] == 2
    assert np.isfinite(runs[0]["train_losses"]).all()
    assert not state_difference(train_state(runs[0]["trainer"]),
                                train_state(runs[1]["trainer"]))
    log = str(tmp_path / "resumed")
    with monkeypatch.context() as m:
        kill_at_step(m, 3)
        with pytest.raises(Killed):
            train_cli.main(common + ["--log_dir", log])
    second = train_cli.main(common + ["--log_dir", log])
    assert second["restored"] == os.path.join(log, "l1_diverse",
                                              "current.pt")
    assert not state_difference(train_state(second["trainer"]),
                                train_state(runs[0]["trainer"]))

"""The PointCleanNet baseline in the port against the JAX package, on the
CPU, at a small size (B=4, N=32; the PCN widths are fixed):

* ``batch_quat_to_rotmat`` and ``surface_dist`` (with and without the
  regularisation), value and gradient: rtol 1e-6 / atol 1e-7;
* the four models (``ResPCPNet``, ``PCPNet``, ``ResMSPCPNet``,
  ``MSPCPNet``) through convert.py with O(1) weights and BatchNorm
  statistics: the eval forward in float32 at rtol 5e-4 / atol 5e-5 (the
  whole-model tolerance); the train forward (with JAX's dropout masks,
  read from its captured ``Dropout`` outputs), its new running statistics
  and every parameter's gradient in float64 on both sides
  (``jax.enable_x64``), within FLOAT64_TOL, 2^-23 and GRAD64_TOL: train
  mode at B=4 amplifies float32 rounding too far for a float32
  comparison (test_pcn_models_match_jax says how far);
* three ``PCNTrainer`` steps per loss (``L1`` with sgd, ``original`` with
  adam, ``original_no_reg`` with sgd) from one converted init against
  JAX's ``_train_step``, both in float64: the losses at rtol 1e-9, the
  parameters' change at rtol 1e-6 (atol 1e-6 of the largest change for
  sgd, 1e-4 for adam), the running statistics at rtol 1e-6, then
  ``eval_step`` and ``predict``;
* the PCN ``OffsetDataset`` (train split with the PCN transforms, test
  split) bitwise against JAX's ``native_patches=False`` path, with full
  and underfilled patches;
* ``denoise_clouds_pcn`` against JAX's with an oracle predictor, exactly;
  ``denoise_clouds_pcn_device`` equal to the host path where no patch
  underfills (atol 1e-6: the oracle's mean sums the same points in
  another order) and to JAX's device function;
* ``train_pcn`` with ``--auto_resume`` after a kill one step into epoch 2
  bitwise equal to an unbroken run; ``infer --pcn`` and ``--pcn
  --device_voting`` writing the same PLY tree, which ``compute_cd``
  reads.

Test clouds are noisy spheres and tori: no two points lie at an exactly
equal distance from a centre, and none within float32 rounding of the
patch radius, so the host's radius query and the sampler's top-k pick the
same points and no tie-break differs.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.data.offset_dataset import \
    OffsetDataset as JaxDataset
from deep3dpointclouddenoising_tpu.data.synthetic import \
    make_icosphere as jax_icosphere
from deep3dpointclouddenoising_tpu.data.synthetic import \
    make_torus as jax_torus
from deep3dpointclouddenoising_tpu.data.transforms import \
    build_train_transforms as jax_transforms
from deep3dpointclouddenoising_tpu.infer import \
    denoise_clouds_pcn as jax_denoise_pcn
from deep3dpointclouddenoising_tpu.infer import \
    denoise_clouds_pcn_device as jax_denoise_pcn_device
from deep3dpointclouddenoising_tpu.models import \
    build_offset_regression_PCN as jax_build_pcn
from deep3dpointclouddenoising_tpu.models import pcpnet as jax_pcpnet
from deep3dpointclouddenoising_tpu.train.pcn import PCNTrainer as JaxPCN
from deep3dpointclouddenoising_tpu.train.pcn import \
    surface_dist as jax_surface_dist
from deep3dpointclouddenoising_tpu.train.trainer import \
    TrainState as JaxTrainState
from deep3dpointclouddenoising_torch import compute_cd, infer, train_pcn
from deep3dpointclouddenoising_torch.config import default_config, \
    load_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.data.meshio import save_off
from deep3dpointclouddenoising_torch.data.offset_dataset import OffsetDataset
from deep3dpointclouddenoising_torch.data.synthetic import (make_icosphere,
                                                            make_torus)
from deep3dpointclouddenoising_torch.data.transforms import \
    build_train_transforms
from deep3dpointclouddenoising_torch.models import pcpnet
from deep3dpointclouddenoising_torch.train.pcn import PCNTrainer, \
    surface_dist
from deep3dpointclouddenoising_torch.utils import grad_check
from deep3dpointclouddenoising_torch.utils.grad_check import \
    state_difference
from test_torch_resume import Killed, train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCN_YAML = os.path.join(ROOT, "cfgs", "synthetic_quality_pcn4.yaml")
B, N, S = 4, 32, 2
MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
# the port's float64 against JAX's float64, relative to the largest value
FLOAT64_TOL = 1e-9
# the same for gradients, whose train-mode BatchNorm terms divide by the
# batch variance twice more (6e-8 seen)
GRAD64_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """This file's torch ops in one thread (six workers share the host's
    cores under the Tier-1 command)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _points(seed, n=N, batch=B):
    """Patch-like clouds that differ from one another in scale, stretch
    and place, so that a train-mode BatchNorm after the max over points
    sees a spread of values across the batch (clouds drawn alike give
    near-equal maxima, whose normalisation amplifies float32 rounding)."""
    rng = np.random.default_rng(seed)
    x = rng.random((batch, n, 3)) - 0.5
    x = x * rng.uniform(0.05, 1.0, size=(batch, 1, 3)) \
        + rng.normal(size=(batch, 1, 3))
    return x.astype(np.float32)


# -- quaternions and the surface distance -------------------------------------

def test_batch_quat_to_rotmat_matches_jax():
    q = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    want = np.asarray(jax_pcpnet.batch_quat_to_rotmat(jnp.asarray(q)))
    got = pcpnet.batch_quat_to_rotmat(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    rot = got @ got.transpose(0, 2, 1)
    np.testing.assert_allclose(rot, np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)


@pytest.mark.parametrize("regularization", [False, True])
def test_surface_dist_matches_jax(regularization):
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(B, 3)).astype(np.float32)
    target = rng.normal(size=(B, N, 3)).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda p: jax_surface_dist(p, jnp.asarray(target), regularization))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = surface_dist(p, torch.from_numpy(target), regularization)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-7)
    if not regularization:  # a prediction on a target point: zero
        zero = surface_dist(torch.from_numpy(target[:, 3]),
                            torch.from_numpy(target))
        assert zero.item() < 1e-9


# -- the four models ----------------------------------------------------------

MODELS = {
    # name: (port class, JAX class, kwargs, scales)
    "ResPCPNet": (pcpnet.ResPCPNet, jax_pcpnet.ResPCPNet, {}, 1),
    "PCPNet": (pcpnet.PCPNet, jax_pcpnet.PCPNet, {}, 1),
    "ResMSPCPNet": (pcpnet.ResMSPCPNet, jax_pcpnet.ResMSPCPNet,
                    {"num_scales": S}, S),
    "MSPCPNet": (pcpnet.MSPCPNet, jax_pcpnet.MSPCPNet, {"num_scales": S}, S),
}


def o1_model(name, seed=0):
    """The port's model with O(1) weights: Dense kernels normal over
    sqrt(fan-in), biases and BatchNorm shifts 0.1 normal, scales in [0.5,
    1.5], running means 0.5 normal and variances in [0.5, 2]; each STN's
    last Dense ten times smaller, so its transform stays near the
    identity."""
    cls, _, kwargs, _ = MODELS[name]
    model = cls(generator=torch.Generator().manual_seed(seed), **kwargs)
    rng = np.random.default_rng(seed)
    stn_last = {f"{n}.{last}" for n, m in model.named_modules()
                if isinstance(m, pcpnet.STN)
                for last in (["Dense_0"] if hasattr(m, "Dense_0") else
                             [f"BasicBlock_{len(m.blocks) - 1}.Dense_1"])}
    with torch.no_grad():
        for key, t in model.state_dict().items():
            mod, leaf = key.rsplit(".", 1)
            if leaf == "num_batches_tracked":
                continue
            if leaf == "weight" and mod.rsplit(".", 1)[-1].startswith(
                    "Dense"):
                v = rng.normal(size=t.shape) / np.sqrt(t.shape[1])
                v *= 0.1 if mod in stn_last else 1.0
            elif leaf == "weight":
                v = rng.uniform(0.5, 1.5, size=t.shape)
            elif leaf == "running_mean":
                v = rng.normal(size=t.shape) * 0.5
            elif leaf == "running_var":
                v = rng.uniform(0.5, 2.0, size=t.shape)
            else:
                v = rng.normal(size=t.shape) * 0.1
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    return model


def _is_dropout(module, _):
    return isinstance(module, fnn.Dropout)


def jax_model_run(name, variables, x, w, masks, monkeypatch):
    """JAX's eval outputs, train outputs, new statistics, dropout outputs
    and the gradient of ``sum_k <w_k, output_k>`` in train mode, all in
    float64 (``jax.enable_x64``).  ``masks``: the Dropouts' keep-masks in
    their order, given to Flax in place of its draws (``bernoulli``,
    patched by ``monkeypatch``)."""
    if masks:
        it = iter([jnp.asarray(m.numpy()) for m in masks])
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda *args, **kwargs: next(it))
    _, cls, kwargs, _ = MODELS[name]
    model = cls(**kwargs)
    key = jax.random.PRNGKey(3)
    variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                       variables)
    x, w = x.astype(np.float64), [wk.astype(np.float64) for wk in w]

    def train(params):
        outs, state = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x, train=True, rngs={"dropout": key},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=_is_dropout)
        value = sum(jnp.sum(o * wk) for o, wk in zip(outs, w))
        return value, (outs, state)

    def run(variables):
        evals = model.apply(variables, x, train=False)
        grads, (outs, state) = jax.grad(train, has_aux=True)(
            variables["params"])
        return evals, outs, state, grads

    with jax.enable_x64(True):
        return _np(jax.jit(run)(variables))


def _drop_masks(state):
    """The keep-masks of the head's Dropouts, in order (an output element
    is zero where it was dropped, or where a ReLU zeroed it, which drops
    nothing either way)."""
    inter = state.get("intermediates", {})
    return [torch.from_numpy(inter[k]["__call__"][0] != 0)
            for k in sorted(k for k in inter if k.startswith("Dropout_"))]


def _hold64(got, want, what, tol=None, scale=None):
    """The port's float64 against JAX's, within ``tol`` (FLOAT64_TOL) of
    ``scale`` (default the largest ``|want|``) and relative."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = FLOAT64_TOL if tol is None else tol
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=f"{what} (float64)")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_pcn_models_match_jax(name, monkeypatch):
    """The eval forward in float32 at MODEL_TOL of JAX's float64 (well
    conditioned: running statistics).  Train mode normalises
    over the batch's 4 clouds, also after the max over points, where
    channels of a small spread amplify rounding by up to 1/sqrt(eps) per
    BatchNorm: the port's float32 train output misses its float64 by up
    to 0.11 of ResMSPCPNet's 3.2, and its float32 gradients by up to 0.4
    of their max-abs, Flax's one-pass variance more.  So the train
    forward, the new statistics and the gradients are held in float64
    (``jax.enable_x64``; one set of dropout masks given to both), where the
    same amplification leaves them within FLOAT64_TOL (outputs),
    2^-23 (statistics, which Flax keeps in float32 variables) and
    GRAD64_TOL of the largest gradient (a Dense bias before a train-mode
    BatchNorm has a gradient of exactly zero, which both give as
    rounding)."""
    model = o1_model(name)
    scales = MODELS[name][3]
    x = _points(2, n=N * scales)
    rng = np.random.default_rng(4)
    w = [rng.normal(size=s).astype(np.float32)
         for s in ((B, 3), (B, 3, 3), (B, 64, 64))]
    variables = flax_from_params(model.state_dict())
    # keep-masks of the vanilla heads' two Dropouts (after the 512- and
    # 256-wide layers), fed to both packages
    masks = [torch.from_numpy(rng.random((B, c)) >= 0.3) for c in (512, 256)
             ] if name in ("PCPNet", "MSPCPNet") else []
    with monkeypatch.context() as m:
        j64 = jax_model_run(name, variables, x, w, masks, m)
    # Flax took them: its Dropouts' outputs are zero wherever they drop
    got_masks = _drop_masks(j64[2])
    assert len(got_masks) == len(masks)
    assert all(b.any() and not (b & ~a).any()
               for a, b in zip(masks, got_masks))
    model.eval()
    with torch.no_grad():
        for i, (got, want) in enumerate(zip(model(torch.from_numpy(x)),
                                            j64[0])):
            np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL,
                                       err_msg=f"{name} eval output {i}")
    m64 = grad_check.float64_copy(model)
    xt = torch.from_numpy(x).double()
    m64.eval()
    with torch.no_grad():
        for i, (got, want) in enumerate(zip(m64(xt), j64[0])):
            _hold64(got.numpy(), want, f"{name} eval output {i}")
    m64.train()
    outs = m64(xt, **({"keep_masks": masks} if masks else {}))
    for i, (got, want) in enumerate(zip(outs, j64[1])):
        _hold64(got.detach().numpy(), want, f"{name} train output {i}")
    value = sum(torch.sum(o * torch.from_numpy(wk).double())
                for o, wk in zip(outs, w))
    names, params = zip(*m64.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(value, params)))
    stats = params_from_flax({"batch_stats": j64[2]["batch_stats"]})
    got_stats = {k: v for k, v in m64.state_dict().items()
                 if "running_" in k}
    assert set(got_stats) == {k for k in stats if "running_" in k}
    for key, value in got_stats.items():
        _hold64(value.numpy(), stats[key], f"{name} {key}", tol=2 ** -23)
    jgrads = params_from_flax({"params": j64[3]})
    assert set(jgrads) == set(grads)
    largest = max(g.abs().max().item() for g in jgrads.values())
    for key, g in grads.items():
        _hold64(g.numpy(), jgrads[key], f"{name} gradient of {key}",
                tol=GRAD64_TOL, scale=largest)


def test_check_device_gradients_rules():
    """``grad_check.check_device_gradients`` (phase 15(a) and the card
    test hold the PCN's gradients by it): a float32 gradient within three
    times the CPU's own float32 noise passes; one past it that float32
    does not pin is decided by float64; a gradient that is zero but for
    rounding is held to the largest one's scale; a float64 gradient off
    the CPU's fails, and so does a non-finite one."""
    rng = np.random.default_rng(9)
    ref = torch.from_numpy(rng.normal(size=(50,)))
    noisy = ref * (1 + 1e-3 * torch.from_numpy(rng.normal(size=(50,))))
    far = ref * 1.3
    zero, zero2 = (torch.from_numpy(rng.normal(size=(50,)) * 1e-16)
                   for _ in range(2))
    ok = grad_check.check_device_gradients(
        ["a", "b", "c"], [noisy, far, zero.float()], [noisy, noisy, zero],
        [ref, ref, zero], [ref, ref.clone(), zero2])
    assert ok["decided_in_float64"] == ["b"] and ok["nearest"][1] == "a"
    with pytest.raises(AssertionError, match="float64 gradient of a"):
        grad_check.check_device_gradients(["a"], [noisy], [noisy], [ref],
                                          [ref * (1 + 1e-4)])
    with pytest.raises(AssertionError, match="not finite"):
        grad_check.check_device_gradients(["a"], [noisy / 0], [noisy],
                                          [ref], [ref])


# -- three train steps --------------------------------------------------------

def _pcn_configs(**extra):
    jc, tc = jax_cfg(), default_config()
    for c in (jc, tc):
        c.num_points, c.in_radius, c.batch_size = N, 0.1, B
        c.lr_scheduler, c.warmup_epoch, c.epochs = "step_PCN", -1, 5
        c.lr_decay_steps, c.momentum, c.weight_decay = 0.1, 0.9, 1e-3
        for k, v in extra.items():
            c[k] = v
    return jc, tc


def _pcn_batches(n, seed=5):
    rng = np.random.default_rng(seed)
    return [{"points": _points(seed + i),
             "offsets": (rng.normal(size=(B, N, 3)) * 0.01).astype(
                 np.float32)} for i in range(n)]


STEP_CASES = {
    "L1-sgd": dict(loss="L1", optimizer="sgd", base_learning_rate=0.05),
    "original-adam": dict(loss="original", optimizer="adam",
                          base_learning_rate=1e-3, lr_scheduler="step",
                          lr_decay_steps=1),
    "original_no_reg-sgd": dict(loss="original_no_reg", optimizer="sgd",
                                base_learning_rate=0.05),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_pcn_trainer_steps_match_jax(case):
    """Both trainers in float64 (``jax.enable_x64``; the port's model and
    batches cast), where train mode's amplified rounding (see
    test_pcn_models_match_jax) stays far below the tolerances: the losses
    at rtol 1e-9, the parameters' change at rtol 1e-6 and an atol of 1e-6
    of the largest change (GRAD64_TOL; SGD is linear in the gradients)
    or, for Adam, which divides gradients near its eps by their root mean
    square, 1e-4 of it, the running statistics at rtol 1e-6 (Flax keeps
    them in float32 variables), then ``eval_step`` (and once
    ``predict``).  The port's learning rate is rounded to float32 as JAX's
    schedule gives it: its 1.5e-8 relative difference grows to 3e-5 of
    the third loss through train mode's amplification otherwise."""
    jc, tc = _pcn_configs(**STEP_CASES[case])
    batches = [{k: v.astype(np.float64) for k, v in b.items()}
               for b in _pcn_batches(3)]
    tt = PCNTrainer(tc, 10, torch.Generator().manual_seed(0), "cpu")
    tt.model.double()
    # JAX computes its schedule in float32 even under x64
    schedule = tt.optimizer.schedule
    tt.optimizer.schedule = lambda count: float(np.float32(schedule(count)))
    init = flax_from_params(tt.model.state_dict())
    init_params = {k: v.clone() for k, v in tt.model.state_dict().items()}
    jmodel, _ = jax_build_pcn(jc)
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(True):
        jt = JaxPCN(jc, jmodel, n_iter_per_epoch=10)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                              params=init["params"],
                              batch_stats=init["batch_stats"],
                              opt_state=jt.tx.init(init["params"]))
        jlosses = []
        for i, b in enumerate(batches):
            state, loss = jt.train_step(state, b, jax.random.fold_in(key, i))
            jlosses.append(float(loss))
        jeval = float(jt.eval_step(state, batches[0]))
        # predict reads no loss: held once, jitted (eager Flax compiles
        # each op on its own, seconds)
        jpred = np.asarray(jax.jit(jt.predict)(
            state, batches[1]["points"])) if case == "L1-sgd" else None
        after = params_from_flax(_np({"params": state.params,
                                      "batch_stats": state.batch_stats}))
    tlosses = [tt.train_step(b).item() for b in batches]
    assert tt.step == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=FLOAT64_TOL)
    got = tt.model.state_dict()
    moved = {k: (got[k] - init_params[k]).numpy() for k in after
             if "running_" not in k and "num_batches" not in k}
    want = {k: (after[k].double() - init_params[k]).numpy() for k in moved}
    largest = max(np.abs(w).max() for w in want.values())
    # Adam's update of a gradient near its eps 1e-8 moves by a larger part
    # of its rounding (1e-5 of the largest change seen)
    atol = GRAD64_TOL if tc.optimizer == "sgd" else 1e-4
    for name, w in after.items():
        if name.endswith("num_batches_tracked"):
            assert int(got[name]) == 3
        elif "running_" in name:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=name)
        else:
            np.testing.assert_allclose(moved[name], want[name], rtol=1e-6,
                                       atol=atol * largest, err_msg=name)
    assert largest > 0
    np.testing.assert_allclose(tt.eval_step(batches[0]).item(), jeval,
                               rtol=1e-6)
    if jpred is not None:
        np.testing.assert_allclose(
            tt.predict(batches[1]["points"]).numpy(), jpred, rtol=1e-6,
            atol=1e-12)


# -- the dataset --------------------------------------------------------------

DATA = dict(noise_type="gaussian", noise_level=5e-3, num_points=N,
            num_points_per_shape=600, seed=3, num_steps=12)


@pytest.mark.parametrize("split", ["train", "qualitative_test"])
def test_pcn_dataset_matches_jax(tmp_path, split):
    """Radius 0.2 on 600-point clouds: some patches overfill (truncated,
    shuffled), some underfill (padded with cloud point 0)."""
    transforms = split == "train"
    cfg_t, cfg_j = load_config(PCN_YAML), None
    if transforms:
        from deep3dpointclouddenoising_tpu.config import load_config as jl
        cfg_j = jl(PCN_YAML)
    jds = JaxDataset(str(tmp_path / "jax"), split, num_epochs=2,
                     in_radius=0.2, architecture="PCN",
                     native_patches=False,
                     transforms=jax_transforms(cfg_j) if transforms else None,
                     shapes={f"{split}/sphere": jax_icosphere(2),
                             f"{split}/torus": jax_torus()}, **DATA)
    tds = OffsetDataset(str(tmp_path / "torch"), split, num_epochs=2,
                        in_radius=0.2, architecture="PCN",
                        transforms=build_train_transforms(cfg_t)
                        if transforms else None,
                        shapes={f"{split}/sphere": make_icosphere(2),
                                f"{split}/torus": make_torus()}, **DATA)
    np.testing.assert_array_equal(tds.point_inds, jds.point_inds)
    np.testing.assert_array_equal(tds.cloud_inds, jds.cloud_inds)
    if split != "train":
        assert len(tds) == 1200  # a patch per cloud point
    full = under = 0
    for epoch in (0, 1):
        for i in range(0, len(tds), 7 if split != "train" else 1):
            got, want = tds.get(i, epoch), jds.get(i, epoch)
            assert set(got) == set(want) == {
                "points", "center_ind", "cloud_ind", "input_inds", "offsets"}
            for key in got:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)
            # an underfilled patch repeats cloud point 0
            unique = len(np.unique(got["input_inds"]))
            under += unique < N
            full += unique == N
            if split != "train":
                assert got["offsets"].shape == (3,)
    assert full and under


# -- denoising ----------------------------------------------------------------

class _MeanModel(torch.nn.Module):
    """A mock PCN: twice the patch's mean as the offset, identity
    transforms."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, pts):
        eye = torch.eye(3).expand(pts.shape[0], 3, 3)
        return pts.mean(1) * 2.0 * self.w, eye, None


class _JaxMeanModel:
    def apply(self, variables, points, train=False):
        trans = jnp.broadcast_to(jnp.eye(3), (points.shape[0], 3, 3))
        return jnp.mean(points, axis=1) * 2.0, trans, None


def test_denoise_clouds_pcn_matches_jax(tmp_path):
    """One icosphere of 300 points at radius 2.5 (no patch underfills,
    JAX's own test geometry): the host paths of both packages exactly,
    the port's device path within atol 1e-6 of its host path and of
    JAX's device path."""
    kwargs = dict(in_radius=2.5, num_points=48, num_steps=1, num_epochs=1,
                  num_points_per_shape=300, noise_type="gaussian",
                  noise_level=0.005, seed=0, architecture="PCN")
    jds = JaxDataset(str(tmp_path / "jax"), "qualitative_test",
                     shapes={"sphere": jax_icosphere(1)},
                     native_patches=False, **kwargs)
    tds = OffsetDataset(str(tmp_path / "torch"), "qualitative_test",
                        shapes={"sphere": make_icosphere(1)}, **kwargs)
    want = jax_denoise_pcn(
        lambda pts: np.asarray(pts).mean(axis=1) * 2.0, jds, batch_size=16)
    got = infer.denoise_clouds_pcn(
        lambda pts: torch.from_numpy(np.asarray(pts).mean(axis=1) * 2.0),
        tds, batch_size=16)
    np.testing.assert_array_equal(got[0]["offsets"], want[0]["offsets"])
    assert (np.abs(got[0]["offsets"]) > 0).all()
    cfg = default_config()
    cfg.num_points, cfg.in_radius, cfg.loss = 48, 2.5, "L1"
    dev = infer.denoise_clouds_pcn_device(_MeanModel(), cfg, tds,
                                          batch_size=16, device="cpu")
    assert (dev[0]["patch_reals"] == 48).all()  # no patch underfills
    np.testing.assert_allclose(dev[0]["offsets"], got[0]["offsets"],
                               atol=1e-6)
    jcfg = jax_cfg()
    jcfg.num_points, jcfg.in_radius, jcfg.loss = 48, 2.5, "L1"
    jdev = jax_denoise_pcn_device(_JaxMeanModel(), {}, jcfg, jds,
                                  batch_size=16, chunk_steps=4)
    np.testing.assert_allclose(dev[0]["offsets"], jdev[0]["offsets"],
                               atol=1e-6)


# -- the entry points ---------------------------------------------------------

def _pcn_yaml(tmp_path, **extra):
    """synthetic_quality_pcn4.yaml cut to gaussian noise on 400-point
    clouds, 32-point patches of radius 0.4."""
    with open(PCN_YAML) as f:
        text = f.read().replace("noise_type: diverse_stable",
                                "noise_type: gaussian").replace(
            "num_points: 500", f"num_points: {N}").replace(
            "num_points_per_shape: 140000", "num_points_per_shape: 400")
    text += "diameter_percent: 80\n"
    text += "".join(f"{k}: {v}\n" for k, v in extra.items())
    path = tmp_path / "tiny_pcn.yaml"
    path.write_text(text)
    return str(path)


def _tree(tmp_path):
    root = tmp_path / "data"
    for split in ("train", "val", "qualitative_test"):
        (root / split).mkdir(parents=True)
        save_off(str(root / split / "sphere.off"), make_icosphere(2))
    save_off(str(root / "train" / "torus.off"), make_torus())
    return str(root)


def test_train_pcn_auto_resume_is_bitwise(tmp_path, capsys, monkeypatch):
    """``train_pcn`` with ``--auto_resume``: a run killed one step into
    epoch 2 and run again ends where an unbroken run ends, bitwise."""
    data = _tree(tmp_path)
    common = ["--config_file", _pcn_yaml(tmp_path, batch_size=4),
              "--data_root", data, "--num_steps", "8", "--num_points",
              str(N), "--epochs", "2", "--val_freq", "1", "--device", "cpu",
              "--auto_resume"]
    straight = train_pcn.main(common + ["--log_dir",
                                        str(tmp_path / "straight")])
    assert straight["steps"] == 4 and straight["val_batches"] == 4
    assert np.isfinite(straight["train_losses"]
                       + straight["val_losses"]).all()
    step = PCNTrainer.train_step

    def killed(trainer, batch):
        loss = step(trainer, batch)
        if trainer.step == 3:
            raise Killed(3)
        return loss

    log = str(tmp_path / "resumed")
    with monkeypatch.context() as m:
        m.setattr(PCNTrainer, "train_step", killed)
        with pytest.raises(Killed):
            train_pcn.main(common + ["--log_dir", log])
    capsys.readouterr()
    second = train_pcn.main(common + ["--log_dir", log])
    assert "start_epoch 2" in capsys.readouterr().out
    assert second["steps"] == 4
    assert not state_difference(train_state(second["trainer"]),
                                train_state(straight["trainer"]))
    run = "synthetic_quality_pcn4"
    for leaf in ("current.pt", "ckpt_epoch_2.pt"):
        assert not state_difference(
            torch.load(os.path.join(log, run, leaf), weights_only=True),
            torch.load(os.path.join(tmp_path, "straight", run, leaf),
                       weights_only=True)), leaf


def test_infer_pcn_cli_host_and_device(tmp_path, capsys):
    """``infer --pcn`` and ``--pcn --device_voting`` from one seed: the same
    offsets (no patch underfills at radius 0.4) and the same PLY tree,
    which ``compute_cd`` reads."""
    data = _tree(tmp_path)
    config = _pcn_yaml(tmp_path, batch_size=64)
    outs = {}
    for name, extra in (("host", []), ("device", ["--device_voting"])):
        out = str(tmp_path / name)
        outs[name] = (infer.main(["--config_file", config, "--data_root",
                                  data, "--out_dir", out, "--pcn",
                                  "--device", "cpu"] + extra), out)
    host, device = outs["host"][0], outs["device"][0]
    assert len(host["dataset"]) == 400  # a patch per point
    assert (device["results"][0]["patch_reals"] == N).all()
    np.testing.assert_allclose(device["results"][0]["offsets"],
                               host["results"][0]["offsets"], rtol=1e-5,
                               atol=1e-7)
    assert np.abs(host["results"][0]["offsets"]).max() > 0
    tables = [compute_cd.main(["--in_dir", out]) for _, out in outs.values()]
    assert set(tables[0]) == set(tables[1]) == {"sphere", "mean"}
    np.testing.assert_allclose(tables[0]["sphere"]["ratio"],
                               tables[1]["sphere"]["ratio"], rtol=1e-4)
    assert "points/s" in capsys.readouterr().out

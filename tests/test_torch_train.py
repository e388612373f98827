"""The port's training slice against the JAX package's, on the CPU.

The same numpy inputs and the same initial weights (carried between the
packages by convert.py) go through both:

* LR schedules: rtol 1e-6 and an atol of 1e-7 of the base LR (JAX
  computes them in float32);
* the optimizer chain against optax for sgd, adam and adamW, with the clip
  active and inactive: rtol 1e-5 / atol 1e-7 (rounding only, the
  gradients are given);
* three train steps of the tiny model of tests/test_trainer.py, with
  l1.yaml's additive L2 and clip: the losses (rtol 1e-5 at the first
  step, 1e-3 after it, for the drift below); the first-step
  gradients at rtol 1e-3 with an atol of 5e-3 of each tensor's max-abs,
  because a train-mode BatchNorm's scale gradient cancels to a small part
  of its terms and float32 itself strays up to 1.1e-3 of the max-abs from
  float64 there; Adam's moments after each step against optax's mu and nu
  at that same tolerance; the parameters' change after k steps within
  2 * lr * k everywhere, because Adam turns a sign flip of a near-zero
  gradient into a jump of 2 * lr, and at rtol 1e-3 / atol 1e-2 * lr on all
  but 1e-3 of the elements; the BatchNorm running statistics after the
  first step (which catch torch's unbiased running variance) at rtol 1e-4
  and an atol of 2e-5 of each tensor's max-abs, and after three steps at
  rtol 5e-2 / atol 2 * lr * k (the forwards of steps 2 and 3 see the
  drifted parameters); a fourth step started from the converted optax
  state (count 3, so bias correction and the state converter decide it),
  its update at rtol 1e-3 / atol 1e-3 * lr, and that comparison shown to
  fail with the converted moments zeroed, untransposed or swapped;
* the train and val splits of OffsetDataset with the l1.yaml transforms,
  epochs 0 and 1: exact;
* the train entry point on the CPU: two tiny epochs and a checkpoint that
  infer.load_model reads.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import linen as fnn

from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.config import load_config as jax_load
from deep3dpointclouddenoising_tpu.data.offset_dataset import \
    OffsetDataset as JaxDataset
from deep3dpointclouddenoising_tpu.data.synthetic import \
    make_icosphere as jax_icosphere
from deep3dpointclouddenoising_tpu.data.synthetic import \
    make_torus as jax_torus
from deep3dpointclouddenoising_tpu.data.transforms import \
    build_train_transforms as jax_transforms
from deep3dpointclouddenoising_tpu.losses.masked import \
    masked_l1_loss as jax_l1
from deep3dpointclouddenoising_tpu.models import \
    build_offset_regression as jax_build
from deep3dpointclouddenoising_tpu.parallel.mesh import make_mesh
from deep3dpointclouddenoising_tpu.train import Trainer as JaxTrainer
from deep3dpointclouddenoising_tpu.train.lr_schedule import \
    get_lr_schedule as jax_schedule
from deep3dpointclouddenoising_tpu.train.trainer import \
    TrainState as JaxTrainState
from deep3dpointclouddenoising_tpu.train.trainer import \
    make_optimizer as jax_optimizer
from deep3dpointclouddenoising_torch import infer
from deep3dpointclouddenoising_torch.config import default_config, \
    load_config
from deep3dpointclouddenoising_torch.convert import \
    adam_state_from_optax, flax_from_params, params_from_flax
from deep3dpointclouddenoising_torch.data.meshio import save_off
from deep3dpointclouddenoising_torch.data.offset_dataset import OffsetDataset
from deep3dpointclouddenoising_torch.data.synthetic import (make_icosphere,
                                                            make_torus)
from deep3dpointclouddenoising_torch.data.transforms import \
    build_train_transforms
from deep3dpointclouddenoising_torch.losses.build import \
    get_offset_regression_loss
from deep3dpointclouddenoising_torch.losses.masked import masked_l1_loss
from deep3dpointclouddenoising_torch.models import build_offset_regression
from deep3dpointclouddenoising_torch.models.layers import \
    ChannelsLastBatchNorm
from deep3dpointclouddenoising_torch.train import __main__ as train_cli
from deep3dpointclouddenoising_torch.train.lr_schedule import \
    get_lr_schedule
from deep3dpointclouddenoising_torch.train.trainer import Trainer, \
    make_optimizer
from test_torch_model import L1_YAML

# tests/test_trainer.py:16-35, with l1.yaml's additive L2
TINY = dict(num_points=64, width=16, depth=2, radius=0.2, sampleDl=0.05,
            nsamples=[8, 8, 8, 8, 8], npoints=[16, 8, 4, 2],
            local_aggregation_type="pseudo_grid", head="offset_reg_head",
            loss="L1", optimizer="adam", base_learning_rate=1e-3,
            lr_scheduler="step", warmup_epoch=-1, epochs=10, batch_size=8,
            weight_decay=1e-3)


def _configs(**extra):
    jc, tc = jax_cfg(), default_config()
    for c in (jc, tc):
        for k, v in {**TINY, **extra}.items():
            c[k] = v
    tc.input_features_dim = 3  # Flax infers it from the input
    return jc, tc


def _batch(rng, B=8, N=64):
    xyz = (rng.random((B, N, 3), dtype=np.float32) * 2 - 1)
    mask = np.ones((B, N), np.float32)
    mask[-1, 50:] = 0.0
    xyz[-1, 50:] = xyz[-1, :14]
    offs = rng.normal(size=(B, N, 3)).astype(np.float32) * 0.02
    return {"points": xyz, "mask": mask, "features": xyz.copy(),
            "offsets": offs}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# -- schedules and the optimizer chain ---------------------------------------

@pytest.mark.parametrize("scheduler", ["step", "cosine", "step_PCN"])
@pytest.mark.parametrize("warmup", [-1, 2])
def test_lr_schedule_matches_jax(scheduler, warmup):
    jc, tc = _configs(lr_scheduler=scheduler, warmup_epoch=warmup,
                      warmup_multiplier=100, lr_decay_steps=2,
                      lr_decay_rate=0.5)
    want = jax_schedule(jc, n_iter_per_epoch=7, base_lr=0.3)
    got = get_lr_schedule(tc, n_iter_per_epoch=7, base_lr=0.3)
    steps = range(0, 80)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps],
                               rtol=1e-6, atol=1e-7 * 0.3)


@pytest.mark.parametrize("clip", [0.05, 100.0])   # active, inactive
@pytest.mark.parametrize("name", ["sgd", "adam", "adamW"])
def test_optimizer_matches_optax(name, clip):
    jc, tc = _configs(optimizer=name, grad_clip_norm=clip,
                      base_learning_rate=0.01, momentum=0.9,
                      lr_decay_steps=1, lr_decay_rate=0.5)
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    # one step per epoch, so the schedule moves at every update
    tx, _ = jax_optimizer(jc, n_iter_per_epoch=1)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
               for k in shapes]
    opt, _ = make_optimizer(tc, tparams, n_iter_per_epoch=1)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(tparams, shapes):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for p, k in zip(tparams, shapes):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert opt.count == 3


# -- three train steps of the tiny model ----------------------------------

def _adam_moments(tt):
    """{name: (exp_avg, exp_avg_sq)} of the port's Adam."""
    state = tt.optimizer.optimizer.state
    return {n: (state[p]["exp_avg"].clone(), state[p]["exp_avg_sq"].clone())
            for n, p in tt.model.named_parameters()}


def _optax_moments(opt_state):
    """{name: (mu, nu)} of optax's Adam state, as the port names and lays
    out its parameters (Dense kernels transposed)."""
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    mu, nu = (params_from_flax({"params": t}) for t in (adam.mu, adam.nu))
    return {n: (mu[n], nu[n]) for n in mu}


def run_both():
    """Three train steps of each package from one init on the same
    batches, and a fourth of the JAX one."""
    jc, tc = _configs()
    rng = np.random.default_rng(3)
    batches = [_batch(rng) for _ in range(4)]
    jmodel, jloss = jax_build(jc)
    jt = JaxTrainer(jc, jmodel, jloss, n_iter_per_epoch=10,
                    mesh=make_mesh(1))
    key = jax.random.PRNGKey(0)
    # one init for both, carried by convert.py (Flax's own init runs the
    # model eagerly, which takes a minute here)
    tt = Trainer(tc, 10, torch.Generator().manual_seed(0), "cpu")
    init = flax_from_params(tt.model.state_dict())
    state = jt.put_replicated(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=init["params"],
        batch_stats=init["batch_stats"],
        opt_state=jt.tx.init(init["params"])))

    def jax_loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": init["batch_stats"]},
            batches[0]["points"], batches[0]["mask"],
            batches[0]["features"], train=True, mutable=["batch_stats"],
            rngs={"dropout": key})
        return jloss(out, batches[0]["offsets"], batches[0]["mask"],
                     batches[0]["points"])

    jgrads = _np(jax.jit(jax.grad(jax_loss))(init["params"]))
    jlosses, jmoments = [], []
    for i in range(3):
        state, loss = jt.train_step(state, batches[i],
                                    jax.random.fold_in(key, i))
        jlosses.append(float(loss))
        jmoments.append(_optax_moments(_np(state.opt_state)))
        if i == 0:
            stats1 = _np(state.batch_stats)
    after3 = _np({"params": state.params, "batch_stats": state.batch_stats,
                  "opt_state": state.opt_state})
    state, loss = jt.train_step(state, batches[3],
                                jax.random.fold_in(key, 3))
    after4 = _np({"params": state.params, "loss": loss})

    init_params = {n: p.detach().clone()
                   for n, p in tt.model.named_parameters()}
    tlosses = [tt.train_step(batches[0]).item()]
    tgrads = {n: p.grad.clone() for n, p in tt.model.named_parameters()}
    tstats1 = {n: b.clone() for n, b in tt.model.named_buffers()
               if "running_" in n}
    tmoments = [_adam_moments(tt)]
    for b in batches[1:3]:
        tlosses.append(tt.train_step(b).item())
        tmoments.append(_adam_moments(tt))
    return dict(tc=tc, batches=batches, jgrads=jgrads, jlosses=jlosses,
                stats1=stats1, after3=after3, after4=after4, tt=tt,
                tgrads=tgrads, tstats1=tstats1, tlosses=tlosses,
                init_params=init_params, jmoments=jmoments,
                tmoments=tmoments)


@pytest.fixture(scope="module")
def runs():
    return run_both()


def test_three_steps_losses_match_jax(runs):
    assert runs["tt"].step == 3
    # step 1 from the same weights: rounding only; steps 2 and 3 see the
    # parameters' drift of up to 2 * lr per element and step
    np.testing.assert_allclose(runs["tlosses"][0], runs["jlosses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(runs["tlosses"], runs["jlosses"], rtol=1e-3)


def test_first_step_gradients_match_jax(runs):
    want = params_from_flax({"params": runs["jgrads"]})
    got = runs["tgrads"]
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-3,
                                   atol=5e-3 * np.abs(w).max(),
                                   err_msg=name)


def test_first_step_batch_stats_match_jax(runs):
    """After one step from the same parameters the running statistics
    agree tightly; torch's own unbiased running variance would miss by
    a factor n / (n - 1), up to 1/15 at the deepest level.  The atol is
    2e-5 of each tensor's max-abs: the statistics at the deep levels come
    after up to eight blocks of float32 forward (2.4e-6 seen at 0.48)."""
    want = params_from_flax({"batch_stats": runs["stats1"]})
    got = runs["tstats1"]
    assert set(got) == {k for k in want if "running_" in k}
    for name, value in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(value.numpy(), w, rtol=1e-4,
                                   atol=2e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("step", [1, 2, 3])
def test_adam_moments_match_optax(runs, step):
    """Adam's first and second moments after each step against optax's mu
    and nu: rtol 1e-3 and an atol of 5e-3 of each tensor's max-abs, the
    first-step gradients' tolerance (the moments average the clipped
    gradients plus the additive L2; at steps 2 and 3 they also see the
    parameters' drift, 9.3e-4 of the max-abs seen).  A Trainer that never
    stepped has no moments; one that skipped the clip or the L2 misses."""
    got, want = runs["tmoments"][step - 1], runs["jmoments"][step - 1]
    assert set(got) == set(want)
    for name, pair in want.items():
        for what, a, w in zip(("exp_avg", "exp_avg_sq"), got[name], pair):
            w = w.numpy()
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-3,
                                       atol=5e-3 * np.abs(w).max(),
                                       err_msg=f"{name} {what}")


def test_three_steps_params_and_batch_stats_match_jax(runs):
    """The parameters' change over three steps: every element within
    2 * lr * k of JAX's, since Adam turns a sign flip of a near-zero
    gradient into a jump of 2 * lr per step; and all but a share of 1e-3
    of the elements (the room left for such flips; none seen) at rtol 1e-3
    and an atol of 1e-2 * lr (the drift of steps 2 and 3 through Adam's
    normalisation; 5.6e-3 * lr seen), so a Trainer that does not update,
    or updates by another rule, fails."""
    lr, k = float(runs["tc"].base_learning_rate), 3
    want = params_from_flax({"params": runs["after3"]["params"],
                             "batch_stats": runs["after3"]["batch_stats"]})
    got = runs["tt"].model.state_dict()
    init = runs["init_params"]
    off, total = 0, 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            assert int(got[name]) == 3
        elif "running_" in name:
            # the forwards of steps 2 and 3 see parameters that may
            # differ by up to 2 * lr per element and step, which moves a
            # BatchNorm input's variance by a few percent
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       rtol=5e-2, atol=2 * lr * k,
                                       err_msg=name)
        else:
            moved = got[name].numpy() - init[name].numpy()
            want_moved = w.numpy() - init[name].numpy()
            np.testing.assert_allclose(moved, want_moved, rtol=0,
                                       atol=2 * lr * k, err_msg=name)
            off += int((np.abs(moved - want_moved)
                        > 1e-3 * np.abs(want_moved) + 1e-2 * lr).sum())
            total += moved.size
    assert off <= 1e-3 * total, f"{off} of {total} elements off"


def _fourth_step(runs, mutation=None):
    """Step 4 of a fresh Trainer loaded with the JAX run's state after
    step 3 (parameters, batch statistics, Adam's moments with count 3),
    optionally with the converted moments broken; returns the loss and
    each parameter's update."""
    tc, after3 = runs["tc"], runs["after3"]
    tt = Trainer(tc, 10, torch.Generator().manual_seed(1), "cpu")
    tt.model.load_state_dict(params_from_flax(
        {"params": after3["params"], "batch_stats": after3["batch_stats"]},
        tt.model))
    adam = next(s for s in after3["opt_state"] if hasattr(s, "mu"))
    assert int(adam.count) == 3
    state = adam_state_from_optax(adam.count, adam.mu, adam.nu, tt.model,
                                  tt.optimizer.optimizer)
    ids = state["param_groups"][0]["params"]
    moments = [state["state"][i] for i in ids]
    names = [n for n, _ in tt.model.named_parameters()]
    if mutation == "zeroed":
        for m in moments:
            m["exp_avg"].zero_()
            m["exp_avg_sq"].zero_()
    elif mutation == "untransposed":
        # a square Dense kernel's moments left in Flax's (in, out) layout
        for n, m in zip(names, moments):
            if n.endswith("Dense_0.weight") and \
                    m["exp_avg"].shape[0] == m["exp_avg"].shape[1]:
                m["exp_avg"] = m["exp_avg"].T.contiguous()
                m["exp_avg_sq"] = m["exp_avg_sq"].T.contiguous()
    elif mutation == "swapped":
        # the moments of two tensors of one shape exchanged (two that
        # differ: some BatchNorm biases of a block share their gradient)
        a, b = next((a, b) for a in range(len(ids)) for b in range(a)
                    if moments[a]["exp_avg"].shape
                    == moments[b]["exp_avg"].shape
                    and not torch.equal(moments[a]["exp_avg"],
                                        moments[b]["exp_avg"]))
        state["state"][ids[a]], state["state"][ids[b]] = \
            moments[b], moments[a]
    tt.optimizer.load_state_dict({"optimizer": state,
                                  "count": int(adam.count)})
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    loss = tt.train_step(runs["batches"][3]).item()
    return loss, {n: (p.detach() - before[n]).numpy()
                  for n, p in tt.model.named_parameters()}


def _fourth_step_mismatches(runs, moved):
    """Elements of step 4's update off JAX's at rtol 1e-3 and an atol of
    1e-3 * lr: both start from the same state, so only the gradient's
    rounding differs (3.2e-5 * lr beyond the rtol seen)."""
    lr = float(runs["tc"].base_learning_rate)
    want4 = params_from_flax({"params": runs["after4"]["params"]})
    want3 = params_from_flax({"params": runs["after3"]["params"]})
    off = {}
    for name, got in moved.items():
        want = want4[name].numpy() - want3[name].numpy()
        n = int((np.abs(got - want) > 1e-3 * np.abs(want) + 1e-3 * lr).sum())
        if n:
            off[name] = n
    return off


def test_fourth_step_from_converted_optax_state(runs):
    """Step 4 from the JAX run's state after step 3, so Adam's bias
    correction at count 3 and the optimizer-state converter decide the
    update, which is compared element by element."""
    loss, moved = _fourth_step(runs)
    np.testing.assert_allclose(loss, float(runs["after4"]["loss"]),
                               rtol=1e-4)
    assert _fourth_step_mismatches(runs, moved) == {}
    tt = runs["tt"]
    adam = next(s for s in runs["after3"]["opt_state"] if hasattr(s, "mu"))
    with pytest.raises(KeyError):
        adam_state_from_optax(3, {"A_0": {"kernel_weights": np.zeros(1)}},
                              adam.nu, tt.model, tt.optimizer.optimizer)


@pytest.mark.parametrize("mutation", ["zeroed", "untransposed", "swapped"])
def test_fourth_step_check_catches_broken_moments(runs, mutation):
    """The comparison above fails when the converted moments are zeroed,
    left in Flax's layout, or taken from another tensor of the shape."""
    _, moved = _fourth_step(runs, mutation)
    assert _fourth_step_mismatches(runs, moved)


# -- layers, losses and init ---------------------------------------------------

def test_train_mode_batchnorm_matches_flax():
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(4, 10, 6)) * 2 + 3).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)
    want, mut = bn.apply(variables, x, mutable=["batch_stats"])
    tbn = ChannelsLastBatchNorm(6, momentum=0.1).train()
    got = tbn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    stats = mut["batch_stats"]
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)


def test_masked_l1_loss_matches_jax():
    rng = np.random.default_rng(9)
    pred, target = (rng.normal(size=(3, 20, 3)).astype(np.float32)
                    for _ in range(2))
    mask = (rng.random((3, 20)) > 0.4).astype(np.float32)
    want = float(jax_l1(pred, target, mask))
    got = get_offset_regression_loss("L1")(
        *(torch.from_numpy(a) for a in (pred, target, mask)))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    assert masked_l1_loss(torch.zeros(1, 2, 3), torch.ones(1, 2, 3),
                          torch.zeros(1, 2)).item() == 0.0
    with pytest.raises(ValueError, match="not implemented"):
        get_offset_regression_loss("no_such_loss")


def test_init_draws_only_from_its_generator():
    _, tc = _configs()
    a = build_offset_regression(tc, torch.Generator().manual_seed(5))
    torch.manual_seed(123)
    b = build_offset_regression(tc, torch.Generator().manual_seed(5))
    c = build_offset_regression(tc, torch.Generator().manual_seed(6))
    for (name, x), y, z in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
    assert not torch.equal(a.state_dict()["MultiDimHead_0.Dense_0.weight"],
                           c.state_dict()["MultiDimHead_0.Dense_0.weight"])


# -- data ----------------------------------------------------------------------

DATA = dict(in_radius=0.4, noise_type="gaussian", noise_level=5e-3,
            num_points_per_shape=2000, seed=3, num_steps=10, num_points=64)


def _split_shapes(split, icosphere, torus):
    return {f"{split}/sphere": icosphere(2), f"{split}/torus": torus()}


@pytest.mark.parametrize("outliers", [0.0, 0.05])
@pytest.mark.parametrize("split", ["train", "val"])
def test_train_and_val_batches_match_jax(tmp_path, split, outliers):
    epochs = 2 if split == "train" else 1
    jds = JaxDataset(str(tmp_path / "jax"), split, num_epochs=epochs,
                     outlier_proportion=outliers, native_patches=False,
                     transforms=jax_transforms(jax_load(L1_YAML))
                     if split == "train" else None,
                     shapes=_split_shapes(split, jax_icosphere, jax_torus),
                     **DATA)
    tds = OffsetDataset(str(tmp_path / "torch"), split, num_epochs=epochs,
                        outlier_proportion=outliers,
                        transforms=build_train_transforms(
                            load_config(L1_YAML))
                        if split == "train" else None,
                        shapes=_split_shapes(split, make_icosphere,
                                             make_torus), **DATA)
    np.testing.assert_array_equal(tds.point_inds, jds.point_inds)
    np.testing.assert_array_equal(tds.cloud_inds, jds.cloud_inds)
    assert len(tds) == len(jds) == 10
    for epoch in (0, 1):
        for i in range(len(tds)):
            got, want = tds.get(i, epoch), jds.get(i, epoch)
            assert set(got) == set(want)
            for key in got:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)


# -- the entry point -------------------------------------------------------------

def test_train_cli_on_cpu(tmp_path, capsys):
    root = tmp_path / "data"
    for split in ("train", "val"):
        (root / split).mkdir(parents=True)
        save_off(str(root / split / "sphere.off"), make_icosphere(2))
    save_off(str(root / "train" / "torus.off"), make_torus())
    with open(L1_YAML) as f:
        text = f.read().replace("width: 144", "width: 8")
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(text + "num_points_per_shape: 1500\n"
                        "batch_size: 4\nprint_freq: 2\n")
    summary = train_cli.main([
        "--config_file", str(cfg_path), "--data_root", str(root),
        "--log_dir", str(tmp_path / "log"), "--num_steps", "16",
        "--num_points", "64", "--epochs", "2", "--val_freq", "1",
        "--device", "cpu"])
    log = capsys.readouterr().out
    assert "epoch 2: 4 steps" in log and "val [2]" in log
    assert summary["steps"] == 8 and summary["val_batches"] == 8
    assert len(summary["train_losses"]) == 8
    assert np.isfinite(summary["train_losses"] + summary["val_losses"]).all()
    ckpt = summary["checkpoint"]
    assert ckpt == str(tmp_path / "log" / "l1_diverse" / "ckpt_epoch_2.pt")
    assert os.path.exists(tmp_path / "log" / "l1_diverse" / "current.pt")
    cfg = load_config(str(cfg_path), {"num_points": 64})
    model = infer.load_model(cfg, "cpu", ckpt)
    for name, value in summary["trainer"].model.state_dict().items():
        assert torch.equal(model.state_dict()[name], value), name
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (
            np.zeros((1, 64, 3), np.float32), np.ones((1, 64), np.float32),
            np.zeros((1, 64, 3), np.float32))))
    assert torch.isfinite(out).all()


def test_train_cli_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--config_file", L1_YAML, "--data_root", "x"])

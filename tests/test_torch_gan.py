"""GAN fine-tuning and discriminator pre-training in the port against the
JAX package, on the CPU, at tests/test_gan.py's tiny size (width 8, depth
1, 32 points):

* ``masked_global_avg_pool``: rtol 1e-6; the binary cross-entropy and its
  gradient, probabilities at and past the eps 1e-7 clip included: rtol
  1e-6; the port's ``Dropout`` against Flax's rule (kept elements over the
  keep probability, the others zero), exactly;
* the discriminator through convert.py (``DiscriminatorHead_0/
  _PooledMLPHead_0``), BatchNorm statistics at O(1): the eval forward, and
  the train forward with JAX's dropout masks (read from its captured
  ``Dropout`` outputs) and its new statistics: rtol 5e-4 / atol 5e-5 (the
  whole-model tolerance); its gradient in the input points (through the
  features and through ``rel``, the ``d_rel`` path), held by
  ``utils/grad_check``'s rule: the relative L2 distance from JAX within
  ``NOISE_FACTOR`` times the port's own float32-vs-float64 distance, floor
  ``FULL_PATH_FLOOR``;
* one ``_pretrain_step`` and ``_pretrain_accuracy``, and two ``_update``s
  for each of ``freeze_gen`` 0 and 1 and ``gan_alpha`` 1e-2 and 1e-4,
  from one converted init on the same batches, with JAX's label flips
  (``_update``'s split of the step key) and dropout masks: the metrics
  (rtol 1e-4 at the first update, 1e-3 at the second, after the
  parameters' drift; the accuracy exactly), each parameter's change over
  the updates (SGD, so linear in the gradients) at rtol 1e-3 and an atol
  of 5e-3 of its max-abs at the first update (a train-mode BatchNorm's
  scale gradient cancels to a small part of its terms, test_torch_train.py),
  2e-2 after the second, plus 1e-6 of the block's largest change (a Dense
  bias before a train-mode BatchNorm has a gradient of exactly zero, and
  both packages give it float32 noise), and the BatchNorm statistics at rtol 1e-4 / atol
  2e-5 of each tensor's max-abs (1e-3 after the second update);
* the G-step's backward asks for ``d_rel`` at exactly the discriminator's
  level-0 calls and for no ``d_kernel_weights`` there;
* both entry points through their command lines, and ``--auto_resume``
  after a kill one update into the last epoch bitwise equal to an unbroken
  run, in both blocks.

JAX's ``freeze_generator`` only makes ``_update`` return the generator's
state unchanged (``train/gan.py:213-214``); the D-step and the metrics do
not read it.  So one jitted ``_update`` (of ``freeze_generator=False``)
serves both settings: under ``freeze_gen: 1`` the test keeps the old
generator state, as that branch does, and saves a second compile.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.losses import masked as jax_masked
from deep3dpointclouddenoising_tpu.models import \
    build_discriminator as jax_build_disc
from deep3dpointclouddenoising_tpu.models import \
    build_offset_regression as jax_build_gen
from deep3dpointclouddenoising_tpu.models.layers import \
    masked_global_avg_pool as jax_pool
from deep3dpointclouddenoising_tpu.parallel.mesh import make_mesh
from deep3dpointclouddenoising_tpu.train.gan import GANTrainer as JaxGAN
from deep3dpointclouddenoising_tpu.train.trainer import \
    TrainState as JaxTrainState
from deep3dpointclouddenoising_torch import infer, train_discriminator, \
    train_gan
from deep3dpointclouddenoising_torch.config import default_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.losses.masked import \
    masked_binary_cross_entropy
from deep3dpointclouddenoising_torch.models import DiscriminatorModel
from deep3dpointclouddenoising_torch.models.layers import Dropout, \
    masked_global_avg_pool
from deep3dpointclouddenoising_torch.ops import kpconv as kpconv_ops
from deep3dpointclouddenoising_torch.train.gan import GANTrainer
from deep3dpointclouddenoising_torch.utils import grad_check
from deep3dpointclouddenoising_torch.utils.grad_check import \
    state_difference
from test_torch_resume import Killed, _shape_tree, _tiny_yaml, train_state

# tests/test_gan.py:17-32, with SGD (the GAN configs' optimizer) at a
# learning rate that moves the weights visibly
TINY = dict(num_points=32, width=8, depth=1, radius=0.3, sampleDl=0.08,
            nsamples=[4, 4, 4, 4, 4], npoints=[8, 4, 2, 1],
            local_aggregation_type="pseudo_grid", head="offset_reg_head",
            head_discriminator="discriminator_head", loss="L1",
            optimizer="sgd", base_learning_rate=0.05, momentum=0.9,
            weight_decay=1e-3, lr_scheduler="step", warmup_epoch=-1,
            epochs=4, batch_size=4)
B, N = 4, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """This file's tiny torch ops in one thread: under the Tier-1 command
    six workers share the host's cores, and each worker's default torch
    thread pool made the entry-point tests here a hundred times slower
    than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(**extra):
    jc, tc = jax_cfg(), default_config()
    for c in (jc, tc):
        for k, v in {**TINY, **extra}.items():
            c[k] = v
    jc.use_pallas = 0  # the jnp path, which differentiates through rel
    tc.input_features_dim = 3  # Flax infers it from the input
    return jc, tc


def _batch(rng):
    xyz = rng.random((B, N, 3), dtype=np.float32) * 2 - 1
    mask = np.ones((B, N), np.float32)
    mask[-1, 26:] = 0.0
    xyz[-1, 26:] = xyz[-1, :6]  # padding replicates real points
    return {"points": xyz, "mask": mask, "features": xyz.copy(),
            "offsets": rng.normal(size=(B, N, 3)).astype(np.float32) * 0.02}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _o1_stats(variables, rng):
    """O(1) BatchNorm running statistics (the init's 0 and 1 would let an
    eval-mode error hide)."""
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


def _is_dropout(module, _):
    return isinstance(module, fnn.Dropout)


def jax_keep_masks(jdisc, variables, rng, rows: int):
    """The keep-masks of the JAX discriminator's three Dropouts in a
    train-mode apply with dropout key ``rng`` on ``rows`` clouds: Flax
    draws them from the key, the module path and the shape alone, so any
    input of that shape gives them (an output element is zero where it was
    dropped)."""
    x = np.random.default_rng(7).random((rows, N, 3), dtype=np.float32)
    mask = np.ones((rows, N), np.float32)
    _, state = _capture(jdisc)(variables, x, mask, rng)
    head = state["intermediates"]["DiscriminatorHead_0"]["_PooledMLPHead_0"]
    return [torch.from_numpy(np.asarray(head[f"Dropout_{i}"]["__call__"][0])
                             != 0) for i in range(3)]


_CAPTURE = {}


def _capture(jdisc):
    if id(jdisc) not in _CAPTURE:
        _CAPTURE[id(jdisc)] = jax.jit(lambda v, x, m, r: jdisc.apply(
            v, x, m, x, train=True, rngs={"dropout": r},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=_is_dropout))
    return _CAPTURE[id(jdisc)]


# -- the pool and the loss ----------------------------------------------------

def test_masked_global_avg_pool_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(3, 20, 5)).astype(np.float32)
    mask = (rng.random((3, 20)) > 0.4).astype(np.float32)
    mask[2] = 0.0  # no real point: divided by 1
    want = np.asarray(jax_pool(jnp.asarray(feats), jnp.asarray(mask)))
    got = masked_global_avg_pool(*_t(feats, mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_masked_binary_cross_entropy_matches_jax():
    """JAX ``losses/masked.py:36`` with its clip at eps 1e-7: value and
    gradient, probabilities inside, at and past the clip."""
    rng = np.random.default_rng(1)
    prob = rng.random(40).astype(np.float32)
    prob[:6] = [0.0, 1.0, 1e-9, 1.0 - 1e-9, 1e-7, 0.5]
    target = (rng.random(40) > 0.5).astype(np.float32)
    mask = (rng.random(40) > 0.2).astype(np.float32)
    want, want_g = jax.value_and_grad(jax_masked.masked_binary_cross_entropy)(
        jnp.asarray(prob), jnp.asarray(target), jnp.asarray(mask))
    p, t, m = _t(prob, target, mask)
    p.requires_grad_(True)
    got = masked_binary_cross_entropy(p, t, m)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("how", ["generator", "keep", "eval"])
def test_dropout_is_flax_dropout(how):
    """``layers.Dropout(0.5)``: in train mode the kept elements doubled and
    the others zero, the mask drawn from the given generator (the same
    seed, the same mask) or given; in eval mode the identity."""
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(6, 40)).astype(np.float32))
    layer = Dropout(0.5).train(how != "eval")
    if how == "eval":
        assert layer(x) is x
        return
    if how == "generator":
        out = layer(x, torch.Generator().manual_seed(3))
        again = layer(x, torch.Generator().manual_seed(3))
        assert torch.equal(out, again)
        keep = out != 0
        assert 0.3 < keep.float().mean().item() < 0.7
    else:
        keep = torch.rand(6, 40) < 0.5
        out = layer(x, keep=keep)
    assert torch.equal(out, torch.where(keep, x / 0.5, torch.zeros_like(x)))


# -- the discriminator --------------------------------------------------------

@pytest.fixture(scope="module")
def disc():
    """The JAX discriminator and the port's with the same converted
    weights and O(1) statistics."""
    jc, tc = _configs()
    jdisc, _ = jax_build_disc(jc)
    tdisc = DiscriminatorModel(tc, torch.Generator().manual_seed(0))
    variables = _o1_stats(flax_from_params(tdisc.state_dict()),
                          np.random.default_rng(2))
    # Flax's apply raises on a tree of another structure, so the JAX
    # forwards below also check the converted names
    tdisc.load_state_dict(params_from_flax(variables, tdisc))
    return jdisc, tdisc, variables, _batch(np.random.default_rng(3))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_discriminator_matches_jax(disc, mode):
    jdisc, tdisc, variables, batch = disc
    points, mask = batch["points"], batch["mask"]
    key = jax.random.PRNGKey(4)
    if mode == "eval":
        want = np.asarray(jax.jit(lambda v: jdisc.apply(
            v, points, mask, points, train=False))(variables))
        keep, want_stats = None, None
    else:
        out, mut = jax.jit(lambda v: jdisc.apply(
            v, points, mask, points, train=True, rngs={"dropout": key},
            mutable=["batch_stats"]))(variables)
        want, want_stats = np.asarray(out), _np(mut["batch_stats"])
        keep = jax_keep_masks(jdisc, variables, key, B)
        assert 0 < sum(int(k.sum()) for k in keep) \
            < sum(k.numel() for k in keep)
    model = DiscriminatorModel(tdisc.cfg)
    model.load_state_dict(tdisc.state_dict())
    model.train(mode == "train")
    x, m = _t(points, mask)
    with torch.no_grad():
        got = model(x, m, x, keep_masks=keep).numpy()
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)
    if want_stats is not None:
        stats = flax_from_params(model.state_dict())["batch_stats"]
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(stats),
                jax.tree_util.tree_leaves_with_path(want_stats)):
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=2e-5 * np.abs(b).max(),
                                       err_msg=str(path))


def test_discriminator_input_gradient_matches_jax(disc):
    """The eval-mode discriminator's gradient in its input points (the
    G-step's path: the features and ``rel`` of the level-0 neighbourhoods)
    against ``jax.grad``, by grad_check's rule."""
    jdisc, tdisc, variables, batch = disc
    points, mask = batch["points"], batch["mask"]
    w = np.random.default_rng(5).normal(size=(B, 1)).astype(np.float32)

    def jax_score(p):
        return jnp.sum(jdisc.apply(variables, p, mask, p, train=False) * w)

    want = np.asarray(jax.jit(jax.grad(jax_score))(jnp.asarray(points)))

    def port_grad(model, dtype):
        x, m, wt = (t.to(dtype) for t in _t(points, mask, w))
        x.requires_grad_(True)
        torch.sum(model.eval()(x, m, x) * wt).backward()
        return x.grad

    got = port_grad(tdisc, torch.float32)
    g64 = port_grad(grad_check.float64_copy(tdisc), torch.float64)
    noise = grad_check.l2_distance(got.double(), g64)
    dist = grad_check.l2_distance(got, torch.from_numpy(want.copy()))
    limit = max(grad_check.NOISE_FACTOR * noise, grad_check.FULL_PATH_FLOOR)
    assert np.abs(want).max() > 0 and torch.isfinite(got).all()
    assert dist <= limit, (dist, noise)
    # the gradient takes both ways: without rel's part (the points as
    # features only) it is another gradient
    x, m, wt = _t(points, mask, w)
    f = x.clone().requires_grad_(True)
    torch.sum(tdisc.eval()(x, m, f) * wt).backward()
    assert grad_check.l2_distance(f.grad, got) > 10 * limit


# -- the trainer steps ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_gan():
    """One JAX GANTrainer (``freeze_generator=False``; alpha is an argument
    of its jitted steps) for every case, so each step compiles once."""
    jc, _ = _configs()
    jgen, jloss = jax_build_gen(jc)
    jdisc, _ = jax_build_disc(jc)
    return JaxGAN(jc, jgen, jloss, jdisc, n_iter_per_epoch=4,
                  mesh=make_mesh(1)), jdisc


def _port_trainer(**extra):
    _, tc = _configs(**extra)
    return GANTrainer(tc, 4, torch.Generator().manual_seed(0), "cpu",
                      freeze_generator=bool(tc.freeze_gen))


def _jax_states(jt, tt):
    """JAX states from the port's init, carried by convert.py (Flax's own
    init runs the models eagerly, which takes a minute)."""
    states = []
    for name, tx in (("generator", jt.tx_g), ("discriminator", jt.tx_d)):
        init = flax_from_params(tt.blocks[name].model.state_dict())
        states.append(jax.device_put(JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=init["params"],
            batch_stats=init["batch_stats"],
            opt_state=tx.init(init["params"])), jt._repl))
    return states


def _snapshot(block):
    return {k: v.detach().clone() for k, v in
            block.model.state_dict().items()}


def _check_block(block, want, before, what, change_atol, stats_rtol,
                 stats_atol):
    """A block's parameters (their change from ``before``) and BatchNorm
    statistics against the JAX state ``want``; returns whether JAX moved
    any parameter."""
    sd = _snapshot(block)
    ref = params_from_flax(_np({"params": want.params,
                                "batch_stats": want.batch_stats}))
    names = [n for n, _ in block.model.named_parameters()]
    changes = {n: ((sd[n] - before[n]).numpy(),
                   (ref[n] - before[n]).numpy()) for n in names}
    block_max = max(float(np.abs(w).max()) for _, w in changes.values())
    for name, (d_got, d_want) in changes.items():
        np.testing.assert_allclose(
            d_got, d_want, rtol=1e-3,
            atol=change_atol * float(np.abs(d_want).max())
            + 1e-6 * block_max, err_msg=f"{what} {name}")
    for name, b in ref.items():
        if "running_" in name:
            np.testing.assert_allclose(
                sd[name].numpy(), b.numpy(), rtol=stats_rtol,
                atol=stats_atol * float(np.abs(b.numpy()).max()),
                err_msg=f"{what} {name}")
    return block_max > 0


def _flip_keys(n):
    """``n`` step keys whose ``_update`` flips at least one of the B
    labels, and those flips (``_update``'s split of the key)."""
    out = []
    for i in range(1000):
        key = jax.random.PRNGKey(100 + i)
        r_flip = jax.random.split(key, 4)[2]
        flip = np.asarray(jax.random.uniform(r_flip, (B,))
                          < 0.05)
        if flip.any():
            out.append((key, torch.from_numpy(flip.copy())))
            if len(out) == n:
                return out
    raise AssertionError("too few keys flip a label")


def test_pretrain_step_and_accuracy_match_jax(jax_gan):
    jt, jdisc = jax_gan
    tt = _port_trainer()
    _, ds = _jax_states(jt, tt)
    d = tt.blocks["discriminator"]
    batch = _batch(np.random.default_rng(8))
    key = jax.random.PRNGKey(9)
    keep = jax_keep_masks(jdisc, {"params": ds.params,
                                  "batch_stats": ds.batch_stats}, key, 2 * B)
    before = _snapshot(d)
    ds, jloss = jt._jit_pretrain(ds, jt.shard_batch(batch), key)
    loss = tt.pretrain_step(batch, keep_masks=keep)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert tt.step == 1 and d.step == 1
    assert _check_block(d, ds, before, "pretrain", 5e-3, 1e-4, 2e-5)
    want = float(jt._jit_pretrain_acc(ds, jt.shard_batch(batch)))
    assert tt.pretrain_accuracy(batch).item() == want


@pytest.mark.parametrize("freeze", [0, 1])
@pytest.mark.parametrize("alpha", [1e-2, 1e-4])
def test_two_gan_updates_match_jax(jax_gan, freeze, alpha):
    """Two updates from one init on the same batches, with JAX's flips and
    D-step dropout masks: metrics, both blocks' parameters and BatchNorm
    statistics; under ``freeze_gen: 1`` the generator's whole state (its
    statistics and step included) unchanged."""
    jt, jdisc = jax_gan
    tt = _port_trainer(freeze_gen=freeze, gan_alpha=alpha)
    assert tt.alpha == alpha
    gs, ds = _jax_states(jt, tt)
    rng = np.random.default_rng(10)
    batches = [_batch(rng) for _ in range(2)]
    before = {k: _snapshot(b) for k, b in tt.blocks.items()}
    for i, (batch, (key, flip)) in enumerate(zip(batches, _flip_keys(2))):
        r_d = jax.random.split(key, 4)[1]
        keep = jax_keep_masks(jdisc, {"params": ds.params,
                                      "batch_stats": ds.batch_stats},
                              r_d, 2 * B)
        kept = _np(gs)
        gs, ds, jm = jt._jit_update(gs, ds, jt.shard_batch(batch), key,
                                    jnp.float32(alpha))
        if freeze:  # train/gan.py:213-214
            gs = jax.device_put(kept, jt._repl)
        m = tt.update(batch, flip=flip, keep_masks=keep)
        rtol = 1e-4 if i == 0 else 1e-3
        for k in ("err_d", "err_g1", "err_g2", "err_g"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]),
                                       rtol=rtol, err_msg=k)
        assert m["disc_accuracy"].item() == float(jm["disc_accuracy"])
        atol, stats_rtol = (5e-3, 1e-4) if i == 0 else (2e-2, 1e-3)
        for name, state in (("generator", gs), ("discriminator", ds)):
            moved = _check_block(tt.blocks[name], state, before[name],
                                 f"update {i + 1} {name}", atol,
                                 stats_rtol, 2e-5 if i == 0 else 1e-3)
            assert moved != (freeze and name == "generator")
    assert tt.step == 2
    assert tt.blocks["generator"].step == (0 if freeze else 2)
    if freeze:
        assert not state_difference(_snapshot(tt.blocks["generator"]),
                                    before["generator"])


def test_g_step_asks_d_rel_at_the_level0_calls_only(monkeypatch):
    """The G-step differentiates the discriminator in its input points
    only: its KPConv backwards ask no ``d_kernel_weights``, and ``d_rel``
    exactly where the support set is the level-0 points (the stem,
    Bottleneck_0 and the first strided block); the generator's and the
    D-step's backwards ask for ``d_kernel_weights`` and no ``d_rel``.
    Frozen, only the D-step's backward runs."""
    calls = []
    backward = kpconv_ops.kpconv_aggregate_backward

    def spy(*args):
        calls.append((args[0].shape[1], args[9], args[10], args[11]))
        return backward(*args)

    monkeypatch.setattr(kpconv_ops, "kpconv_aggregate_backward", spy)
    batch = _batch(np.random.default_rng(11))
    for freeze in (0, 1):
        calls.clear()
        _port_trainer(freeze_gen=freeze).update(batch)
        g_step_disc = [c for c in calls if not c[2]]
        rel = [c for c in calls if c[3]]
        assert len(calls) == (18 if not freeze else 6)
        assert len(g_step_disc) == (6 if not freeze else 0)
        assert rel == [c for c in g_step_disc if c[0] == N]
        assert len(rel) == (3 if not freeze else 0)
        assert all(c[1] for c in calls)  # features always


# -- the entry points -----------------------------------------------------------

EXTRA = "num_points_per_shape: 1500\nbatch_size: 4\n"


def _kill_at(monkeypatch, method, step):
    """Make ``GANTrainer.<method>`` end its process, as a kill would, just
    after update ``step``."""
    original = getattr(GANTrainer, method)

    def killed(trainer, batch, *args, **kwargs):
        out = original(trainer, batch, *args, **kwargs)
        if trainer.step == step:
            raise Killed(step)
        return out

    monkeypatch.setattr(GANTrainer, method, killed)


def _resume_check(main, method, common, tmp_path, blocks, monkeypatch,
                  capsys):
    """A run killed one update into epoch 2 and run again with
    ``--auto_resume`` against an unbroken run: both blocks' states and
    checkpoints bitwise equal."""
    straight = main(common + ["--log_dir", str(tmp_path / "straight")])
    per_epoch = straight["steps"] // 2
    assert per_epoch > 0
    log = str(tmp_path / "resumed")
    with monkeypatch.context() as m:
        _kill_at(m, method, per_epoch + 1)
        with pytest.raises(Killed):
            main(common + ["--log_dir", log])
    capsys.readouterr()
    second = main(common + ["--log_dir", log])
    text = capsys.readouterr().out
    assert f"at step {per_epoch} -> start_epoch 2" in text
    assert "epoch 1:" not in text and second["steps"] == straight["steps"]
    for name, sub in blocks.items():
        a = second["trainer"].blocks[name]
        b = straight["trainer"].blocks[name]
        assert not state_difference(train_state(a), train_state(b)), name
        for leaf in ("current.pt", "ckpt_epoch_2.pt"):
            assert not state_difference(
                torch.load(os.path.join(log, sub, leaf), weights_only=True),
                torch.load(os.path.join(tmp_path, "straight", sub, leaf),
                           weights_only=True)), (name, leaf)
    return straight, second, text


def test_train_discriminator_cli_and_auto_resume(tmp_path, capsys,
                                                 monkeypatch):
    common = ["--config_file",
              _tiny_yaml(tmp_path, "synthetic_quality_disc", EXTRA),
              "--data_root", _shape_tree(tmp_path), "--num_steps", "8",
              "--num_points", "64", "--epochs", "2", "--val_freq", "1",
              "--device", "cpu", "--auto_resume"]
    straight, second, text = _resume_check(
        train_discriminator.main, "pretrain_step", common, tmp_path,
        {"discriminator": "synthetic_quality_disc"}, monkeypatch, capsys)
    assert straight["restored"] is None
    assert len(straight["val_accuracy"]) == 2 and "val [2] accuracy" in text
    assert all(0.0 <= a <= 1.0 for a in straight["val_accuracy"])
    assert np.isfinite(straight["train_losses"]).all()
    assert second["val_accuracy"] == straight["val_accuracy"][1:]


def test_train_gan_cli_and_auto_resume(tmp_path, capsys, monkeypatch):
    """``--load_path_generator`` / ``--load_path_discriminator`` take
    weights (a train-entry-point-style state_dict and the discriminator
    entry point's checkpoint); ``--auto_resume`` takes precedence once the
    run has checkpoints; ``infer.load_model`` reads the generator's."""
    data = _shape_tree(tmp_path)
    disc_yaml = _tiny_yaml(tmp_path, "synthetic_quality_disc", EXTRA)
    train_discriminator.main(
        ["--config_file", disc_yaml, "--data_root", data, "--num_steps",
         "8", "--num_points", "64", "--epochs", "1", "--device", "cpu",
         "--log_dir", str(tmp_path / "disc")])
    disc_ckpt = str(tmp_path / "disc" / "synthetic_quality_disc" /
                    "current.pt")
    gan_yaml = _tiny_yaml(tmp_path, "synthetic_quality_gan_tuned", EXTRA)
    cfg = train_gan._train_cli.load_config(gan_yaml, {"num_points": 64})
    donor = infer.load_model(cfg, "cpu", seed=5)
    gen_ckpt = str(tmp_path / "gen.pt")
    torch.save(donor.state_dict(), gen_ckpt)
    common = ["--config_file", gan_yaml, "--data_root", data,
              "--num_steps", "8", "--num_points", "64", "--epochs", "2",
              "--device", "cpu", "--auto_resume", "--load_path_generator",
              gen_ckpt, "--load_path_discriminator", disc_ckpt]
    exp = "synthetic_quality_gan_tuned"
    straight, second, text = _resume_check(
        train_gan.main, "update", common, tmp_path,
        {"generator": f"{exp}/generator",
         "discriminator": f"{exp}/discriminator"}, monkeypatch, capsys)
    assert straight["restored"] == {"generator": gen_ckpt,
                                    "discriminator": disc_ckpt}
    assert second["restored"]["generator"].endswith(
        os.path.join(exp, "generator", "current.pt"))
    for k, values in straight["metrics"].items():
        assert len(values) == straight["steps"] and np.isfinite(values).all()
    ckpt = os.path.join(tmp_path, "resumed", exp, "generator", "current.pt")
    served = infer.load_model(cfg, "cpu", ckpt)
    assert not state_difference(
        served.state_dict(),
        second["trainer"].blocks["generator"].model.state_dict())

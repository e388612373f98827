"""Full-state resume in the port, on the CPU: ``utils/checkpoint.py``
(``load_checkpoint``, ``load_weights``, ``latest_epoch_checkpoint``) and the
training entry points' ``--load_path`` / ``--load_weights_path`` /
``--auto_resume`` with ``scripts/train.py``'s precedence (:167-197).

A resumed run must repeat an unbroken one bitwise: parameters, BatchNorm
buffers, Adam's moments and step counts, the update count the LR schedule
reads, and the LR.  No tolerance is needed on the CPU, where every op of a
train step is deterministic; these tests import no JAX.
"""
import os

import numpy as np
import pytest
import torch

from deep3dpointclouddenoising_torch import train_full_cleaning, \
    train_outlier_seg
from deep3dpointclouddenoising_torch.config import default_config
from deep3dpointclouddenoising_torch.data.meshio import save_off
from deep3dpointclouddenoising_torch.data.scans import make_scans
from deep3dpointclouddenoising_torch.data.synthetic import make_icosphere, \
    make_torus
from deep3dpointclouddenoising_torch.train import __main__ as train_cli
from deep3dpointclouddenoising_torch.train.trainer import Trainer
from deep3dpointclouddenoising_torch.utils.checkpoint import (
    latest_epoch_checkpoint, load_checkpoint, load_weights, save_checkpoint)
from deep3dpointclouddenoising_torch.utils.grad_check import \
    state_difference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = os.path.join(ROOT, "cfgs")

# tests/test_torch_train.py's tiny model; the step schedule decays once
# per update at one step per epoch, so a lost count moves the LR
TINY = dict(num_points=64, width=16, depth=2, radius=0.2, sampleDl=0.05,
            nsamples=[8, 8, 8, 8, 8], npoints=[16, 8, 4, 2],
            local_aggregation_type="pseudo_grid", head="offset_reg_head",
            loss="L1", optimizer="adam", base_learning_rate=1e-3,
            lr_scheduler="step", warmup_epoch=-1, epochs=10, batch_size=4,
            weight_decay=1e-3, lr_decay_steps=1, lr_decay_rate=0.5)
STEPS_PER_EPOCH = 1


def _cfg(**extra):
    cfg = default_config()
    for k, v in {**TINY, **extra}.items():
        cfg[k] = v
    cfg.input_features_dim = 3
    return cfg


def _batches(n, seed=3, B=4, N=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xyz = rng.random((B, N, 3), dtype=np.float32) * 2 - 1
        mask = np.ones((B, N), np.float32)
        mask[-1, 50:] = 0.0
        xyz[-1, 50:] = xyz[-1, :14]
        out.append({"points": xyz, "mask": mask, "features": xyz.copy(),
                    "offsets": rng.normal(size=(B, N, 3)).astype(
                        np.float32) * 0.02})
    return out


def _trainer(cfg, seed=0):
    return Trainer(cfg, STEPS_PER_EPOCH, torch.Generator().manual_seed(seed),
                   "cpu")


def train_state(trainer):
    """Everything a resumed run must carry: the model's state_dict, Adam's
    per-parameter state, the update count and each group's LR."""
    state = {"model/" + k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()}
    opt = trainer.optimizer.optimizer
    for i, p in enumerate(trainer.optimizer.params):
        for k, v in opt.state.get(p, {}).items():
            state[f"adam/{i}/{k}"] = v.clone()
    state["count"] = trainer.optimizer.count
    state["lr"] = [g["lr"] for g in opt.param_groups]
    return state


class Killed(Exception):
    """Stands for the end of a training process killed mid-epoch."""


def kill_at_step(monkeypatch, step):
    """Make every Trainer end its process, as a kill would, just after its
    update ``step``."""
    train_step = Trainer.train_step

    def killed_step(trainer, batch):
        loss = train_step(trainer, batch)
        if trainer.step == step:
            raise Killed(step)
        return loss

    monkeypatch.setattr(Trainer, "train_step", killed_step)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_resumed_steps_equal_straight_steps_bitwise(tmp_path, compute_dtype):
    """Four straight steps against two, a save, a restore into a trainer
    built afresh from another seed, and two more."""
    cfg = _cfg(compute_dtype=compute_dtype)
    batches = _batches(4)
    straight = _trainer(cfg)
    for b in batches:
        straight.train_step(b)
    first = _trainer(cfg)
    for b in batches[:2]:
        first.train_step(b)
    path = save_checkpoint(str(tmp_path / "half.pt"), first.model,
                           first.optimizer, first.step)
    del first
    torch.manual_seed(123)  # no state may come from the global generator
    resumed = _trainer(cfg, seed=7)
    assert not torch.equal(
        resumed.model.MultiDimHead_0.Dense_0.weight,
        straight.model.MultiDimHead_0.Dense_0.weight)
    assert load_checkpoint(path, resumed) == 2
    for b in batches[2:]:
        resumed.train_step(b)
    got, want = train_state(resumed), train_state(straight)
    assert want["count"] == 4 and want["lr"] == [
        straight.lr_schedule(3)] == [1e-3 * 0.5 ** 3]
    assert any(k.startswith("adam/") for k in want)
    assert not state_difference(got, want)


def _checkpoints(tmp_path):
    """A trainer's checkpoints after one, two and three steps."""
    cfg = _cfg()
    trainer = _trainer(cfg)
    paths = []
    for i, b in enumerate(_batches(3), start=1):
        trainer.train_step(b)
        paths.append(save_checkpoint(str(tmp_path / f"step{i}.pt"),
                                     trainer.model, trainer.optimizer,
                                     trainer.step))
    return cfg, paths


def _model_state(path):
    return torch.load(path, weights_only=True)["model"]


@pytest.mark.parametrize("case", [
    "load_path_first", "auto_resume_over_weights", "weights_without_ckpt",
    "auto_resume_epoch_fallback", "nothing_to_resume"])
def test_restore_run_precedence(tmp_path, case):
    """scripts/train.py:167-197: --load_path first; --load_weights_path
    unless --auto_resume finds a checkpoint; --auto_resume prefers
    current.pt, then the newest ckpt_epoch_<E>.pt, and sets start_epoch to
    the epoch after the restored step's."""
    cfg, (w1, p2, c3) = _checkpoints(tmp_path)
    run = tmp_path / "run"
    run.mkdir()
    cfg.start_epoch = 5
    weights, auto = None, False
    if case == "load_path_first":
        cfg.load_path = p2
        os.replace(c3, run / "current.pt")
        weights, auto = w1, True
        want_path, want_step, want_start = p2, 2, 5
    elif case == "auto_resume_over_weights":
        os.replace(c3, run / "current.pt")
        weights, auto = w1, True
        want_path, want_step, want_start = str(run / "current.pt"), 3, 4
    elif case == "weights_without_ckpt":
        weights, auto = w1, True
        want_path, want_step, want_start = w1, 0, 5
    elif case == "auto_resume_epoch_fallback":
        os.replace(p2, run / "ckpt_epoch_2.pt")
        os.replace(w1, run / "ckpt_epoch_1.pt")
        auto = True
        want_path, want_step, want_start = str(run / "ckpt_epoch_2.pt"), 2, 3
    else:
        auto = True
        want_path, want_step, want_start = None, 0, 5
    trainer = _trainer(cfg, seed=9)
    before = train_state(trainer)
    got = train_cli.restore_run(trainer, cfg, str(run), STEPS_PER_EPOCH,
                                weights, auto)
    assert got == want_path
    assert trainer.step == want_step
    assert int(cfg.start_epoch) == want_start
    if want_path is None:
        assert not state_difference(train_state(trainer), before)
        return
    assert not state_difference(trainer.model.state_dict(),
                                _model_state(want_path))
    if case == "weights_without_ckpt":  # a fresh optimizer and schedule
        assert not any(trainer.optimizer.optimizer.state.values())
        assert trainer.lr_schedule(trainer.step) == 1e-3
    else:
        assert not state_difference(
            trainer.optimizer.state_dict(),
            torch.load(want_path, weights_only=True)["optimizer"])


def test_load_checkpoint_refuses_a_bare_state_dict(tmp_path):
    cfg = _cfg()
    trainer = _trainer(cfg)
    path = str(tmp_path / "bare.pt")
    torch.save(trainer.model.state_dict(), path)
    with pytest.raises(ValueError, match="weights only"):
        load_checkpoint(path, trainer)
    other = _trainer(cfg, seed=4)
    load_weights(path, other)
    assert not state_difference(other.model.state_dict(),
                                trainer.model.state_dict())


def test_latest_epoch_checkpoint_and_its_fallback(tmp_path):
    assert latest_epoch_checkpoint(str(tmp_path / "absent")) is None
    assert latest_epoch_checkpoint(str(tmp_path)) is None
    (tmp_path / "current.pt").write_bytes(b"")
    assert latest_epoch_checkpoint(str(tmp_path)) == \
        str(tmp_path / "current.pt")
    for name in ("ckpt_epoch_2.pt", "ckpt_epoch_10.pt", "ckpt_epoch_9.pt",
                 "ckpt_epoch_11.pt.123.tmp", "ckpt_epoch_x.pt"):
        (tmp_path / name).write_bytes(b"")
    # numerically newest, not by name; temporary files are no checkpoints
    assert latest_epoch_checkpoint(str(tmp_path)) == \
        str(tmp_path / "ckpt_epoch_10.pt")


# -- the entry points ---------------------------------------------------------

def _shape_tree(tmp_path):
    root = tmp_path / "data"
    for split in ("train", "val"):
        (root / split).mkdir(parents=True)
        save_off(str(root / split / "sphere.off"), make_icosphere(2))
    save_off(str(root / "train" / "torus.off"), make_torus())
    return str(root)


def _tiny_yaml(tmp_path, config, extra):
    with open(os.path.join(CFGS, config + ".yaml")) as f:
        text = f.read().replace("width: 144", "width: 8")
    path = tmp_path / f"tiny_{config}.yaml"
    path.write_text(text + extra)
    return str(path)


ENTRY_POINTS = {
    # name: (main, config, experiment, extra yaml, extra flags)
    "train_l1": (train_cli.main, "l1", "l1_diverse",
                 "num_points_per_shape: 1500\nbatch_size: 4\n", []),
    "train_bf16": (train_cli.main, "synthetic_quality_diverse_bf16",
                   "synthetic_quality_diverse_bf16",
                   "num_points_per_shape: 1500\nbatch_size: 4\n", []),
    "train_full_cleaning": (
        train_full_cleaning.main, "synthetic_quality_cleaning",
        "synthetic_quality_cleaning",
        "num_points_per_shape: 3000\nsample_Dl_patches: 0.4\n"
        "batch_size: 4\n", []),
    "train_outlier_seg": (train_outlier_seg.main, "outlier_seg_edf",
                          "outlier_seg_edfs", "batch_size: 8\n",
                          ["--DEBUG", "1"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_auto_resume_through_the_entry_points(tmp_path, capsys, monkeypatch,
                                              entry):
    """Each training entry point at width 8: a run with ``--auto_resume``
    killed one update into epoch 2 (after epoch 1's checkpoint) and run
    again ends in the state and the checkpoints of an unbroken two-epoch
    run, bitwise."""
    main, config, experiment, extra, flags = ENTRY_POINTS[entry]
    if entry == "train_outlier_seg":
        data = str(tmp_path / "scans")
        make_scans(data, n=400, diameter=1.0, cut=(11, 12),
                   corner=(0.0, 0.0, 0.0))
    else:
        data = _shape_tree(tmp_path)
    common = ["--config_file", _tiny_yaml(tmp_path, config, extra),
              "--data_root", data, "--num_steps", "8", "--num_points", "64",
              "--epochs", "2", "--val_freq", "2", "--device", "cpu",
              "--auto_resume"] + flags
    straight = main(common + ["--log_dir", str(tmp_path / "straight")])
    assert straight["restored"] is None
    per_epoch = straight["steps"] // 2
    assert per_epoch > 0
    log = str(tmp_path / "resumed")
    with monkeypatch.context() as m:
        kill_at_step(m, per_epoch + 1)
        with pytest.raises(Killed):
            main(common + ["--log_dir", log])
    capsys.readouterr()
    second = main(common + ["--log_dir", log])
    text = capsys.readouterr().out
    current = os.path.join(log, experiment, "current.pt")
    assert second["restored"] == current
    assert f"auto-resumed from {current} at step {per_epoch} -> " \
           "start_epoch 2" in text
    assert "val [2] loss" in text and "epoch 1:" not in text
    assert second["steps"] == straight["steps"]
    assert not state_difference(train_state(second["trainer"]),
                                train_state(straight["trainer"]))
    for name in ("current.pt", "ckpt_epoch_2.pt"):
        assert not state_difference(
            torch.load(os.path.join(log, experiment, name),
                       weights_only=True),
            torch.load(os.path.join(tmp_path, "straight", experiment, name),
                       weights_only=True)), name


def test_load_weights_path_warm_starts_through_the_cli(tmp_path, capsys):
    """--load_weights_path takes a checkpoint's weights under a fresh
    optimizer; with --auto_resume and a checkpoint of the run it is
    ignored."""
    main, config, experiment, extra, _ = ENTRY_POINTS["train_l1"]
    common = ["--config_file", _tiny_yaml(tmp_path, config, extra),
              "--data_root", _shape_tree(tmp_path), "--num_steps", "8",
              "--num_points", "64", "--epochs", "1", "--val_freq", "5",
              "--device", "cpu"]
    donor = main(common + ["--log_dir", str(tmp_path / "donor")])
    weights = os.path.join(tmp_path, "donor", experiment, "current.pt")
    log = str(tmp_path / "warm")
    capsys.readouterr()
    warm = main(common + ["--log_dir", log, "--load_weights_path", weights,
                          "--auto_resume"])
    assert warm["restored"] == weights
    assert "warm-started weights from" in capsys.readouterr().out
    # a fresh optimizer: the same number of updates as the donor's run
    assert warm["steps"] == donor["steps"]
    again = main(common + ["--log_dir", log, "--load_weights_path", weights,
                           "--auto_resume"])
    assert again["restored"] == os.path.join(log, experiment, "current.pt")
    assert again["steps"] == warm["steps"]  # nothing left to run

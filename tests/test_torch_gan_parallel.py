"""Data-parallel GAN training (``train/gan.py`` inside a process group) on
the CPU.

Two gloo ranks, started from a ``spawn`` context and joined through a
``file://`` store under the test's ``tmp_path``, run every multi-rank case
in one job, one torch thread each; this module imports no JAX, so the
ranks load torch and the port alone (checked).
``tests/test_torch_gan.py`` holds the one-process ``GANTrainer`` to JAX's;
here W=2 ranks, each on its ``process_slice`` of every global batch, are
held to one process on the global batch, at tests/test_torch_gan.py's tiny
size under Adam:

* two GAN updates (``freeze_gen`` 0 and 1) with the draws of
  ``step_generator`` (label flips and dropout masks drawn for the global
  batch, each rank taking its rows), and two pre-training steps and the
  pre-training accuracy: metrics at rtol 1e-4, parameters within 6 * lr,
  the ranks' states bitwise equal;
* the checks shown to fail with per-rank BCE denominators (each rank's
  own mean, summed by the gradient hook) and with per-rank flip draws
  (each rank drawing its own rows' flips);
* ``train_discriminator`` and ``train_gan`` with ``--multihost``: only rank
  0 writes ``log.txt``, ``metrics.jsonl`` and the checkpoints, the ranks
  end bitwise equal, and a ``train_gan`` run killed one update into epoch
  2 and run again with ``--auto_resume`` ends bitwise where the unbroken
  run does.
"""
import contextlib
import io
import json
import multiprocessing
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deep3dpointclouddenoising_torch import train_discriminator, train_gan
from deep3dpointclouddenoising_torch.config import default_config
from deep3dpointclouddenoising_torch.losses import masked
from deep3dpointclouddenoising_torch.parallel import dist as pdist
from deep3dpointclouddenoising_torch.train import __main__ as train_cli
from deep3dpointclouddenoising_torch.train.gan import (FLIP_STREAM,
                                                       LABEL_FLIP_P,
                                                       GANTrainer,
                                                       step_generator)
from deep3dpointclouddenoising_torch.utils.grad_check import \
    state_difference
from test_torch_resume import Killed, _shape_tree, _tiny_yaml, train_state

WORLD = 2
JOB_TIMEOUT_S = 600
# tests/test_torch_gan.py's tiny size, under Adam.  Adam turns gradients
# that differ by float32 rounding (the ranks' sums run in another order)
# into steps that differ by up to 2 * lr, and the D-step's step moves the
# next update's metrics: at lr 1e-3 the second update's err_g1 moved by
# 2.3e-4 relative, at lr 1e-4 it stays well inside METRIC_RTOL
TINY = dict(num_points=32, width=8, depth=1, radius=0.3, sampleDl=0.08,
            nsamples=[4, 4, 4, 4, 4], npoints=[8, 4, 2, 1],
            local_aggregation_type="pseudo_grid", head="offset_reg_head",
            head_discriminator="discriminator_head", loss="L1",
            optimizer="adam", base_learning_rate=1e-4, weight_decay=1e-3,
            lr_scheduler="step", warmup_epoch=-1, epochs=4, batch_size=4,
            gan_alpha=1e-2)
B, N = 4, 32
# real points of the global batch's clouds: rank 1's rows hold fewer, so
# a per-rank mean of the task loss weighs its points unlike the global one
REAL_POINTS = (32, 30, 20, 12)
UPDATES = 2
METRIC_RTOL = 1e-4
EXPERIMENTS = {"discriminator": "synthetic_quality_disc",
               "gan": "synthetic_quality_gan_tuned"}


def flip_seed() -> int:
    """The first ``rng_seed`` whose first update flips a label of rank 1's
    rows in the global draw unlike a draw of rank 1's rows alone, so that
    per-rank flip draws change the G-step."""
    for seed in range(10000):
        whole = torch.rand(B, generator=step_generator(seed, 0, FLIP_STREAM))
        own = torch.rand(B // WORLD, generator=step_generator(
            seed, 0, FLIP_STREAM))
        rows = pdist.process_slice(B, 1, WORLD)
        if ((whole[rows] < LABEL_FLIP_P) != (own < LABEL_FLIP_P)).any():
            return seed
    raise AssertionError("no seed flips rank 1's rows")


def _cfg(**extra):
    cfg = default_config()
    for k, v in {**TINY, "rng_seed": flip_seed(), **extra}.items():
        cfg[k] = v
    cfg.input_features_dim = 3
    return cfg


def _batch(rng):
    xyz = rng.random((B, N, 3), dtype=np.float32) * 2 - 1
    mask = np.zeros((B, N), np.float32)
    for r, k in enumerate(REAL_POINTS):
        mask[r, :k] = 1.0
        xyz[r, k:] = xyz[r, np.arange(N - k) % k]
    return {"points": xyz, "mask": mask, "features": xyz.copy(),
            "offsets": rng.normal(size=(B, N, 3)).astype(np.float32) * 0.02}


def _batches(seed=7, n=UPDATES):
    rng = np.random.default_rng(seed)
    return [_batch(rng) for _ in range(n)]


def _rows(batch, rank, world):
    sl = pdist.process_slice(len(batch["points"]), rank, world)
    return {k: v[sl] for k, v in batch.items()}


def _blocks(trainer):
    return {name: train_state(block) for name, block in
            trainer.blocks.items()}


def _updates(rank, world, freeze, flips=None):
    """``UPDATES`` updates from generator seed 0's init on this rank's
    rows; ``flips`` (per update) replaces the trainer's own draws."""
    tt = GANTrainer(_cfg(freeze_gen=freeze), 10,
                    torch.Generator().manual_seed(0), "cpu",
                    freeze_generator=bool(freeze))
    init = _blocks(tt)
    metrics = []
    for i, b in enumerate(_batches()):
        flip = None if flips is None else flips[i]
        m = tt.update(_rows(b, rank, world), flip=flip)
        metrics.append({k: v.item() for k, v in m.items()})
    return {"metrics": metrics, "init": init, "state": _blocks(tt),
            "steps": (tt.blocks["generator"].step, tt.step)}


def _pretrain(rank, world):
    tt = GANTrainer(_cfg(), 10, torch.Generator().manual_seed(0), "cpu")
    losses = [tt.pretrain_step(_rows(b, rank, world)).item()
              for b in _batches()]
    acc = tt.pretrain_accuracy(_rows(_batches(seed=9, n=1)[0], rank, world))
    return {"losses": losses, "accuracy": acc.item(),
            "state": {"discriminator": train_state(
                tt.blocks["discriminator"])}}


def _own_flips(seed):
    """Each rank's flips drawn for its own rows alone (the mutant)."""
    return [torch.rand(B // WORLD, generator=step_generator(
        seed, step, FLIP_STREAM)) < LABEL_FLIP_P for step in range(UPDATES)]


def _numerics(rank, world):
    out = {"jax_loaded": "jax" in sys.modules,
           "updates": {f: _updates(rank, world, f) for f in (0, 1)},
           "pretrain": _pretrain(rank, world), "mutants": {}}
    kept = masked.global_sum
    masked.global_sum = lambda x: x
    try:
        out["mutants"]["per-rank BCE denominators"] = _updates(
            rank, world, 0)
    finally:
        masked.global_sum = kept
    out["mutants"]["per-rank flip draws"] = _updates(
        rank, world, 0, _own_flips(_cfg().rng_seed))
    return out


def cli_argv(job, name, log_dir, *extra):
    """Two epochs of 2 steps at width 8 on the job's shape tree."""
    return ["--config_file", job[name], "--data_root", job["tree"],
            "--num_steps", "8", "--num_points", "64", "--epochs", "2",
            "--val_freq", "1", "--device", "cpu", "--auto_resume",
            "--multihost", "--log_dir", log_dir, *extra]


def _cli(job):
    """``train_discriminator`` and then ``train_gan`` from its checkpoint,
    with --multihost; ``train_gan`` again killed one update into epoch 2
    and resumed; stdout and checkpoint writes recorded."""
    writes = []
    save = train_cli.save_checkpoint

    def counted_save(path, *args):
        writes.append(os.path.relpath(path, job["out"]))
        return save(path, *args)

    train_cli.save_checkpoint = counted_save
    out, text = {}, io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            disc = train_discriminator.main(cli_argv(
                job, "disc_config", job["disc_log"]))
            out["disc"] = {"state": train_state(
                disc["trainer"].blocks["discriminator"]),
                "losses": disc["train_losses"],
                "accuracy": disc["val_accuracy"]}
            gan_argv = lambda log: cli_argv(  # noqa: E731
                job, "gan_config", log, "--load_path_discriminator",
                disc["checkpoint"])
            straight = train_gan.main(gan_argv(job["straight"]))
            out["straight"] = {"state": _blocks(straight["trainer"]),
                               "metrics": straight["metrics"],
                               "steps": straight["steps"]}
            update = GANTrainer.update

            def killed(trainer, batch, *args, **kwargs):
                m = update(trainer, batch, *args, **kwargs)
                if trainer.step == straight["steps"] // 2 + 1:
                    raise Killed(trainer.step)
                return m

            GANTrainer.update = killed
            try:
                train_gan.main(gan_argv(job["resumed"]))
            except Killed:
                pass
            finally:
                GANTrainer.update = update
            resumed = train_gan.main(gan_argv(job["resumed"]))
            out["resumed"] = {"state": _blocks(resumed["trainer"]),
                              "restored": resumed["restored"]}
    finally:
        train_cli.save_checkpoint = save
    out.update(stdout=text.getvalue(), writes=writes)
    return out


def rank_main(rank, world, init_file, job):
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = {"numerics": _numerics(rank, world)}
        t1 = time.perf_counter()
        out["cli"] = _cli(job)
        out["seconds"] = (t1 - t0, time.perf_counter() - t1)
        torch.save(out, os.path.join(job["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 2-rank job, started; yields a function that waits for it and
    returns each rank's results and the job's paths."""
    tmp = tmp_path_factory.mktemp("gan_parallel")
    extra = "num_points_per_shape: 1500\nbatch_size: 4\n"
    spec = {"tree": _shape_tree(tmp),
            "disc_config": _tiny_yaml(tmp, EXPERIMENTS["discriminator"],
                                      extra),
            "gan_config": _tiny_yaml(tmp, EXPERIMENTS["gan"], extra),
            "disc_log": str(tmp / "disc"), "straight": str(tmp / "straight"),
            "resumed": str(tmp / "resumed"), "out": str(tmp)}
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, WORLD, str(tmp / "store"), spec))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    results = []

    def wait():
        if not results:
            deadline = time.monotonic() + JOB_TIMEOUT_S
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join()
            assert not alive, f"ranks past {JOB_TIMEOUT_S} s"
            assert [p.exitcode for p in procs] == [0] * WORLD, \
                [p.exitcode for p in procs]
            results.extend(torch.load(str(tmp / f"rank{r}.pt"),
                                      weights_only=False)
                           for r in range(WORLD))
        return results, spec

    yield wait
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


@pytest.fixture(scope="module")
def one_process(job):
    """The same updates and pre-training in this process on the global
    batches (while the ranks run)."""
    return {"updates": {f: _updates(0, 1, f) for f in (0, 1)},
            "pretrain": _pretrain(0, 1)}


def _check_params(got, want, lr, what):
    """Every parameter within 6 * lr of the one-process run's (Adam moves
    an element by about lr a step whatever its gradient's size)."""
    for block, state in want.items():
        for name, value in state.items():
            if not name.startswith("model/") or "running_" in name \
                    or "num_batches" in name:
                continue
            np.testing.assert_allclose(
                got[block][name].numpy(), value.numpy(), atol=6.0 * lr,
                rtol=0, err_msg=f"{what} {block} {name}")


def _check_updates(run, one, what):
    """The metrics of every update at rtol 1e-4 (the accuracy exactly)
    and the parameters after them within 6 * lr."""
    for got, want in zip(run["metrics"], one["metrics"]):
        for k in ("err_d", "err_g1", "err_g2", "err_g"):
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                       err_msg=f"{what} {k}")
        assert got["disc_accuracy"] == want["disc_accuracy"], what
    _check_params(run["state"], one["state"],
                  TINY["base_learning_rate"], what)


@pytest.mark.parametrize("freeze", [0, 1])
def test_two_rank_updates_equal_the_one_process_updates(job, one_process,
                                                        freeze):
    """Both ranks start from the one-process init, take its metrics and
    end within 6 * lr of its parameters, bitwise equal to each other; a
    frozen generator stays bitwise where it started."""
    ranks, _ = job()
    one = one_process["updates"][freeze]
    for r in ranks:
        run = r["numerics"]["updates"][freeze]
        for block in one["init"]:
            assert not state_difference(run["init"][block],
                                        one["init"][block]), block
        assert run["steps"] == one["steps"] == (0 if freeze else UPDATES,
                                                UPDATES)
        _check_updates(run, one, f"rank {freeze}")
        if freeze:
            assert not state_difference(run["state"]["generator"],
                                        run["init"]["generator"])
    a, b = (r["numerics"]["updates"][freeze] for r in ranks)
    assert a["metrics"] == b["metrics"]
    for block in a["state"]:
        assert not state_difference(a["state"][block], b["state"][block])


def test_two_rank_pretraining_equals_one_process(job, one_process):
    ranks, _ = job()
    one = one_process["pretrain"]
    for r in ranks:
        run = r["numerics"]["pretrain"]
        np.testing.assert_allclose(run["losses"], one["losses"],
                                   rtol=METRIC_RTOL)
        assert run["accuracy"] == one["accuracy"]
        _check_params(run["state"], one["state"],
                      TINY["base_learning_rate"], "pretraining")
    assert not state_difference(
        ranks[0]["numerics"]["pretrain"]["state"]["discriminator"],
        ranks[1]["numerics"]["pretrain"]["state"]["discriminator"])


@pytest.mark.parametrize("mutant", ["per-rank BCE denominators",
                                    "per-rank flip draws"])
def test_the_checks_catch_a_per_rank_reduction_or_draw(job, one_process,
                                                      mutant):
    ranks, _ = job()
    for r in ranks:
        with pytest.raises(AssertionError):
            _check_updates(r["numerics"]["mutants"][mutant],
                           one_process["updates"][0], mutant)


def test_ranks_import_no_jax(job):
    ranks, _ = job()
    assert [r["numerics"]["jax_loaded"] for r in ranks] == [False, False]
    print("rank seconds (numerics, CLI):",
          [tuple(round(s, 1) for s in r["seconds"]) for r in ranks])


def test_cli_only_the_coordinator_writes(job):
    """Rank 0 writes both entry points' checkpoints, ``log.txt`` and
    ``metrics.jsonl``; rank 1 writes nothing and logs under ``[rank 1]``;
    the ranks end bitwise equal."""
    ranks, spec = job()
    r0, r1 = ranks[0]["cli"], ranks[1]["cli"]
    assert r1["writes"] == []
    disc = os.path.join("disc", EXPERIMENTS["discriminator"])
    gan = os.path.join("straight", EXPERIMENTS["gan"])
    for leaf in ("current.pt", "ckpt_epoch_2.pt"):
        assert os.path.join(disc, leaf) in r0["writes"]
        for block in ("generator", "discriminator"):
            assert os.path.join(gan, block, leaf) in r0["writes"]
    lines = [l for l in r1["stdout"].splitlines() if l.strip()]
    assert lines and all(l.startswith("[rank 1] ") for l in lines)
    assert "[rank 1] data parallel: rank 1 of 2 (gloo), rows 2-3 of each " \
           "global batch of 4" in lines
    assert "[rank" not in r0["stdout"]
    for run, tags in ((disc, ("train/loss", "val/accuracy")),
                      (gan, tuple(f"train/{k}" for k in (
                          "err_g", "err_g1", "err_g2", "err_d",
                          "disc_accuracy")))):
        path = os.path.join(spec["out"], run)
        with open(os.path.join(path, "log.txt")) as f:
            log = f.read()
        assert "[rank 1]" not in log and "rank 0 of 2" in log
        with open(os.path.join(path, "metrics.jsonl")) as f:
            got = sorted((m["tag"], m["step"]) for m in map(json.loads, f))
        assert got == sorted((t, e) for t in tags for e in (1, 2))
    assert not state_difference(r0["disc"]["state"], r1["disc"]["state"])
    assert r0["disc"]["losses"] == r1["disc"]["losses"]
    assert r0["straight"]["metrics"] == r1["straight"]["metrics"]
    for block in r0["straight"]["state"]:
        assert not state_difference(r0["straight"]["state"][block],
                                    r1["straight"]["state"][block])
    assert np.isfinite(r0["disc"]["losses"]).all()
    assert all(np.isfinite(v).all() for v in
               r0["straight"]["metrics"].values())


def test_cli_gan_resume_reproduces_the_unbroken_run(job):
    """Killed one update into epoch 2 and run again with --auto_resume,
    each rank ends bitwise where the unbroken run ended, in both
    blocks."""
    ranks, spec = job()
    run = os.path.join(spec["resumed"], EXPERIMENTS["gan"])
    for r in ranks:
        cli = r["cli"]
        assert cli["resumed"]["restored"] == {
            b: os.path.join(run, b, "current.pt")
            for b in ("generator", "discriminator")}
        for block in cli["straight"]["state"]:
            assert not state_difference(cli["resumed"]["state"][block],
                                        cli["straight"]["state"][block])
    assert "auto-resumed from" in ranks[1]["cli"]["stdout"]

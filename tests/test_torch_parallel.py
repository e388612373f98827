"""Data parallelism of the port (``parallel/dist.py``) on the CPU.

Two gloo ranks, started from a ``spawn`` context and joined through a
``file://`` store under the test's ``tmp_path`` (no port, so concurrent
test workers cannot collide), run every multi-rank case in one job: this
module imports no JAX at its top, so the ranks, which import it to find
their entry function, load torch and the port alone (checked); JAX runs in
this process, while the ranks work.  One torch thread per rank.

* the helpers without a group: identities, rank 0 of 1, no-op barriers,
  ``initialize_distributed`` a no-op without torchrun's environment and
  NCCL refused without a card (``tests/test_multihost.py:18-30,111-118``);
  ``process_slice``'s error; the loader's rank rows against the global
  batch;
* ``ChannelsLastBatchNorm`` across 2 ranks against one process on the
  concatenated batch: output, input and parameter gradients, running
  statistics (equal on both ranks);
* the losses of the three modes (offset L1, Chamfer-L1 and the adaptive
  Chamfer loss, which is not linear in the batch; the three cleaning
  losses; the segmentation cross-entropy) on rows whose real-point counts
  differ by rank: the shares sum to the one-process loss and their
  gradients are its gradients;
* the offset ``Trainer`` on 2 ranks against the JAX ``Trainer`` on
  ``make_mesh(2)`` from one converted init (``tests/test_trainer.py:73-144``):
  3 Adam steps, losses at rtol 2e-3 and parameters at 6 * lr; one SGD step
  whose recovered gradient agrees at atol 2e-5; the ranks' parameters
  bitwise equal; ``remat`` under DDP; and the same checks shown to fail
  with a local-statistics BatchNorm and with per-rank loss denominators;
* the train CLI with ``--multihost`` on 2 ranks (2 epochs of 2 steps):
  only rank 0 writes ``log.txt``, ``metrics.jsonl`` and checkpoints, rank
  1 logs under ``[rank 1]``, the checkpoint loads into a one-process
  Trainer, a run killed in epoch 2 and resumed from epoch 1 ends bitwise
  where the unbroken one does, and ``device_sampler: 1`` is refused.
"""
import contextlib
import io
import json
import multiprocessing
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deep3dpointclouddenoising_torch.config import default_config
from deep3dpointclouddenoising_torch.data.loader import BatchLoader
from deep3dpointclouddenoising_torch.data.meshio import save_off
from deep3dpointclouddenoising_torch.data.synthetic import make_icosphere, \
    make_torus
from deep3dpointclouddenoising_torch.losses import masked
from deep3dpointclouddenoising_torch.losses.build import (
    get_complete_denoising_loss, get_offset_regression_loss)
from deep3dpointclouddenoising_torch.losses.masked import \
    masked_cross_entropy
from deep3dpointclouddenoising_torch.models import layers
from deep3dpointclouddenoising_torch.models.layers import \
    ChannelsLastBatchNorm
from deep3dpointclouddenoising_torch.parallel import dist as pdist
from deep3dpointclouddenoising_torch.train import __main__ as train_cli
from deep3dpointclouddenoising_torch.train.trainer import Trainer
from deep3dpointclouddenoising_torch.utils.checkpoint import load_checkpoint
from deep3dpointclouddenoising_torch.utils.grad_check import \
    state_difference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
JOB_TIMEOUT_S = 600
# tests/test_torch_train.py's tiny model (tests/test_trainer.py:16-35)
TINY = dict(num_points=64, width=16, depth=2, radius=0.2, sampleDl=0.05,
            nsamples=[8, 8, 8, 8, 8], npoints=[16, 8, 4, 2],
            local_aggregation_type="pseudo_grid", head="offset_reg_head",
            loss="L1", optimizer="adam", base_learning_rate=1e-3,
            lr_scheduler="step", warmup_epoch=-1, epochs=10, batch_size=8,
            weight_decay=1e-3)
# the SGD check of tests/test_trainer.py:106-144
SGD = dict(optimizer="sgd", momentum=0.0, weight_decay=0.0,
           base_learning_rate=1e-2)
# real points of the 8 rows of a global batch: rank 1's rows hold far
# fewer, so a per-rank mean weighs its points unlike the global one
REAL_POINTS = (64, 60, 64, 50, 20, 33, 64, 12)
STEPS = 3


def _tiny_cfg(**extra):
    cfg = default_config()
    for k, v in {**TINY, **extra}.items():
        cfg[k] = v
    cfg.input_features_dim = 3
    return cfg


def _batch(rng, B=8, N=64):
    """A global batch of padded patches; padding slots cycle the row's
    real points, as the datasets pad."""
    xyz = rng.random((B, N, 3), dtype=np.float32) * 2 - 1
    mask = np.zeros((B, N), np.float32)
    for r, k in enumerate(REAL_POINTS[:B]):
        mask[r, :k] = 1.0
        xyz[r, k:] = xyz[r, np.arange(N - k) % k]
    offs = rng.normal(size=(B, N, 3)).astype(np.float32) * 0.02
    labels = (rng.random((B, N)) < 0.3).astype(np.float32)
    return {"points": xyz, "mask": mask, "features": xyz.copy(),
            "offsets": offs, "labels": labels}


def _batches(seed=3, n=STEPS):
    rng = np.random.default_rng(seed)
    return [_batch(rng) for _ in range(n)]


def _rows(batch, rank, world=WORLD):
    sl = pdist.process_slice(len(batch["points"]), rank, world)
    return {k: v[sl] for k, v in batch.items()}


# -- what each rank runs -------------------------------------------------

def _bn_inputs(seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 5, 6)).astype(np.float32) * 3 + 1
    w = rng.normal(size=(4, 5, 6)).astype(np.float32)
    return x, w


def _bn(x, w, rows):
    """Two train-mode steps of a BatchNorm on rows ``rows`` of (x, w):
    outputs, gradients and the running statistics."""
    torch.manual_seed(0)
    bn = ChannelsLastBatchNorm(6, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, 6))
    outs = []
    for step in range(2):
        xt = torch.tensor(x[rows] * (1 + step), requires_grad=True)
        out = bn(xt)
        (out * torch.tensor(w[rows])).sum().backward()
        outs.append({"out": out.detach(), "x_grad": xt.grad})
    return {"steps": outs, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad,
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(),
            "num_batches_tracked": bn.num_batches_tracked.clone()}


LOSS_CASES = ("L1", "chamfer_L1", "l1_chamfer_adaptive_to_chamfer",
              "L1_classification", "Weighted_L1_classification",
              "double_weight", "segmentation")


def _loss_inputs(seed=5):
    b = _batch(np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 1)
    b["pred3"] = rng.normal(size=b["offsets"].shape).astype(np.float32) \
        * 0.02
    b["raw4"] = rng.normal(size=b["offsets"].shape[:2] + (4,)).astype(
        np.float32)
    b["logits"] = rng.normal(size=b["offsets"].shape[:2] + (2,)).astype(
        np.float32)
    return b


def _loss(case, b):
    """The loss of ``case`` on the (rows of the) batch ``b`` and the
    gradient of its prediction."""
    t = {k: torch.tensor(v) for k, v in b.items()}
    if case == "segmentation":
        pred = t["logits"].requires_grad_()
        loss = masked_cross_entropy(pred, t["labels"], t["mask"])
    elif case in ("L1", "chamfer_L1", "l1_chamfer_adaptive_to_chamfer"):
        pred = t["pred3"].requires_grad_()
        loss = get_offset_regression_loss(case)(pred, t["offsets"],
                                                t["mask"], t["points"])
    else:
        pred = t["raw4"].requires_grad_()
        loss = get_complete_denoising_loss(case, 0.05)(
            pred, t["offsets"], t["labels"], t["mask"])
    loss.backward()
    return loss.detach(), pred.grad


def _trainer_run(cfg, batches, rank, world):
    """``len(batches)`` steps of a Trainer from the init of generator
    seed 0 on this rank's rows: losses, the parameters before and after,
    and the state after."""
    tt = Trainer(cfg, 10, torch.Generator().manual_seed(0), "cpu")
    init = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    losses = [tt.train_step(_rows(b, rank, world)).item() for b in batches]
    return {"losses": losses, "init": init, "lr0": tt.lr_schedule(0),
            "state": {k: v.clone() for k, v in
                      tt.model.state_dict().items()}}


def _local_denominator(x):
    """The denominator a per-rank mean uses, scaled as DDP's default mean
    of the ranks' gradients scales it: each rank's own count."""
    return x * pdist.world_size()


def _numerics(rank, world):
    out = {"jax_loaded": "jax" in sys.modules}
    x, w = _bn_inputs()
    out["bn"] = _bn(x, w, pdist.process_slice(len(x), rank, world))
    b = _rows(_loss_inputs(), rank, world)
    out["losses"] = {case: _loss(case, b) for case in LOSS_CASES}
    batches = _batches()
    out["adam"] = _trainer_run(_tiny_cfg(), batches, rank, world)
    out["sgd"] = _trainer_run(_tiny_cfg(**SGD), batches[:1], rank, world)
    out["remat"] = _trainer_run(_tiny_cfg(remat=1), batches, rank, world)
    out["mutants"] = {}
    for name, module, attr, value in (
            ("local BatchNorm statistics", layers, "is_distributed",
             lambda: False),
            ("local loss denominators", masked, "global_sum",
             _local_denominator)):
        kept = getattr(module, attr)
        setattr(module, attr, value)
        try:
            out["mutants"][name] = _trainer_run(_tiny_cfg(**SGD),
                                                batches[:1], rank, world)
        finally:
            setattr(module, attr, kept)
    return out


class Killed(Exception):
    """Stands for the end of a training process killed mid-epoch."""


def cli_argv(tree, config):
    """Two epochs of 2 steps at width 8."""
    return ["--config_file", config, "--data_root", tree, "--num_steps",
            "8", "--num_points", "64", "--epochs", "2", "--val_freq", "1",
            "--device", "cpu", "--auto_resume"]


def train_state(trainer):
    state = {"model/" + k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()}
    opt = trainer.optimizer.optimizer
    for i, p in enumerate(trainer.optimizer.params):
        for k, v in opt.state.get(p, {}).items():
            state[f"adam/{i}/{k}"] = v.clone()
    state["count"] = trainer.optimizer.count
    return state


def _cli(rank, world, job):
    """The train CLI with --multihost: an unbroken run, a run killed one
    update into epoch 2 and its --auto_resume, and a refused
    device_sampler run; stdout and checkpoint writes recorded."""
    argv = cli_argv(job["tree"], job["config"]) + ["--multihost"]
    writes = []
    save = train_cli.save_checkpoint

    def counted_save(path, *args):
        writes.append(os.path.basename(path))
        return save(path, *args)

    train_cli.save_checkpoint = counted_save
    out, text = {}, io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            straight = train_cli.main(argv + ["--log_dir", job["straight"]])
            out["straight"] = {
                "state": train_state(straight["trainer"]),
                "train_losses": straight["train_losses"],
                "val_losses": straight["val_losses"],
                "steps": straight["steps"],
                "keys": list(straight["trainer"].model.state_dict())}
            step = Trainer.train_step

            def killed_step(trainer, batch):
                loss = step(trainer, batch)
                if trainer.step == straight["steps"] // 2 + 1:
                    raise Killed()
                return loss

            Trainer.train_step = killed_step
            try:
                train_cli.main(argv + ["--log_dir", job["resumed"]])
            except Killed:
                pass
            finally:
                Trainer.train_step = step
            resumed = train_cli.main(argv + ["--log_dir", job["resumed"]])
            out["resumed"] = {"state": train_state(resumed["trainer"]),
                              "restored": resumed["restored"]}
            try:
                train_cli.main(cli_argv(job["tree"], job["sampler_config"])
                               + ["--multihost", "--log_dir",
                                  job["sampler_log"]])
                out["sampler_refused"] = False
            except NotImplementedError:
                out["sampler_refused"] = True
    finally:
        train_cli.save_checkpoint = save
    out.update(stdout=text.getvalue(), writes=writes)
    return out


def _quiet_process():
    torch.set_num_threads(1)
    # the run logs' JSONL alone: TensorBoard's import takes seconds here
    sys.modules["torch.utils.tensorboard"] = None


def one_main(job):
    """The CLI's command in one process, without --multihost, on a shape
    tree of its own."""
    _quiet_process()
    one = train_cli.main(cli_argv(job["one_tree"], job["config"])
                         + ["--log_dir", job["one_log"]])
    torch.save({"train_losses": one["train_losses"], "steps": one["steps"],
                "params": {n: p.detach().clone() for n, p in
                           one["trainer"].model.named_parameters()}},
               os.path.join(job["out"], "one.pt"))


def rank_main(rank, world, init_file, job):
    """One rank: join the file:// group, run the numerics and the CLI,
    save what they gave."""
    _quiet_process()
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = {"numerics": _numerics(rank, world)}
        t1 = time.perf_counter()
        out["cli"] = _cli(rank, world, job)
        out["seconds"] = (t1 - t0, time.perf_counter() - t1)
        torch.save(out, os.path.join(job["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the job's fixture -------------------------------------------------------

def _tiny_yaml(path, config, extra):
    with open(os.path.join(ROOT, "cfgs", config + ".yaml")) as f:
        text = f.read().replace("width: 144", "width: 8")
    with open(path, "w") as f:
        f.write(text + extra)
    return path


def _shape_tree(root):
    for split in ("train", "val"):
        os.makedirs(os.path.join(root, split))
        save_off(os.path.join(root, split, "sphere.off"), make_icosphere(2))
    save_off(os.path.join(root, "train", "torus.off"), make_torus())
    return root


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 2-rank job and the one-process CLI run, started; yields a
    function that waits for them and returns each rank's results (and the
    job's paths, with the one-process run's results)."""
    tmp = tmp_path_factory.mktemp("parallel")
    extra = "num_points_per_shape: 1500\nbatch_size: 4\n"
    spec = {"tree": _shape_tree(str(tmp / "shapes")),
            "config": _tiny_yaml(str(tmp / "l1.yaml"), "l1", extra),
            "sampler_config": _tiny_yaml(str(tmp / "sampler.yaml"), "l1",
                                         extra + "device_sampler: 1\n"),
            "straight": str(tmp / "straight"),
            "resumed": str(tmp / "resumed"),
            "sampler_log": str(tmp / "sampler"), "out": str(tmp),
            "one_log": str(tmp / "one")}
    spec["one_tree"] = str(tmp / "one_shapes")
    shutil.copytree(spec["tree"], spec["one_tree"])
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, WORLD, str(tmp / "store"), spec))
             for r in range(WORLD)]
    procs.append(ctx.Process(target=one_main, args=(spec,)))
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
            assert [p.exitcode for p in procs] == [0] * len(procs), \
                [p.exitcode for p in procs]
            results.extend(torch.load(str(tmp / f"rank{r}.pt"),
                                      weights_only=False)
                           for r in range(WORLD))
            spec["one"] = torch.load(str(tmp / "one.pt"))
        return results, spec

    yield wait
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


# -- without a group -------------------------------------------------------

def test_helpers_without_a_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not pdist.is_distributed()
    assert pdist.initialize_distributed("cpu") == 0
    assert not pdist.is_distributed()
    assert (pdist.rank(), pdist.world_size()) == (0, 1)
    assert pdist.is_coordinator()
    pdist.host_barrier("unit")  # returns at once
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    for fn in (pdist.all_reduce_sum, pdist.global_sum,
               pdist.replicated_share):
        assert fn(x) is x
    n = torch.tensor(4.0)
    assert torch.equal(pdist.global_mean(x.sum(0), n), x.sum(0) / n)
    assert pdist.coordinator_value({"a": 1}) == {"a": 1}
    calls = []
    assert pdist.coordinator_first(lambda: calls.append(1) or 7) == 7
    assert calls == [1]
    assert pdist.local_device("cuda") == torch.device("cuda")
    assert pdist.local_device("cuda:0") == torch.device("cuda", 0)
    assert pdist.process_slice(16) == slice(0, 16)
    assert pdist.process_slice(7) == slice(0, 7)
    with pdist.distributed_run("cpu"):
        assert not pdist.is_distributed()


def test_nccl_without_a_card_raises(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for device, backend in (("cuda", None), ("cpu", "nccl")):
        with pytest.raises(RuntimeError, match="CUDA device"):
            pdist.initialize_distributed(device, backend)
        assert not pdist.is_distributed()


def test_process_slice_splits_evenly_or_raises():
    assert [pdist.process_slice(8, r, 2) for r in range(2)] == [
        slice(0, 4), slice(4, 8)]
    assert [pdist.process_slice(12, r, 3) for r in range(3)] == [
        slice(0, 4), slice(4, 8), slice(8, 12)]
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        pdist.process_slice(7, 0, 2)


class _Rows:
    """A dataset whose rows record which indices were asked for."""

    def __init__(self, n):
        self.n, self.asked = n, []

    def __len__(self):
        return self.n

    def get(self, idx, epoch):
        self.asked.append(idx)
        return {"i": np.array([idx, epoch]),
                "x": np.full(3, idx * 10 + epoch, np.float32)}


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_rank_rows_are_slices_of_the_global_batch(drop_last):
    """Each rank's batch is its process_slice of the global one, and it
    asks the dataset for those rows only; a ragged last batch the ranks
    cannot split raises."""
    n, bs = 16, 4
    whole = list(BatchLoader(_Rows(n), bs, drop_last).epoch_iter(2))
    for r in range(WORLD):
        ds = _Rows(n)
        got = list(BatchLoader(ds, bs, drop_last, r, WORLD).epoch_iter(2))
        assert len(got) == len(whole) == len(BatchLoader(ds, bs, drop_last,
                                                         r, WORLD))
        for g, w in zip(got, whole):
            for k in w:
                np.testing.assert_array_equal(
                    g[k], w[k][pdist.process_slice(bs, r, WORLD)])
        assert sorted(ds.asked) == [i for i in range(n)
                                    if (i % bs) // (bs // WORLD) == r]
    ragged = BatchLoader(_Rows(n + 1), bs, False, 0, WORLD)
    with pytest.raises(ValueError, match="not divisible"):
        list(ragged.epoch_iter(0))
    assert len(list(BatchLoader(_Rows(n + 1), bs, True, 1,
                                WORLD).epoch_iter(0))) == n // bs


# -- the 2-rank job ----------------------------------------------------------

def _jax_runs(init):
    """The JAX Trainer on a 2-device mesh from ``init`` (a converted
    Flax tree), on the global batches: 3 Adam steps and one SGD step."""
    import jax
    import jax.numpy as jnp
    from deep3dpointclouddenoising_tpu.config import default_config as jcfg
    from deep3dpointclouddenoising_tpu.models import \
        build_offset_regression as jax_build
    from deep3dpointclouddenoising_tpu.parallel.mesh import make_mesh
    from deep3dpointclouddenoising_tpu.train import Trainer as JaxTrainer
    from deep3dpointclouddenoising_tpu.train.trainer import \
        TrainState as JaxTrainState
    from deep3dpointclouddenoising_torch.convert import params_from_flax

    batches = _batches()
    out = {}
    for name, extra, steps in (("adam", {}, STEPS), ("sgd", SGD, 1)):
        jc = jcfg()
        for k, v in {**TINY, **extra}.items():
            jc[k] = v
        model, loss_fn = jax_build(jc)
        jt = JaxTrainer(jc, model, loss_fn, n_iter_per_epoch=10,
                        mesh=make_mesh(WORLD))
        state = jt.put_replicated(JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=init["params"],
            batch_stats=init["batch_stats"],
            opt_state=jt.tx.init(init["params"])))
        losses = []
        key = jax.random.PRNGKey(0)
        for i in range(steps):
            b = {k: v for k, v in batches[i].items() if k != "labels"}
            state, loss = jt.train_step(state, b, jax.random.fold_in(key, i))
            losses.append(float(loss))
        params = jax.tree_util.tree_map(np.asarray,
                                        jax.device_get(state.params))
        out[name] = {"losses": losses, "lr0": float(jt.lr_schedule(0)),
                     "params": params_from_flax({"params": params})}
    return out


@pytest.fixture(scope="module")
def against_jax(job):
    """The ranks' runs and JAX's from the same init (the Trainer of
    generator seed 0, which this process builds too); JAX steps here while
    the ranks run."""
    from deep3dpointclouddenoising_torch.convert import flax_from_params
    tt = Trainer(_tiny_cfg(), 10, torch.Generator().manual_seed(0), "cpu")
    init = {k: v.detach().clone() for k, v in tt.model.state_dict().items()}
    jax_out = _jax_runs(flax_from_params(init))
    ranks, _ = job()
    for r in ranks:
        for name, p in r["numerics"]["adam"]["init"].items():
            assert torch.equal(p, init[name]), name
    return ranks, jax_out


def _check_adam(run, jax_adam):
    """tests/test_trainer.py:96,104: losses at rtol 2e-3, parameters at
    6 * lr."""
    np.testing.assert_allclose(run["losses"], jax_adam["losses"], rtol=2e-3)
    lr = TINY["base_learning_rate"]
    for name, want in jax_adam["params"].items():
        np.testing.assert_allclose(run["state"][name].numpy(), want.numpy(),
                                   atol=6.0 * lr, rtol=0, err_msg=name)


def _check_sgd(run, jax_sgd):
    """tests/test_trainer.py:106-144: the gradient recovered from one SGD
    step, ``(p0 - p1) / lr``, at atol 2e-5."""
    assert run["lr0"] == pytest.approx(jax_sgd["lr0"], rel=1e-7)
    for name, want in jax_sgd["params"].items():
        p0 = run["init"][name].numpy()
        g = (p0 - run["state"][name].numpy()) / run["lr0"]
        g_want = (p0 - want.numpy()) / jax_sgd["lr0"]
        np.testing.assert_allclose(g, g_want, atol=2e-5, rtol=0,
                                   err_msg=name)


def test_two_rank_adam_steps_match_jax_on_two_devices(against_jax):
    ranks, jax_out = against_jax
    for r in ranks:
        _check_adam(r["numerics"]["adam"], jax_out["adam"])
    a, b = (r["numerics"]["adam"] for r in ranks)
    assert a["losses"] == b["losses"]
    assert not state_difference(a["state"], b["state"])


def test_two_rank_sgd_gradient_matches_jax_on_two_devices(against_jax):
    """The SGD LR counts the world size (8 * 2 / 8 * 1e-2), as JAX's."""
    ranks, jax_out = against_jax
    assert jax_out["sgd"]["lr0"] == pytest.approx(2e-2)
    for r in ranks:
        _check_sgd(r["numerics"]["sgd"], jax_out["sgd"])
    assert not state_difference(ranks[0]["numerics"]["sgd"]["state"],
                                ranks[1]["numerics"]["sgd"]["state"])


def test_two_rank_steps_equal_the_one_process_steps(against_jax):
    """A step of 2 ranks is the one-process step on the global batch, up
    to the order of float32 sums, which Adam turns into steps of up to
    2 * lr on near-zero gradients (the JAX test's tolerances)."""
    ranks, _ = against_jax
    one = _trainer_run(_tiny_cfg(), _batches(), 0, 1)
    run = ranks[0]["numerics"]["adam"]
    # the first from the same parameters; then Adam's sign flips
    np.testing.assert_allclose(run["losses"][0], one["losses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(run["losses"], one["losses"], rtol=2e-3)
    lr = TINY["base_learning_rate"]
    for name in run["init"]:  # the parameters
        np.testing.assert_allclose(run["state"][name].numpy(),
                                   one["state"][name].numpy(),
                                   atol=6.0 * lr, rtol=0, err_msg=name)


def test_remat_under_ddp_repeats_the_plain_steps(against_jax):
    """``remat: 1`` recomputes each bottleneck in the backward (its
    BatchNorm all-reduces too) beside DDP's bucket all-reduces."""
    ranks, _ = against_jax
    for r in ranks:
        plain, remat = r["numerics"]["adam"], r["numerics"]["remat"]
        np.testing.assert_allclose(remat["losses"], plain["losses"],
                                   rtol=1e-6)
        for name, want in plain["state"].items():
            np.testing.assert_allclose(remat["state"][name].numpy(),
                                       want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("mutant", ["local BatchNorm statistics",
                                    "local loss denominators"])
def test_the_checks_catch_a_per_rank_reduction(against_jax, mutant):
    """A BatchNorm over each rank's own slots, or losses over each rank's
    own mask count averaged as DDP's default hook averages, fail the SGD
    check.  (Their first losses stay within 2e-3 of JAX's: the near-zero
    head's loss is the mean |offset|, which neither moves much.)"""
    ranks, jax_out = against_jax
    for r in ranks:
        with pytest.raises(AssertionError):
            _check_sgd(r["numerics"]["mutants"][mutant], jax_out["sgd"])


def test_cross_rank_batchnorm_matches_one_process(job):
    """Two train-mode steps: the ranks' outputs and input gradients are
    the rows of one process's on the concatenated batch, their parameter
    gradients sum to its, and the running statistics (equal on both
    ranks) are its."""
    ranks, _ = job()
    x, w = _bn_inputs()
    want = _bn(x, w, slice(None))
    got = [r["numerics"]["bn"] for r in ranks]
    for step in range(2):
        for key in ("out", "x_grad"):
            np.testing.assert_allclose(
                torch.cat([g["steps"][step][key] for g in got]).numpy(),
                want["steps"][step][key].numpy(), rtol=1e-5, atol=1e-6,
                err_msg=f"step {step} {key}")
    for key in ("weight_grad", "bias_grad"):
        np.testing.assert_allclose(sum(g[key] for g in got).numpy(),
                                   want[key].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    for key in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(got[0][key], got[1][key]), key
        np.testing.assert_allclose(got[0][key].numpy(), want[key].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    # the statistics of one rank's rows alone are not the global ones
    local = _bn(x, w, slice(0, 2))
    assert not np.allclose(local["running_var"].numpy(),
                           want["running_var"].numpy(), rtol=1e-2)


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_shares_sum_to_the_global_loss(job, case):
    """Rank 1's rows hold 129 real points, rank 0's 238: the shares sum to
    the one-process loss of the global batch (which each rank's
    ``global_sum`` reports) and their gradients are its gradients; a
    per-rank mean would not be."""
    ranks, _ = job()
    b = _loss_inputs()
    want, want_grad = _loss(case, b)
    shares = [r["numerics"]["losses"][case][0] for r in ranks]
    np.testing.assert_allclose(float(sum(shares)), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        torch.cat([r["numerics"]["losses"][case][1] for r in ranks]).numpy(),
        want_grad.numpy(), rtol=1e-5, atol=1e-7 * float(
            want_grad.abs().max()))
    per_rank = [float(_loss(case, _rows(b, r))[0]) for r in range(WORLD)]
    assert abs(np.mean(per_rank) - float(want)) > 1e-3 * abs(float(want))


def test_ranks_import_no_jax(job):
    ranks, _ = job()
    assert [r["numerics"]["jax_loaded"] for r in ranks] == [False, False]
    print("rank seconds (numerics, CLI):",
          [tuple(round(s, 1) for s in r["seconds"]) for r in ranks])


EXPERIMENT = "l1_diverse"


def test_cli_only_the_coordinator_writes(job):
    """Rank 0 writes the checkpoints, ``log.txt`` and ``metrics.jsonl``;
    rank 1 writes nothing and prints every line under ``[rank 1]``."""
    ranks, spec = job()
    r0, r1 = ranks[0]["cli"], ranks[1]["cli"]
    assert r1["writes"] == []
    assert r0["writes"][:2] == ["current.pt", "current.pt"]
    assert "ckpt_epoch_2.pt" in r0["writes"]
    lines = [l for l in r1["stdout"].splitlines() if l.strip()]
    assert lines and all(l.startswith("[rank 1] ") for l in lines)
    assert "[rank 1] data parallel: rank 1 of 2 (gloo), rows 2-3 of each " \
           "global batch of 4" in lines
    assert "[rank" not in r0["stdout"]
    run = os.path.join(spec["straight"], EXPERIMENT)
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    assert "[rank 1]" not in log
    assert "data parallel: rank 0 of 2 (gloo), rows 0-1" in log
    with open(os.path.join(run, "metrics.jsonl")) as f:
        tags = [(m["tag"], m["step"]) for m in map(json.loads, f)]
    assert sorted(tags) == sorted(
        (t, e) for t in ("train/loss", "train/lr", "val/loss")
        for e in (1, 2))
    assert ranks[0]["cli"]["straight"]["train_losses"] \
        == ranks[1]["cli"]["straight"]["train_losses"]
    assert not state_difference(r0["straight"]["state"],
                                r1["straight"]["state"])


def test_cli_checkpoint_loads_into_one_process(job):
    """The 2-rank checkpoint has the module's own names and loads into a
    one-process Trainer of the same command.  The one-process run of the
    command starts from the same loss; its parameters stay within Adam's
    reach of 2 * lr a step.  (Its later losses move apart by up to 2%
    here: at width 8 the encoder's gradients behind the near-zero head are
    at rounding level, and Adam turns each into a full step; the Trainer
    tests above hold the steps themselves.)"""
    ranks, spec = job()
    run = ranks[0]["cli"]["straight"]
    assert not any(k.startswith("module.") for k in run["keys"])
    one = spec["one"]
    cfg = train_cli.load_run_config(train_cli.parse_args(
        cli_argv(spec["tree"], spec["config"])))
    trainer = Trainer(cfg, one["steps"] // 2,
                      torch.Generator().manual_seed(1), "cpu")
    path = os.path.join(spec["straight"], EXPERIMENT, "current.pt")
    assert load_checkpoint(path, trainer) == run["steps"] == one["steps"]
    assert not state_difference(train_state(trainer), run["state"])
    np.testing.assert_allclose(run["train_losses"][0],
                               one["train_losses"][0], rtol=1e-4)
    assert np.isfinite(run["train_losses"] + run["val_losses"]).all()
    lr = float(cfg.base_learning_rate)
    for name, value in one["params"].items():
        np.testing.assert_allclose(
            run["state"]["model/" + name].numpy(), value.numpy(),
            atol=2.0 * lr * one["steps"], rtol=0, err_msg=name)


def test_cli_resume_from_epoch_1_reproduces_the_unbroken_run(job):
    """Killed one update into epoch 2 and run again with --auto_resume,
    each rank ends bitwise where the unbroken run ended."""
    ranks, spec = job()
    current = os.path.join(spec["resumed"], EXPERIMENT, "current.pt")
    for r in ranks:
        cli = r["cli"]
        assert cli["resumed"]["restored"] == current
        assert not state_difference(cli["resumed"]["state"],
                                    cli["straight"]["state"])
    assert "auto-resumed from" in ranks[1]["cli"]["stdout"]


def test_cli_refuses_the_device_sampler_across_ranks(job):
    ranks, _ = job()
    assert [r["cli"]["sampler_refused"] for r in ranks] == [True, True]

"""The point-sharded spatial forward and training (``parallel/spatial.py``)
on the CPU.

Two gloo ranks, started from a ``spawn`` context and joined through a
``file://`` store under the test's ``tmp_path``, run every multi-rank case
in one job, one torch thread each: this module imports no JAX at its top,
so the ranks load torch and the port alone (checked); the JAX oracles run
in this process while the ranks work, jitted at ``tests/test_spatial.py``'s
tiny size (width 16, depth 1, one case at depth 2, 256 points with a
padded tail):

* ``all_gather_points``: uneven rows, its adjoint (each rank's gradient the
  sum of the ranks' gradients to its rows), its counters; ``point_rows``;
* the spatial pyramid's rows against the whole pyramid's, bitwise, also
  where the neighbour queries compact their supports;
* the spatial forward on 2 ranks against the port's one-process forward
  at rtol 2e-5 / atol 2e-6 (``tests/test_spatial.py:68``) for the three
  kinds, at depth 2, and with uneven shards (``npoints = [50, 22, 10, 3]``
  at 200 points, :205); its ``state_dict`` keys and shapes are the plain
  model's; against JAX's ``build_spatial_forward`` on ``make_mesh(2)``
  from the same converted weights at the whole-model tolerance (rtol 5e-4
  / atol 5e-5, BatchNorm statistics and the final Dense at O(1));
* the gradients of ``sum(out ** 2)`` through ``kpconv_aggregate_sharded``
  summed over the ranks against the one-process model's (rtol 2e-4 / atol
  2e-5, :178);
* point-sharded training: 3 Adam steps of ``Trainer(spatial=True)`` on 2
  ranks against JAX's ``Trainer(spatial=True)`` on ``make_mesh(2)``
  (losses at rtol 2e-3, parameters at 6 * lr, :117-158), the ranks bitwise
  equal; one SGD step's gradient against the one-process Trainer's at atol
  2e-5, shown to fail with a BatchNorm of each rank's own points;
* ``denoise_clouds_spatial`` on 2 ranks against JAX's on one icosphere
  shape of 300 points, ``size_bucket=128`` (:88-114);
* ``infer --spatial --multihost`` on 2 ranks: rank 0 alone writes the PLY
  tree the voting path writes, its denoised clouds those of ``infer
  --spatial`` in one process; ``--spatial`` refuses ``--device_voting``.

The other aggregation operators and the Chamfer losses in the spatial
model: ``tests/test_torch_spatial_ops.py``.
"""
import contextlib
import io
import multiprocessing
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deep3dpointclouddenoising_torch import infer
from deep3dpointclouddenoising_torch.config import default_config
from deep3dpointclouddenoising_torch.data.meshio import read_ply, save_off
from deep3dpointclouddenoising_torch.data.offset_dataset import OffsetDataset
from deep3dpointclouddenoising_torch.data.synthetic import make_icosphere
from deep3dpointclouddenoising_torch.models import (build_complete_denoising,
                                                    build_offset_regression,
                                                    build_scene_segmentation,
                                                    layers)
from deep3dpointclouddenoising_torch.models.pyramid import build_pyramid
from deep3dpointclouddenoising_torch.ops import neighbors
from deep3dpointclouddenoising_torch.parallel import dist as pdist
from deep3dpointclouddenoising_torch.parallel.spatial import (
    build_spatial_forward, build_spatial_model, gather_points)
from deep3dpointclouddenoising_torch.train.trainer import Trainer
from deep3dpointclouddenoising_torch.utils.grad_check import \
    state_difference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
JOB_TIMEOUT_S = 600
# tests/test_spatial.py:23-39
GIANT = dict(num_points=256, width=16, depth=1, radius=0.2, sampleDl=0.05,
             nsamples=[8, 8, 8, 8, 8], npoints=[64, 32, 16, 8],
             local_aggregation_type="pseudo_grid", head="offset_reg_head",
             loss="L1", num_classes=3)
# tests/test_spatial.py:117-129
TRAIN = dict(optimizer="adam", base_learning_rate=1e-3, lr_scheduler="step",
             warmup_epoch=-1, epochs=10, batch_size=2, weight_decay=0.0)
SGD = dict(optimizer="sgd", momentum=0.0, base_learning_rate=1e-2)
STEPS = 3
BUILDS = {"offset_regression": build_offset_regression,
          "complete_denoising": build_complete_denoising,
          "scene_segmentation": build_scene_segmentation}
# name: (kind, config changes, points)
FORWARDS = {
    "offset depth 1": ("offset_regression", {}, 256),
    "offset depth 2": ("offset_regression", {"depth": 2}, 256),
    "full cleaning": ("complete_denoising", {}, 256),
    "segmentation": ("scene_segmentation", {}, 256),
    "uneven shards": ("offset_regression",
                      {"num_points": 200, "npoints": [50, 22, 10, 3]}, 200),
}
SPATIAL_TOL = dict(rtol=2e-5, atol=2e-6)
MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
ICO_POINTS, ICO_BUCKET = 300, 128


def _cfg(**extra):
    cfg = default_config()
    for k, v in {**GIANT, **extra}.items():
        cfg[k] = v
    cfg.input_features_dim = 3
    return cfg


def _cloud(seed=0, B=1, N=256):
    """tests/test_spatial.py's cloud: uniform in the cube, the last 7
    slots padding."""
    rng = np.random.default_rng(seed)
    xyz = rng.random((B, N, 3), dtype=np.float32) * 2 - 1
    mask = np.ones((B, N), np.float32)
    mask[:, -7:] = 0.0
    return xyz, mask


def _model(kind, cfg, spatial, seed=0):
    """The model of ``kind`` from generator seed ``seed``, every
    BatchNorm's running statistics and the final Dense at O(1) (the head's
    1e-4 init would let atol hide every error), in eval mode."""
    build = (lambda c, g: build_spatial_model(c, kind, g)) if spatial \
        else BUILDS[kind]
    model = build(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(
                    size=buf.shape).astype(np.float32) * 0.5))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(
                    0.5, 2.0, size=buf.shape).astype(np.float32)))
        for name, p in model.named_parameters():
            if "MultiDimHead_0.Dense_0" in name:
                p.copy_(torch.from_numpy(rng.normal(
                    size=tuple(p.shape)).astype(np.float32)))
    return model.eval()


def _forward(name, spatial):
    """The eval output of case ``name`` (whole on every rank) and the
    model's state keys and shapes."""
    kind, extra, n = FORWARDS[name]
    model = _model(kind, _cfg(**extra), spatial)
    xyz, mask = (torch.from_numpy(a) for a in _cloud(N=n))
    with torch.no_grad():
        out = model(xyz, mask, xyz)
    if spatial:
        out = gather_points(out, n)
    return out, {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _grads(spatial):
    """The gradient of sum(out ** 2) of the eval model at its init, as
    tests/test_spatial.py:178 takes it (the O(1) head of :func:`_model`
    makes gradients of 1e3, whose float32 noise passes the atol), in every
    parameter (this rank's share in the spatial model)."""
    cfg, g = _cfg(), torch.Generator().manual_seed(0)
    model = build_spatial_model(cfg, generator=g) if spatial \
        else build_offset_regression(cfg, g)
    model.eval()
    xyz, mask = (torch.from_numpy(a) for a in _cloud())
    (model(xyz, mask, xyz) ** 2).sum().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _train_batch(seed=3):
    """Two clouds (tests/test_spatial.py:130-138), their points in order
    of x, so each rank's half of a cloud is a region of its own (whose
    BatchNorm statistics are not the cloud's)."""
    xyz, mask = _cloud(seed, B=2)
    xyz = np.take_along_axis(xyz, np.argsort(xyz[..., :1], axis=1), axis=1)
    offs = np.random.default_rng(seed + 1).normal(
        size=xyz.shape).astype(np.float32) * 0.02
    return {"points": xyz, "mask": mask, "features": xyz.copy(),
            "offsets": offs, "cloud_ind": np.arange(2, dtype=np.int32)}


def _trainer_run(cfg, steps, spatial):
    tt = Trainer(cfg, 10, torch.Generator().manual_seed(0), "cpu",
                 spatial=spatial)
    init = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    batch = _train_batch()
    losses = [tt.train_step(batch).item() for _ in range(steps)]
    return {"losses": losses, "init": init, "lr0": tt.lr_schedule(0),
            "state": {k: v.clone() for k, v in
                      tt.model.state_dict().items()}}


def _ico_dataset(root):
    """tests/test_spatial.py:88-97's icosphere cloud."""
    return OffsetDataset(
        root, "qualitative_test", in_radius=0.4, num_points=64,
        num_steps=1, num_epochs=1, noise_type="gaussian", noise_level=5e-3,
        num_points_per_shape=ICO_POINTS, outlier_proportion=0.0, seed=0,
        sample_dl_patches=0.3,
        shapes={"qualitative_test/sphere": make_icosphere(2)})


def _denoise(root):
    model = _model("offset_regression", _cfg(), False)
    res = infer.denoise_clouds_spatial(model.state_dict(), _cfg(),
                                       _ico_dataset(root), "cpu",
                                       size_bucket=ICO_BUCKET)
    return {k: res[0][k] for k in ("noisy", "offsets", "denoised")}


def _gather_case(rank, world):
    """5 rows over 2 ranks (3 and 2): the gathered rows and the gradient
    of sum(gathered * w_r), w_r the rank's own weights."""
    rows = pdist.point_rows(5, rank, world)
    x = torch.arange(5 * 2, dtype=torch.float32).reshape(1, 5, 2)[:, rows]
    x = (x + 100 * rank).requires_grad_()
    pdist.all_gather_points.calls = pdist.all_gather_points.bytes = 0
    y = pdist.all_gather_points(x, 5)
    w = torch.from_numpy(np.random.default_rng(rank).normal(
        size=(1, 5, 2)).astype(np.float32))
    (y * w).sum().backward()
    return {"rows": rows, "y": y.detach(), "grad": x.grad,
            "calls": pdist.all_gather_points.calls,
            "bytes": pdist.all_gather_points.bytes}


def _numerics(rank, world):
    out = {"jax_loaded": "jax" in sys.modules,
           "gather": _gather_case(rank, world),
           "forwards": {name: _forward(name, True) for name in FORWARDS},
           "grads": _grads(True),
           "adam": _trainer_run(_cfg(**TRAIN), STEPS, True),
           "sgd": _trainer_run(_cfg(**{**TRAIN, **SGD}), 1, True)}
    kept = layers.is_distributed
    layers.is_distributed = lambda: False
    try:
        out["local_bn"] = _trainer_run(_cfg(**{**TRAIN, **SGD}), 1, True)
    finally:
        layers.is_distributed = kept
    return out


def _cli(job, rank):
    """``infer --spatial --multihost`` on the job's tree; stdout and the
    PLY files written recorded."""
    writes = []
    write_ply = infer.write_ply

    def counted(path, *args, **kwargs):
        writes.append(os.path.relpath(path, job["cli_out"]))
        return write_ply(path, *args, **kwargs)

    infer.write_ply = counted
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            summary = infer.main(infer_argv(job["tree"], job["config"],
                                            job["cli_out"], "--spatial",
                                            "--multihost"))
    finally:
        infer.write_ply = write_ply
    return {"writes": writes, "stdout": text.getvalue(),
            "denoised": [r["denoised"] for r in summary["results"]]}


def infer_argv(tree, config, out_dir, *extra):
    return ["--config_file", config, "--data_root", tree, "--out_dir",
            out_dir, "--device", "cpu", "--checkpoint_low", "none",
            "--noise_type", "gaussian", "--noise_level", "0.005", *extra]


def rank_main(rank, world, init_file, job):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = {"numerics": _numerics(rank, world)}
        t1 = time.perf_counter()
        out["denoise"] = _denoise(os.path.join(job["out"], f"ico{rank}"))
        out["cli"] = _cli(job, rank)
        out["seconds"] = (t1 - t0, time.perf_counter() - t1)
        torch.save(out, os.path.join(job["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the job's fixture -------------------------------------------------------

def _qualitative_tree(root):
    os.makedirs(os.path.join(root, "qualitative_test"))
    save_off(os.path.join(root, "qualitative_test", "sphere.off"),
             make_icosphere(2))
    return root


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
    tmp = tmp_path_factory.mktemp("spatial")
    with open(os.path.join(ROOT, "cfgs", "l1.yaml")) as f:
        text = f.read().replace("width: 144", "width: 8")
    config = str(tmp / "l1.yaml")
    with open(config, "w") as f:
        f.write(text + "num_points_per_shape: 300\nnum_points: 64\n"
                "batch_size: 64\n")
    spec = {"tree": _qualitative_tree(str(tmp / "shapes")),
            "config": config, "cli_out": str(tmp / "cli"), "out": str(tmp)}
    spec["one_tree"] = str(tmp / "one_shapes")
    shutil.copytree(spec["tree"], spec["one_tree"])
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


# -- without a group -------------------------------------------------------

def test_point_rows_split_in_blocks_of_the_ceiling():
    assert [pdist.point_rows(5, r, 2) for r in range(2)] == [
        slice(0, 3), slice(3, 5)]
    assert [pdist.point_rows(3, r, 8) for r in (0, 1, 2, 7)] == [
        slice(0, 1), slice(1, 2), slice(2, 3), slice(3, 3)]
    assert pdist.point_rows(200) == slice(0, 200)
    x = torch.ones(1, 4, 2)
    assert pdist.all_gather_points(x, 4) is x
    with pytest.raises(ValueError, match="rows of 5"):
        pdist.all_gather_points(x, 5)


@pytest.mark.parametrize("compact", [False, True])
def test_spatial_pyramid_rows_are_the_whole_pyramid_rows(monkeypatch,
                                                         compact):
    """Each rank's rows of every level, neighbourhood and upsample table
    of the point-sharded pyramid (uneven shards, 3 ranks) are the whole
    pyramid's rows bitwise; its indices name the whole support level.
    ``compact``: every query first compacts its supports, as the 15k
    configs' queries do."""
    if compact:
        monkeypatch.setattr(neighbors, "auto_compact", lambda *a: True)
    cfg = _cfg(num_points=200, npoints=[50, 22, 10, 3], depth=2)
    xyz, mask = (torch.from_numpy(a) for a in _cloud(N=200))
    kw = dict(radius=cfg.radius, sample_dl=cfg.sampleDl,
              nsamples=list(cfg.nsamples), npoints=list(cfg.npoints))
    whole = build_pyramid(xyz, mask, **kw)
    sizes = [200] + list(cfg.npoints)
    for r in range(3):
        part = build_pyramid(xyz, mask, **kw,
                             rows=lambda n: pdist.point_rows(n, r, 3))
        for i, (lw, lp) in enumerate(zip(whole.levels, part.levels)):
            rows = pdist.point_rows(sizes[i], r, 3)
            assert torch.equal(lp.xyz, lw.xyz[:, rows])
            assert torch.equal(lp.mask, lw.mask[:, rows])
            assert lp.self_nbr.support_size == sizes[i]
            for a, b in zip(lp.self_nbr[:3], lw.self_nbr[:3]):
                assert torch.equal(a, b[:, rows]), (r, i)
        for i, (tw, tp) in enumerate(zip(whole.transitions,
                                         part.transitions)):
            coarse = pdist.point_rows(sizes[i + 1], r, 3)
            fine = pdist.point_rows(sizes[i], r, 3)
            assert tp.pool_nbr.support_size == sizes[i]
            assert tp.coarse_size == sizes[i + 1]
            for a, b in zip(tp.pool_nbr[:3], tw.pool_nbr[:3]):
                assert torch.equal(a, b[:, coarse]), (r, i)
            assert torch.equal(tp.up_idx, tw.up_idx[:, fine])
            assert torch.equal(tp.up_mask, tw.up_mask[:, fine])
    assert whole.levels[0].self_nbr.support_size is None
    assert whole.transitions[0].coarse_size is None


def test_spatial_model_has_the_plain_parameters_and_refuses_others():
    """The spatial model of each kind, and of PosPool, has the plain
    model's state keys and shapes; a spatial Trainer takes the Chamfer
    losses; another kind of model is refused."""
    pospool = dict(local_aggregation_type="pospool", width=24)
    for kind, build, extra in [(k, b, {}) for k, b in BUILDS.items()] + [
            ("offset_regression", build_offset_regression, pospool)]:
        plain = build(_cfg(**extra))
        spatial = build_spatial_model(_cfg(**extra), kind)
        assert {k: v.shape for k, v in plain.state_dict().items()} == \
            {k: v.shape for k, v in spatial.state_dict().items()}
    with pytest.raises(ValueError, match="kind"):
        build_spatial_model(_cfg(), "discriminator")
    tt = Trainer(_cfg(loss="chamfer_L1"), 10, device="cpu", spatial=True)
    assert tt.loss_fn.keywords == {"spatial": True, "group": None}


def test_spatial_forward_in_one_process_is_the_plain_forward():
    """In one process the spatial model's rows are the whole cloud: the
    forward is the plain one, bitwise; ``build_spatial_forward`` takes
    numpy arrays."""
    xyz, mask = _cloud()
    plain = _model("offset_regression", _cfg(), False)
    model, fwd = build_spatial_forward(_cfg(), device="cpu")
    model.load_state_dict(plain.state_dict())
    with torch.no_grad():
        want = plain(*(torch.from_numpy(a) for a in (xyz, mask, xyz)))
    assert torch.equal(fwd(xyz, mask, xyz), want)


def test_infer_spatial_refuses_device_voting(tmp_path):
    for flags in (["--device_voting"], ["--full_cleaning"]):
        with pytest.raises(SystemExit):
            infer.main(infer_argv(str(tmp_path), "cfgs/l1.yaml",
                                  str(tmp_path / "o"), "--spatial", *flags))
    with pytest.raises(SystemExit):  # --multihost only with --spatial
        infer.main(infer_argv(str(tmp_path), "cfgs/l1.yaml",
                              str(tmp_path / "o"), "--multihost"))


# -- the 2-rank job ----------------------------------------------------------

def test_all_gather_points_and_its_adjoint(job):
    ranks, _ = job()
    want_y = torch.arange(10, dtype=torch.float32).reshape(1, 5, 2)
    want_y[:, 3:] += 100
    w = sum(torch.from_numpy(np.random.default_rng(r).normal(
        size=(1, 5, 2)).astype(np.float32)) for r in range(WORLD))
    for r in ranks:
        g = r["numerics"]["gather"]
        assert torch.equal(g["y"], want_y)
        assert torch.equal(g["grad"], w[:, g["rows"]])
        # one gather of every rank's rows padded to 3
        assert (g["calls"], g["bytes"]) == (1, WORLD * 3 * 2 * 4)


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_spatial_forward_matches_one_process(job, name):
    ranks, _ = job()
    want, keys = _forward(name, False)
    for r in ranks:
        got, got_keys = r["numerics"]["forwards"][name]
        assert got_keys == keys
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SPATIAL_TOL)
    assert torch.equal(ranks[0]["numerics"]["forwards"][name][0],
                       ranks[1]["numerics"]["forwards"][name][0])


def test_spatial_gradients_match_one_process(job):
    ranks, _ = job()
    want = _grads(False)
    for name, g in want.items():
        got = sum(r["numerics"]["grads"][name] for r in ranks)
        np.testing.assert_allclose(got.numpy(), g.numpy(), **GRAD_TOL,
                                   err_msg=name)


# -- against JAX -----------------------------------------------------------

def _jax_cfg(**extra):
    from deep3dpointclouddenoising_tpu.config import default_config as jcfg
    jc = jcfg()
    for k, v in {**GIANT, **extra}.items():
        jc[k] = v
    jc.use_pallas = False
    return jc


def _jax_runs():
    """JAX's spatial forward, its spatial Trainer's 3 Adam steps and its
    ``denoise_clouds_spatial``, each on ``make_mesh(2)`` from the port's
    converted weights."""
    import jax
    import jax.numpy as jnp
    from deep3dpointclouddenoising_tpu.data.offset_dataset import \
        OffsetDataset as JaxDataset
    from deep3dpointclouddenoising_tpu.data.synthetic import \
        make_icosphere as jax_icosphere
    from deep3dpointclouddenoising_tpu.infer import \
        denoise_clouds_spatial as jax_denoise
    from deep3dpointclouddenoising_tpu.models import \
        build_offset_regression as jax_build
    from deep3dpointclouddenoising_tpu.parallel.mesh import make_mesh
    from deep3dpointclouddenoising_tpu.parallel.spatial import (
        build_spatial_forward as jax_spatial_forward,
        build_spatial_model as jax_spatial_model)
    from deep3dpointclouddenoising_tpu.train import Trainer as JaxTrainer
    from deep3dpointclouddenoising_tpu.train.trainer import \
        TrainState as JaxTrainState
    from deep3dpointclouddenoising_torch.convert import (flax_from_params,
                                                         params_from_flax)
    mesh = make_mesh(WORLD)
    out = {}
    variables = flax_from_params(
        _model("offset_regression", _cfg(), False).state_dict())
    xyz, mask = _cloud()
    _, fwd = jax_spatial_forward(_jax_cfg(), mesh)
    out["forward"] = np.asarray(fwd(variables, xyz, mask, xyz))

    jc = _jax_cfg(**TRAIN)
    _, loss_fn = jax_build(jc)
    jt = JaxTrainer(jc, jax_spatial_model(jc, mesh), loss_fn, 10, mesh=mesh,
                    spatial=True)
    tt = Trainer(_cfg(**TRAIN), 10, torch.Generator().manual_seed(0), "cpu")
    init = flax_from_params({k: v.detach() for k, v in
                             tt.model.state_dict().items()})
    state = jt.put_replicated(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=init["params"],
        batch_stats=init["batch_stats"],
        opt_state=jt.tx.init(init["params"])))
    batch = _train_batch()
    losses = []
    for i in range(STEPS):
        state, loss = jt.train_step(state, batch, jax.random.PRNGKey(100 + i))
        losses.append(float(loss))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    out["adam"] = {"losses": losses,
                   "params": params_from_flax({"params": params})}

    import tempfile
    with tempfile.TemporaryDirectory() as root:
        ds = JaxDataset(
            root, "qualitative_test", in_radius=0.4, num_points=64,
            num_steps=1, num_epochs=1, noise_type="gaussian",
            noise_level=5e-3, num_points_per_shape=ICO_POINTS,
            outlier_proportion=0.0, seed=0, sample_dl_patches=0.3,
            shapes={"qualitative_test/sphere": jax_icosphere(2)})
        res = jax_denoise(variables, _jax_cfg(), ds, mesh=mesh,
                          size_bucket=ICO_BUCKET)
    out["denoise"] = {k: res[0][k] for k in ("noisy", "offsets",
                                             "denoised")}
    return out


@pytest.fixture(scope="module")
def against_jax(job):
    jax_out = _jax_runs()
    ranks, spec = job()
    return ranks, spec, jax_out


def test_spatial_forward_matches_jax_on_two_devices(against_jax):
    ranks, _, jax_out = against_jax
    for r in ranks:
        np.testing.assert_allclose(
            r["numerics"]["forwards"]["offset depth 1"][0].numpy(),
            jax_out["forward"], **MODEL_TOL)


def _check_adam(run, jax_adam):
    """tests/test_spatial.py:151-158: losses at rtol 2e-3, parameters at
    6 * lr."""
    np.testing.assert_allclose(run["losses"], jax_adam["losses"], rtol=2e-3)
    lr = TRAIN["base_learning_rate"]
    for name, want in jax_adam["params"].items():
        np.testing.assert_allclose(run["state"][name].numpy(), want.numpy(),
                                   atol=6.0 * lr, rtol=0, err_msg=name)


def test_spatial_training_matches_jax_on_two_devices(against_jax):
    ranks, _, jax_out = against_jax
    for r in ranks:
        _check_adam(r["numerics"]["adam"], jax_out["adam"])
    a, b = (r["numerics"]["adam"] for r in ranks)
    assert a["losses"] == b["losses"]
    assert not state_difference(a["state"], b["state"])


def _check_sgd(run, one):
    """The gradient recovered from one SGD step, ``(p0 - p1) / lr``,
    against the one-process Trainer's at atol 2e-5 (the LR counts a world
    of 1, as JAX's spatial Trainer's)."""
    assert run["lr0"] == one["lr0"]
    for name, p0 in one["init"].items():
        g = (p0 - run["state"][name]) / run["lr0"]
        g_want = (p0 - one["state"][name]) / one["lr0"]
        np.testing.assert_allclose(g.numpy(), g_want.numpy(), atol=2e-5,
                                   rtol=0, err_msg=name)


def test_spatial_sgd_gradient_matches_one_process(job):
    """One SGD step on 2 ranks applies the one-process gradient; with a
    BatchNorm over each rank's own points it does not."""
    ranks, _ = job()
    one = _trainer_run(_cfg(**{**TRAIN, **SGD}), 1, False)
    for r in ranks:
        _check_sgd(r["numerics"]["sgd"], one)
        with pytest.raises(AssertionError):
            _check_sgd(r["numerics"]["local_bn"], one)
    assert not state_difference(ranks[0]["numerics"]["sgd"]["state"],
                                ranks[1]["numerics"]["sgd"]["state"])


def test_denoise_clouds_spatial_matches_jax(against_jax):
    ranks, _, jax_out = against_jax
    want = jax_out["denoise"]
    for r in ranks:
        got = r["denoise"]
        assert got["denoised"].shape == (ICO_POINTS, 3)
        np.testing.assert_array_equal(got["noisy"], want["noisy"])
        np.testing.assert_allclose(got["offsets"], want["offsets"],
                                   **MODEL_TOL)
        np.testing.assert_allclose(got["denoised"],
                                   got["noisy"] + got["offsets"])
    np.testing.assert_array_equal(ranks[0]["denoise"]["offsets"],
                                  ranks[1]["denoise"]["offsets"])


def test_infer_spatial_multihost_writes_the_voting_tree(job, tmp_path):
    """Rank 0 alone writes the noisy/denoised/clean PLY tree, the files
    the voting path writes, with its noisy and clean clouds; the denoised
    clouds are ``infer --spatial`` in one process's."""
    ranks, spec = job()
    one_out, vote_out = str(tmp_path / "one"), str(tmp_path / "vote")
    one = infer.main(infer_argv(spec["one_tree"], spec["config"], one_out,
                                "--spatial"))
    infer.main(infer_argv(spec["one_tree"], spec["config"], vote_out))
    r0, r1 = ranks[0]["cli"], ranks[1]["cli"]
    assert r1["writes"] == [] and "points/s" not in r1["stdout"]
    assert "one spatial forward per cloud" in r0["stdout"]
    listing = lambda d: sorted(  # noqa: E731
        os.path.relpath(os.path.join(a, f), d) for a, _, fs in os.walk(d)
        for f in fs)
    assert sorted(r0["writes"]) == listing(spec["cli_out"]) \
        == listing(vote_out) == listing(one_out)
    for sub in ("noisy", "clean"):
        for f in os.listdir(os.path.join(vote_out, sub)):
            for d in (spec["cli_out"], one_out):
                a = read_ply(os.path.join(d, sub, f))
                b = read_ply(os.path.join(vote_out, sub, f))
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k])
    for got, want in zip(r0["denoised"], one["results"]):
        np.testing.assert_allclose(got, want["denoised"], **SPATIAL_TOL)
    np.testing.assert_array_equal(r0["denoised"][0], r1["denoised"][0])


def test_ranks_import_no_jax(job):
    ranks, _ = job()
    assert [r["numerics"]["jax_loaded"] for r in ranks] == [False, False]
    print("rank seconds (numerics, denoising and CLI):",
          [tuple(round(s, 1) for s in r["seconds"]) for r in ranks])

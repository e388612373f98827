"""The 2-D ``(data, points)`` layout (``parallel.dist.make_mesh_2d``) of
the point-sharded spatial forward and training, on the CPU.

Four gloo ranks (2 data x 2 points), started from a ``spawn`` context and
joined through a ``file://`` store under the test's ``tmp_path``, run
every multi-rank case in one job, one torch thread each; this module
imports no JAX at its top, so the ranks load torch and the port alone
(checked).  The JAX oracles run in this process on ``make_mesh_2d(2, 2)``
over 4 of conftest's 8 CPU devices while the ranks work, jitted with
``use_pallas`` off, at ``tests/test_spatial.py``'s tiny size (width 16,
depth 1, 256 points with a padded tail, B = 2 clouds):

* the layout: rank r at data index r // 2 and points index r % 2, its
  groups' ranks, ``point_rows`` of the points group, ``batch_rows``, and
  the refusal of a layout that is not the world;
* the 2 x 2 forward against the port's one-process forward (rtol 2e-5 /
  atol 2e-6, ``tests/test_spatial.py:243``) and against JAX's
  ``build_spatial_forward(..., axis=POINTS_AXIS, batch_axis=DATA_AXIS)``
  from the same converted weights at the whole-model tolerance (rtol 5e-4
  / atol 5e-5, BatchNorm statistics and the final Dense at O(1));
* 3 Adam steps of ``Trainer(spatial="2d")`` against JAX's on the 2-D mesh
  (losses at rtol 2e-3, ``tests/test_spatial.py:262``), the four ranks'
  states bitwise equal;
* one SGD step's gradient against the one-process Trainer's on the
  global batch at atol 2e-5, with the LR world equal to ``n_data``, also
  with ``loss: chamfer``;
* the 1-D spatial forward on the same four ranks (every rank one points
  shard of the whole batch) against the one-process forward, as before;
* CAA (``cfgs/CAA.yaml`` at ``tests/test_torch_spatial_ops.py``'s
  geometry) in train mode on the 2 x 2 layout, in float64: each rank's
  rows of the output against the one-process forward of the two clouds
  (rtol 2e-5 / atol 2e-6) and the gradients of ``sum(out ** 2)`` summed
  over the four ranks against one process's (rtol 2e-4 / atol 2e-5):
  its point-axis products, which the two ranks of a points group hold
  whole, take their train-mode BatchNorm statistics over all four ranks'
  copies.
"""
import multiprocessing
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deep3dpointclouddenoising_torch.parallel import dist as pdist
from deep3dpointclouddenoising_torch.parallel.spatial import (
    build_spatial_forward, build_spatial_model, gather_points)
from deep3dpointclouddenoising_torch.train.trainer import (Trainer,
                                                           make_optimizer)
from deep3dpointclouddenoising_torch.utils.grad_check import \
    state_difference
from test_torch_spatial import (GIANT, MODEL_TOL, SGD, SPATIAL_TOL, TRAIN,
                                _cfg, _cloud, _model, _train_batch)
from test_torch_spatial_ops import GRAD_TOL
from test_torch_spatial_ops import _model as _op_model

N_DATA, N_POINTS = 2, 2
WORLD = N_DATA * N_POINTS
B = 2
STEPS = 3
JOB_TIMEOUT_S = 600


def _weights():
    """The eval model's state: seeded weights, BatchNorm statistics and
    the final Dense at O(1) (``test_torch_spatial._model``)."""
    return _model("offset_regression", _cfg(), False).state_dict()


def _forward_2d(mesh):
    """The 2 x 2 eval forward of the B clouds: this rank's data rows,
    whole (gathered over its points group)."""
    model, fwd = build_spatial_forward(_cfg(), device="cpu", mesh=mesh)
    model.load_state_dict(_weights())
    xyz, mask = _cloud(B=B)
    return gather_points(fwd(xyz, mask, xyz), xyz.shape[1],
                         mesh.points_group)


def _forward_1d():
    """The 1-D spatial forward over all four ranks, gathered whole."""
    model = build_spatial_model(_cfg()).eval()
    model.load_state_dict(_weights())
    xyz, mask = (torch.from_numpy(a) for a in _cloud(B=B))
    with torch.no_grad():
        return gather_points(model(xyz, mask, xyz), xyz.shape[1])


def _trainer_run(cfg, steps, mesh):
    """``steps`` steps of ``Trainer`` (``spatial="2d"`` with ``mesh``, else
    one process) on its rows of the global batch."""
    tt = Trainer(cfg, 10, torch.Generator().manual_seed(0), "cpu",
                 spatial="2d" if mesh else False, mesh=mesh)
    init = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    batch = _train_batch()
    if mesh:
        rows = mesh.batch_rows(B)
        batch = {k: v[rows] for k, v in batch.items()}
    losses = [tt.train_step(batch).item() for _ in range(steps)]
    return {"losses": losses, "init": init, "lr0": tt.lr_schedule(0),
            "state": {k: v.clone() for k, v in
                      tt.model.state_dict().items()}}


def _caa_train(mesh=None):
    """CAA's train-mode output and the gradients of sum(out ** 2) in
    float64 (positions float32) on the B clouds: with ``mesh`` this rank's
    point rows of its data index's clouds, gathered over its points
    group, and its gradient share; else one process's."""
    model = _op_model("CAA", mesh is not None, mesh=mesh).double().train()
    xyz, mask = (torch.from_numpy(a) for a in _cloud(B=B))
    if mesh is not None:
        rows = mesh.batch_rows(B)
        xyz, mask = xyz[rows], mask[rows]
    out = model(xyz, mask, xyz.double())
    (out ** 2).sum().backward()
    if mesh is not None:
        out = gather_points(out.detach(), xyz.shape[1], mesh.points_group)
    return {"out": out.detach(),
            "grads": {n: p.grad.clone() for n, p in
                      model.named_parameters()}}


def _layout(mesh):
    ranks = lambda g: dist.get_process_group_ranks(g)  # noqa: E731
    with pytest.raises(ValueError, match="needs 6 ranks"):
        pdist.make_mesh_2d(2, 3)
    return {"place": (mesh.data_index, mesh.points_index),
            "points_ranks": ranks(mesh.points_group),
            "data_ranks": ranks(mesh.data_group),
            "rows": pdist.point_rows(5, group=mesh.points_group),
            "batch_rows": mesh.batch_rows(4)}


def rank_main(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        mesh = pdist.make_mesh_2d(N_DATA, N_POINTS)
        out = {"layout": _layout(mesh),
               "forward": _forward_2d(mesh),
               "forward_1d": _forward_1d(),
               "adam": _trainer_run(_cfg(**TRAIN), STEPS, mesh),
               "sgd": _trainer_run(_cfg(**{**TRAIN, **SGD}), 1, mesh),
               "sgd_chamfer": _trainer_run(_cfg(**{**TRAIN, **SGD},
                                                loss="chamfer"), 1, mesh),
               "caa": _caa_train(mesh),
               "jax_loaded": "jax" in sys.modules}
        out["seconds"] = time.perf_counter() - t0
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
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
    """The 4-rank job, started; yields a function that waits for it and
    returns each rank's results."""
    tmp = tmp_path_factory.mktemp("spatial2d")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, WORLD, str(tmp / "store"), str(tmp)))
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
        return results

    yield wait
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


def _jax_runs():
    """JAX's 2-D spatial forward and its ``Trainer(spatial="2d")``'s 3 Adam
    steps on ``make_mesh_2d(2, 2)``, from the port's converted weights."""
    import jax
    import jax.numpy as jnp
    from deep3dpointclouddenoising_tpu.config import default_config as jcfg
    from deep3dpointclouddenoising_tpu.models import \
        build_offset_regression as jax_build
    from deep3dpointclouddenoising_tpu.parallel.mesh import (
        DATA_AXIS, POINTS_AXIS, make_mesh_2d)
    from deep3dpointclouddenoising_tpu.parallel.spatial import (
        build_spatial_forward as jax_spatial_forward,
        build_spatial_model as jax_spatial_model)
    from deep3dpointclouddenoising_tpu.train import Trainer as JaxTrainer
    from deep3dpointclouddenoising_tpu.train.trainer import \
        TrainState as JaxTrainState
    from deep3dpointclouddenoising_torch.convert import flax_from_params

    def jax_cfg(**extra):
        jc = jcfg()
        for k, v in {**GIANT, **extra}.items():
            jc[k] = v
        jc.use_pallas = False
        return jc

    mesh = make_mesh_2d(N_DATA, N_POINTS)
    axes = dict(axis=POINTS_AXIS, batch_axis=DATA_AXIS)
    _, fwd = jax_spatial_forward(jax_cfg(), mesh, **axes)
    xyz, mask = _cloud(B=B)
    out = {"forward": np.asarray(fwd(flax_from_params(_weights()), xyz,
                                     mask, xyz))}
    jc = jax_cfg(**TRAIN)
    _, loss_fn = jax_build(jc)
    jt = JaxTrainer(jc, jax_spatial_model(jc, mesh, **axes), loss_fn, 10,
                    mesh=mesh, spatial="2d")
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
    out["losses"] = losses
    return out


@pytest.fixture(scope="module")
def against_jax(job):
    jax_out = _jax_runs()
    return job(), jax_out


# -- without a group ---------------------------------------------------------

def test_mesh_2d_outside_a_group_is_one_by_one():
    mesh = pdist.make_mesh_2d(1, 1)
    assert mesh == pdist.Mesh2D(1, 1, 0, 0, None, None)
    assert mesh.batch_rows(3) == slice(0, 3)
    assert pdist.point_rows(7, group=mesh.points_group) == slice(0, 7)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        pdist.make_mesh_2d(2, 2)
    with pytest.raises(ValueError, match="mesh"):
        Trainer(_cfg(), 10, device="cpu", spatial="2d")


# -- the 4-rank job ----------------------------------------------------------

def test_mesh_2d_layout_is_row_major(job):
    ranks = job()
    for r, out in enumerate(ranks):
        lay = out["layout"]
        d, p = divmod(r, N_POINTS)
        assert lay["place"] == (d, p)
        assert lay["points_ranks"] == [d * N_POINTS + q
                                       for q in range(N_POINTS)]
        assert lay["data_ranks"] == [e * N_POINTS + p
                                     for e in range(N_DATA)]
        assert lay["rows"] == pdist.point_rows(5, p, N_POINTS)
        assert lay["batch_rows"] == slice(2 * d, 2 * d + 2)


def _one_process_forward():
    model = _model("offset_regression", _cfg(), False)
    xyz, mask = (torch.from_numpy(a) for a in _cloud(B=B))
    with torch.no_grad():
        return model(xyz, mask, xyz)


def test_mesh_2d_forward_matches_one_process(job):
    ranks = job()
    want = _one_process_forward()
    for r, out in enumerate(ranks):
        d = r // N_POINTS
        np.testing.assert_allclose(out["forward"].numpy(),
                                   want[d:d + 1].numpy(), **SPATIAL_TOL)
    for d in range(N_DATA):
        a, b = (ranks[d * N_POINTS + q]["forward"] for q in range(N_POINTS))
        assert torch.equal(a, b)


def test_one_d_spatial_forward_on_four_ranks_is_unchanged(job):
    ranks = job()
    want = _one_process_forward()
    for out in ranks:
        np.testing.assert_allclose(out["forward_1d"].numpy(), want.numpy(),
                                   **SPATIAL_TOL)


def test_mesh_2d_forward_matches_jax(against_jax):
    ranks, jax_out = against_jax
    for r, out in enumerate(ranks):
        d = r // N_POINTS
        np.testing.assert_allclose(out["forward"].numpy(),
                                   jax_out["forward"][d:d + 1], **MODEL_TOL)


def test_mesh_2d_training_matches_jax(against_jax):
    ranks, jax_out = against_jax
    for out in ranks:
        np.testing.assert_allclose(out["adam"]["losses"], jax_out["losses"],
                                   rtol=2e-3)
    first = ranks[0]["adam"]
    for out in ranks[1:]:
        assert out["adam"]["losses"] == first["losses"]
        assert not state_difference(out["adam"]["state"], first["state"])


def _check_sgd_2d(ranks, key, **extra):
    """Each rank's SGD step ``key`` against one process's on the global
    batch (``_cfg(**TRAIN, **SGD, **extra)``): the applied gradients at
    atol 2e-5, the LR counting the data axis alone, the ranks bitwise
    equal."""
    cfg = _cfg(**{**TRAIN, **SGD, **extra})
    one = _trainer_run(cfg, 1, None)
    _, schedule = make_optimizer(cfg, [torch.zeros(1)], 10, N_DATA)
    for out in ranks:
        run = out[key]
        assert run["lr0"] == schedule(0) == N_DATA * one["lr0"]
        for name, p0 in one["init"].items():
            g = (p0 - run["state"][name]) / run["lr0"]
            g_want = (p0 - one["state"][name]) / one["lr0"]
            np.testing.assert_allclose(g.numpy(), g_want.numpy(), atol=2e-5,
                                       rtol=0, err_msg=name)
        assert not state_difference(out[key]["state"],
                                    ranks[0][key]["state"])


def test_mesh_2d_sgd_gradient_matches_one_process(job):
    """One SGD step on 2 x 2 ranks applies the one-process gradient of the
    global batch; its LR counts the data axis alone."""
    _check_sgd_2d(job(), "sgd")


def test_mesh_2d_chamfer_sgd_gradient_matches_one_process(job):
    """The same with ``loss: chamfer``: each cloud's search runs over its
    points group, the clouds count once over the data axis."""
    _check_sgd_2d(job(), "sgd_chamfer", loss="chamfer")


def test_ranks_import_no_jax(job):
    ranks = job()
    assert [out["jax_loaded"] for out in ranks] == [False] * WORLD
    print("rank seconds:", [round(out["seconds"], 1) for out in ranks])


def test_caa_2d_training_matches_one_process(job):
    """CAA on the 2 x 2 layout in train mode: each rank's rows of its
    clouds and the four ranks' summed gradients are one process's on the
    two clouds."""
    ranks = job()
    want = _caa_train()
    for r in ranks:
        d = r["layout"]["place"][0]
        np.testing.assert_allclose(r["caa"]["out"].numpy(),
                                   want["out"][d:d + 1].numpy(),
                                   **SPATIAL_TOL)
    for name, g in want["grads"].items():
        got = sum(r["caa"]["grads"][name] for r in ranks)
        np.testing.assert_allclose(got.numpy(), g.numpy(), **GRAD_TOL,
                                   err_msg=name)

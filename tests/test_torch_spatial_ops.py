"""The point-sharded spatial model over every aggregation operator, and
point-sharded training with the Chamfer losses, on the CPU.

``tests/test_torch_spatial.py``'s pattern: two gloo ranks, started from a
``spawn`` context and joined through a ``file://`` store under the test's
``tmp_path``, run every multi-rank case in one job, one torch thread
each; this module imports no JAX at its top, so the ranks load torch and
the port alone (checked); the JAX oracles run in this process while the
ranks work.  The models are ``cfgs/<config>.yaml``'s operator settings at
``tests/test_spatial.py``'s tiny geometry (256 points with a padded tail,
depth 1) at width 24, the smallest width at which every operator builds
(PosPool ``sin_cos`` needs channel counts that 6 divides; 16 gives the
stem 8), with every BatchNorm's statistics, scale and bias, the attention
gates and the head's final Dense at O(1) values (:func:`_model`), so that
no branch vanishes:

* ``reduce_scatter_points`` and ``all_reduce_max``: their values, their
  adjoints, ties split over both ranks;
* the 2-rank spatial forward of each of the 13 operators (PosPool,
  AdaptiveWeight, PointWiseMLP, the ten attention types) against the
  port's one-process forward: in float64 (positions float32) element by
  element at rtol 2e-5 / atol 2e-6 (``tests/test_spatial.py:68``), and in
  float32 element by element within the larger of that and three times
  the one-process forward's own float32 noise at the element
  (``grad_check.check_forward``).  In float32 the ranks' products over a
  part of the points (``(m, N) @ (N, C)`` where one process takes ``(N,
  N) @ (N, C)``) and the all-reduced sums round otherwise, and the O(1)
  attention gates amplify it: at a few elements four operators' float32
  outputs (FLOAT32_BY_TENSOR) leave that limit, by up to 12 times, where
  one process's own noise happens to be small, while their float64
  forwards agree element by element; those four are held in float32 by
  the whole tensor within three times the one-process noise
  (``grad_check.check_forward_tensor``).  Uneven shards (``npoints = [50,
  22, 10, 3]`` at 200 points) for three operators;
* the gradients of ``sum(out ** 2)`` in train mode, summed over the
  ranks, against one process's at rtol 2e-4 / atol 2e-5 (:178), for the
  13 operators, both sides in float64 (positions float32), so that the
  comparison sees the collectives' algebra and not train-mode BatchNorm's
  float32 cancellations; CAA's BatchNorms over the tensor every rank
  holds whole are what it holds;
* against JAX's ``build_spatial_forward`` on ``make_mesh(2)`` from the
  converted weights: PosPool, Offset-attention, CBAM and CAA, the ranks'
  float64 and float32 forwards element by element at rtol 5e-4 / atol
  5e-5, or within three times JAX's own float32 noise (its distance from
  the one-process float64 forward; ``grad_check.check_forward``);
* point-sharded Chamfer training: 3 Adam steps of ``Trainer(spatial=True)``
  with ``loss: chamfer`` on 2 ranks against JAX's ``Trainer(spatial=True)``
  on ``make_mesh(2)`` (losses at rtol 2e-3, parameters at 6 * lr), the
  ranks bitwise equal; one SGD step's gradient against the one-process
  Trainer's at atol 2e-5 for ``chamfer``, ``chamfer_L1`` and
  ``l1_chamfer_adaptive_to_chamfer``.

Without a group: each operator's spatial model in one process is the
plain model bitwise, and a spatial CAA refuses a level of another slot
count than it was built for.
"""
import multiprocessing
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deep3dpointclouddenoising_torch import infer
from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.models import build_offset_regression
from deep3dpointclouddenoising_torch.parallel import dist as pdist
from deep3dpointclouddenoising_torch.parallel.spatial import (
    build_spatial_model, gather_points)
from deep3dpointclouddenoising_torch.utils.grad_check import (
    check_forward, check_forward_tensor, draw_gates_and_head, float64_copy,
    state_difference)
from test_torch_spatial import (MODEL_TOL, SGD, SPATIAL_TOL, TRAIN,
                                _check_adam, _check_sgd, _cloud,
                                _train_batch)
from test_torch_spatial import _cfg as _kpconv_cfg
from test_torch_spatial import _trainer_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
JOB_TIMEOUT_S = 600
# tests/test_spatial.py:23-39 at width 24
GEOMETRY = dict(num_points=256, width=24, depth=1, radius=0.2,
                sampleDl=0.05, nsamples=[8, 8, 8, 8, 8],
                npoints=[64, 32, 16, 8], head="offset_reg_head", loss="L1",
                input_features_dim=3)
UNEVEN = dict(num_points=200, npoints=[50, 22, 10, 3])
# operator: the config that sets it
OPERATORS = {
    "PosPool": "pospool_sincos_avg",
    "AdaptiveWeight": "adaptiveweight_dp_fc1_avg",
    "PointWiseMLP": "pointwisemlp_dp_fj_max",
    "Non-local": "NOLO", "Criss-cross": "CRCR", "SE": "SEAT",
    "CBAM": "CBAM", "Dual-attention": "DUAT", "A-SCN": "ASCN",
    "Point-attention": "POAT", "Offset-attention": "OFAT", "CAA": "CAA",
    "Point-transformer": "POTR"}
# name: (operator, geometry changes, points)
FORWARDS = {**{op: (op, {}, 256) for op in OPERATORS},
            **{f"{op} uneven": (op, UNEVEN, 200)
               for op in ("Offset-attention", "Criss-cross", "CAA")}}
# the cases whose float32 2-rank forward leaves rtol 2e-5 / atol 2e-6 and
# three times the one-process float32 noise at a few elements (PERF.md
# lists them: the worst element, its noise, both readings); they are held
# by the whole tensor in float32, and element by element in float64
FLOAT32_BY_TENSOR = ("A-SCN", "CAA", "Offset-attention", "Point-transformer")
AGAINST_JAX = ("PosPool", "Offset-attention", "CBAM", "CAA")
CHAMFER_LOSSES = ("chamfer", "chamfer_L1", "l1_chamfer_adaptive_to_chamfer")
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _cfg(op, **extra):
    """``cfgs/<config>.yaml`` of ``op`` cut to GEOMETRY."""
    cfg = load_config(os.path.join(ROOT, "cfgs", OPERATORS[op] + ".yaml"))
    for k, v in {**GEOMETRY, **extra}.items():
        cfg[k] = v
    return cfg


def _model(op, spatial, extra=None, seed=0, mesh=None):
    """``op``'s offset model from generator seed ``seed`` (spatial: on
    ``mesh``, a 2-D layout, or over every rank), in eval mode, its
    BatchNorms' statistics, scales and biases, the attention gates and the
    head's final Dense at O(1) values (numpy draws from ``seed``)."""
    cfg = _cfg(op, **(extra or {}))
    g = torch.Generator().manual_seed(seed)
    model = build_spatial_model(cfg, generator=g, mesh=mesh) if spatial \
        else build_offset_regression(cfg, g)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                a = rng.normal(size=tuple(buf.shape)) * 0.5
            elif name.endswith("running_var"):
                a = rng.uniform(0.5, 2.0, size=tuple(buf.shape))
            else:
                continue
            buf.copy_(torch.from_numpy(a.astype(np.float32)))

    def other(name, shape):
        leaf = name.rsplit(".", 1)[-1]
        if "BatchNorm" in name and leaf == "weight":
            return rng.uniform(0.5, 2.0, size=shape)
        if leaf == "bias":
            return rng.normal(size=shape) * 0.1
        return None

    draw_gates_and_head(model, rng, other)
    return model.eval()


def _forward(name, spatial):
    """Case ``name``'s eval output in float32 and in float64 (positions
    float32), whole on every rank, and the model's state keys and
    shapes."""
    op, extra, n = FORWARDS[name]
    model = _model(op, spatial, extra)
    xyz, mask = (torch.from_numpy(a) for a in _cloud(N=n))
    with torch.no_grad():
        out = [m(xyz, mask, xyz.to(dt)) for m, dt in (
            (model, torch.float32), (float64_copy(model), torch.float64))]
        if spatial:
            out = [gather_points(o, n) for o in out]
    return out, {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _grads(op, spatial):
    """The gradient of sum(out ** 2) of ``op``'s model in train mode, in
    float64 (positions float32), in every parameter (this rank's share in
    the spatial model)."""
    model = _model(op, spatial).double().train()
    xyz, mask = (torch.from_numpy(a) for a in _cloud())
    (model(xyz, mask, xyz.double()) ** 2).sum().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _collectives(rank):
    """reduce_scatter_points of a (1, 5, 2) partial (rows 3 and 2), its
    adjoint under a rank's cotangent; all_reduce_max over points with a
    tie on each rank, its adjoint under each rank's cotangent."""
    rng = np.random.default_rng(rank)
    x = torch.from_numpy(rng.normal(size=(1, 5, 2)).astype(np.float32))
    x.requires_grad_()
    y = pdist.reduce_scatter_points(x, 5)
    w = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
    (y * w).sum().backward()
    rows = pdist.point_rows(5)
    # channel 0: the max 3.0 twice on rank 0 and once on rank 1;
    # channel 1: rank 1's own max
    m = torch.tensor([[[3.0, 0.0], [1.0, -1.0], [3.0, 0.5]],
                      [[0.0, 2.0], [3.0, 1.0], [-4.0, 0.0]]])[rank][None]
    m = m[:, :3 - rank].clone().requires_grad_()
    mx = pdist.all_reduce_max(m, 1)
    c = torch.tensor([[[2.0, 5.0]], [[4.0, 7.0]]])[rank][None]
    (mx * c).sum().backward()
    return {"x": x.detach(), "y": y.detach(), "w": w, "x_grad": x.grad,
            "rows": rows, "max": mx.detach(), "max_grad": m.grad}


def _numerics(rank):
    out = {"jax_loaded": "jax" in sys.modules,
           "collectives": _collectives(rank),
           "forwards": {name: _forward(name, True) for name in FORWARDS},
           "grads": {op: _grads(op, True) for op in OPERATORS},
           "adam": _trainer_run(_kpconv_cfg(**TRAIN, loss="chamfer"),
                                3, True),
           "sgd": {loss: _trainer_run(_kpconv_cfg(**{**TRAIN, **SGD},
                                                  loss=loss), 1, True)
                   for loss in CHAMFER_LOSSES}}
    return out


def rank_main(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = _numerics(rank)
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
    """The 2-rank job, started; yields a function that waits for it and
    returns each rank's results."""
    tmp = tmp_path_factory.mktemp("spatial_ops")
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


# -- against JAX (first: its oracles run in this process while the ranks
# work) ------------------------------------------------------------------

def _jax_cfg(op, **extra):
    from deep3dpointclouddenoising_tpu.config import load_config as jload
    jc = jload(os.path.join(ROOT, "cfgs", OPERATORS[op] + ".yaml"))
    for k, v in {**GEOMETRY, **extra}.items():
        jc[k] = v
    jc.use_pallas = False
    return jc


def _jax_runs():
    """JAX's spatial forward of each of AGAINST_JAX and its spatial
    Trainer's 3 Adam steps with ``loss: chamfer``, on ``make_mesh(2)``
    from the port's converted weights."""
    import jax
    import jax.numpy as jnp
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
    from deep3dpointclouddenoising_torch.train.trainer import Trainer
    from test_torch_spatial import _jax_cfg as _jax_kpconv_cfg
    mesh = make_mesh(WORLD)
    out = {"forward": {}}
    xyz, mask = _cloud()
    for op in AGAINST_JAX:
        variables = flax_from_params(_model(op, False).state_dict())
        _, fwd = jax_spatial_forward(_jax_cfg(op), mesh)
        out["forward"][op] = np.asarray(fwd(variables, xyz, mask, xyz))

    jc = _jax_kpconv_cfg(**TRAIN, loss="chamfer")
    _, loss_fn = jax_build(jc)
    jt = JaxTrainer(jc, jax_spatial_model(jc, mesh), loss_fn, 10, mesh=mesh,
                    spatial=True)
    tt = Trainer(_kpconv_cfg(**TRAIN, loss="chamfer"), 10,
                 torch.Generator().manual_seed(0), "cpu")
    init = flax_from_params({k: v.detach() for k, v in
                             tt.model.state_dict().items()})
    state = jt.put_replicated(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=init["params"],
        batch_stats=init["batch_stats"],
        opt_state=jt.tx.init(init["params"])))
    batch = _train_batch()
    losses = []
    for i in range(3):
        state, loss = jt.train_step(state, batch, jax.random.PRNGKey(100 + i))
        losses.append(float(loss))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    out["adam"] = {"losses": losses,
                   "params": params_from_flax({"params": params})}
    return out


@pytest.fixture(scope="module")
def against_jax(job):
    jax_out = _jax_runs()
    return job(), jax_out


@pytest.mark.parametrize("op", AGAINST_JAX)
def test_spatial_forward_matches_jax_on_two_devices(against_jax, op):
    ranks, jax_out = against_jax
    want = torch.tensor(jax_out["forward"][op])
    assert want.abs().max() > 1.0
    (_, one64), _ = _forward(op, False)
    for r in ranks:
        got, got64 = r["forwards"][op][0]
        check_forward(got64, want, one64, **MODEL_TOL)
        check_forward(got, want, one64, **MODEL_TOL)


def test_spatial_chamfer_training_matches_jax_on_two_devices(against_jax):
    ranks, jax_out = against_jax
    for r in ranks:
        _check_adam(r["adam"], jax_out["adam"])
    a, b = (r["adam"] for r in ranks)
    assert a["losses"] == b["losses"]
    assert not state_difference(a["state"], b["state"])


# -- the 2-rank job ----------------------------------------------------------

def test_reduce_scatter_points_and_its_adjoint(job):
    ranks = job()
    total = sum(r["collectives"]["x"] for r in ranks)
    w = torch.cat([r["collectives"]["w"] for r in ranks], dim=1)
    for r in ranks:
        c = r["collectives"]
        torch.testing.assert_close(c["y"], total[:, c["rows"]], rtol=0,
                                   atol=1e-6)
        # every rank's partial reaches every row: its gradient is the
        # whole cotangent
        assert torch.equal(c["x_grad"], w)


def test_all_reduce_max_splits_the_gradient_among_every_rank_s_ties(job):
    ranks = job()
    a, b = (r["collectives"] for r in ranks)
    assert torch.equal(a["max"], torch.tensor([[[3.0, 2.0]]]))
    assert torch.equal(b["max"], a["max"])
    # channel 0: 2 + 4 = 6 split over three ties (two on rank 0);
    # channel 1: 5 + 7 = 12 to rank 1's one maximum
    assert torch.equal(a["max_grad"], torch.tensor(
        [[[2.0, 0.0], [0.0, 0.0], [2.0, 0.0]]]))
    assert torch.equal(b["max_grad"], torch.tensor(
        [[[0.0, 12.0], [2.0, 0.0]]]))


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_spatial_forward_matches_one_process(job, name):
    ranks = job()
    (want, want64), keys = _forward(name, False)
    for r in ranks:
        (got, got64), got_keys = r["forwards"][name]
        assert got_keys == keys
        np.testing.assert_allclose(got64.numpy(), want64.numpy(),
                                   **SPATIAL_TOL)
        if name in FLOAT32_BY_TENSOR:
            check_forward_tensor(got, want, want64)
        else:
            check_forward(got, want, want64, **SPATIAL_TOL)
    for i in range(2):
        assert torch.equal(ranks[0]["forwards"][name][0][i],
                           ranks[1]["forwards"][name][0][i])


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_spatial_gradients_match_one_process(job, op):
    ranks = job()
    want = _grads(op, False)
    for name, g in want.items():
        got = sum(r["grads"][op][name] for r in ranks)
        np.testing.assert_allclose(got.numpy(), g.numpy(), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("loss", CHAMFER_LOSSES)
def test_spatial_chamfer_sgd_gradient_matches_one_process(job, loss):
    """One SGD step of a Chamfer loss on 2 ranks applies the one-process
    gradient; the ranks end bitwise equal."""
    ranks = job()
    one = _trainer_run(_kpconv_cfg(**{**TRAIN, **SGD}, loss=loss), 1, False)
    for r in ranks:
        _check_sgd(r["sgd"][loss], one)
    assert not state_difference(ranks[0]["sgd"][loss]["state"],
                                ranks[1]["sgd"][loss]["state"])


def test_ranks_import_no_jax(job):
    ranks = job()
    assert [r["jax_loaded"] for r in ranks] == [False, False]
    print("rank seconds:", [round(r["seconds"], 1) for r in ranks])


# -- without a group -------------------------------------------------------

@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_spatial_model_in_one_process_is_the_plain_model(op):
    """Outside a process group every operator's spatial model is the plain
    model: the same state keys and shapes, the same output bitwise."""
    plain, spatial = _model(op, False), _model(op, True)
    assert {k: v.shape for k, v in plain.state_dict().items()} == \
        {k: v.shape for k, v in spatial.state_dict().items()}
    xyz, mask = (torch.from_numpy(a) for a in _cloud())
    with torch.no_grad():
        assert torch.equal(spatial(xyz, mask, xyz), plain(xyz, mask, xyz))


def test_spatial_caa_refuses_another_slot_count():
    """A CAA model takes the slot counts it was built for: the spatial
    forward of a cloud of other counts is refused before its weights
    load."""
    state = _model("CAA", False).state_dict()
    with pytest.raises(ValueError, match="CAA model takes only"):
        infer._check_slot_counts(
            build_spatial_model(infer.spatial_config(_cfg("CAA"), 512)),
            state, 512)
    infer._check_slot_counts(_model("PosPool", True),
                             _model("PosPool", False).state_dict(), 256)

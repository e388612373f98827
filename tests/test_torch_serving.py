"""Sealed serving export in the port (``serving.py``, ``export_model.py``)
against the JAX package's (``serving.py``), on the CPU.

The port's exported forward and JAX's ``make_serving_forward`` from the
same converted weights (O(1) head and statistics, as
``tests/test_torch_model.py``) agree at the whole-model tolerance (rtol
5e-4 / atol 5e-5), with and without ``cfg.norm`` scaling, and for full
cleaning's four raw channels (the cases of ``tests/test_serving.py``); a
saved and loaded artifact equals the eager forward within rtol 1e-6 /
atol 1e-7; its sidecar has JAX's keys and abstract values.  The KPConv
aggregation is an opaque custom op of the exported graph
(``torch.library.opcheck`` holds both ops' schema, fake and autograd
registrations), and a query that compacts its supports in eager mode
exports with the same indices.  torch runs in one thread.
"""
import json
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.models.build import \
    CompleteDenoisingModel as JaxCleaningModel
from deep3dpointclouddenoising_tpu.models.build import \
    OffsetRegressionModel as JaxModel
from deep3dpointclouddenoising_tpu import serving as jax_serving
from deep3dpointclouddenoising_torch import export_model, infer, serving
from deep3dpointclouddenoising_torch.config import default_config, \
    load_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.models import (CompleteDenoisingModel,
                                                    OffsetRegressionModel)
from deep3dpointclouddenoising_torch.ops import kpconv as tkp
from deep3dpointclouddenoising_torch.ops import neighbors as tnb

from test_torch_model import perturb, small_config, small_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TOL = dict(rtol=5e-4, atol=5e-5)
ROUND_TRIP_TOL = dict(rtol=1e-6, atol=1e-7)
# a norm factor (in_radius / 100 in a config) that is a power of two:
# x * NORM / NORM == x and NORM * y are exact in float32, so JAX's forward
# with NORM on x * NORM is NORM times its forward without on x, bitwise
NORM = 2.0 ** -7


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(torch_cls, jax_cls, seed=0):
    rng = np.random.default_rng(seed)
    jcfg = small_config(jax_cfg())
    jcfg.use_pallas = 0
    tmodel = torch_cls(small_config(default_config()),
                       torch.Generator().manual_seed(seed)).eval()
    variables = perturb(flax_from_params(tmodel.state_dict()), rng)
    tmodel.load_state_dict(params_from_flax(variables, tmodel))
    return tmodel, jax_cls(cfg=jcfg), variables


def _batch(scale=1.0):
    xyz, mask = small_inputs(np.random.default_rng(1))
    xyz = (xyz * scale).astype(np.float32)
    return {"points": xyz, "mask": mask, "features": xyz.copy()}


def _jax_forward(jmodel, variables, batch, norm_factor, scale_outputs=True):
    fwd = jax.jit(jax_serving.make_serving_forward(
        jmodel, variables, norm_factor=norm_factor,
        scale_outputs=scale_outputs))
    return np.asarray(fwd(batch["points"], batch["mask"],
                          batch["features"]))



def _run(exported, batch) -> np.ndarray:
    """The exported program's output on ``batch`` (the save and load are
    the ``artifact`` fixture's)."""
    with torch.no_grad():
        return exported.module()(*(torch.from_numpy(batch[k]) for k in (
            "points", "mask", "features"))).numpy()


def _kpconv_nodes(exported, name):
    return sum(1 for n in exported.graph.nodes if n.op == "call_function"
               and str(n.target).startswith(f"d3pcd_torch.{name}"))


@pytest.fixture(scope="module")
def offset():
    tmodel, jmodel, variables = _models(OffsetRegressionModel, JaxModel)
    return dict(tmodel=tmodel, jmodel=jmodel, variables=variables,
                jax_out=_jax_forward(jmodel, variables, _batch(), None))


@pytest.fixture(scope="module")
def artifact(offset, tmp_path_factory):
    """The offset model (no norm) exported, saved and loaded."""
    path = str(tmp_path_factory.mktemp("artifact") / "denoiser.pt2")
    batch = _batch()
    exported = serving.export_denoiser(offset["tmodel"], batch)
    serving.save_artifact(exported, path, meta={"test": True})
    return dict(path=path, batch=batch, exported=exported,
                predict=serving.load_denoiser(path))


def test_export_matches_jax_and_eager(offset, artifact):
    batch, predict = artifact["batch"], artifact["predict"]
    got = predict(batch["points"], batch["mask"], batch["features"]).numpy()
    want = offset["jax_out"]
    assert got.shape == want.shape == (2, 64, 3)
    assert np.abs(want).max() > 1.0  # the perturbed head is O(1)
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    eager = infer.make_predict_fn(offset["tmodel"])(batch).numpy()
    np.testing.assert_allclose(got, eager, **ROUND_TRIP_TOL)


def test_export_with_norm_scales_offsets(offset, artifact):
    """cfg.norm: inputs divided by f, offsets multiplied back, out of
    place (``infer.make_predict_fn`` scales in place).  JAX's serving
    forward with ``NORM`` on ``x * NORM`` is ``NORM`` times its forward
    without on ``x`` (see ``NORM``)."""
    batch = _batch(NORM)
    got = _run(serving.export_denoiser(offset["tmodel"], batch,
                                       norm_factor=NORM), batch)
    assert np.array_equal(batch["points"] / np.float32(NORM),
                          artifact["batch"]["points"])
    want = NORM * offset["jax_out"]
    assert np.abs(want).max() > NORM
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    eager = infer.make_predict_fn(offset["tmodel"], NORM)(batch).numpy()
    np.testing.assert_allclose(got, eager, **ROUND_TRIP_TOL)


def test_full_cleaning_artifact_keeps_raw_outputs():
    """Full cleaning: four raw channels, the logit never scaled, the
    offsets left unscaled for ``f * tanh(raw)``."""
    tmodel, jmodel, variables = _models(CompleteDenoisingModel,
                                        JaxCleaningModel, seed=2)
    batch = _batch(NORM)
    got = _run(serving.export_denoiser(tmodel, batch, norm_factor=NORM,
                                       scale_outputs=False), batch)
    want = _jax_forward(jmodel, variables, batch, NORM, scale_outputs=False)
    assert got.shape == (2, 64, 4) and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    eager = infer.make_predict_fn(tmodel, NORM, False)(batch).numpy()
    np.testing.assert_allclose(got, eager, **ROUND_TRIP_TOL)


def test_sidecar_has_jax_keys(offset, artifact, tmp_path):
    batch = artifact["batch"]
    jpath = str(tmp_path / "denoiser.stablehlo")
    jax_serving.save_artifact(jax_serving.export_denoiser(
        offset["jmodel"], offset["variables"], batch), jpath,
        meta={"test": True})
    meta = serving.artifact_meta(artifact["path"])
    want = jax_serving.artifact_meta(jpath)
    assert set(meta) == set(want)
    for key in ("format_version", "platforms", "in_avals", "out_avals",
                "nr_devices", "test"):
        assert meta[key] == want[key], key
    assert meta["in_avals"] == ["float32[2,64,3]", "float32[2,64]",
                                "float32[2,64,3]"]
    assert meta["bytes"] == os.path.getsize(artifact["path"]) > 0


def test_graph_holds_the_kpconv_op(artifact):
    """One opaque forward op per PseudoGrid call (ten at depth 2), no
    backward; the exported graph runs them on the CPU's plain version."""
    exported = artifact["exported"]
    assert _kpconv_nodes(exported, "kpconv_fwd") == 10
    assert _kpconv_nodes(exported, "kpconv_bwd") == 0
    loaded = artifact["predict"].exported
    assert _kpconv_nodes(loaded, "kpconv_fwd") == 10


def test_loaded_artifact_needs_no_model_code(artifact, tmp_path):
    """A fresh process that imports only ``serving`` loads and runs the
    artifact: equal to eager, and no model module imported."""
    batch = artifact["batch"]
    np.savez(tmp_path / "batch.npz", **batch)
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from deep3dpointclouddenoising_torch import serving\n"
        f"b = np.load({str(tmp_path / 'batch.npz')!r})\n"
        f"p = serving.load_denoiser({artifact['path']!r})\n"
        "out = p(b['points'], b['mask'], b['features']).numpy()\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.startswith('deep3dpointclouddenoising')))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    modules = eval(run.stdout.strip().splitlines()[-1])
    assert not any(".models" in m or ".infer" in m or ".config" in m
                   for m in modules), modules
    got = np.load(tmp_path / "out.npy")
    want = artifact["predict"](batch["points"], batch["mask"],
                               batch["features"]).numpy()
    np.testing.assert_allclose(got, want, **ROUND_TRIP_TOL)


def test_export_where_the_query_compacts(offset, artifact, monkeypatch):
    """With the chunk budget forced small the eager queries compact their
    supports (a count read on the host); under export they do not, and
    the exported query gives the same indices and the exported model the
    same output."""
    chunk = tnb.auto_chunk
    monkeypatch.setattr(tnb, "auto_chunk",
                        lambda b, m, n, budget=3 * 2 * 64 * 8:
                        chunk(b, m, n, budget))
    calls = []
    compact = tnb.compact_supports
    monkeypatch.setattr(tnb, "compact_supports",
                        lambda *a: calls.append(1) or compact(*a))
    batch = artifact["batch"]
    xyz, mask = (torch.from_numpy(batch[k]) for k in ("points", "mask"))

    class Query(torch.nn.Module):
        def forward(self, q, s, qm, sm):
            return tnb.masked_ordered_ball_query(q, s, qm, sm, radius=0.3,
                                                 nsample=8)

    args = (xyz[:, :16].contiguous(), xyz, mask[:, :16].contiguous(), mask)
    want = Query()(*args)
    assert len(calls) == 1
    exported = torch.export.export(Query(), args, strict=False)
    assert len(calls) == 1  # not under export
    got = exported.module()(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the artifact (exported without compaction) against the eager model
    # that compacts
    eager = infer.make_predict_fn(offset["tmodel"])(batch).numpy()
    assert len(calls) > 1
    got = artifact["predict"](batch["points"], batch["mask"],
                              batch["features"]).numpy()
    np.testing.assert_allclose(got, eager, **ROUND_TRIP_TOL)


def _op_args(dtype, op, needs=(True, True, False)):
    rng = np.random.default_rng(5)
    B, N, M, K, C, P = 2, 20, 15, 6, 8, 15
    f = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, N, (B, M, K)).astype(np.int32))
    rel = torch.from_numpy(
        (0.1 * rng.normal(size=(B, M, K, 3))).astype(np.float32))
    mask = torch.from_numpy((rng.random((B, M, K)) > 0.2).astype(np.float32))
    kp = torch.from_numpy((0.1 * rng.normal(size=(P, 3))).astype(np.float32))
    kw = torch.from_numpy(rng.normal(size=(P, C)).astype(np.float32))
    f = f.to(dtype)
    if op == "kpconv_fwd":
        return (f.requires_grad_(), idx,
                rel.requires_grad_(dtype == torch.float32), mask, kp,
                kw.requires_grad_(), 0.12, "linear")
    g = torch.from_numpy(rng.normal(size=(B, M, C)).astype(np.float32))
    return (f, idx, rel, mask, kp, kw, g.to(dtype), 0.12, "gaussian", *needs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["kpconv_fwd", "kpconv_bwd"])
def test_opcheck(op, dtype):
    """Schema, fake implementation, autograd registration and AOT
    dispatch of both ops on the CPU (the plain versions); the backward
    for each set of gradients asked, d_rel in float32 only."""
    target = getattr(torch.ops.d3pcd_torch, op).default
    if op == "kpconv_fwd":
        cases = [_op_args(dtype, op)]
    else:
        needs = [(True, True, False), (True, False, False),
                 (False, True, False), (False, False, False)]
        if dtype == torch.float32:
            needs.append((True, True, True))
        cases = [_op_args(dtype, op, n) for n in needs]
    for args in cases:
        result = torch.library.opcheck(target, args)
        assert set(result.values()) == {"SUCCESS"}, result
    assert tkp.kpconv_aggregate.launches == 0  # no kernel on the CPU


def test_export_model_cli_checks_the_round_trip(tmp_path, capsys):
    """``export_model --check --device cpu`` on a checkpoint of the
    l1.yaml model at width 8: the artifact, its sidecar and the check."""
    with open(os.path.join(ROOT, "cfgs", "l1.yaml")) as f:
        text = f.read().replace("width: 144", "width: 8")
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(text + "\nnum_points: 64\n")
    cfg = load_config(str(cfg_path))
    model = infer.load_model(cfg, "cpu", seed=3)
    ckpt = str(tmp_path / "weights.pt")
    torch.save(model.state_dict(), ckpt)
    out = str(tmp_path / "l1.pt2")
    result = export_model.main(["--config_file", str(cfg_path),
                                "--checkpoint", ckpt, "--out", out,
                                "--batch_size", "2", "--check",
                                "--device", "cpu"])
    text = capsys.readouterr().out
    assert "CHECK OK" in text and result["err"] <= 1e-5 * max(
        result["scale"], 1.0)
    meta = serving.artifact_meta(out)
    assert meta["platforms"] == ["cpu"] and meta["in_avals"][0] \
        == "float32[2,64,3]" and meta["full_cleaning"] is False
    assert json.loads(text[:text.index("exported in")]) == meta
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.main(["--config_file", str(cfg_path), "--checkpoint",
                           ckpt, "--out", out])

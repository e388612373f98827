"""The ``custom_cfgs`` ablation sweep (``run_custom_sweep``) on the CPU:
its stand-in scans byte for byte the JAX script's, its metric parser on
the port's evaluation table, its config order, one train step of each of
the 17 configs through the port's ``train_outlier_seg`` at width 24 (the
narrowest at which the Non-local operator keeps a channel: width / 2 / 8),
64-point patches and two scans a split, one config swept end to end
(training and evaluation each in a process of their own) on small scans,
and a failing config ending the sweep with exit code 1.
"""
import filecmp
import glob
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from deep3dpointclouddenoising_torch import run_custom_sweep, \
    train_outlier_seg
from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.data.scans import make_scans
from deep3dpointclouddenoising_torch.utils.metrics import (
    format_metric_table, metrics_from_confusion)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "cfgs", "custom_cfgs",
                                        "*.yaml")))
TINY = ["--width", "24", "--num_points", "64", "--batch_size", "2",
        "--device", "cpu"]
# a scan of this many points keeps the sweep's voting evaluation (no
# --DEBUG: three whole test scans, about a patch per point at 64 points
# and in_radius 2.0) to a few seconds at batch 16
SCAN_POINTS = 600
# each config's operator: its LocalAggregation's submodule
OPERATORS = {"pseudogrid": "PseudoGrid_0", "pospool": "PosPool_0",
             "adaptativeweight": "AdaptiveWeight_0",
             "pointwisemlp": "PointWiseMLP_0",
             "Non-local": "AttentionAggregation_0"}


def _jax_script():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import run_custom_sweep as jax_sweep
    finally:
        sys.path.pop(0)
    return jax_sweep


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the sweep's processes
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sweep_scans") / "scans")
    make_scans(root, n=SCAN_POINTS)
    return root


def test_scans_are_the_jax_scripts_byte_for_byte(tmp_path):
    _jax_script().make_scans(str(tmp_path / "jax"), n_scans=2, n=400,
                             seed=3)
    make_scans(str(tmp_path / "torch"), n_scans=2, n=400, seed=3)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["pointcloud_00.ply", "pointcloud_01.ply"]
    assert sorted(os.listdir(tmp_path / "torch")) == names
    for n in names:
        assert filecmp.cmp(str(tmp_path / "jax" / n),
                           str(tmp_path / "torch" / n), shallow=False)


def test_parse_metrics_reads_the_evaluation_table():
    metrics = metrics_from_confusion(np.array([[50, 3], [4, 9]]))
    text = "val [1] loss 0.3\n" + format_metric_table(metrics, "test")
    got = run_custom_sweep.parse_metrics(text)
    assert tuple(got) == run_custom_sweep.METRIC_KEYS
    for k, v in got.items():
        assert v == float(f"{metrics[k]:.2f}")
    assert got == _jax_script().parse_metrics(text)
    assert run_custom_sweep.parse_metrics("no table") == {}


def test_configs_run_core_matrix_first():
    order = [os.path.basename(c)
             for c in run_custom_sweep.ordered_configs(CONFIGS)]
    assert len(CONFIGS) == 17
    assert not any(n.startswith(("pseudogrid", "Non-local"))
                   for n in order[:12])
    assert sorted(order[12:]) == sorted(
        n for n in map(os.path.basename, CONFIGS)
        if n.startswith(("pseudogrid", "Non-local")))


@pytest.mark.parametrize("config", CONFIGS, ids=os.path.basename)
def test_custom_config_takes_a_train_step(config, scans, tmp_path):
    """One step of the config's model on two train scans' patches, with
    the config's features and operator."""
    summary = train_outlier_seg.main(
        ["--config_file", config, "--data_root", scans, "--log_dir",
         str(tmp_path), "--num_steps", "2", "--epochs", "1", "--DEBUG", "1",
         "--dataset_type", "EDFS", *TINY])
    assert summary["steps"] == 1
    assert np.isfinite(summary["train_losses"]).all()
    cfg = load_config(config)
    model = summary["trainer"].model
    kind = os.path.basename(config).split("_")[0]
    ops = {m.op for m in model.modules() if hasattr(m, "op")}
    assert ops == {OPERATORS[kind]}
    n_feat = len(cfg.katz_params) * any("katz" in f for f in cfg.features) \
        + ("intensity" in cfg.features)
    assert model.ResNetEncoder_0.ConvBN_0.Dense_0.in_features == \
        (3 if n_feat == 0 else 3 * -(-n_feat // 3))
    assert os.path.exists(os.path.join(tmp_path, cfg.experiment_name,
                                       "current.pt"))


def test_sweep_runs_one_config_end_to_end(scans, tmp_path, capsys):
    """pospool___ trained (1 epoch of 2 steps of 16 patches) and evaluated
    on the test split by the sweep's processes; its table row is the
    metrics read back."""
    out = tmp_path / "sweep"
    shutil.copytree(scans, str(out / "scans"))
    config = os.path.join(ROOT, "cfgs", "custom_cfgs", "pospool___.yaml")
    res = run_custom_sweep.main(
        ["--out_dir", str(out), "--configs", config, "--epochs", "1",
         "--num_steps", "32", *TINY, "--batch_size", "16"])
    text = capsys.readouterr().out
    assert "generating" not in text and "pospool___: {" in text
    (name, met), = res["rows"]
    assert name == "pospool___" and set(met) == set(
        run_custom_sweep.METRIC_KEYS)
    assert all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in met.values())
    assert res["seconds"]["pospool___"] > 0
    with open(res["table"]) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("| config | macc | mIoU |")
    assert lines[2] == "| pospool___ | " + " | ".join(
        f"{met[k]:.1f}" for k in run_custom_sweep.METRIC_KEYS) + " |"
    assert os.path.exists(str(out / "log" / "custom_pospool" /
                              "current.pt"))


def test_sweep_fails_loudly(scans, tmp_path, capsys):
    """A config whose training fails (here: its file is missing) is
    printed with its error, stands as FAILED, and the sweep exits with
    code 1."""
    out = tmp_path / "sweep"
    shutil.copytree(scans, str(out / "scans"))
    bad = str(tmp_path / "bad.yaml")
    with pytest.raises(SystemExit) as exc:
        run_custom_sweep.main(["--out_dir", str(out), "--configs", bad,
                               "--epochs", "1", "--num_steps", "2", *TINY])
    assert exc.value.code == 1
    text = capsys.readouterr().out
    assert "bad: TRAIN FAILED (exit code 1)" in text
    assert "FileNotFoundError" in text and bad in text
    with open(str(out / "ablation_table.md")) as f:
        assert f.read().splitlines()[2] == "| bad | FAILED |"

"""Run logs and device traces of the port's training entry points, on the
CPU: ``utils/logger.py`` (``log.txt``, ``metrics.jsonl`` in the JAX
package's schema, read by ``scripts/plot_metrics.load_metrics``),
``utils/profiling.py`` (``device_trace``'s Chrome trace, ``StepTimer``),
and every training entry point writing JAX's tags at JAX's steps (one
per epoch): ``train/loss``, ``train/lr`` and ``val/loss``
(``scripts/train.py:336-354``), ``train/loss`` and ``val/loss``
(``train_full_cleaning.py``, ``train_outlier_seg.py``, ``train_pcn.py``),
``train/loss`` and ``val/accuracy`` (``train_discriminator.py``),
``train/<metric>`` (``train_gan.py``).  Imports no JAX; torch runs in one
thread (tiny steps under the Tier-1 command's six workers run many times
slower with torch's default threads).
"""
import importlib.util
import json
import logging
import os

import numpy as np
import pytest
import torch

from deep3dpointclouddenoising_torch import evaluate_outlier_seg, \
    train_discriminator, train_full_cleaning, train_gan, train_outlier_seg, \
    train_pcn
from deep3dpointclouddenoising_torch.data.meshio import save_off
from deep3dpointclouddenoising_torch.data.scans import make_scans
from deep3dpointclouddenoising_torch.data.synthetic import make_icosphere, \
    make_torus
from deep3dpointclouddenoising_torch.train import __main__ as train_cli
from deep3dpointclouddenoising_torch.train.gan import METRICS
from deep3dpointclouddenoising_torch.utils.logger import (
    MetricsWriter, get_logger, run_logs, setup_logger)
from deep3dpointclouddenoising_torch.utils.profiling import (
    TRACE_NAME, StepTimer, device_trace)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = os.path.join(ROOT, "cfgs")


def _plot_metrics():
    spec = importlib.util.spec_from_file_location(
        "plot_metrics", os.path.join(ROOT, "scripts", "plot_metrics.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapes")
    for split in ("train", "val"):
        (root / split).mkdir()
        save_off(str(root / split / "sphere.off"), make_icosphere(2))
    save_off(str(root / "train" / "torus.off"), make_torus())
    return str(root)


def _config(tmp_path, name: str, extra: str = "") -> str:
    """``cfgs/<name>.yaml`` at width 8 (a multiple of what every config's
    stem needs) with small batches."""
    with open(os.path.join(CFGS, name + ".yaml")) as f:
        text = f.read().replace("width: 144", "width: 8")
    path = tmp_path / f"{name}.yaml"
    path.write_text(text + "\nbatch_size: 4\nprint_freq: 1\n" + extra)
    return str(path)


def _tiny(cfg_path, tree, log_dir, epochs=2, points=64):
    return ["--config_file", cfg_path, "--data_root", tree, "--log_dir",
            str(log_dir), "--num_steps", "8", "--num_points", str(points),
            "--epochs", str(epochs), "--val_freq", "1",
            "--num_points_per_shape", "1500", "--device", "cpu"]


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _tags_steps(records):
    out = {}
    for r in records:
        out.setdefault(r["tag"], []).append(r["step"])
    return out


class Killed(Exception):
    """Stands for the end of a process killed at a checkpoint."""


def test_setup_logger_writes_log_txt_and_the_current_stdout(tmp_path,
                                                             capsys):
    logger = setup_logger(str(tmp_path / "a"))
    logger.info("first line")
    assert capsys.readouterr().out == "first line\n"
    # a second run of the process moves the file, and the stream is the
    # stdout of the moment (a test's capture), not the first call's
    logger = setup_logger(str(tmp_path / "b"))
    logger.info("second line")
    assert capsys.readouterr().out == "second line\n"
    with open(tmp_path / "a" / "log.txt") as f:
        a = f.read()
    with open(tmp_path / "b" / "log.txt") as f:
        b = f.read()
    assert "first line" in a and "second line" not in a
    assert b.rstrip().endswith("d3pcd_torch INFO: second line")
    with run_logs(str(tmp_path / "c"), metrics=False) as (log, writer):
        assert writer is None and log is get_logger()
        log.info("third")
    assert capsys.readouterr().out == "third\n"
    assert not get_logger().handlers


def test_metrics_writer_appends_jsonl_that_plot_metrics_reads(tmp_path):
    for values in ((1.0, 2.0), (5.0,)):  # a resumed run appends
        writer = MetricsWriter(str(tmp_path), tensorboard=False)
        for step, value in enumerate(values, 1):
            writer.add_scalar("train/loss", np.float32(value), step)
        writer.close()
    assert _records(tmp_path) == [
        {"tag": "train/loss", "value": 1.0, "step": 1},
        {"tag": "train/loss", "value": 2.0, "step": 2},
        {"tag": "train/loss", "value": 5.0, "step": 1}]
    steps, values = _plot_metrics().load_metrics(
        str(tmp_path / "metrics.jsonl"))["train/loss"]
    assert steps == [1, 2] and values == [5.0, 2.0]  # the last one wins


def test_device_trace_and_step_timer(tmp_path):
    with device_trace(None) as prof:
        assert prof is None
    x = torch.randn(64, 64)
    timer = StepTimer()
    with device_trace(str(tmp_path / "t")):
        for _ in range(3):
            timer.host()
            timer.device(x @ x)
    with open(tmp_path / "t" / TRACE_NAME) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    s = timer.summary()
    assert s["steps"] == 3 and s["host_ms_per_step"] >= 0.0 \
        and s["device_ms_per_step"] > 0.0


def test_train_cli_logs_metrics_resume_and_profile(tmp_path, capsys,
                                                   monkeypatch, tree):
    """Two epochs killed at the second epoch's checkpoint, then the same
    command with ``--auto_resume``: ``log.txt`` holds both processes'
    lines, ``metrics.jsonl`` steps 1, 2, 2 (the epoch run again), and
    ``load_metrics`` keeps the resumed epoch's values; ``--profile_dir``
    traces the first epoch's steps, the KPConv op among them."""
    cfg_path = _config(tmp_path, "l1")
    log, trace = tmp_path / "log", tmp_path / "trace"
    argv = _tiny(cfg_path, tree, log) + ["--profile_dir", str(trace)]
    save_epoch = train_cli.save_epoch

    def killed(directory, trainer, epoch, cfg):
        if epoch == 2:
            raise Killed(epoch)
        return save_epoch(directory, trainer, epoch, cfg)

    with monkeypatch.context() as m:
        m.setattr(train_cli, "save_epoch", killed)
        with pytest.raises(Killed):
            train_cli.main(argv)
    first = capsys.readouterr().out
    run = log / "l1_diverse"
    records = _records(run)
    assert _tags_steps(records) == {"train/loss": [1, 2], "train/lr": [1, 2],
                                    "val/loss": [1, 2]}
    summary = train_cli.main(argv + ["--auto_resume"])
    second = capsys.readouterr().out
    assert "start_epoch 2" in second and "epoch 1:" not in second
    records = _records(run)
    assert _tags_steps(records) == {"train/loss": [1, 2, 2],
                                    "train/lr": [1, 2, 2],
                                    "val/loss": [1, 2, 2]}
    assert records[-1]["value"] == pytest.approx(summary["val_losses"][-1])
    # the epoch run again repeats the killed one's (resume is bitwise)
    assert [r["value"] for r in records[3:6]] \
        == [r["value"] for r in records[6:]]
    curves = _plot_metrics().load_metrics(str(run / "metrics.jsonl"))
    assert curves["val/loss"] == ([1, 2], [records[2]["value"],
                                           records[-1]["value"]])
    with open(run / "log.txt") as f:
        text = f.read()
    for line in ("epoch 1: 2 steps", "auto-resumed from", "val [2] loss",
                 "trained 4 steps"):
        assert line in text
    # each printed line is in log.txt, after its time stamp
    for line in (first + second).splitlines():
        assert f"d3pcd_torch INFO: {line}" in text
    with open(trace / TRACE_NAME) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("kpconv_fwd" in n for n in names)
    assert any("kpconv_bwd" in n for n in names)


@pytest.mark.parametrize("entry", ["full_cleaning", "segmentation", "pcn",
                                   "discriminator", "gan"])
def test_entry_points_write_jax_tags(tmp_path, tree, entry):
    """One epoch (the GAN and PCN: two) of each other training entry point
    on the CPU: its ``log.txt`` and its tags at steps 1..E; segmentation's
    evaluation adds its lines to the run's ``log.txt``."""
    log = tmp_path / "log"
    if entry == "segmentation":
        scans = str(tmp_path / "scans")
        make_scans(scans, n=400, diameter=1.0, cut=(11, 12),
                   corner=(0.0, 0.0, 0.0))
        tiny = ["--config_file", os.path.join(CFGS, "outlier_seg_edf.yaml"),
                "--data_root", scans, "--width", "8", "--num_points", "64",
                "--batch_size", "8", "--DEBUG", "1", "--log_dir", str(log),
                "--device", "cpu"]
        train_outlier_seg.main(tiny + ["--num_steps", "16", "--epochs", "1",
                                       "--val_freq", "1"])
        evaluate_outlier_seg.main(tiny + [
            "--load_path", str(log / "outlier_seg_edfs" / "current.pt")])
        exp, tags, epochs = "outlier_seg_edfs", ("train/loss", "val/loss"), 1
    elif entry == "full_cleaning":
        cfg = _config(tmp_path, "synthetic_quality_cleaning")
        train_full_cleaning.main(_tiny(cfg, tree, log, epochs=1))
        exp, tags, epochs = ("synthetic_quality_cleaning",
                             ("train/loss", "val/loss"), 1)
    elif entry == "pcn":
        cfg = _config(tmp_path, "synthetic_quality_pcn4")
        train_pcn.main(_tiny(cfg, tree, log, points=32))
        exp, tags, epochs = ("synthetic_quality_pcn4",
                             ("train/loss", "val/loss"), 2)
    elif entry == "discriminator":
        cfg = _config(tmp_path, "synthetic_quality_disc")
        train_discriminator.main(_tiny(cfg, tree, log, epochs=1))
        exp, tags, epochs = ("synthetic_quality_disc",
                             ("train/loss", "val/accuracy"), 1)
    else:
        cfg = _config(tmp_path, "synthetic_quality_gan_tuned")
        train_gan.main(_tiny(cfg, tree, log))
        exp, tags, epochs = ("synthetic_quality_gan_tuned",
                             tuple(f"train/{k}" for k in METRICS), 2)
    run = log / exp
    records = _records(run)
    assert _tags_steps(records) == {t: list(range(1, epochs + 1))
                                    for t in tags}
    assert all(np.isfinite(r["value"]) for r in records)
    with open(run / "log.txt") as f:
        text = f.read()
    assert f"epoch {epochs}:" in text and "device cpu" in text
    if entry == "segmentation":
        assert "loaded " in text and "points/s" in text and "macc" in text
    assert not logging.getLogger("d3pcd_torch").handlers


def test_offset_entry_point_alone_takes_profile_dir():
    with pytest.raises(SystemExit):
        train_full_cleaning.main(["--config_file", "x", "--data_root", "y",
                                  "--profile_dir", "z"])

"""The port's evaluation against the JAX package's on the same clouds.

Tolerances: the KD-tree tables, the noise estimate and the formatted
tables are exact (the same float64 arithmetic on the same inputs); the
brute-force NN distances are float32, so they and the tables built on them
are held to 1e-6 relative.  The command lines write byte-identical files.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from deep3dpointclouddenoising_tpu import evaluate as jax_eval
from deep3dpointclouddenoising_tpu.data.meshio import \
    write_ply as jax_write_ply
from deep3dpointclouddenoising_torch import compute_cd, evaluate, \
    measure_performance
from deep3dpointclouddenoising_torch.data.meshio import read_ply, write_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    """A JAX-package script of ``scripts/`` loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clouds(seed, n=3000):
    """A clean surface sample, its noisy copy with 2% outliers and a
    denoised copy, float32."""
    rng = np.random.default_rng(seed)
    clean = rng.normal(size=(n, 3))
    clean /= np.linalg.norm(clean, axis=1, keepdims=True)
    noisy = clean + 0.01 * rng.normal(size=(n, 3))
    out = rng.random(n) < 0.02
    noisy[out] += rng.uniform(-0.3, 0.3, size=(out.sum(), 3))
    denoised = clean + 0.003 * rng.normal(size=(n, 3))
    return [a.astype(np.float32) for a in (clean, noisy, denoised)]


def _near_duplicates(seed, n=2000):
    """Queries 1e-4 to 1e-3 from support points of norm ~1-3, where
    |x|^2 + |y|^2 - 2 x.y loses most of its digits."""
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    step = rng.normal(size=(n, 3))
    step *= rng.uniform(1e-4, 1e-3, size=(n, 1)) / np.linalg.norm(
        step, axis=1, keepdims=True)
    return (y + step).astype(np.float32), y


@pytest.mark.parametrize("case", ["random", "near_duplicates"])
def test_device_nn_dists_match_kdtree_and_jax(case):
    if case == "random":
        x, y, _ = _clouds(0)
    else:
        x, y = _near_duplicates(1)
    got = evaluate._nn_dists_device(x, y, chunk=512, device="cpu")
    assert got.dtype == np.float32 and got.shape == (len(x),)
    np.testing.assert_allclose(got, evaluate._nn_dists(x, y), rtol=1e-6)
    np.testing.assert_allclose(got, jax_eval._nn_dists_device(x, y),
                               rtol=1e-6)
    np.testing.assert_array_equal(evaluate._nn_dists(x, y),
                                  jax_eval._nn_dists(x, y))
    if case == "near_duplicates":
        # the matmul form alone is off by far more than 1e-6 here
        d2 = (x ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None] - 2 * x @ y.T
        naive = np.sqrt(np.maximum(d2.min(1), 0))
        assert np.abs(naive - got).max() > 1e-2 * got.min()


def test_device_nn_dists_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, _ = _clouds(2, 50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate._nn_dists_device(x, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.chamfer_ratio_table([x], [y], [y], device=True)


@pytest.mark.parametrize("device", [False, "cpu"])
def test_chamfer_ratio_table_matches_jax(device):
    sets = [_clouds(s) for s in (3, 4)]
    clean, noisy, denoised = (list(c) for c in zip(*sets))
    names = ["ellipsoid_t", "torus_t"]
    got = evaluate.chamfer_ratio_table(clean, noisy, denoised, names,
                                       device=device)
    want = jax_eval.chamfer_ratio_table(clean, noisy, denoised, names,
                                        device=bool(device))
    assert list(got) == list(want) == names + ["mean"]
    assert got["mean"]["ratio"] < 1.0
    for name in want:
        for key in want[name]:
            if device:
                np.testing.assert_allclose(got[name][key], want[name][key],
                                           rtol=1e-6, err_msg=key)
            else:
                assert got[name][key] == want[name][key], (name, key)
    if not device:
        assert evaluate.format_cd_table(got) == \
            jax_eval.format_cd_table(want)


@pytest.mark.parametrize("threshold", [0.05, 0.01])
def test_performance_table_matches_jax(threshold):
    sets = [_clouds(s) for s in (5, 6)]
    clean, noisy, _ = (list(c) for c in zip(*sets))
    got = evaluate.performance_table(clean, noisy, threshold, ["a", "b"])
    want = jax_eval.performance_table(clean, noisy, threshold, ["a", "b"])
    assert got == want
    assert got["mean"]["outlier_ratio"] > 0


@pytest.mark.parametrize("sigma", [0.0, 0.001, 0.005])
def test_estimate_noise_sigma_matches_jax(sigma):
    rng = np.random.default_rng(7)
    pts = rng.uniform(-0.5, 0.5, size=(20000, 3))
    pts[:, 2] = 0.1 * np.sin(3 * pts[:, 0])
    pts = (pts + sigma * rng.normal(size=pts.shape)).astype(np.float32)
    got = evaluate.estimate_noise_sigma(pts)
    assert got == jax_eval.estimate_noise_sigma(pts)
    if sigma:
        assert 0.7 * sigma < got < 1.5 * sigma
    assert evaluate.estimate_noise_sigma(pts[:10]) == 0.0


def _ply_tree(root, seeds=(8, 9)):
    for sub in ("noisy", "denoised", "clean"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, seed in enumerate(seeds):
        clean, noisy, denoised = _clouds(seed, 2000)
        base = f"shape_{i}.ply"
        write_ply(os.path.join(root, "noisy", base),
                  [noisy, np.zeros(len(noisy), np.float32)],
                  ["vertex", "gt_outlier"])
        write_ply(os.path.join(root, "denoised", base), [denoised],
                  ["vertex"])
        write_ply(os.path.join(root, "clean", base), [clean], ["vertex"])


def test_write_and_read_ply_match_jax(tmp_path):
    rng = np.random.default_rng(10)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    lab = rng.random(50).astype(np.float32)
    write_ply(str(tmp_path / "a.ply"), [xyz, lab], ["vertex", "gt"])
    jax_write_ply(str(tmp_path / "b.ply"), [xyz, lab], ["vertex", "gt"])
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()
    got = read_ply(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(got["vertex"], xyz)
    np.testing.assert_array_equal(got["gt"], lab)
    (tmp_path / "c.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
        "property float y\nproperty float z\nend_header\n1 2 3\n4 5 6\n")
    np.testing.assert_array_equal(read_ply(str(tmp_path / "c.ply"))["vertex"],
                                  [[1, 2, 3], [4, 5, 6]])


def test_compute_cd_cli_writes_the_jax_scripts_files(tmp_path, monkeypatch):
    tree = tmp_path / "tree"
    _ply_tree(str(tree))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.setattr(sys, "argv", [
        "compute_cd.py", "--in_dir", str(tree), "--out_dir",
        str(tmp_path / "jax"), "--platform", "cpu"])
    _script("compute_cd").main()
    table = compute_cd.main(["--in_dir", str(tree), "--out_dir",
                             str(tmp_path / "port")])
    for name in ("CD_table.txt", "CD_table_absolute.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert list(table) == ["shape_0", "shape_1", "mean"]
    # the brute-force path gives the same table to float32 noise
    dev = compute_cd.main(["--in_dir", str(tree), "--out_dir",
                           str(tmp_path / "port"), "--device", "cpu"])
    for name in table:
        for key in table[name]:
            np.testing.assert_allclose(dev[name][key], table[name][key],
                                       rtol=1e-6)


def test_compute_cd_device_flag_needs_a_card(tmp_path, monkeypatch):
    _ply_tree(str(tmp_path), seeds=(11,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_cd.main(["--in_dir", str(tmp_path), "--device"])


@pytest.mark.parametrize("which", ["denoised", "noisy"])
def test_measure_performance_cli_writes_the_jax_scripts_file(
        tmp_path, monkeypatch, which):
    tree = tmp_path / "tree"
    _ply_tree(str(tree))
    monkeypatch.setattr(sys, "argv", [
        "measure_performance.py", "--in_dir", str(tree), "--which", which,
        "--threshold", "0.02", "--platform", "cpu"])
    _script("measure_performance").main()
    want = (tree / "Performance.txt").read_bytes()
    os.remove(tree / "Performance.txt")
    measure_performance.main(["--in_dir", str(tree), "--which", which,
                              "--threshold", "0.02"])
    assert (tree / "Performance.txt").read_bytes() == want

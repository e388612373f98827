"""The PyTorch port imports nothing of JAX, Flax, PyYAML or the JAX package:
the machine with the card has none of them."""
import ast
import os
import pkgutil
import subprocess
import sys

import deep3dpointclouddenoising_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(ROOT, "deep3dpointclouddenoising_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "yaml", "deep3dpointclouddenoising_tpu"}


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            deep3dpointclouddenoising_torch.__path__,
            "deep3dpointclouddenoising_torch."))


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG_DIR):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_has_every_module_of_the_slice():
    mods = set(_port_modules())
    for name in ("config", "convert", "infer", "ops.neighbors",
                 "ops.subsample", "ops.kpconv", "models.kernel_points",
                 "models.layers", "models.pyramid",
                 "models.local_aggregation", "models.resnet",
                 "models.heads", "models.build", "utils.spatial",
                 "data.meshio", "data.synthetic", "data.offset_dataset",
                 "data.loader", "data.transforms", "losses.masked",
                 "losses.build", "train.lr_schedule", "train.trainer",
                 "train.__main__", "utils.metrics", "utils.checkpoint",
                 "utils.grad_check",
                 "profile_serving", "evaluate", "compute_cd",
                 "measure_performance", "make_synthetic_dataset",
                 "data.device_sampler", "losses.chamfer",
                 "train_full_cleaning", "train.gan", "train_gan",
                 "train_discriminator"):
        assert f"deep3dpointclouddenoising_torch.{name}" in mods


def test_importing_the_port_loads_no_forbidden_module():
    # a fresh interpreter: this test process has jax loaded by conftest
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_forbidden_import_statement():
    found = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(os.path.relpath(path, ROOT), n) for n in names
                      if n.split(".")[0] in FORBIDDEN]
    assert not found


def test_port_builds_kernels_with_nvcc_not_torch_extensions():
    for path in _port_files():
        with open(path) as f:
            assert "cpp_extension" not in f.read(), path

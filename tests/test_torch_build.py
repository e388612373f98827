"""The kernels' build cache: a library's name hashes its source, every header
under ``csrc/`` and the flags, so editing any of them builds anew instead of
loading a stale library.  No compiler is needed: only names are computed."""
import importlib
import os
import re
import shutil

import numpy as np
import pytest
import torch

from deep3dpointclouddenoising_torch import compare_host
from deep3dpointclouddenoising_torch.ops import _cuda, kpconv


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc directory with one source that includes one header."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\nint f();\n')
    (tmp_path / "common.cuh").write_text("#pragma once\nint g();\n")
    monkeypatch.setattr(_cuda, "CSRC_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("edit", ["source", "header", "new_header",
                                  "flags"])
def test_lib_path_changes_with_what_the_build_reads(csrc, monkeypatch, edit):
    before = _cuda._lib_path("k")
    assert _cuda._lib_path("k") == before  # stable while nothing changes
    if edit == "source":
        (csrc / "k.cu").write_text('#include "common.cuh"\nint f2();\n')
    elif edit == "header":
        (csrc / "common.cuh").write_text("#pragma once\nint g2();\n")
    elif edit == "new_header":
        (csrc / "other.cuh").write_text("int h();\n")
    else:
        monkeypatch.setattr(_cuda, "NVCC_FLAGS", _cuda.NVCC_FLAGS + ["-G"])
    after = _cuda._lib_path("k")
    assert after != before
    assert os.path.basename(after).startswith("k-")


def test_every_quoted_include_is_a_hashed_header():
    """Each ``#include "..."`` of the port's sources names a header under
    csrc/, so its edits reach the library's name."""
    headers = {os.path.basename(h) for h in _cuda._headers()}
    assert headers  # the KPConv kernels share kpconv_common.cuh
    for name in _cuda.kernel_names():
        with open(_cuda.source_path(name)) as f:
            for inc in re.findall(r'#include "([^"]+)"', f.read()):
                assert inc in headers, (name, inc)


def test_other_checkout_loads_beside_this_one(tmp_path):
    """``compare_host.load_other`` imports another checkout's package under
    another name: its own module objects, ``csrc/`` and ``build/``, and the
    same function on the same inputs."""
    pkg = os.path.dirname(os.path.dirname(_cuda.__file__))
    shutil.copytree(pkg, tmp_path / os.path.basename(pkg),
                    ignore=shutil.ignore_patterns("__pycache__"))
    package = compare_host.load_other(str(tmp_path))
    other = importlib.import_module(package.__name__ + ".ops.kpconv")
    assert other is not kpconv
    other_cuda = other._cuda
    assert other_cuda is not _cuda
    assert other_cuda.CSRC_DIR.startswith(str(tmp_path))
    assert other_cuda.BUILD_DIR == str(tmp_path / "build" / "kernels")
    rng = np.random.default_rng(0)
    B, M, N, K, C, P = 2, 5, 7, 4, 3, 6
    args = [torch.from_numpy(a) for a in (
        rng.normal(size=(B, N, C)).astype(np.float32),
        rng.integers(0, N, size=(B, M, K)).astype(np.int32),
        rng.normal(size=(B, M, K, 3)).astype(np.float32),
        (rng.random((B, M, K)) > 0.3).astype(np.float32),
        rng.normal(size=(P, 3)).astype(np.float32),
        rng.normal(size=(P, C)).astype(np.float32))]
    assert torch.equal(other.kpconv_aggregate(*args, 1.5, "linear"),
                       kpconv.kpconv_aggregate(*args, 1.5, "linear"))

"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C launchers.  It is compiled at first
use by ``nvcc`` into a shared library under ``build/kernels/`` at the
checkout's root (listed in ``.gitignore``) and loaded with ``ctypes``.  The
file name carries a hash of the source, of every header under ``csrc/``
(``*.cuh``, which a source may include) and of the flags, so an edited
source or header is rebuilt.  No PyTorch headers are involved, so a build
takes seconds.  A missing ``nvcc`` or a failed build raises with the
compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of deep3dpointclouddenoising_"
            "torch are built at first use and need the CUDA toolkit")
    return path


def _headers() -> List[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cuh"))


def _lib_path(name: str) -> str:
    digest = hashlib.sha256()
    for path in [source_path(name)] + _headers():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: List[str] | None = None) -> Dict[str, Tuple[str, float, str]]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.

    Returns ``{name: (library path, seconds, compiler output)}``; seconds is
    0 for a library that was already built.
    """
    names = kernel_names() if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    result: Dict[str, Tuple[str, float, str]] = {}
    procs = []
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path):
            result[name] = (path, 0.0, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp, source_path(name)]
        procs.append((name, path, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    for name, path, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source_path(name)} "
                f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, path)
        result[name] = (path, time.perf_counter() - t0, log)
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _, _ = build([name])[name]
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib

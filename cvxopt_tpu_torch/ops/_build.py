"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` is compiled by ``nvcc`` for ``sm_90a`` into
``cvxopt_tpu_torch/_build/lib<name>-<hash>.so`` (a plain C interface,
loaded with ctypes) at first use.  The hash is of the source and the
flags, so an edited source is rebuilt and a stale library is never
loaded.  Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}
build_log = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                       "a machine with the CUDA toolkit")


def lib_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; returns the
    library path.  Records seconds and ptxas output in `build_log`."""
    out = lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    build_log[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": proc.stderr}
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib

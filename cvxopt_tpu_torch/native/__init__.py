"""Host-side C helpers of the sparse path, twin of
`cvxopt_tpu/native/__init__.py`.

The port keeps its own copies of the two sources (`mindeg.c`, a
minimum-degree fill-reducing ordering, and `blockfill.c`, the symbolic
block-Cholesky fill).  At first use each is compiled with the system
``cc`` into ``cvxopt_tpu_torch/_build/lib<name>-<hash>.so`` (the hash
is of the source and the flags) and loaded with ctypes.  Without a C
compiler the callers fall back to pure Python; `built()` says which
libraries loaded.  Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CC_FLAGS = ["-O2", "-shared", "-fPIC"]

_libs = {}


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    with open(os.path.join(_HERE, name + ".c"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _load(name: str, fn: str, restype, argtypes):
    """The ctypes function `fn` of <name>.c, building the library at
    first use; None when it cannot be built or loaded."""
    if name in _libs:
        return _libs[name]
    _libs[name] = None
    out = lib_path(name)
    try:
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            subprocess.run(["cc", *CC_FLAGS, "-o", tmp,
                            os.path.join(_HERE, name + ".c")],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
        f = getattr(ctypes.CDLL(out), fn)
    except (OSError, subprocess.SubprocessError, AttributeError):
        return None
    f.restype = restype
    f.argtypes = argtypes
    _libs[name] = f
    return f


def built() -> dict:
    """{library: loaded?} for the libraries asked for so far."""
    return {k: v is not None for k, v in _libs.items()}


def _arr(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


def mindeg_order(indptr, indices, n: int) -> Optional[np.ndarray]:
    """Native minimum-degree ordering of a CSR symmetric pattern; None
    when the library is unavailable."""
    f = _load("mindeg", "mindeg_order", ctypes.c_int,
              [ctypes.c_int, _arr(np.int32), _arr(np.int32),
               _arr(np.int32)])
    if f is None:
        return None
    perm = np.zeros(n, dtype=np.int32)
    rc = f(n, np.ascontiguousarray(indptr, dtype=np.int32),
           np.ascontiguousarray(indices, dtype=np.int32), perm)
    return perm if rc == 0 else None


def block_fill(indptr, indices, nt: int):
    """Native symbolic block-Cholesky fill: CSR block adjacency ->
    (colptr, cols) of the factor's block pattern (diagonal first in
    each column).  None when the library is unavailable."""
    f = _load("blockfill", "block_fill", ctypes.c_long,
              [ctypes.c_long, _arr(np.int64), _arr(np.int64),
               _arr(np.int64), _arr(np.int64), ctypes.c_long])
    if f is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    cap = max(64 * nt, int(indices.size) * 4 + nt)
    for _ in range(4):
        colptr = np.zeros(nt + 1, dtype=np.int64)
        cols = np.zeros(cap, dtype=np.int64)
        rc = f(nt, indptr, indices, colptr, cols, cap)
        if rc == -1:
            cap *= 4
            continue
        if rc < 0:
            return None
        return colptr, cols[:rc]
    return None

"""Rules of the PyTorch/CUDA port as a package:

  - cvxopt_tpu_torch/ and chip_smoke.py import neither jax nor the JAX
    package (cvxopt_tpu or any cvxopt_tpu.* module);
  - entry points default to device="cuda" and raise, naming
    device="cpu", when no card is present;
  - the kernels are built at first use, never when imported."""

import ast
import os

import numpy as np
import pytest
import torch

import cvxopt_tpu_torch
from cvxopt_tpu_torch import ConeDims, convert
from cvxopt_tpu_torch.coneqp import make_coneqp, make_coneqp_cascade, \
    coneqp
from cvxopt_tpu_torch.ops import fused_chol as fc
from cvxopt_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "cvxopt_tpu_torch")


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "cvxopt_tpu")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_no_jax_imports():
    srcs = list(_sources())
    assert len(srcs) > 10
    bad = [(os.path.relpath(p, ROOT), m) for p in srcs
           for m in _imports(p) if _forbidden(m)]
    assert not bad, bad


def test_forbidden_matches_exact_module_names():
    """cvxopt_tpu_torch shares its prefix with cvxopt_tpu."""
    assert not _forbidden("cvxopt_tpu_torch.cones")
    assert _forbidden("cvxopt_tpu") and _forbidden("cvxopt_tpu.kkt")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping_x")


def test_tf32_off():
    assert cvxopt_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.fixture()
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_entry_points_raise_without_card(no_card):
    dims = ConeDims(l=2)
    calls = [
        lambda: make_coneqp(dims),
        lambda: make_coneqp_cascade(dims),
        lambda: coneqp(np.eye(2), np.ones(2), -np.eye(2), np.zeros(2)),
        lambda: fc.fused_schur_cholesky(torch.eye(64), torch.ones(64, 2),
                                        torch.ones(2)),
        lambda: fc.fused_cholesky_solve(torch.eye(64),
                                        torch.eye(64).reshape(1, 64, 64),
                                        torch.ones(1, 64)),
        lambda: fc.fused_schur_cholesky_batched(
            torch.eye(64).expand(8, 64, 64), torch.ones(64, 2),
            torch.ones(8, 2)),
        lambda: fc.fused_cholesky_solve_batched(
            torch.eye(64).expand(8, 64, 64), torch.ones(8, 1, 64, 64),
            torch.ones(8, 1, 64)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_wrapper_refuses_mismatched_operands():
    """A wrapper takes operands of one dtype on the device it is told."""
    with pytest.raises(TypeError):
        fc.fused_schur_cholesky(torch.eye(64), torch.ones(64, 2),
                                torch.ones(2, dtype=torch.float64),
                                device="cpu")
    with pytest.raises(ValueError):
        fc.fused_schur_cholesky(torch.eye(64, device="meta"),
                                torch.ones(64, 2), torch.ones(2),
                                device="cpu")


def test_cpu_run_does_not_count_launches():
    fc.reset_launch_counts()
    fc.fused_schur_cholesky(torch.eye(64), torch.ones(64, 2),
                            torch.ones(2), device="cpu")
    assert fc.launch_counts() == {w.__name__: 0 for w in fc.WRAPPERS}


def test_build_is_lazy_and_hashed():
    assert fc._lib is None or torch.cuda.is_available()
    p = _build.lib_path("fused_chol")
    assert p.startswith(_build.BUILD_DIR) and p.endswith(".so")
    assert p == _build.lib_path("fused_chol")


def test_convert_helpers():
    from cvxopt_tpu.cones import ConeDims as JDims
    jd = JDims(l=3, q=(4, 2), s=(3,))
    assert convert.dims_from(jd) == ConeDims(l=3, q=(4, 2), s=(3,))
    assert convert.dims_from({"l": 2, "q": [3], "s": []}) == \
        ConeDims(l=2, q=(3,))
    P, q, G, h, A, b = convert.problem_from_numpy(
        np.eye(2), np.ones(2), -np.eye(2), np.zeros(2), np.ones((1, 2)),
        np.ones(1), device="cpu", dtype=torch.float32)
    assert P.dtype == torch.float32 and b.shape == (1,)
    iv = convert.initvals_from_numpy(
        {"x": np.zeros((2, 3)), "_valid": np.array([1, 0])}, device="cpu")
    assert iv["x"].dtype == torch.float64
    assert iv["_valid"].tolist() == [True, False]

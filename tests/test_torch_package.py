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
from cvxopt_tpu_torch.cones import cone_identity
from cvxopt_tpu_torch.scaling import identity_scaling
from cvxopt_tpu_torch.coneqp import make_coneqp, make_coneqp_cascade, \
    coneqp
from cvxopt_tpu_torch import conelp as tlp
from cvxopt_tpu_torch import solvers, kkt_structured
from cvxopt_tpu_torch.cvxprog import make_cpl
from cvxopt_tpu_torch import glpk, modeling
from cvxopt_tpu_torch.simplex import make_simplex
from cvxopt_tpu_torch.ops import fused_chol as fc
from cvxopt_tpu_torch.ops import _build
from cvxopt_tpu_torch.ops import sparse_kkt, blocksparse, banded, blas, \
    lapack
from cvxopt_tpu_torch import cholmod, umfpack
from cvxopt_tpu_torch.parallel import make_mesh, multihost, schur
from cvxopt_tpu_torch.utils import fft
import scipy.sparse as sp

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

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
    names = {os.path.relpath(p, PKG) for p in srcs}
    for mod in ("conelp.py", "frontends.py", "solvers.py", "kkt.py",
                "cvxprog.py", "kkt_structured.py", "_tree.py",
                "mpsio.py", "modeling.py", "msk.py", "simplex.py",
                "glpk.py", "ilp.py", "base.py", "cholmod.py",
                "umfpack.py", "amd.py",
                os.path.join("native", "__init__.py"),
                os.path.join("utils", "fft.py"),
                os.path.join("utils", "rng.py"),
                os.path.join("utils", "printing.py"),
                os.path.join("ops", "blockinv.py"),
                os.path.join("ops", "jacobi.py"),
                os.path.join("ops", "banded.py"),
                os.path.join("ops", "sparse_kkt.py"),
                os.path.join("ops", "blocksparse.py"),
                os.path.join("ops", "spsolve.py"),
                os.path.join("ops", "blas.py"),
                os.path.join("ops", "lapack.py")) + tuple(
                    os.path.join("parallel", f + ".py")
                    for f in PARALLEL_MODULES + ("__init__",)):
        assert mod in names
    bad = [(os.path.relpath(p, ROOT), m) for p in srcs
           for m in _imports(p) if _forbidden(m)]
    assert not bad, bad


PARALLEL_MODULES = ("mesh", "collectives", "multihost", "schur",
                    "conesolve")


def test_parallel_names_have_twins():
    """Every public name that a module of cvxopt_tpu.parallel defines has
    a twin of the same name in cvxopt_tpu_torch.parallel."""
    import importlib
    import inspect
    import cvxopt_tpu.parallel as jpar
    import cvxopt_tpu_torch.parallel as tpar
    assert tpar.__all__ == jpar.__all__
    for mod in PARALLEL_MODULES:
        jm = importlib.import_module("cvxopt_tpu.parallel." + mod)
        tm = importlib.import_module("cvxopt_tpu_torch.parallel." + mod)
        names = [k for k, v in vars(jm).items() if not k.startswith("_")
                 and (inspect.isfunction(v) or inspect.isclass(v))
                 and v.__module__ == jm.__name__]
        assert names, mod
        missing = [k for k in names if not hasattr(tm, k)]
        assert not missing, (mod, missing)


def test_forbidden_matches_exact_module_names():
    """cvxopt_tpu_torch shares its prefix with cvxopt_tpu."""
    assert not _forbidden("cvxopt_tpu_torch.cones")
    assert _forbidden("cvxopt_tpu") and _forbidden("cvxopt_tpu.kkt")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping_x")


def test_package_namespace():
    """modeling and mpsio are exported as in cvxopt_tpu/__init__.py;
    glpk, msk, simplex and ilp are submodules under their JAX names."""
    import importlib
    for name in ("modeling", "mpsio"):
        assert name in cvxopt_tpu_torch.__all__
        assert getattr(cvxopt_tpu_torch, name).__name__ == \
            "cvxopt_tpu_torch." + name
    for name in ("glpk", "msk", "simplex", "ilp"):
        importlib.import_module("cvxopt_tpu_torch." + name)
    assert set(glpk.__all__) == {"lp", "ilp", "options"}


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
        lambda: tlp.make_conelp(dims),
        lambda: tlp.make_conelp_cascade(dims),
        lambda: tlp.make_conelp_ws(dims),
        lambda: tlp.make_conelp_ws_detect(dims),
        lambda: tlp.make_conelp_refresh(dims),
        lambda: solvers.conelp(np.ones(2), -np.eye(2), np.zeros(2)),
        lambda: solvers.lp(np.ones(2), -np.eye(2), np.zeros(2)),
        lambda: solvers.qp(np.eye(2), np.ones(2), -np.eye(2), np.zeros(2)),
        lambda: solvers.socp(np.ones(2), Gq=[-np.eye(2)], hq=[np.zeros(2)]),
        lambda: solvers.sdp(np.ones(1), Gs=[-np.ones((1, 1))],
                            hs=[np.zeros((1, 1))]),
        lambda: cone_identity(dims),
        lambda: identity_scaling(dims),
        lambda: make_cpl(ConeDims(l=2, mnl=1), torch.exp),
        lambda: solvers.cpl(np.ones(1), torch.exp, np.zeros(1)),
        lambda: solvers.cp(torch.exp, np.zeros(1)),
        lambda: solvers.gp([1], np.ones((1, 1)), np.zeros(1)),
        lambda: kkt_structured.l1(np.eye(2), np.ones(2)),
        lambda: kkt_structured.l1regls(np.eye(2), np.ones(2)),
        lambda: kkt_structured.woodbury_solver(np.ones(2), np.ones((2, 1))),
        lambda: kkt_structured.l1_operator(np.eye(2)),
        lambda: kkt_structured.kkt_l1(np.eye(2)),
        lambda: kkt_structured.kkt_l1regls(np.eye(2)),
        lambda: glpk.lp(np.ones(2), -np.eye(2), np.zeros(2)),
        lambda: glpk.ilp(np.ones(2), -np.eye(2), np.zeros(2), I={0}),
        lambda: solvers.lp(np.ones(2), -np.eye(2), np.zeros(2),
                           solver="glpk"),
        lambda: make_simplex(2, 2, 0, 10),
        lambda: modeling.op(modeling.variable(), [
            modeling.variable() >= 0]).solve(),
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
        lambda: sparse_kkt.lp_sparse(np.ones(2), sp.eye(2), np.ones(2)),
        lambda: sparse_kkt.qp_sparse(sp.eye(2), np.ones(2), sp.eye(2),
                                     np.ones(2)),
        lambda: sparse_kkt.kkt_chol2_banded(sp.eye(2), dims),
        lambda: sparse_kkt.make_band_plan(sp.eye(2)),
        lambda: blocksparse.linsolve(sp.eye(2), np.ones(2)),
        lambda: cholmod.linsolve(sp.eye(2), np.ones(2)),
        lambda: cholmod.numeric(np.eye(2), cholmod.symbolic(np.eye(2))),
        lambda: umfpack.linsolve(sp.eye(2), np.ones(2)),
        lambda: banded.pbtrf(np.ones((2, 4))),
        lambda: blas.dot([1.0], [1.0]),
        lambda: lapack.potrf(np.eye(2)),
        lambda: fft.dct([1.0, 2.0]),
        lambda: cvxopt_tpu_torch.matrix([1.0, 2.0]),
        lambda: cvxopt_tpu_torch.spmatrix([1.0], [0], [0]),
        lambda: cvxopt_tpu_torch.normal(2),
        lambda: cvxopt_tpu_torch.uniform(2),
        lambda: make_mesh(),
        lambda: multihost.initialize(),
        lambda: multihost.global_mesh(),
        lambda: schur.random_arrow_qp(2, 2, 1, 2),
        lambda: schur.random_block_qp(2, 2, 1),
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
    fc.fused_cholesky_solve(torch.eye(64), torch.eye(64).reshape(1, 64, 64),
                            torch.ones(1, 64), device="cpu")
    assert fc.launch_counts() == {
        **{w.__name__: 0 for w in fc.WRAPPERS},
        "schur_chol64": 0, "panel_factor": 0, "panel_solve": 0}
    assert fc.solve_kernel_counts() == {
        w.__name__: {"solve_few": 0, "solve_many": 0, "panel_solve": 0}
        for w in fc.SOLVE_WRAPPERS}
    assert fc.factor_kernel_counts() == {
        w.__name__: {"schur_chol64": 0, "schur_factor": 0,
                     "panel_factor": 0}
        for w in fc.FACTOR_WRAPPERS}


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

"""The port's cholmod/umfpack/amd namespaces (cvxopt_tpu_torch/
cholmod.py, umfpack.py, amd.py over ops/spsolve.py) against
cvxopt_tpu's on the CPU - twins of the cases of
tests/test_cholmod_sys.py: the CHOLMOD sys table 0..8 on every backend
(dense, RCM + banded, blocksparse tile-map), on the same seeded numpy
data.

Tolerances: every sys code's solution within 1e-12 relative of the JAX
package's, plus the JAX test's residual checks (1e-8 n absolute).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cvxopt_tpu import cholmod as jcholmod
from cvxopt_tpu_torch import cholmod, umfpack, amd

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _banded_spd(n=60, kd=3, seed=0):
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for d in range(kd + 1):
        v = rng.standard_normal(n - d) * (0.3 if d else 1.0)
        A += np.diag(v, -d) + (np.diag(v, d) if d else 0)
    A = A @ A.T + n * np.eye(n)
    # a random symmetric permutation hides the band
    p = rng.permutation(n)
    return sp.csr_matrix(A[np.ix_(p, p)])


def _arrow_spd(n=256, head=8, seed=1):
    """Diagonal plus dense head rows/columns: RCM cannot band it, the
    tile map's block fill is tiny."""
    rng = np.random.default_rng(seed)
    A = sp.lil_matrix((n, n))
    A.setdiag(rng.uniform(1.0, 2.0, n) + n)
    C = 0.3 * rng.standard_normal((head, n - head))
    A[:head, head:] = C
    A[head:, :head] = C.T
    return sp.csr_matrix(A)


def _dense_L(F, n):
    from cvxopt_tpu_torch.ops import banded as bnd
    if F.banded:
        return bnd.band_to_dense(F.L).numpy() * np.tri(n)
    return F.L.numpy() * np.tri(n)


def _check_all_sys(Asp, F, jF):
    n = Asp.shape[0]
    b = np.random.default_rng(42).standard_normal(n)
    A = np.asarray(Asp.todense())
    perm = F.perm if F.perm is not None else (
        F.bsp.perm if F.bsp is not None else np.arange(n))
    perm = np.asarray(perm)
    inv = np.argsort(perm)

    def sol(sys, rhs=b):
        x = cholmod.solve(F, torch.as_tensor(rhs), sys=sys).numpy()
        want = np.asarray(jcholmod.solve(jF, rhs, sys=sys))
        np.testing.assert_allclose(
            x, want, rtol=0, atol=1e-12 * max(np.abs(want).max(), 1.0),
            err_msg=f"sys={sys}")
        return x

    x0 = sol(0)
    np.testing.assert_allclose(A @ x0, b, rtol=0, atol=1e-8 * n)
    x1 = sol(1)
    np.testing.assert_allclose(x1, np.linalg.solve(A, b[inv])[perm],
                               atol=1e-8 * n)
    if F.bsp is None:
        L = _dense_L(F, n)
        np.testing.assert_allclose(L @ (L.T @ x1), b, atol=1e-8 * n)
        x2, x3 = sol(2), sol(3)
        np.testing.assert_allclose(L @ x2, b, atol=1e-8 * n)
        np.testing.assert_allclose(L.T @ x3, b, atol=1e-8 * n)
        np.testing.assert_allclose(sol(4), x2, atol=1e-10 * n)
        np.testing.assert_allclose(sol(5), x3, atol=1e-10 * n)
        np.testing.assert_allclose(sol(5, sol(4)), x1, atol=1e-8 * n)
    else:
        for sys in (2, 3, 4, 5):
            with pytest.raises(ValueError):
                cholmod.solve(F, b, sys=sys)
    np.testing.assert_allclose(sol(6), b)
    np.testing.assert_allclose(sol(7), b[perm])
    np.testing.assert_allclose(sol(8), b[inv])
    np.testing.assert_allclose(sol(8, sol(7)), b)


def test_sys_codes_banded_backend():
    Asp = _banded_spd()
    symb = cholmod.symbolic(Asp)
    assert symb.banded
    F = cholmod.numeric(Asp, symb, device="cpu")
    _check_all_sys(Asp, F, jcholmod.numeric(Asp, jcholmod.symbolic(Asp)))


def test_sys_codes_dense_backend():
    n = 40
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    F = cholmod.numeric(A, cholmod.symbolic(A), device="cpu")
    _check_all_sys(sp.csr_matrix(A), F,
                   jcholmod.numeric(A, jcholmod.symbolic(A)))


def test_sys_codes_blocksparse_backend():
    Asp = _arrow_spd()
    symb = cholmod.symbolic(Asp)
    assert symb.bsp is not None
    F = cholmod.numeric(Asp, symb, device="cpu")
    _check_all_sys(Asp, F, jcholmod.numeric(Asp, jcholmod.symbolic(Asp)))


def test_sys_out_of_range():
    A = np.eye(8) * 2
    F = cholmod.numeric(A, cholmod.symbolic(A), device="cpu")
    with pytest.raises(ValueError):
        cholmod.solve(F, np.ones(8), sys=9)


def test_diag_getfactor_and_options_object():
    from cvxopt_tpu_torch.ops import spsolve
    assert cholmod.options is spsolve.options
    A = np.diag(np.arange(1.0, 6.0))
    F = cholmod.numeric(A, cholmod.symbolic(A), device="cpu")
    np.testing.assert_allclose(cholmod.diag(F).numpy(),
                               np.sqrt(np.arange(1.0, 6.0)))
    assert cholmod.getfactor(F) is F.L


def test_namespace_modules():
    n = 30
    rng = np.random.default_rng(0)
    A = np.diag(rng.uniform(1, 2, n) + n)
    A[1, 0] = A[0, 1] = 0.5
    Asp = sp.csr_matrix(A)
    x = cholmod.linsolve(Asp, np.ones(n), device="cpu").numpy()
    np.testing.assert_allclose(A @ x, np.ones(n), atol=1e-10)
    np.testing.assert_allclose(
        cholmod.splinsolve(Asp, np.ones(n), device="cpu").numpy(), x)
    B = A.copy()
    B[2, 0] = 0.3
    Bsp = sp.csr_matrix(B)
    xb = umfpack.linsolve(Bsp, np.ones(n), device="cpu").numpy()
    np.testing.assert_allclose(B @ xb, np.ones(n), atol=1e-10)
    Ft = umfpack.numeric(Bsp, umfpack.symbolic(Bsp), device="cpu")
    xt = umfpack.solve(Ft, np.ones(n), trans="T").numpy()
    np.testing.assert_allclose(B.T @ xt, np.ones(n), atol=1e-10)
    p = amd.order(Asp)
    assert sorted(np.asarray(p).tolist()) == list(range(n))


def test_spsolve_dense_return_contract():
    """cholmod.spsolve returns a DENSE solution for a sparse B, as the
    JAX package does."""
    A = _banded_spd(n=24, kd=2, seed=5)
    F = cholmod.numeric(A, cholmod.symbolic(A), device="cpu")
    B = sp.csr_matrix(np.eye(24)[:, :3])
    X = cholmod.spsolve(F, B)
    assert torch.is_tensor(X) and not X.is_sparse
    np.testing.assert_allclose(A @ X.numpy(), B.toarray(), atol=1e-8)
    jX = np.asarray(jcholmod.spsolve(
        jcholmod.numeric(A, jcholmod.symbolic(A)), B))
    np.testing.assert_allclose(X.numpy(), jX, atol=1e-12)


def test_torch_sparse_input():
    """The port's own sparse matrix (torch sparse COO from
    base.spmatrix) takes the same sparse analysis as scipy input."""
    from cvxopt_tpu_torch.base import spmatrix
    Asp = _banded_spd(n=40, kd=2, seed=6).tocoo()
    S = spmatrix(Asp.data, Asp.row, Asp.col, size=Asp.shape, device="cpu")
    symb = cholmod.symbolic(S)
    assert symb.banded
    b = np.ones(40)
    x = cholmod.solve(cholmod.numeric(S, symb), b).numpy()
    np.testing.assert_allclose(Asp @ x, b, atol=1e-10)

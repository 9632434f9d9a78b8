"""The port's mixed sparse/dense base-level linear algebra and matrix
I/O (cvxopt_tpu_torch/base.py, sparse matrices as uncoalesced torch
sparse COO tensors) against cvxopt_tpu/base.py on the CPU - twins of
the cases of tests/test_base_sparse_ops.py on the same seeded numpy
data, plus the top-level namespace of the port.

Tolerances: products within 1e-12 of the JAX function and of numpy;
file round trips and triplet order exact.
"""

import io

import numpy as np
import scipy.sparse as sp
import torch

import jax.numpy as jnp
import cvxopt_tpu as jcvx
from cvxopt_tpu import base as jbase
import cvxopt_tpu_torch as cvx
from cvxopt_tpu_torch import base, convert

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

CPU = dict(device="cpu")


def _sp(seed, m, n, d=0.3):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((m, n)) * (rng.random((m, n)) < d)
    I, J = np.nonzero(M)
    return M, cvx.spmatrix(M[I, J], I, J, size=(m, n), **CPU), \
        jcvx.spmatrix(M[I, J], I, J, size=(m, n))


def close(got, want, tol=1e-12):
    if torch.is_tensor(got) and got.is_sparse:
        got = got.to_dense()
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    if hasattr(want, "todense"):
        want = want.todense()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def test_axpy_gemv_mixed():
    rng = np.random.default_rng(0)
    M, S, JS = _sp(1, 6, 4)
    D = rng.standard_normal((6, 4))
    close(base.axpy(S, torch.as_tensor(D), alpha=2.0), D + 2.0 * M)
    close(base.axpy(S, torch.as_tensor(D), alpha=2.0),
          jbase.axpy(JS, jnp.asarray(D), alpha=2.0))
    x = rng.standard_normal(4)
    y = rng.standard_normal(6)
    close(base.gemv(S, torch.as_tensor(x)), M @ x)
    close(base.gemv(S, torch.as_tensor(y), trans="T", alpha=0.5),
          jbase.gemv(JS, jnp.asarray(y), trans="T", alpha=0.5))
    close(base.gemv(torch.as_tensor(M), torch.as_tensor(x), beta=2.0,
                    y=torch.as_tensor(y)), M @ x + 2.0 * y)


def test_gemm_syrk_mixed():
    rng = np.random.default_rng(2)
    M, S, JS = _sp(3, 5, 7)
    D = rng.standard_normal((7, 3))
    close(base.gemm(S, torch.as_tensor(D)), M @ D)
    N, Tn, JT = _sp(4, 5, 7)
    out = base.gemm(S, Tn, transB="T")
    close(out, M @ N.T)
    close(out, jbase.gemm(JS, JT, transB="T"))
    close(base.syrk(S), M @ M.T)
    close(base.syrk(S, trans="T", alpha=2.0), 2.0 * M.T @ M)
    close(base.syrk(S), jbase.syrk(JS))


def test_symv():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((5, 5))
    x = rng.standard_normal(5)
    S = np.tril(A) + np.tril(A, -1).T
    close(base.symv(torch.as_tensor(A), torch.as_tensor(x)), S @ x)
    close(base.symv(torch.as_tensor(A), torch.as_tensor(x), alpha=3.0),
          jbase.symv(jnp.asarray(A), jnp.asarray(x), alpha=3.0))


def test_sparse_block_assembly_no_densify():
    """base.sparse assembles mixed sparse/dense blocks in triplet form:
    a large sparse block matrix keeps O(nnz) storage, with the JAX
    package's triplets in the JAX package's order."""
    n = 5000
    D = sp.diags(np.arange(1.0, n + 1))
    Icol = base.spmatrix(np.ones(n), np.arange(n), np.zeros(n),
                         size=(n, 1), **CPU)
    M = base.sparse([[D], [Icol]])
    assert M.shape == (n, n + 1)
    assert M._nnz() == 2 * n
    assert not M.is_coalesced()
    close(M.to_dense()[:3, :3], np.diag([1.0, 2.0, 3.0]))
    J = jbase.sparse([[D], [jbase.spmatrix(np.ones(n), np.arange(n),
                                           np.zeros(n), size=(n, 1))]])
    np.testing.assert_array_equal(M._indices().numpy().T,
                                  np.asarray(J.indices))
    np.testing.assert_array_equal(M._values().numpy(), np.asarray(J.data))


def test_sparse_from_dense_and_duplicates():
    rng = np.random.default_rng(6)
    M = rng.standard_normal((4, 5)) * (rng.random((4, 5)) < 0.5)
    S = base.sparse(torch.as_tensor(M))
    J = jbase.sparse(jnp.asarray(M))
    np.testing.assert_array_equal(S._indices().numpy().T,
                                  np.asarray(J.indices))
    close(S, M)
    # duplicates stay as separate triplets and sum in the dense view
    X = base.spmatrix([1.0, 2.0, 5.0], [0, 0, 1], [1, 1, 0], size=(2, 2),
                      **CPU)
    assert X._nnz() == 3
    close(X, np.array([[0.0, 3.0], [5.0, 0.0]]))
    np.testing.assert_array_equal(base.sp_V(X).numpy(), [1.0, 2.0, 5.0])


def test_matrix_file_io_roundtrip():
    M = np.arange(6.0).reshape(2, 3)
    for data, tc in ((M, "d"), (M + 1j * M, "z")):
        buf = io.BytesIO()
        base.matrix_tofile(torch.as_tensor(data), buf)
        jbuf = io.BytesIO()
        jbase.matrix_tofile(data, jbuf)
        assert buf.getvalue() == jbuf.getvalue()
        buf.seek(0)
        np.testing.assert_array_equal(
            base.matrix_fromfile(buf, (2, 3), tc=tc, **CPU).numpy(), data)
    S = base.spmatrix([1.0, 2.0, 3.5], [0, 2, 1], [1, 0, 2], size=(3, 3),
                      **CPU)
    buf = io.BytesIO()
    base.spmatrix_tofile(S, buf)
    jbuf = io.BytesIO()
    jbase.spmatrix_tofile(jbase.spmatrix([1.0, 2.0, 3.5], [0, 2, 1],
                                         [1, 0, 2], size=(3, 3)), jbuf)
    assert buf.getvalue() == jbuf.getvalue()
    buf.seek(0)
    S2 = base.spmatrix_fromfile(buf, 3, (3, 3), **CPU)
    close(S2, S.to_dense().numpy())


def test_spmatrix_from_numpy_carries_bcoo():
    """convert.spmatrix_from_numpy carries a JAX BCOO's (data, indices)
    into the port's sparse matrix, triplet for triplet."""
    J = jcvx.spmatrix([1.0, 2.0, 3.0, 4.0], [0, 2, 1, 0], [1, 0, 1, 1],
                      size=(3, 2))
    idx = np.asarray(J.indices)
    X = convert.spmatrix_from_numpy(np.asarray(J.data), idx[:, 0],
                                    idx[:, 1], J.shape, **CPU)
    np.testing.assert_array_equal(base.sp_I(X).numpy(), idx[:, 0])
    np.testing.assert_array_equal(base.sp_J(X).numpy(), idx[:, 1])
    np.testing.assert_array_equal(base.sp_V(X).numpy(), np.asarray(J.data))
    close(X, J.todense())


def test_top_level_names_have_twins():
    """Every name of cvxopt_tpu.__all__ and cvxopt_tpu.ops.__all__ has a
    twin in the port."""
    import cvxopt_tpu.ops as jops
    import cvxopt_tpu_torch.ops as tops
    missing = [n for n in jcvx.__all__ if not hasattr(cvx, n)]
    assert not missing, missing
    assert set(jcvx.__all__) <= set(cvx.__all__)
    assert [n for n in jops.__all__ if not hasattr(tops, n)] == []
    assert cvx.__version__ == jcvx.__version__
    for mod in ("cones", "scaling", "kkt", "base", "solvers", "printing"):
        assert getattr(cvx, mod).__name__.startswith("cvxopt_tpu_torch.")

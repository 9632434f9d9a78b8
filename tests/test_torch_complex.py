"""Complex ('z' typecode) support of the port (cvxopt_tpu_torch/base.py,
ops/blas.py, ops/lapack.py) against cvxopt_tpu's on the CPU - twins of
the cases of tests/test_complex.py on the same seeded numpy data.

Tolerances: constructors exact; BLAS results within 1e-12 relative of
the JAX function; eigenvalues at 1e-12, eigenvectors up to phase (the
reconstruction V diag(w) V^H at 1e-12); Schur forms by their
reconstruction at 1e-12.
"""

import numpy as np
import torch

import jax.numpy as jnp
import cvxopt_tpu as jcvx
import cvxopt_tpu_torch as cvx
from cvxopt_tpu.ops import blas as jblas, lapack as jlapack
from cvxopt_tpu_torch.ops import blas, lapack

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

CPU = dict(device="cpu")


def T(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def test_matrix_z_nested_preserved():
    A = cvx.matrix([[1 + 2j, 3 - 1j], [0.5j, 2.0]], tc="z", **CPU)
    assert A.dtype == torch.complex128
    np.testing.assert_array_equal(
        A.numpy(), np.asarray(jcvx.matrix([[1 + 2j, 3 - 1j], [0.5j, 2.0]],
                                          tc="z")))
    np.testing.assert_array_equal(A.numpy(), np.array([[1 + 2j, 0.5j],
                                                       [3 - 1j, 2.0]]))


def test_matrix_z_scalar_and_flat():
    A = cvx.matrix(1 + 1j, size=(2, 2), **CPU)
    assert A.dtype == torch.complex128
    np.testing.assert_array_equal(A.numpy(), np.full((2, 2), 1 + 1j))
    B = cvx.matrix([1j, 2j, 3j, 4j], size=(2, 2), **CPU)
    np.testing.assert_array_equal(B.numpy(),
                                  np.array([[1j, 3j], [2j, 4j]]))


def test_matrix_d_to_z_promotion():
    A = cvx.matrix([1.0, 2.0], tc="z", **CPU)
    assert A.dtype == torch.complex128
    np.testing.assert_array_equal(A.numpy().ravel(), [1.0, 2.0])


def test_spmatrix_z():
    S = cvx.spmatrix([1 + 1j, 2 - 1j], [0, 1], [1, 0], size=(2, 2), tc="z",
                     **CPU)
    D = S.to_dense().numpy()
    assert D.dtype == np.complex128
    np.testing.assert_array_equal(D, np.array([[0, 1 + 1j], [2 - 1j, 0]]))
    J = jcvx.spmatrix([1 + 1j, 2 - 1j], [0, 1], [1, 0], size=(2, 2), tc="z")
    np.testing.assert_array_equal(D, np.asarray(J.todense()))


def test_ctrans_real_imag():
    A = cvx.matrix([[1 + 2j], [3 - 4j]], tc="z", **CPU)
    JA = jcvx.matrix([[1 + 2j], [3 - 4j]], tc="z")
    for name in ("ctrans", "trans", "real", "imag"):
        np.testing.assert_array_equal(getattr(cvx, name)(A).numpy(),
                                      np.asarray(getattr(jcvx, name)(JA)))
    r = cvx.matrix([1.0, 2.0], **CPU)
    np.testing.assert_array_equal(cvx.imag(r).numpy(), np.zeros((2, 1)))


def test_complex_arithmetic_and_mul():
    A = cvx.matrix([[1 + 1j, 2], [3, 4 - 2j]], tc="z", **CPU)
    Ad = A.numpy()
    close(cvx.mul(A, A), Ad * Ad)
    close(A @ cvx.ctrans(A), Ad @ Ad.conj().T)


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_blas_complex_paths():
    rng = np.random.default_rng(0)
    n = 5
    A = _cplx(rng, n, n)
    H = A + A.conj().T
    x, y = _cplx(rng, n), _cplx(rng, n)
    B = _cplx(rng, n, 3)
    for name, args in (("dotu", (x, y)), ("dot", (x, y)), ("nrm2", (x,)),
                       ("asum", (x,)), ("hemv", (H, x)), ("herk", (A,)),
                       ("her", (x,)), ("her2", (x, y)), ("ger", (x, y)),
                       ("geru", (x, y)), ("her2k", (A, _cplx(rng, n, n))),
                       ("hemm", (H, B)), ("gemv", (A, x))):
        close(getattr(blas, name)(*map(T, args)),
              getattr(jblas, name)(*map(jnp.asarray, args)))
    assert int(blas.iamax(T(x))) == int(jblas.iamax(jnp.asarray(x)))
    close(blas.hemv(T(H), T(x)), H @ x)
    K = blas.herk(T(A)).numpy()
    close(np.tril(K), np.tril(A @ A.conj().T))
    close(blas.herk(T(A), trans="C"),
          jblas.herk(jnp.asarray(A), trans="C"))
    close(blas.her2(T(x), T(y), alpha=0.5 + 1j),
          jblas.her2(jnp.asarray(x), jnp.asarray(y), alpha=0.5 + 1j))
    close(blas.gemm(T(A), T(B), transA="C"), A.conj().T @ B)


def test_lapack_complex_heev():
    rng = np.random.default_rng(1)
    n = 6
    A = _cplx(rng, n, n)
    H = A + A.conj().T
    w, V = lapack.heev(T(H))
    wj, Vj = jlapack.heev(jnp.asarray(H))
    close(w, wj)
    Vn = V.numpy()
    close(Vn @ np.diag(w.numpy()) @ Vn.conj().T, H)
    # each eigenvector equals the JAX one up to a phase
    ph = np.sum(Vn.conj() * np.asarray(Vj), axis=0)
    close(Vn * ph, Vj, 1e-10)


def test_lapack_complex_hegv_and_potrf():
    rng = np.random.default_rng(2)
    n = 5
    A = _cplx(rng, n, n)
    H = A + A.conj().T
    F = _cplx(rng, n, n)
    B = F @ F.conj().T + n * np.eye(n)
    w, V = lapack.hegv(T(np.tril(H)), T(np.tril(B)))
    close(w, jlapack.hegv(jnp.asarray(np.tril(H)),
                          jnp.asarray(np.tril(B)))[0])
    Vn = V.numpy()
    close(H @ Vn, B @ Vn * w.numpy()[None, :], 1e-9)
    L = lapack.potrf(T(np.tril(B)))
    close(L, jlapack.potrf(jnp.asarray(np.tril(B))))
    b = _cplx(rng, n)
    close(lapack.potrs(L, T(b)), np.linalg.solve(B, b), 1e-10)


def test_lapack_complex_gees():
    rng = np.random.default_rng(3)
    A = _cplx(rng, 6, 6)
    S, w, V = (u.numpy() for u in lapack.gees(T(A)))
    assert S.dtype == np.complex128 and w.dtype == np.complex128
    assert np.abs(V @ S @ V.conj().T - A).max() < 1e-12
    assert np.abs(np.tril(S, -1)).max() == 0.0
    close(S, jlapack.gees(jnp.asarray(A))[0])


def test_lapack_complex_getrs_trans():
    rng = np.random.default_rng(4)
    A = _cplx(rng, 5, 5) + 5 * np.eye(5)
    b = _cplx(rng, 5)
    f = lapack.getrf(T(A))
    close(lapack.getrs(f, T(b), trans="T"), np.linalg.solve(A.T, b), 1e-10)
    close(lapack.getrs(f, T(b), trans="C"),
          np.linalg.solve(A.conj().T, b), 1e-10)

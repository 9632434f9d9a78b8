"""The port's numeric namespaces (cvxopt_tpu_torch/ops/blas.py,
ops/lapack.py, ops/spsolve.py, native/, utils/fft.py, utils/rng.py,
utils/printing.py, base.py constructors) against cvxopt_tpu's on the
CPU - twins of the cases of tests/test_ops.py on the same seeded numpy
data, with the spsolve and native cases.

Tolerances: BLAS results and factor solves within 1e-12 relative
(float64) of the JAX function; eigenvalues at 1e-12, eigen- and
singular vectors and QR factors up to sign; Schur forms by their
reconstruction at 1e-12 (scipy's LAPACK on both sides); rng by
determinism per seed, shapes and loose moments, not values.
"""

import io

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax
import jax.numpy as jnp
from cvxopt_tpu.ops import blas as jblas, lapack as jlapack, \
    spsolve as jspsolve
from cvxopt_tpu.utils import fft as jfft
from cvxopt_tpu_torch.ops import blas, lapack, spsolve
from cvxopt_tpu_torch.utils import fft, rng, printing
from cvxopt_tpu_torch import base

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(np.abs(want).max(initial=0), 1.0))


def randpsd(n, seed=0):
    r = np.random.default_rng(seed)
    F = r.standard_normal((n, n))
    return F @ F.T + n * np.eye(n)


def _data(seed=0):
    r = np.random.default_rng(seed)
    return {"x7": r.standard_normal(7), "y7": r.standard_normal(7),
            "A54": r.standard_normal((5, 4)), "x4": r.standard_normal(4),
            "x5": r.standard_normal(5), "A43": r.standard_normal((4, 3)),
            "B35": r.standard_normal((3, 5)), "C43": r.standard_normal((4, 3)),
            "T44": np.tril(r.standard_normal((4, 4))) + 4 * np.eye(4),
            "X45": r.standard_normal((4, 5))}


# ---- blas ----------------------------------------------------------------

def test_blas_level1():
    d = _data()
    x, y = d["x7"], d["y7"]
    for name in ("dot", "dotu"):
        close(getattr(blas, name)(T(x), T(y)),
              getattr(jblas, name)(jnp.asarray(x), jnp.asarray(y)))
    for name in ("nrm2", "asum"):
        close(getattr(blas, name)(T(x)), getattr(jblas, name)(jnp.asarray(x)))
    assert int(blas.iamax(T(x))) == int(jblas.iamax(jnp.asarray(x)))
    close(blas.axpy(T(x), T(y), 2.0), 2 * x + y)
    close(blas.scal(3.0, T(x)), 3 * x)
    close(blas.copy(T(x)), x)
    a, b = blas.swap(T(x), T(y))
    close(a, y)
    assert int(blas.iamax(T([1.0, -2.0, 3.0, -4.0]))) == 3


def test_blas_level2():
    d = _data()
    A, x4, x5 = d["A54"], d["x4"], d["x5"]
    close(blas.gemv(T(A), T(x4)), A @ x4)
    close(blas.gemv(T(A), T(x5), trans="T", alpha=0.5, y=T(x4), beta=2.0),
          jblas.gemv(jnp.asarray(A), jnp.asarray(x5), trans="T", alpha=0.5,
                     y=jnp.asarray(x4), beta=2.0))
    S = randpsd(4)
    close(blas.symv(T(np.tril(S)), T(x4)), S @ x4)
    close(blas.symv(T(np.triu(S)), T(x4), uplo="U"), S @ x4)
    Tm = d["T44"]
    close(blas.trmv(T(Tm), T(x4)), Tm @ x4)
    close(blas.trmv(T(Tm), T(x4), trans="T", diag="U"),
          jblas.trmv(jnp.asarray(Tm), jnp.asarray(x4), trans="T", diag="U"))
    close(blas.trsv(T(Tm), T(Tm @ x4)), x4, 1e-9)
    close(blas.trsv(T(Tm), T(x4), trans="T"),
          jblas.trsv(jnp.asarray(Tm), jnp.asarray(x4), trans="T"))
    close(blas.ger(T(x5), T(x4)), np.outer(x5, x4))
    close(blas.geru(T(x5), T(x4), T(A), alpha=2.0), A + 2 * np.outer(x5, x4))
    close(blas.syr(T(x4)), np.outer(x4, x4))
    close(blas.syr2(T(x4), T(x4[::-1].copy())),
          jblas.syr2(jnp.asarray(x4), jnp.asarray(x4[::-1].copy())))


def test_blas_band_level2():
    rng_ = np.random.default_rng(7)
    n, kl, ku = 6, 1, 2
    Ab = rng_.standard_normal((kl + ku + 1, n))
    x = rng_.standard_normal(n)
    close(blas.gbmv(T(Ab), n, n, kl, ku, T(x)),
          jblas.gbmv(jnp.asarray(Ab), n, n, kl, ku, jnp.asarray(x)))
    Sb = rng_.standard_normal((3, n))
    Sb[0] += 4
    for uplo in ("L", "U"):
        close(blas.sbmv(T(Sb), n, 2, T(x), uplo=uplo),
              jblas.sbmv(jnp.asarray(Sb), n, 2, jnp.asarray(x), uplo=uplo))
        close(blas.tbmv(T(Sb), n, 2, T(x), uplo=uplo),
              jblas.tbmv(jnp.asarray(Sb), n, 2, jnp.asarray(x), uplo=uplo))
        close(blas.tbsv(T(Sb), n, 2, T(x), uplo=uplo),
              jblas.tbsv(jnp.asarray(Sb), n, 2, jnp.asarray(x), uplo=uplo))


def test_blas_level3():
    d = _data()
    A, B, C, Tm, X = d["A43"], d["B35"], d["C43"], d["T44"], d["X45"]
    close(blas.gemm(T(A), T(B)), A @ B)
    close(blas.gemm(T(A), T(C), transB="T", alpha=2.0), 2 * A @ C.T)
    close(blas.syrk(T(A)), A @ A.T)
    close(blas.syrk(T(A), trans="T"), A.T @ A)
    close(blas.syr2k(T(A), T(C)), A @ C.T + C @ A.T)
    close(blas.syr2k(T(A), T(C), trans="T"),
          jblas.syr2k(jnp.asarray(A), jnp.asarray(C), trans="T"))
    S = randpsd(4)
    close(blas.symm(T(np.tril(S)), T(X)), S @ X)
    close(blas.symm(T(np.tril(S)), T(X.T), side="R"), X.T @ S)
    close(blas.trmm(T(Tm), T(X)), Tm @ X)
    close(blas.trsm(T(Tm), T(Tm @ X)), X, 1e-9)
    close(blas.trsm(T(Tm), T(X.T @ Tm), side="R"), X.T, 1e-9)
    for side, tr in (("L", "T"), ("R", "T"), ("L", "N")):
        Bm = X if side == "L" else X.T
        close(blas.trsm(T(Tm), T(Bm), side=side, transA=tr, alpha=0.5),
              jblas.trsm(jnp.asarray(Tm), jnp.asarray(Bm), side=side,
                         transA=tr, alpha=0.5))


# ---- lapack --------------------------------------------------------------

def test_lapack_cholesky():
    A = randpsd(6)
    B = np.random.default_rng(1).standard_normal((6, 2))
    L = lapack.potrf(T(A))
    close(L, jlapack.potrf(jnp.asarray(A)))
    close(lapack.potrs(L, T(B)), jlapack.potrs(jlapack.potrf(
        jnp.asarray(A)), jnp.asarray(B)))
    close(lapack.potri(L), np.linalg.inv(A), 1e-10)
    _, X = lapack.posv(T(A), T(B))
    close(T(A) @ X, B, 1e-10)
    bad = A - 100 * np.eye(6)
    assert torch.isnan(lapack.potrf(T(bad))).any()


def test_lapack_lu_sytrf():
    r = np.random.default_rng(2)
    A = r.standard_normal((5, 5))
    b = r.standard_normal(5)
    _, x = lapack.gesv(T(A), T(b))
    close(x, jlapack.gesv(jnp.asarray(A), jnp.asarray(b))[1])
    f = lapack.getrf(T(A))
    for tr in ("T", "C"):
        close(lapack.getrs(f, T(b), trans=tr), np.linalg.solve(A.T, b), 1e-10)
    close(lapack.getri(f), np.linalg.inv(A), 1e-10)
    S = randpsd(5) - 10 * np.eye(5)          # indefinite
    f = lapack.sytrf(T(np.tril(S)))
    x = lapack.sytrs(f, T(b))
    close(x, jlapack.sytrs(jlapack.sytrf(jnp.asarray(np.tril(S))),
                           jnp.asarray(b)))
    close(lapack.sysv(T(np.tril(S)), T(b))[1], np.linalg.solve(S, b), 1e-10)
    close(lapack.sytri(f) @ T(S), np.eye(5), 1e-9)


def test_lapack_triangular():
    Tm = _data()["T44"]
    B = np.random.default_rng(3).standard_normal((4, 2))
    for uplo, M in (("L", Tm), ("U", Tm.T)):
        for trans in ("N", "T", "C"):
            for diag in ("N", "U"):
                close(lapack.trtrs(T(M), T(B), uplo=uplo, trans=trans,
                                   diag=diag),
                      jlapack.trtrs(jnp.asarray(M), jnp.asarray(B),
                                    uplo=uplo, trans=trans, diag=diag),
                      1e-10)
    close(lapack.trtri(T(Tm)), np.linalg.inv(Tm), 1e-10)


def _up_to_sign(Q, Qj):
    Q, Qj = np.asarray(Q), np.asarray(Qj)
    s = np.sign(np.sum(Q * Qj, axis=0))
    close(Q * s, Qj, 1e-10)


def test_lapack_qr_eig_svd():
    r = np.random.default_rng(4)
    A = r.standard_normal((6, 4))
    Q, R = lapack.geqrf(T(A))
    close(Q @ R, A, 1e-12)
    Qj, Rj = jlapack.geqrf(jnp.asarray(A))
    _up_to_sign(Q.numpy(), Qj)
    close(lapack.orgqr((Q, R)), Q)
    C = r.standard_normal((6, 2))
    close(lapack.ormqr((Q, R), T(C), trans="T"), Q.numpy().T @ C)
    bb = r.standard_normal(6)
    close(lapack.gels(T(A), T(bb)), jlapack.gels(jnp.asarray(A),
                                                 jnp.asarray(bb)), 1e-10)
    S = randpsd(5)
    w, V = lapack.syev(T(np.tril(S)))
    wj, Vj = jlapack.syev(jnp.asarray(np.tril(S)))
    close(w, wj)
    _up_to_sign(V.numpy(), Vj)
    close(lapack.syevd(T(np.tril(S)), jobz="N"), wj)
    w2 = lapack.syevr(T(np.tril(S)), jobz="N", il=1, iu=2)
    close(w2, np.asarray(wj)[:2])
    w3, V3 = lapack.syevx(T(np.tril(S)), il=2, iu=3)
    close(w3, np.asarray(wj)[1:3])
    assert V3.shape == (5, 2)
    U, sv, Vt = lapack.gesvd(T(A))
    Uj, svj, Vtj = jlapack.gesvd(jnp.asarray(A))
    close(sv, svj)
    _up_to_sign(U.numpy(), Uj)
    close(U @ torch.diag(sv) @ Vt, A, 1e-12)
    assert lapack.gesdd(T(A), jobu="A")[0].shape == (6, 6)
    B = randpsd(5, seed=7)
    w3, V3 = lapack.sygv(T(np.tril(S)), T(np.tril(B)))
    close(w3, jlapack.sygv(jnp.asarray(np.tril(S)),
                           jnp.asarray(np.tril(B)))[0])
    for i in range(5):
        close(S @ V3[:, i].numpy(), w3[i].item() * (B @ V3[:, i].numpy()),
              1e-8)


def test_lapack_gees_identity():
    S, w, V = lapack.gees(torch.eye(3, dtype=torch.float64))
    assert np.allclose(w.numpy(), 1.0)


def test_lapack_lacpy_larfg_larfx():
    r = np.random.default_rng(1)
    x = r.standard_normal(6)
    v, tau, beta = lapack.larfg(T(x))
    jv, jtau, jbeta = jlapack.larfg(jnp.asarray(x))
    close(v, jv)
    close(tau, jtau)
    close(beta, jbeta)
    y = lapack.larfx(v, tau, T(x)[:, None]).numpy()
    np.testing.assert_allclose(y[0, 0], float(beta), atol=1e-10)
    np.testing.assert_allclose(y[1:, 0], 0.0, atol=1e-10)
    C = r.standard_normal((4, 6))
    close(lapack.larfx(v, tau, T(C), side="R"),
          jlapack.larfx(jv, jtau, jnp.asarray(C), side="R"))
    A = r.standard_normal((4, 4))
    for uplo in (None, "L", "U"):
        close(lapack.lacpy(T(A), uplo), jlapack.lacpy(jnp.asarray(A), uplo))


def test_geqp3_pivoted_qr():
    """Column-pivoted QR: the JAX function's pivots and factors."""
    r = np.random.default_rng(0)
    for m, n in ((8, 6), (6, 8), (7, 7)):
        A = r.standard_normal((m, n)) * np.logspace(0, 4, n)
        Q, R, piv = lapack.geqp3(T(A))
        Qj, Rj, pj = jlapack.geqp3(jnp.asarray(A))
        np.testing.assert_array_equal(piv.numpy(), np.asarray(pj))
        close(Q, Qj, 1e-10)
        close(R, Rj, 1e-10)
        Qn, Rn, pn = Q.numpy(), R.numpy(), piv.numpy()
        close(Qn @ Rn, A[:, pn], 1e-12)
        close(Qn.T @ Qn, np.eye(m), 1e-12)
        dg = np.abs(np.diag(Rn))
        assert np.all(dg[:-1] >= dg[1:] - 1e-9), dg
        _, _, ps = sla.qr(A, pivoting=True)
        np.testing.assert_array_equal(pn[:3], ps[:3])


def test_gees_real_and_complex():
    r = np.random.default_rng(0)
    A = r.standard_normal((8, 8))
    S, w, V = (u.numpy() for u in lapack.gees(T(A)))
    assert np.abs(V @ S @ V.T - A).max() < 1e-12
    assert np.abs(V.T @ V - np.eye(8)).max() < 1e-12
    wr = np.sort_complex(np.linalg.eigvals(A))
    assert np.abs(np.sort_complex(w) - wr).max() < 1e-10
    Sj, wj, Vj = jlapack.gees(jnp.asarray(A))
    close(S, Sj)
    close(V, Vj)
    _, _, _, sdim = lapack.gees(T(A), select=lambda s: s.real < 0)
    assert int(sdim) == int((wr.real < 0).sum())
    Az = A + 1j * r.standard_normal((8, 8))
    Sz, wz, Vz = (u.numpy() for u in lapack.gees(T(Az)))
    assert np.abs(Vz @ Sz @ Vz.conj().T - Az).max() < 1e-12
    assert np.abs(np.tril(Sz, -1)).max() == 0.0
    # a batch runs one matrix at a time
    Sb, wb, Vb = lapack.gees(T(np.stack([A, A.T])))
    assert Sb.shape == (2, 8, 8) and wb.shape == (2, 8)
    close(Sb[0], S)


def test_gges_generalized_schur():
    r = np.random.default_rng(1)
    A = r.standard_normal((6, 6))
    B = r.standard_normal((6, 6)) + 4 * np.eye(6)
    S, Tm, al, be, Q, Z = (u.numpy() for u in lapack.gges(T(A), T(B)))
    assert np.abs(Q @ S @ Z.T - A).max() < 1e-12
    assert np.abs(Q @ Tm @ Z.T - B).max() < 1e-12
    gen = np.sort_complex(al / be)
    ref = np.sort_complex(np.linalg.eigvals(np.linalg.solve(B, A)))
    assert np.abs(gen - ref).max() < 1e-10
    jres = jlapack.gges(jnp.asarray(A), jnp.asarray(B))
    close(S, jres[0])
    out = lapack.gges(T(A), T(B), select=lambda z: abs(z) < 1)
    assert int(out[-1]) == int((np.abs(ref) < 1).sum())


def test_lapack_long_tail_sytri_unmqr_ormlq():
    S = randpsd(5) - 10 * np.eye(5)
    f = lapack.sytrf(T(np.tril(S)))
    close(T(S) @ lapack.sytri(f), np.eye(5), 1e-9)
    r = np.random.default_rng(3)
    Az = r.standard_normal((6, 4)) + 1j * r.standard_normal((6, 4))
    qr_ = lapack.geqrf(T(Az))
    Q = lapack.ungqr(qr_)
    close(Q.conj().T @ Q, np.eye(4))
    C = r.standard_normal((6, 3)) + 1j * r.standard_normal((6, 3))
    close(lapack.unmqr(qr_, T(C), trans="C"), Q.conj().T @ T(C))
    Ar = r.standard_normal((3, 5))
    L, Qlq = lapack.gelqf(T(Ar))
    close(L @ Qlq, Ar)
    Cr = r.standard_normal((2, 5))
    close(lapack.unmlq((L, Qlq), T(Cr), trans="T", side="R"),
          Cr @ Qlq.numpy().T)


# ---- spsolve (cholmod/umfpack/amd) ---------------------------------------

def test_cholmod_like():
    import scipy.sparse as sp
    A = randpsd(8)
    A[np.abs(A) < 0.5] = 0.0
    A = A + 8 * np.eye(8)
    b = np.random.default_rng(5).standard_normal(8)
    F = spsolve.numeric(T(A), spsolve.symbolic(A))
    jF = jspsolve.numeric(jnp.asarray(A), jspsolve.symbolic(A))
    x = spsolve.solve(F, T(b))
    close(x, jspsolve.solve(jF, jnp.asarray(b)))
    x2 = spsolve.linsolve(sp.csc_matrix(A), T(b))
    close(T(A) @ x2, b, 1e-10)
    y = spsolve.solve(F, T(b), sys=4)
    close(spsolve.solve(F, y, sys=5), x, 1e-10)


def test_umfpack_like():
    r = np.random.default_rng(6)
    A = r.standard_normal((6, 6)) + 6 * np.eye(6)
    b = r.standard_normal(6)
    x = spsolve.lu_linsolve(T(A), T(b))
    close(x, jspsolve.lu_linsolve(jnp.asarray(A), jnp.asarray(b)))
    F = spsolve.lu_numeric(T(A), spsolve.lu_symbolic(A))
    xt = spsolve.lu_solve(F, T(b), trans="T")
    close(xt, np.linalg.solve(A.T, b), 1e-10)


def test_amd_order_vs_jax():
    A = np.eye(6)
    A[0, 5] = A[5, 0] = 1.0
    A[1, 2] = A[2, 1] = 1.0
    p = spsolve.amd_order(A)
    assert sorted(p.tolist()) == list(range(6))
    np.testing.assert_array_equal(p, jspsolve.amd_order(A))


def test_native_mindeg_matches_python():
    """The port's own native minimum-degree library gives the JAX
    package's ordering, builds into the ignored _build/ directory, and
    its orders do not fill more than the natural order."""
    import os
    import scipy.sparse as sp
    from cvxopt_tpu_torch import native
    from cvxopt_tpu import native as jnative
    n = 40
    A = sp.random(n, n, density=0.08, random_state=7)
    A = ((A + A.T) != 0).tocsr() + sp.eye(n)
    A = sp.csr_matrix(A)
    perm_c = native.mindeg_order(A.indptr, A.indices, n)
    if perm_c is None:
        pytest.skip("no C toolchain available")
    assert native.built()["mindeg"]
    assert os.path.exists(native.lib_path("mindeg"))
    assert "_build" in native.lib_path("mindeg")
    assert sorted(perm_c.tolist()) == list(range(n))
    np.testing.assert_array_equal(
        perm_c, jnative.mindeg_order(A.indptr.astype(np.int32),
                                     A.indices.astype(np.int32), n))
    D = np.asarray(A.todense(), dtype=float) + n * np.eye(n)

    def fill(perm):
        return (np.abs(np.linalg.cholesky(D[np.ix_(perm, perm)]))
                > 1e-12).sum()

    assert fill(np.asarray(perm_c)) <= fill(np.arange(n)) * 1.1


def test_native_block_fill_vs_jax():
    from cvxopt_tpu_torch import native
    from cvxopt_tpu import native as jnative
    indptr = np.array([0, 3, 5, 7, 9], np.int64)
    indices = np.array([0, 2, 3, 1, 3, 0, 2, 0, 3], np.int64)
    got = native.block_fill(indptr, indices, 4)
    if got is None:
        pytest.skip("no C toolchain available")
    want = jnative.block_fill(indptr, indices, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---- fft -----------------------------------------------------------------

def test_fft_roundtrips():
    x = np.random.default_rng(0).standard_normal((8, 3))
    close(fft.idft(fft.dft(T(x))).real, x, 1e-12)
    close(fft.dft(T(x)), jfft.dft(jnp.asarray(x)))
    close(fft.dftn(T(x)), jfft.dftn(jnp.asarray(x)))
    close(fft.idftn(fft.dftn(T(x))).real, x)
    close(fft.idctn(fft.dctn(T(x))), x, 1e-10)
    close(fft.idstn(fft.dstn(T(x))), x, 1e-10)
    import scipy.fft as sfft
    close(fft.dct(T(x)), sfft.dct(x, axis=0))
    close(fft.dst(T(x)), sfft.dst(x, type=1, axis=0))


def test_fft_all_dct_dst_types_vs_jax():
    import scipy.fft as sfft
    r = np.random.default_rng(0)
    x = r.standard_normal(17)
    X2 = r.standard_normal((9, 4))
    for t in (1, 2, 3, 4):
        for name in ("dct", "dst", "idct", "idst"):
            close(getattr(fft, name)(T(x), type=t),
                  getattr(jfft, name)(jnp.asarray(x), type=t))
        close(fft.dct(T(x), type=t), sfft.dct(x, type=t), 1e-12)
        close(fft.idst(T(x), type=t), sfft.idst(x, type=t, norm=None), 1e-12)
    close(fft.dst(T(X2), type=2, axis=1), sfft.dst(X2, type=2, axis=1))
    close(fft.dct(T(X2), type=3, axis=1), sfft.dct(X2, type=3, axis=1))
    x16 = r.standard_normal(16)
    for t in (2, 3):
        close(fft.dct(T(x16), type=t), jfft.dct(jnp.asarray(x16), type=t))


# ---- rng (gsl equivalent) ------------------------------------------------

def test_rng_seeding():
    rng.setseed(42)
    a = rng.normal(5, 2, device="cpu")
    u = rng.uniform(4, 1, a=2.0, b=3.0, device="cpu")
    rng.setseed(42)
    a2 = rng.normal(5, 2, device="cpu")
    np.testing.assert_array_equal(a.numpy(), a2.numpy())
    assert rng.getseed() == 42
    assert a.shape == (5, 2) and a.dtype == torch.float64
    assert u.shape == (4,)
    assert (u >= 2.0).all() and (u < 3.0).all()
    rng.setseed(7)
    assert not torch.equal(rng.normal(5, 2, device="cpu"), a)


def test_rng_moments():
    rng.setseed(3)
    z = rng.normal(20000, mean=1.0, std=2.0, device="cpu")
    assert abs(float(z.mean()) - 1.0) < 0.05
    assert abs(float(z.std()) - 2.0) < 0.05
    u = rng.uniform(20000, device="cpu")
    assert abs(float(u.mean()) - 0.5) < 0.02
    rng.setseed(None)
    assert rng.getseed() >= 0


# ---- printing / base -----------------------------------------------------

def test_printing_vs_jax():
    from cvxopt_tpu.utils import printing as jp
    from cvxopt_tpu.base import spmatrix as jspm
    X = np.arange(6.0).reshape(2, 3)
    s = printing.matrix_str_default(T(X))
    assert s == jp.matrix_str_default(X)
    assert printing.matrix_repr(T(X)) == "<2x3 matrix, tc='d'>"
    assert printing.matrix_repr(T(X).int()) == jp.matrix_repr(
        X.astype(np.int32))
    S = base.spmatrix([1.0, 2.0], [0, 1], [1, 0], size=(2, 2), device="cpu")
    t = printing.spmatrix_str_triplet(S)
    assert "(0,1)" in t
    assert t == jp.spmatrix_str_triplet(jspm([1.0, 2.0], [0, 1], [1, 0],
                                             size=(2, 2)))
    assert printing.spmatrix_repr(S) == "<2x2 sparse matrix, nnz=2>"


def test_base_constructors():
    from cvxopt_tpu import base as jbase
    kw = dict(device="cpu")
    A = base.matrix([[2., 1., -1., 0.], [1., 2., 0., -1.]], **kw)
    assert A.shape == (4, 2)
    close(A, jbase.matrix([[2., 1., -1., 0.], [1., 2., 0., -1.]]))
    close(base.matrix(3.0, (2, 2), **kw), 3.0 * np.ones((2, 2)))
    C = base.matrix(np.arange(6.0), (2, 3), **kw)
    assert float(C[1, 0]) == 1.0 and float(C[0, 1]) == 2.0
    assert base.matrix([1, 2], tc="i", **kw).dtype == torch.int32
    S = base.spmatrix([1., 2., 3.], [0, 1, 2], [0, 1, 2], **kw)
    close(S.to_dense(), np.diag([1., 2., 3.]))
    D = base.spdiag([1., 2.], **kw)
    close(D.to_dense(), np.diag([1., 2.]))
    Db = base.spdiag([np.eye(2), 3 * np.ones((1, 1))], **kw)
    close(Db.to_dense(), np.asarray(jbase.spdiag(
        [np.eye(2), 3 * np.ones((1, 1))]).todense()))
    Bl = base.sparse([[np.eye(2), np.zeros((1, 2))],
                      [np.zeros((2, 1)), np.ones((1, 1))]], **kw)
    assert Bl.shape == (3, 3)
    x, y = T([1., 2.]), T([3., 4.])
    close(base.mul(x, y), [3., 8.])
    close(base.div(T([4.]), T([2.])), [2.])
    close(base.emax(x, T([2., 1.])), [2., 2.])
    close(base.emin(x, T([2., 1.])), [1., 1.])
    for name in ("exp", "log", "sqrt", "sin", "cos"):
        close(getattr(base, name)(x), getattr(jbase, name)(np.array([1., 2.])))


def test_base_complex_elementwise():
    z = base.matrix(np.array([1 + 2j, -1j]), (2, 1), tc="z", device="cpu")
    assert z.is_complex()
    close(base.exp(z), np.exp(z.numpy()))
    close(base.mul(z, z), z.numpy() ** 2)
    x = T(np.array([1 + 1j, 2 - 1j]))
    y = T(np.array([1j, 1.0]))
    close(blas.dotu(x, y), np.sum(x.numpy() * y.numpy()))
    close(blas.dot(x, y), np.vdot(x.numpy(), y.numpy()))


def test_ops_namespace_exports():
    import cvxopt_tpu.ops as jops
    import cvxopt_tpu_torch.ops as tops
    assert set(jops.__all__) <= set(tops.__all__)
    for mod in ("blas", "lapack"):
        jm, tm = getattr(jops, mod), getattr(tops, mod)
        missing = [n for n in jm.__all__ if not hasattr(tm, n)]
        assert not missing, (mod, missing)
    jsp = [n for n in dir(jspsolve) if not n.startswith("_")
           and callable(getattr(jspsolve, n))
           and getattr(getattr(jspsolve, n), "__module__", "")
           == jspsolve.__name__]
    assert [n for n in jsp if not hasattr(spsolve, n)] == []

"""The port's banded and tridiagonal factorizations
(cvxopt_tpu_torch/ops/banded.py) against cvxopt_tpu/ops/banded.py on the
CPU - twins of the cases of tests/test_banded.py on the same seeded
numpy data.

Tolerances: factors and solves within 1e-12 relative (float64) of the
JAX function, 1e-5 in float32; the sparse LPs (scan against blocked
factor, and against the JAX package) with equal status and iterations
and x within 1e-6.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from cvxopt_tpu.ops import banded as jb
from cvxopt_tpu_torch.ops import banded as tb

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

RTOL = 1e-12


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def close(got, want, rtol=RTOL):
    got = got.double().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(np.abs(want).max(initial=0.0), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _spd_band(n, kd, seed=0):
    rng = np.random.default_rng(seed)
    AB = np.zeros((kd + 1, n))
    AB[0] = rng.uniform(2.0 + kd, 3.0 + kd, n)
    for j in range(1, kd + 1):
        AB[j, :n - j] = rng.uniform(-1, 1, n - j)
    return AB


@pytest.mark.parametrize("n,kd", [(12, 1), (20, 3), (33, 5), (9, 0)])
def test_pbtrf_pbtrs_vs_jax_and_scipy(n, kd):
    AB = _spd_band(n, kd, seed=n)
    B = np.random.default_rng(1).standard_normal((n, 2))
    LB = tb.pbtrf(T(AB))
    x = tb.pbtrs(LB, T(B))
    close(LB, jb.pbtrf(jnp.asarray(AB)))
    close(x, jb.pbtrs(jb.pbtrf(jnp.asarray(AB)), jnp.asarray(B)))
    close(x, sla.solveh_banded(AB, B, lower=True), 1e-9)
    close(LB, sla.cholesky_banded(AB, lower=True), 1e-9)
    # vector right-hand side and pbsv
    _, xv = tb.pbsv(T(AB), T(B[:, 0]))
    assert xv.shape == (n,)
    close(xv, np.asarray(x)[:, 0])


def test_pbtrf_float32():
    AB = _spd_band(20, 3, seed=7)
    B = np.random.default_rng(2).standard_normal(20)
    x = tb.pbtrs(tb.pbtrf(T(AB, torch.float32)), T(B, torch.float32))
    assert x.dtype == torch.float32
    close(x, jb.pbtrs(jb.pbtrf(jnp.asarray(AB)), jnp.asarray(B)), 1e-5)


def test_pbtrf_non_pd_nan():
    AB = _spd_band(10, 2, seed=3)
    AB[0, 5] = -1.0
    LB = tb.pbtrf(T(AB))
    assert torch.isnan(LB).any()
    jLB = np.asarray(jb.pbtrf(jnp.asarray(AB)))
    np.testing.assert_array_equal(torch.isnan(LB).numpy(), np.isnan(jLB))


def test_pbtrf_dbound_clamps_pivots():
    AB = _spd_band(12, 2, seed=4)
    AB[0, 6] = 0.0
    close(tb.pbtrf(T(AB), dbound=1e-3),
          jb.pbtrf(jnp.asarray(AB), dbound=1e-3))


def test_band_storage_round_trip():
    AB = _spd_band(15, 3, seed=5)
    A = tb.band_to_dense(T(AB))
    close(A, jb.band_to_dense(jnp.asarray(AB)))
    close(tb.dense_to_band(A, 3), AB)


def test_pt_tridiag_vs_jax():
    n = 25
    rng = np.random.default_rng(2)
    d = rng.uniform(2, 3, n)
    e = rng.uniform(-1, 1, n - 1)
    B = rng.standard_normal((n, 3))
    df, ef = tb.pttrf(T(d), T(e))
    jdf, jef = jb.pttrf(jnp.asarray(d), jnp.asarray(e))
    close(df, jdf)
    close(ef, jef)
    x = tb.pttrs(df, ef, T(B))
    close(x, jb.pttrs(jdf, jef, jnp.asarray(B)))
    A = np.diag(d) + np.diag(e, -1) + np.diag(e, 1)
    close(x, np.linalg.solve(A, B), 1e-9)
    _, xs = tb.ptsv(T(d), T(e), T(B[:, 1]))
    close(xs, np.asarray(x)[:, 1])


def test_gtsv_vs_jax_with_pivoting():
    n = 30
    rng = np.random.default_rng(4)
    d = rng.standard_normal(n) * 0.01
    dl = rng.standard_normal(n - 1) + 2.0
    du = rng.standard_normal(n - 1) + 2.0
    B = rng.standard_normal((n, 2))
    A = np.diag(d) + np.diag(dl, -1) + np.diag(du, 1)
    x = tb.gtsv(T(dl), T(d), T(du), T(B))
    close(x, jb.gtsv(*map(jnp.asarray, (dl, d, du, B))))
    close(x, np.linalg.solve(A, B), 1e-9)
    fac = tb.gttrf(T(dl), T(d), T(du))
    xt = tb.gttrs(fac, T(B), trans="T")
    close(xt, jb.gttrs(jb.gttrf(*map(jnp.asarray, (dl, d, du))),
                       jnp.asarray(B), trans="T"))
    close(xt, np.linalg.solve(A.T, B), 1e-9)


def test_tbtrs_lower_vs_jax():
    n, kd = 15, 3
    rng = np.random.default_rng(5)
    AB = np.zeros((kd + 1, n))
    AB[0] = rng.uniform(1, 2, n)
    for j in range(1, kd + 1):
        AB[j, :n - j] = rng.uniform(-1, 1, n - j)
    b = rng.standard_normal(n)
    for trans in ("N", "T"):
        close(tb.tbtrs(T(AB), T(b), trans=trans),
              jb.tbtrs(jnp.asarray(AB), jnp.asarray(b), trans=trans))


def test_tbtrs_upper_storage_vs_jax():
    rng = np.random.default_rng(1)
    n, kd = 30, 3
    A = rng.standard_normal((n, n))
    U = np.triu(A) - np.triu(A, kd + 1)
    np.fill_diagonal(U, np.sign(np.diag(U)) * (3 + np.abs(np.diag(U))))
    AB = np.zeros((kd + 1, n))
    for d in range(kd + 1):
        AB[kd - d, d:] = np.diagonal(U, d)
    b = rng.standard_normal(n)
    B = rng.standard_normal((n, 2))
    for rhs in (b, B):
        for trans in ("N", "T"):
            x = tb.tbtrs(T(AB), T(rhs), uplo="U", trans=trans)
            close(x, jb.tbtrs(jnp.asarray(AB), jnp.asarray(rhs), uplo="U",
                              trans=trans))
    x = tb.tbtrs(T(AB), T(b), uplo="U").numpy()
    assert np.max(np.abs(U @ x - b)) < 1e-12


def test_gbsv_vs_jax():
    n, kl, ku = 18, 2, 1
    rng = np.random.default_rng(6)
    AB = rng.standard_normal((kl + ku + 1, n))
    AB[ku] += 4.0
    B = rng.standard_normal(n)
    _, x = tb.gbsv(T(AB), kl, ku, T(B))
    close(x, jb.gbsv(jnp.asarray(AB), kl, ku, jnp.asarray(B))[1])
    close(x, sla.solve_banded((kl, ku), AB, B), 1e-9)
    fac = tb.gbtrf(T(AB), kl, ku)
    close(tb.gbtrs(fac, T(B), trans="T"),
          jb.gbtrs(jb.gbtrf(jnp.asarray(AB), kl, ku), jnp.asarray(B),
                   trans="T"))


def test_exported_from_lapack():
    from cvxopt_tpu_torch.ops import lapack
    for name in ("pbtrf", "pttrf", "gtsv", "tbtrs", "gbsv"):
        assert getattr(lapack, name) is getattr(tb, name)


@pytest.mark.parametrize("n,kd,cb", [(50, 3, 8), (100, 5, 16), (37, 4, 8)])
def test_pbtrf_blocked_vs_jax(n, kd, cb):
    rng = np.random.default_rng(0)
    A = np.zeros((n, n))
    for j in range(kd + 1):
        d = rng.standard_normal(n - j) * 0.3
        A += np.diag(d, -j) + (np.diag(d, j) if j else 0)
    A += np.eye(n) * (kd + 2.0)
    AB = np.stack([np.pad(np.diagonal(A, -j), (0, j))
                   for j in range(kd + 1)])
    fac = tb.pbtrf_blocked(T(AB), cb=cb)
    jfac = jb.pbtrf_blocked(jnp.asarray(AB), cb=cb)
    close(fac[0], jfac[0])
    close(fac[1], jfac[1])
    for rhs in (rng.standard_normal(n), rng.standard_normal((n, 3))):
        x = tb.pbtrs_blocked(fac, T(rhs))
        close(x, jb.pbtrs_blocked(jfac, jnp.asarray(rhs)))
        close(x, np.linalg.solve(A, rhs), 1e-10)


def test_pbtrf_blocked_non_pd_nan():
    AB = _spd_band(40, 2, seed=8)
    AB[0, 20] = -5.0
    Ls, _ = tb.pbtrf_blocked(T(AB), cb=8)
    jLs, _ = jb.pbtrf_blocked(jnp.asarray(AB), cb=8)
    np.testing.assert_array_equal(torch.isnan(Ls).numpy(),
                                  np.isnan(np.asarray(jLs)))


def test_sparse_lp_blocked_method():
    """conelp through the banded kktsolver: the scan and the blocked
    factor give the same answer, and both the JAX package's."""
    from cvxopt_tpu.ops.sparse_kkt import kkt_chol2_banded as jk, \
        _as_ops as jops
    from cvxopt_tpu.cones import ConeDims as JDims
    from cvxopt_tpu import solvers as js
    from cvxopt_tpu_torch.ops.sparse_kkt import kkt_chol2_banded, _as_ops
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch import solvers
    from test_torch_sparse_kkt import _chain_lp
    c, G, h = _chain_lp(300, seed=1)
    r = G.shape[0]
    ref = js.conelp(jnp.asarray(c), jops(G, jnp.float64), jnp.asarray(h),
                    dims=JDims(l=r), kktsolver=jk(G, JDims(l=r),
                                                  method="blocked"),
                    options={"maxiters": 30})
    outs = []
    for method in ("scan", "blocked"):
        kkt = kkt_chol2_banded(G, ConeDims(l=r), method=method,
                               device="cpu")
        sol = solvers.conelp(torch.as_tensor(c), _as_ops(G, torch.float64,
                                                         "cpu"),
                             torch.as_tensor(h), dims=ConeDims(l=r),
                             kktsolver=kkt, options={"maxiters": 30},
                             device="cpu")
        assert sol["status"] == ref["status"] == "optimal"
        assert sol["iterations"] == ref["iterations"]
        outs.append(sol["x"].numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)
    np.testing.assert_allclose(outs[1], np.asarray(ref["x"]), atol=1e-6)


def test_gbtrf_scan_vs_jax():
    rng = np.random.default_rng(0)
    for n, kl, ku in ((40, 2, 3), (100, 1, 1), (60, 4, 0), (50, 0, 2)):
        A = np.zeros((n, n))
        for d in range(-kl, ku + 1):
            A += np.diag(rng.standard_normal(n - abs(d)), d)
        A += np.diag(3.0 + rng.uniform(0, 1, n))
        AB = np.zeros((kl + ku + 1, n))
        for jc in range(n):
            for i in range(max(0, jc - ku), min(n, jc + kl + 1)):
                AB[ku + i - jc, jc] = A[i, jc]
        fac = tb.gbtrf_scan(T(AB), kl, ku)
        jfac = jb.gbtrf_scan(jnp.asarray(AB), kl, ku)
        close(fac[0], jfac[0])
        close(fac[1], jfac[1])
        np.testing.assert_array_equal(fac[2].numpy(), np.asarray(jfac[2]))
        for rhs in (rng.standard_normal(n), rng.standard_normal((n, 4))):
            x = tb.gbtrs_scan(fac, T(rhs), kl, ku)
            close(x, jb.gbtrs_scan(jfac, jnp.asarray(rhs), kl, ku))
            close(x, np.linalg.solve(A, rhs), 1e-9)


def test_umfpack_banded_no_densify():
    """The umfpack API factors a large banded unsymmetric system
    through RCM and the pivoted banded LU, never densifying; the
    solutions equal the JAX package's."""
    from cvxopt_tpu.ops import spsolve as js
    from cvxopt_tpu_torch.ops import spsolve
    n = 20_000
    rng = np.random.default_rng(0)
    main = 4.0 + rng.uniform(0, 1, n)
    lo = rng.standard_normal(n - 1)
    up = rng.standard_normal(n - 1)
    A = sp.diags([lo, main, up], [-1, 0, 1]).tocsr()
    b = rng.standard_normal(n)
    symb = spsolve.lu_symbolic(A)
    assert symb.banded
    F = spsolve.lu_numeric(A, symb, device="cpu")
    jF = js.lu_numeric(A, js.lu_symbolic(A))
    x = spsolve.lu_solve(F, b)
    close(x, js.lu_solve(jF, b))
    assert np.abs(A @ x.numpy() - b).max() < 1e-9
    xt = spsolve.lu_solve(F, b, trans="T")
    close(xt, js.lu_solve(jF, b, trans="T"))
    assert np.abs(A.T @ xt.numpy() - b).max() < 1e-9
    p = rng.permutation(n)
    As = A[p][:, p]
    x2 = spsolve.lu_linsolve(As, b, device="cpu")
    assert np.abs(As @ x2.numpy() - b).max() < 1e-9

"""The port's advanced solver forms against the JAX package on the CPU
in float64: operator-form G/A/P (`LinearOperator`, callables), callable
kktsolvers, warm starts and a dict-valued x in `conelp`/`coneqp` —
twins of the cases of tests/test_custom_kkt.py, each on the same numpy
data with the user callables written again in torch.  Statuses and
iteration counts equal, x within 1e-6 (absolute) unless stated."""

import numpy as np
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import pytest
import torch

from cvxopt_tpu import solvers as js
from cvxopt_tpu import kkt as jkkt
from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu.linops import LinearOperator as JOp
from cvxopt_tpu_torch import solvers as ts
from cvxopt_tpu_torch import kkt as tkkt
from cvxopt_tpu_torch import LinearOperator as TOp, aslinearoperator
from cvxopt_tpu_torch.cones import ConeDims as TDims

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

XTOL = 1e-6


def _same(out, ref, xtol=XTOL, key=None):
    assert out["status"] == ref["status"] == "optimal"
    assert out["iterations"] == ref["iterations"]
    ox, rx = out["x"], ref["x"]
    if key is not None:
        ox, rx = ox[key], rx[key]
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), atol=xtol,
                               rtol=0)


def make_l1_data(m=80, n=25, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), rng.standard_normal(m)


def l1_dense(P, q, lib):
    m, n = P.shape
    c = np.concatenate([np.zeros(n), np.ones(m)])
    I = np.eye(m)
    G = np.block([[P, -I], [-P, -I]])
    h = np.concatenate([q, -q])
    if lib is js:
        return js.conelp(c, G, h)
    return ts.conelp(c, G, h, device="cpu")


def _l1_kkt_jax(P):
    m, n = P.shape

    def Fkkt(W):
        di = W["di"]
        d1, d2 = di[:m] ** 2, di[m:] ** 2
        D = d1 * d2 / (d1 + d2)
        L = jnp.linalg.cholesky(4.0 * (P.T * D) @ P)

        def solve(bx, by, bz):
            r = bx[:n] + P.T @ ((d1 - d2) / (d1 + d2) * bx[n:]
                                + 2.0 * D * (bz[:m] - bz[m:]))
            w = jsl.solve_triangular(L, r, lower=True)
            xu = jsl.solve_triangular(L.T, w, lower=False)
            u = P @ xu
            xv = (bx[n:] - d1 * bz[:m] - d2 * bz[m:]
                  + (d1 - d2) * u) / (d1 + d2)
            z1 = di[:m] * (u - xv - bz[:m])
            z2 = di[m:] * (-u - xv - bz[m:])
            return (jnp.concatenate([xu, xv]), by,
                    jnp.concatenate([z1, z2]))

        return solve

    return Fkkt


def _tri(L, r, upper):
    return torch.linalg.solve_triangular(L, r.unsqueeze(-1),
                                         upper=upper).squeeze(-1)


def _l1_kkt_torch(P):
    m, n = P.shape

    def Fkkt(W):
        di = W["di"]
        d1, d2 = di[:m] ** 2, di[m:] ** 2
        D = d1 * d2 / (d1 + d2)
        L = torch.linalg.cholesky(4.0 * (P.T * D) @ P)

        def solve(bx, by, bz):
            r = bx[:n] + P.T @ ((d1 - d2) / (d1 + d2) * bx[n:]
                                + 2.0 * D * (bz[:m] - bz[m:]))
            xu = _tri(L.T, _tri(L, r, False), True)
            u = P @ xu
            xv = (bx[n:] - d1 * bz[:m] - d2 * bz[m:]
                  + (d1 - d2) * u) / (d1 + d2)
            z1 = di[:m] * (u - xv - bz[:m])
            z2 = di[m:] * (-u - xv - bz[m:])
            return torch.cat([xu, xv]), by, torch.cat([z1, z2])

        return solve

    return Fkkt


def _warm(P, q, m, n):
    """Least-squares warm starts of l1.py:100-116, in numpy."""
    uls = np.linalg.lstsq(P, q, rcond=None)[0]
    rls = P @ uls - q
    x0 = np.concatenate([uls, 1.1 * np.abs(rls)])
    t = P @ x0[:n]
    s0 = np.concatenate([q, -q]) - np.concatenate([t - x0[n:], -t - x0[n:]])
    w = 0.9 / np.abs(rls).max() * rls
    return x0, s0, np.concatenate([0.5 * (1 + w), 0.5 * (1 - w)])


def l1_custom(P, q, lib):
    """Operator G + custom kktsolver (examples/doc/chap8/l1.py) with
    least-squares warm starts."""
    m, n = P.shape
    c = np.concatenate([np.zeros(n), np.ones(m)])
    h = np.concatenate([q, -q])
    x0, s0, z0 = _warm(P, q, m, n)
    kw = dict(dims={"l": 2 * m, "q": [], "s": []},
              primalstart={"x": x0, "s": s0}, dualstart={"z": z0})
    if lib is js:
        Pj = jnp.asarray(P)
        G = JOp(mv=lambda x: jnp.concatenate([Pj @ x[:n] - x[n:],
                                              -Pj @ x[:n] - x[n:]]),
                rmv=lambda z: jnp.concatenate([Pj.T @ (z[:m] - z[m:]),
                                               -(z[:m] + z[m:])]),
                shape=(2 * m, n + m))
        return js.conelp(c, G, h, kktsolver=_l1_kkt_jax(Pj), **kw)
    Pt = torch.as_tensor(P)
    G = TOp(mv=lambda x: torch.cat([Pt @ x[:n] - x[n:],
                                    -Pt @ x[:n] - x[n:]]),
            rmv=lambda z: torch.cat([Pt.T @ (z[:m] - z[m:]),
                                     -(z[:m] + z[m:])]),
            shape=(2 * m, n + m))
    return ts.conelp(c, G, h, kktsolver=_l1_kkt_torch(Pt), device="cpu",
                     **kw)


def test_l1_custom_matches_dense():
    P, q = make_l1_data()
    m, n = P.shape
    out_d, out_c = l1_dense(P, q, ts), l1_custom(P, q, ts)
    _same(out_d, l1_dense(P, q, js))
    _same(out_c, l1_custom(P, q, js))
    np.testing.assert_allclose(out_c["x"][:n].numpy(),
                               out_d["x"][:n].numpy(), atol=1e-3)
    z = out_c["z"].numpy()
    np.testing.assert_allclose(P.T @ (z[m:] - z[:m]), np.zeros(n),
                               atol=1e-5)


def test_warm_start_reduces_iterations():
    P, q = make_l1_data(seed=3)
    cold, warm = l1_dense(P, q, ts), l1_custom(P, q, ts)
    assert warm["iterations"] <= cold["iterations"] + 2
    assert warm["iterations"] == l1_custom(P, q, js)["iterations"]
    assert cold["iterations"] == l1_dense(P, q, js)["iterations"]


def test_operator_without_kkt_raises():
    P, q = make_l1_data()
    m, n = P.shape
    for lib, Op, kw in ((js, JOp, {}), (ts, TOp, dict(device="cpu"))):
        G = Op(mv=lambda x: x, rmv=lambda x: x, shape=(n + m, n + m))
        with pytest.raises(ValueError):
            lib.conelp(np.zeros(n + m), G, np.zeros(n + m), **kw)
        with pytest.raises(ValueError):
            lib.coneqp(np.eye(n + m), np.zeros(n + m), G,
                       np.zeros(n + m), **kw)
    # an operator P without a kktsolver: the JAX package would factor
    # without P; the port refuses
    with pytest.raises(ValueError, match="operator-form P"):
        ts.coneqp(G, np.zeros(n + m), device="cpu")


def _l1regls_data():
    rng = np.random.default_rng(5)
    m, n = 20, 40                       # m < n: the SMW trick pays off
    return rng.standard_normal((m, n)), rng.standard_normal(m)


def _l1regls_kkt_torch(A):
    m, n = A.shape

    def Fkkt(W):
        d1 = W["di"][:n] ** 2
        d2 = W["di"][n:] ** 2
        D = 4.0 * d1 * d2 / (d1 + d2)
        ds = (d2 - d1) / (d1 + d2)
        Asc = A / torch.sqrt(D)[None, :]
        L = torch.linalg.cholesky(torch.eye(m, dtype=A.dtype)
                                  + 2.0 * (Asc @ Asc.T))

        def solve(bx, by, bz):
            xn = bx[:n] - ds * bx[n:] \
                + d1 * (1.0 + ds) * bz[:n] - d2 * (1.0 - ds) * bz[n:]
            rhs = xn / D
            v = _tri(L.T, _tri(L, A @ rhs, False), True)
            x1 = rhs - (A.T @ v) * (2.0 / D)
            x2 = (bx[n:] - d1 * bz[:n] - d2 * bz[n:]) / (d1 + d2) \
                - ds * x1
            z1 = W["di"][:n] * (x1 - x2 - bz[:n])
            z2 = W["di"][n:] * (-x1 - x2 - bz[n:])
            return torch.cat([x1, x2]), by, torch.cat([z1, z2])

        return solve

    return Fkkt


def test_custom_kkt_qp_l1regls():
    """l1-regularized least squares through `coneqp` with operator P/G
    and the Woodbury kktsolver: against the JAX package's library form
    (same operators and kktsolver), the port's dense default path, and
    the optimality conditions."""
    from cvxopt_tpu import kkt_structured as jks
    A, yv = _l1regls_data()
    m, n = A.shape
    At = torch.as_tensor(A)
    q = np.concatenate([-2.0 * A.T @ yv, np.ones(n)])

    def Gmv(u):
        return torch.cat([u[:n] - u[n:], -u[:n] - u[n:]])

    def Grmv(z):
        return torch.cat([z[:n] - z[n:], -(z[:n] + z[n:])])

    def Pmv(u):
        return torch.cat([2.0 * At.T @ (At @ u[:n]), At.new_zeros(n)])

    P = TOp(mv=Pmv, rmv=Pmv, shape=(2 * n, 2 * n))
    # the plain-callable form G(x, trans) for G
    sol = ts.coneqp(P, q, lambda v, t: Gmv(v) if t == "N" else Grmv(v),
                    np.zeros(2 * n), dims={"l": 2 * n},
                    kktsolver=_l1regls_kkt_torch(At), device="cpu")
    _same(sol, jks.l1regls(A, yv))
    x = sol["x"][:n].numpy()

    Pd = np.zeros((2 * n, 2 * n))
    Pd[:n, :n] = 2 * A.T @ A
    I = np.eye(n)
    sol_d = ts.coneqp(Pd, q, np.block([[I, -I], [-I, -I]]),
                      np.zeros(2 * n), device="cpu")
    assert sol_d["status"] == "optimal"
    np.testing.assert_allclose(x, sol_d["x"][:n].numpy(), atol=1e-5)
    g = 2 * A.T @ (A @ x - yv)
    on = np.abs(x) > 1e-3
    assert np.max(np.abs(g[on] + np.sign(x[on]))) < 1e-4
    assert np.max(np.abs(g[~on])) <= 1.0 + 1e-4


def test_pytree_vector_space():
    """x as a dict {'u': (n,), 'v': (m,)} throughout the solve."""
    P, q = make_l1_data(m=40, n=12, seed=7)
    m, n = P.shape
    h = np.concatenate([q, -q])
    Pj, Pt = jnp.asarray(P), torch.as_tensor(P)

    def kkt(lib, Pm):
        cat = jnp.concatenate if lib is jnp else torch.cat
        chol = jnp.linalg.cholesky if lib is jnp else torch.linalg.cholesky

        def cho(L, r):
            if lib is jnp:
                return jsl.solve_triangular(
                    L.T, jsl.solve_triangular(L, r, lower=True),
                    lower=False)
            return _tri(L.T, _tri(L, r, False), True)

        def Fkkt(W):
            di = W["di"]
            d1, d2 = di[:m] ** 2, di[m:] ** 2
            D = d1 * d2 / (d1 + d2)
            L = chol(4.0 * (Pm.T * D) @ Pm)

            def solve(bx, by, bz):
                xu = cho(L, bx["u"] + Pm.T @ (
                    (d1 - d2) / (d1 + d2) * bx["v"]
                    + 2.0 * D * (bz[:m] - bz[m:])))
                t = Pm @ xu
                xv = (bx["v"] - d1 * bz[:m] - d2 * bz[m:]
                      + (d1 - d2) * t) / (d1 + d2)
                z1 = di[:m] * (t - xv - bz[:m])
                z2 = di[m:] * (-t - xv - bz[m:])
                return {"u": xu, "v": xv}, by, cat([z1, z2])

            return solve

        return Fkkt

    def G(Op, Pm, cat):
        return Op(mv=lambda x: cat([Pm @ x["u"] - x["v"],
                                    -Pm @ x["u"] - x["v"]]),
                  rmv=lambda z: {"u": Pm.T @ (z[:m] - z[m:]),
                                 "v": -(z[:m] + z[m:])},
                  shape=(2 * m, n + m))

    c = {"u": np.zeros(n), "v": np.ones(m)}
    ref = js.conelp({k: jnp.asarray(v) for k, v in c.items()},
                    G(JOp, Pj, jnp.concatenate), h, dims={"l": 2 * m},
                    kktsolver=kkt(jnp, Pj))
    out = ts.conelp(c, G(TOp, Pt, torch.cat), h, dims={"l": 2 * m},
                    kktsolver=kkt(torch, Pt), device="cpu")
    for key in ("u", "v"):
        _same(out, ref, key=key)
    dense = l1_dense(P, q, ts)
    np.testing.assert_allclose(out["x"]["u"].numpy(),
                               dense["x"][:n].numpy(), atol=1e-3)


def _batch(W):
    """A one-instance tree with a leading batch axis of 1."""
    if isinstance(W, dict):
        return {k: _batch(v) for k, v in W.items()}
    if isinstance(W, list):
        return [_batch(v) for v in W]
    return W.unsqueeze(0)


def test_qcl1_soc():
    """qcl1 (examples/doc/chap8/qcl1.py): min ||u||_1 s.t.
    ||Au - b||_2 <= 1, dense and through a callable kktsolver that reads
    the run-stacked SOC entries W['v'] / W['beta'] of one instance and
    delegates to the library's 'qr' strategy."""
    rng = np.random.default_rng(2)
    m, n = 20, 6
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    b = b / (1.1 * np.linalg.norm(b))
    c = np.concatenate([np.zeros(n), np.ones(n)])
    I = np.eye(n)
    G = np.zeros((2 * n + m + 1, 2 * n))
    G[:n, :n], G[:n, n:] = I, -I
    G[n:2 * n, :n], G[n:2 * n, n:] = -I, -I
    G[2 * n + 1:, :n] = -A
    h = np.zeros(2 * n + m + 1)
    h[2 * n] = 1.0
    h[2 * n + 1:] = -b
    dims = {"l": 2 * n, "q": [m + 1], "s": []}

    sol = ts.conelp(c, G, h, dims, device="cpu")
    _same(sol, js.conelp(c, G, h, dims))
    u = sol["x"][:n].numpy()
    assert np.linalg.norm(A @ u - b) <= 1.0 + 1e-6

    jbase = jkkt.get_kktsolver("qr", jnp.asarray(G),
                               JDims(l=2 * n, q=(m + 1,)),
                               jnp.zeros((0, 2 * n)))
    tbase = tkkt.get_kktsolver("qr", torch.as_tensor(G),
                               TDims(l=2 * n, q=(m + 1,)),
                               torch.zeros((0, 2 * n), dtype=torch.float64))
    seen = {}

    def Fkkt(W):
        seen["v_shape"] = tuple(W["v"][0].shape)
        seen["beta_shape"] = tuple(W["beta"][0].shape)
        solve1 = tbase(_batch(W))

        def solve(bx, by, bz):
            return tuple(u_[0] for u_ in solve1(bx[None], by[None],
                                                bz[None]))

        return solve

    out = ts.conelp(c, G, h, dims, kktsolver=Fkkt, device="cpu")
    _same(out, js.conelp(c, G, h, dims, kktsolver=jbase))
    assert seen == {"v_shape": (1, m + 1), "beta_shape": (1,)}
    np.testing.assert_allclose(out["x"][:n].numpy(), u, atol=1e-5)


def test_advanced_path_is_cached():
    """The port has no compile cache to test: two consecutive solves
    with the same callable kktsolver (and a dense G wrapped by
    `aslinearoperator` in the second) each match their JAX results."""
    rng = np.random.default_rng(3)
    n = 6
    G = np.vstack([np.eye(n), -np.eye(n)])  # box => always bounded
    h = np.ones(2 * n)

    def make_kkt(Gm, lib):
        def kktsolver(W):
            di = W["di"]
            L = lib.linalg.cholesky((Gm * (di * di)[:, None]).T @ Gm)

            def solve(bx, by, bz):
                r = bx + Gm.T @ (di * di * bz)
                if lib is jnp:
                    ux = jsl.solve_triangular(
                        L.T, jsl.solve_triangular(L, r, lower=True),
                        lower=False)
                else:
                    ux = _tri(L.T, _tri(L, r, False), True)
                return ux, by, di * (Gm @ ux - bz)

            return solve

        return kktsolver

    jk = make_kkt(jnp.asarray(G), jnp)
    tk = make_kkt(torch.as_tensor(G), torch)
    for k, cvec in enumerate(rng.standard_normal((2, n)) * 0.1):
        Gt = G if k == 0 else aslinearoperator(torch.as_tensor(G))
        _same(ts.conelp(cvec, Gt, h, kktsolver=tk, device="cpu"),
              js.conelp(cvec, G, h, kktsolver=jk))

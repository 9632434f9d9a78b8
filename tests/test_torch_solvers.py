"""Twins of the cases of tests/test_solvers.py that no other
tests/test_torch_*.py file twins: the KKT strategy pairs (chol2 /
chol2_inv, chol / chol_inv, qr / qr_inv, ldl / ldl2, cholqr), the mixed-
precision factors, the cone edge cases, conelp's trigger-driven refresh
and psqrt_factor's reduced-precision path.  Each feeds the same numpy
data through cvxopt_tpu and cvxopt_tpu_torch on the CPU.

Tolerances: status and iterations equal to the JAX package's (the
float32 factors: status equal, iterations within 1) and x within 1e-6
of its x; the pairs within the JAX test's own tolerance of each other.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cvxopt_tpu import solvers as js
from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu.coneqp import make_coneqp as jmake_coneqp
from cvxopt_tpu_torch import solvers as ts
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.coneqp import make_coneqp

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

CPU = dict(device="cpu")


def _x(sol):
    x = sol["x"]
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _twin(sol, ref, atol=1e-6, iters_slack=0):
    assert sol["status"] == ref["status"]
    assert abs(sol["iterations"] - ref["iterations"]) <= iters_slack
    if ref["status"] == "optimal":
        np.testing.assert_allclose(_x(sol), _x(ref), atol=atol)


def _qp(seed, n):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, n))
    return rng, F @ F.T + np.eye(n), rng.standard_normal(n)


def test_chol2_inv_matches_chol2():
    _, P, q = _qp(9, 25)
    n = 25
    G, h = -np.eye(n), np.zeros(n)
    A, b = np.ones((1, n)), np.array([1.0])
    outs = []
    for ks in ("chol2", "chol2_inv"):
        ref = js.coneqp(P, q, G, h, A=A, b=b, kktsolver=ks)
        sol = ts.coneqp(P, q, G, h, A=A, b=b, kktsolver=ks, **CPU)
        assert sol["status"] == "optimal"
        _twin(sol, ref)
        outs.append(_x(sol))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-9, atol=1e-12)


def test_mixed_precision_factor():
    _, P, q = _qp(11, 30)
    n = 30
    G, h = -np.eye(n), np.zeros(n)
    opts = {"factor_dtype": "float32", "refinement": 1}
    ref = js.coneqp(P, q, G, h, kktsolver="chol2_inv", options=opts)
    sol = ts.coneqp(P, q, G, h, kktsolver="chol2_inv", options=opts, **CPU)
    _twin(sol, ref, iters_slack=1)
    x, z = _x(sol), sol["z"].numpy()
    assert np.abs(P @ x + q - z).max() < 1e-9


def test_soc_dimension_one():
    c = np.array([-1.0, -1.0])
    G = np.concatenate([-np.eye(2), np.eye(2)])
    h = np.array([0.0, 0.0, 1.0, 1.0])
    dims = {"l": 2, "q": [1, 1], "s": []}
    ref = js.conelp(c, G, h, dims=dims)
    sol = ts.conelp(c, G, h, dims=dims, **CPU)
    assert sol["status"] == "optimal"
    _twin(sol, ref)
    np.testing.assert_allclose(_x(sol), [1.0, 1.0], atol=1e-6)


def test_mixed_q_s_cone():
    from cvxopt_tpu.cones import cone_identity
    rng = np.random.default_rng(13)
    n = 4
    dims = {"l": 2, "q": [3, 4], "s": [2, 3]}
    cdim = 2 + 3 + 4 + 4 + 9
    G = rng.standard_normal((cdim, n))
    x0 = rng.standard_normal(n)
    e = np.asarray(cone_identity(JDims.from_dict(dims)))
    h = G @ x0 + 2.0 * e
    c = -G.T @ e
    ref = js.conelp(c, G, h, dims)
    sol = ts.conelp(c, G, h, dims, **CPU)
    assert sol["status"] == "optimal" and sol["gap"] < 1e-5
    _twin(sol, ref)


def _soc_box_qp(seed=21, n=8):
    rng, P, q = _qp(seed, n)
    I = np.eye(n)
    G = np.concatenate([-I, np.zeros((1, n)), I], axis=0)
    h = np.array(n * [0.0] + [2.0] + n * [0.0])
    return P, q, G, h, {"l": n, "q": [n + 1], "s": []}


def test_chol_inv_matches_chol():
    P, q, G, h, dims = _soc_box_qp()
    A, b = np.ones((1, 8)), np.array([1.0])
    outs = []
    for ks in ("chol", "chol_inv"):
        ref = js.coneqp(P, q, G, h, dims, A=A, b=b, kktsolver=ks)
        sol = ts.coneqp(P, q, G, h, dims, A=A, b=b, kktsolver=ks, **CPU)
        assert sol["status"] == "optimal"
        _twin(sol, ref)
        outs.append(_x(sol))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-8, atol=1e-10)


def test_chol_factor_dtype_refinement():
    P, q, G, h, dims = _soc_box_qp(seed=23)
    opts = {"factor_dtype": "float32", "refinement": 1}
    ref = js.coneqp(P, q, G, h, dims, kktsolver="chol_inv", options=opts)
    mix = ts.coneqp(P, q, G, h, dims, kktsolver="chol_inv", options=opts,
                    **CPU)
    full = ts.coneqp(P, q, G, h, dims, kktsolver="chol", **CPU)
    assert mix["status"] == full["status"] == "optimal"
    _twin(mix, ref, iters_slack=1)
    np.testing.assert_allclose(_x(mix), _x(full), atol=1e-6)


DOC_G = np.array([
    [16., 7., 24., -8., 8., -1., 0., -1., 0., 0., 7., -5., 1., -5., 1.,
     -7., 1., -7., -4.],
    [-14., 2., 7., -13., -18., 3., 0., 0., -1., 0., 3., 13., -6., 13.,
     12., -10., -6., -10., -28.],
    [5., 0., -15., 12., -6., 17., 0., 0., 0., -1., 9., 6., -6., 6., -7.,
     -7., -6., -7., -11.]]).T
DOC_H = np.array([-3., 5., 12., -2., -14., -13., 10., 0., 0., 0., 68.,
                  -30., -19., -30., 99., 23., -19., 23., 10.])


def test_qr_inv_matches_qr():
    c = np.array([-6., -4., -5.])
    dims = {"l": 2, "q": [4, 4], "s": [3]}
    outs = []
    for ks in ("qr", "qr_inv"):
        ref = js.conelp(c, DOC_G, DOC_H, dims, kktsolver=ks)
        sol = ts.conelp(c, DOC_G, DOC_H, dims, kktsolver=ks, **CPU)
        assert sol["status"] == "optimal"
        _twin(sol, ref)
        outs.append(_x(sol))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-7, atol=1e-9)


def test_qr_inv_equalities():
    c = np.array([-1., -1., 0.])
    G = np.concatenate([-np.eye(3), np.eye(3), np.zeros((2, 3))])
    G[-1, 2] = -1.0
    h = np.array([0., 0., 0., 1., 1., 1., 2.0, 0.0])
    A, b = np.array([[1., 1., 1.]]), np.array([1.5])
    dims = {"l": 6, "q": [2], "s": []}
    outs = []
    for ks in ("qr", "qr_inv"):
        ref = js.conelp(c, G, h, dims, A=A, b=b, kktsolver=ks)
        sol = ts.conelp(c, G, h, dims, A=A, b=b, kktsolver=ks, **CPU)
        assert sol["status"] == "optimal"
        _twin(sol, ref)
        outs.append(_x(sol))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-7, atol=1e-8)


def test_kkt_ldl2_condensed():
    rng = np.random.default_rng(11)
    n = 12
    F = rng.standard_normal((n, 4))
    P = F @ F.T + np.eye(n)
    q = rng.standard_normal(n)
    G = 0.4 * rng.standard_normal((10, n))
    h = np.concatenate([rng.uniform(0.5, 1.0, 6), [2.0],
                        0.1 * rng.standard_normal(3)])
    A = rng.standard_normal((2, n))
    b = np.zeros(2)
    dims = {"l": 6, "q": [4], "s": []}
    c = rng.standard_normal(n) * 0.1
    xs = {}
    for ks in ("ldl", "ldl2"):
        ref = js.coneqp(P, q, G, h, dims=dims, A=A, b=b, kktsolver=ks)
        sol = ts.coneqp(P, q, G, h, dims=dims, A=A, b=b, kktsolver=ks,
                        **CPU)
        assert sol["status"] == "optimal"
        _twin(sol, ref)
        xs[ks] = (_x(sol), sol["y"].numpy())
        ref2 = js.conelp(c, G, h, dims=dims, A=A, b=b, kktsolver=ks)
        sol2 = ts.conelp(c, G, h, dims=dims, A=A, b=b, kktsolver=ks, **CPU)
        _twin(sol2, ref2, atol=1e-5)
    np.testing.assert_allclose(xs["ldl2"][0], xs["ldl"][0], atol=1e-6)
    np.testing.assert_allclose(xs["ldl2"][1], xs["ldl"][1], atol=1e-5)


def _soc_qp_instance(n=24, nq=8, mq=4, seed=5, p=1):
    """A strictly feasible SOC-constrained QP (robls pattern)."""
    rng = np.random.default_rng(seed)
    m = nq * mq
    F = rng.standard_normal((n, max(n // 4, 2))) / np.sqrt(n)
    P = F @ F.T + 0.1 * np.eye(n)
    q = -rng.uniform(0, 0.1, n)
    G = 0.3 * rng.standard_normal((m, n))
    h = (0.1 * rng.standard_normal(m)).reshape(nq, mq)
    h[:, 0] = 1.0
    return P, q, G, h.reshape(-1), np.ones((p, n)), np.ones(p)


TOL7 = dict(abstol=1e-7, reltol=1e-7, feastol=1e-7)


def _both(dims_q, args, **kw):
    jd = JDims(q=dims_q)
    ref = jmake_coneqp(jd, **TOL7, **kw)(*map(jnp.asarray, args))
    out = make_coneqp(ConeDims(q=dims_q), **TOL7, **kw, **CPU)(
        *map(torch.as_tensor, args))
    return out, ref


@pytest.mark.parametrize("ks", ["cholqr", "cholqr_inv"])
def test_cholqr_matches_chol(ks):
    args = _soc_qp_instance()
    chol, _ = _both((4,) * 8, args, kktsolver="chol")
    out, ref = _both((4,) * 8, args, kktsolver=ks)
    assert int(out["status"]) == int(ref["status"]) == 0
    assert int(out["iterations"]) == int(ref["iterations"])
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-6)
    np.testing.assert_allclose(out["x"].numpy(), chol["x"].numpy(),
                               atol=1e-9)


def test_cholqr_f32_factor_soc_1e7():
    """At 1e-7 an f32 factor of the formed normal equations fails where
    the f32 QR factor converges, in the port as in the JAX package."""
    P, q, G, h, _, _ = _soc_qp_instance(n=32, nq=16, seed=7, p=0)
    args = (P, q, G, h, np.zeros((0, 32)), np.zeros(0))
    kw = dict(factor_dtype="float32", refinement=2, maxiters=60)
    bad, jbad = _both((4,) * 16, args, kktsolver="chol2", **kw)
    good, jgood = _both((4,) * 16, args, kktsolver="cholqr_inv", **kw)
    assert int(good["status"]) == int(jgood["status"]) == 0
    assert float(good["gap"]) <= 1e-7 * 1.01
    assert abs(int(good["iterations"]) - int(jgood["iterations"])) <= 1
    np.testing.assert_allclose(good["x"].numpy(), np.asarray(jgood["x"]),
                               atol=1e-6)
    assert int(bad["status"]) != 0 and int(jbad["status"]) != 0


def test_cholqr_equalities_f32():
    P, q, G, h, _, _ = _soc_qp_instance(n=24, nq=8, seed=11, p=2)
    A = np.vstack([np.ones(24), np.arange(24) / 24.])
    b = np.array([1.0, 0.3])
    args = (P, q, G, h, A, b)
    chol, _ = _both((4,) * 8, args, kktsolver="chol")
    out, ref = _both((4,) * 8, args, kktsolver="cholqr_inv",
                     factor_dtype="float32", refinement=2, maxiters=60)
    assert int(out["status"]) == int(ref["status"]) == 0
    assert abs(int(out["iterations"]) - int(ref["iterations"])) <= 1
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-6)
    np.testing.assert_allclose(out["x"].numpy(), chol["x"].numpy(),
                               atol=1e-6)


def test_solvers_namespace_exports_cp_cpl_gp():
    from cvxopt_tpu_torch.cvxprog import cp, cpl, gp
    assert ts.cp is cp and ts.cpl is cpl and ts.gp is gp
    for name in ("cp", "cpl", "gp"):
        assert name in ts.__all__


def test_conelp_refresh_trigger_mode():
    """A healthy solve never restarts and costs the plain core's
    iterations; the open-loop segment mode runs; an infeasibility
    certificate is not consumed by a refresh - in both packages."""
    from cvxopt_tpu import conelp as jlp
    from cvxopt_tpu_torch import conelp as tlp
    m = 12
    rng = np.random.default_rng(3)
    w = rng.standard_normal((m, m))
    w = (w + w.T) / np.sqrt(m)
    G = np.zeros((m * m, m))
    for j in range(m):
        G[j * m + j, j] = -1.0
    data = (np.ones(m), G, w.reshape(-1, order="F"), np.zeros((0, m)),
            np.zeros(0))
    jd, td = JDims(s=(m,)), ConeDims(s=(m,))
    ref = jlp.make_conelp(jd, kktsolver="chol2", maxiters=50)(
        *map(jnp.asarray, data))
    out = tlp.make_conelp_refresh(td, kktsolver="chol2", maxiters=50,
                                  stall_exit=4, rounds=3, **CPU)(
        *map(torch.as_tensor, data))
    assert int(out["status"]) == 0 and out["refresh_rounds"] == 0
    assert int(out["iterations"]) == int(ref["iterations"])
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-6)
    out2 = tlp.make_conelp_refresh(td, kktsolver="chol2", maxiters=50,
                                   segment=12, rounds=3, **CPU)(
        *map(torch.as_tensor, data))
    assert int(out2["status"]) == 0
    infeas = (np.array([1.0]), np.array([[1.0], [-1.0]]),
              np.array([-1.0, -1.0]), np.zeros((0, 1)), np.zeros(0))
    o3 = tlp.make_conelp_refresh(ConeDims(l=2), maxiters=50, stall_exit=4,
                                 **CPU)(*map(torch.as_tensor, infeas))
    j3 = jlp.make_conelp_refresh(JDims(l=2), maxiters=50, stall_exit=4)(
        *map(jnp.asarray, infeas))
    assert int(o3["status"]) == int(j3["status"]) == 1
    assert o3["refresh_rounds"] == 0


def test_psqrt_factor_reduced_precision():
    """psqrt_factor(dtype=float32): Rt'Rt ~ P at f32 grade for PD input,
    as the JAX package's; the default stays exact."""
    from cvxopt_tpu.kkt import psqrt_factor as jpsqrt
    from cvxopt_tpu_torch.kkt import psqrt_factor
    rng = np.random.default_rng(0)
    F = rng.standard_normal((3, 8, 4))
    P = F @ np.swapaxes(F, -1, -2) + 0.1 * np.eye(8)

    def rel(Rt):
        Rt = np.asarray(Rt, dtype=np.float64)
        return np.linalg.norm(np.swapaxes(Rt, -1, -2) @ Rt - P) \
            / np.linalg.norm(P)

    Rt = psqrt_factor(torch.as_tensor(P), dtype=torch.float32).Rt
    assert Rt.dtype == torch.float32
    assert rel(Rt.numpy()) < 1e-5
    assert rel(jpsqrt(jnp.asarray(P), dtype="float32").Rt) < 1e-5
    assert rel(psqrt_factor(torch.as_tensor(P)).Rt.numpy()) < 1e-12

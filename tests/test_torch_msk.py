"""The port's MOSEK bridge (cvxopt_tpu_torch/msk.py) and the port's
solver='mosek' front ends against cvxopt_tpu — twins of
tests/test_msk.py, on its stub `mosek` module.

The stub captures the task data a bridge submits, rebuilds the problem
under MOSEK's conventions and solves it: for the JAX bridge with the JAX
package's solvers, for the port's bridge with the port's solvers on the
CPU (its `from cvxopt_tpu import solvers, glpk` is pointed at the port
for those runs).  A translation error therefore shows up as a wrong
answer.  Results agree within 1e-6; the ilp cases run glpk.ilp."""

import functools
import sys
import types

import numpy as np
import pytest
import torch

import cvxopt_tpu
from cvxopt_tpu import msk as jmsk, solvers as jsolvers
from cvxopt_tpu_torch import msk as tmsk, solvers as tsolvers, glpk as tglpk
from test_msk import _make_stub

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

C = np.array([-4.0, -5.0])
G = np.array([[2.0, 1.0], [1.0, 2.0], [-1.0, 0.0], [0.0, -1.0]])
H = np.array([3.0, 3.0, 0.0, 0.0])


@pytest.fixture()
def stub_mosek(monkeypatch):
    stub = _make_stub()
    monkeypatch.setitem(sys.modules, "mosek", stub)
    return stub


@pytest.fixture()
def both(stub_mosek, monkeypatch):
    """run(call) -> (call(port msk, port solvers), call(JAX msk, JAX
    solvers)): the port's bridge solved by the port's solvers, the JAX
    bridge by JAX's."""
    cpu = dict(device="cpu")
    port = types.SimpleNamespace(
        conelp=functools.partial(tsolvers.conelp, **cpu),
        qp=functools.partial(tsolvers.qp, **cpu))
    port_glpk = types.SimpleNamespace(
        ilp=functools.partial(tglpk.ilp, **cpu))

    def run(call):
        with monkeypatch.context() as mp:
            mp.setattr(cvxopt_tpu, "solvers", port)
            mp.setattr(cvxopt_tpu, "glpk", port_glpk, raising=False)
            out = call(tmsk, tsolvers)
        return out, call(jmsk, jsolvers)

    return run


def _close(out, ref, tol=1e-6):
    assert out[0] is ref[0] if not isinstance(ref[0], str) \
        else out[0] == ref[0]
    for u, v in zip(out[1:], ref[1:]):
        if v is None:
            assert u is None
        elif isinstance(v, list):
            for a, b in zip(u, v):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           atol=tol)
        else:
            np.testing.assert_allclose(np.asarray(u, dtype=float),
                                       np.asarray(v, dtype=float),
                                       atol=tol)


def test_msk_lp_roundtrip(both, stub_mosek):
    out, ref = both(lambda m, s: m.lp(C, G, H))
    _close(out, ref)
    solsta, x, z, y = out
    assert solsta is stub_mosek.solsta.optimal
    np.testing.assert_allclose(x, [1.0, 1.0], atol=1e-6)
    assert np.all(z >= -1e-9)
    np.testing.assert_allclose(C + G.T @ z, 0.0, atol=1e-6)


def test_msk_lp_with_equalities(both, stub_mosek):
    A, b = np.array([[1.0, 1.0]]), np.array([1.0])
    out, ref = both(lambda m, s: m.lp(C, G, H, A, b))
    _close(out, ref)
    solsta, x, z, y = out
    assert solsta is stub_mosek.solsta.optimal
    np.testing.assert_allclose(A @ x, b, atol=1e-6)
    np.testing.assert_allclose(C + G.T @ z + A.T @ y, 0.0, atol=1e-5)


def test_msk_conelp_socp(both, stub_mosek):
    c = np.array([-1.0, 0.0])
    Gc = np.vstack([[1.0, 0.0], [-1.0, 0.0], [0.0, -1.0]])
    h = np.array([0.5, 0.0, 0.0])
    dims = {"l": 1, "q": [2], "s": []}
    out, ref = both(lambda m, s: m.conelp(c, Gc, h, dims))
    _close(out, ref)
    assert out[0] is stub_mosek.solsta.optimal
    assert abs(out[1][0] - 0.5) < 1e-5 and abs(out[1][1]) <= 0.5 + 1e-6
    out, ref = both(lambda m, s: m.socp(c, Gc[:1], h[:1], [Gc[1:]],
                                        [h[1:]]))
    _close(out, ref)
    with pytest.raises(NotImplementedError):
        tmsk.conelp(c, Gc, h, {"l": 1, "q": [], "s": [1, 1]})


def test_msk_qp(both, stub_mosek):
    P = np.array([[2.0, 0.0], [0.0, 2.0]])
    q = np.array([-2.0, -2.0])
    h = np.array([0.5, 2.0])
    out, ref = both(lambda m, s: m.qp(P, q, np.eye(2), h))
    _close(out, ref)
    assert out[0] is stub_mosek.solsta.optimal
    np.testing.assert_allclose(out[1], [0.5, 1.0], atol=1e-5)


def test_msk_ilp(both, stub_mosek):
    c = np.array([-1.0, -1.0])
    h = np.array([3.2, 3.2, 0.0, 0.0])
    out, ref = both(lambda m, s: m.ilp(c, G, h, I={0, 1}))
    _close(out, ref)
    assert out[0] is stub_mosek.solsta.integer_optimal
    np.testing.assert_allclose(out[1], np.round(out[1]), atol=1e-6)


@pytest.mark.parametrize("front", ["lp", "qp", "socp"])
def test_solver_mosek_dispatch(both, front):
    """solvers.lp/qp/socp(solver='mosek'): the result dicts recomputed
    from the bridge's vertex agree field by field."""
    if front == "lp":
        call = lambda m, s: s.lp(C, G, H, solver="mosek")  # noqa: E731
    elif front == "qp":
        call = lambda m, s: s.qp(  # noqa: E731
            np.eye(2), np.array([-1.0, -1.0]), G, H, solver="mosek")
    else:
        call = lambda m, s: s.socp(  # noqa: E731
            np.array([-1.0, 0.0]), np.array([[1.0, 0.0]]),
            np.array([0.5]), [-np.eye(2)], [np.zeros(2)], solver="mosek")
    out, ref = both(call)
    assert out["status"] == ref["status"] == "optimal"
    for k, v in ref.items():
        if isinstance(v, float):
            assert abs(out[k] - v) <= 1e-6, k
        elif isinstance(v, np.ndarray):
            np.testing.assert_allclose(out[k], v, atol=1e-6, err_msg=k)
    if front == "lp":
        np.testing.assert_allclose(out["x"], [1.0, 1.0], atol=1e-6)
        assert out["primal infeasibility"] < 1e-6
        assert out["dual infeasibility"] < 1e-5
    if front == "socp":
        with pytest.raises(ValueError, match="equality"):
            tsolvers.socp(np.ones(2), Gq=[-np.eye(2)], hq=[np.zeros(2)],
                          A=np.ones((1, 2)), b=np.ones(1), solver="mosek")


def test_solvers_lp_mosek_infeasible(both):
    out, ref = both(lambda m, s: s.lp(
        np.array([1.0]), np.array([[1.0], [-1.0]]),
        np.array([-1.0, -1.0]), solver="mosek"))
    assert out["status"] == ref["status"] == "primal infeasible"
    assert out["x"] is None


def test_msk_missing_package_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "mosek", None)
    with pytest.raises((ImportError, TypeError)):
        tmsk.lp(np.array([1.0]), np.array([[1.0]]), np.array([1.0]))

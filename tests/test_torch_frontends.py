"""The port's front ends (cvxopt_tpu_torch/frontends.py, solvers.py) on
the cases of tests/test_solvers.py that use the package's own solver,
against cvxopt_tpu.solvers on the same inputs (float64, CPU): equal
status strings and iteration counts, x and the split s/z blocks within
1e-8, and the documented answers."""

import sys

import numpy as np
import pytest
import torch

from cvxopt_tpu import solvers as js
from cvxopt_tpu_torch import solvers as ts

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

SOCP = dict(
    c=np.array([-2., 1., 5.]),
    Gq=[np.array([[12., 13., 12.], [6., -3., -12.], [-5., -5., 6.]]).T,
        np.array([[3., 3., -1., 1.], [-6., -6., -9., 19.],
                  [10., -2., -2., -3.]]).T],
    hq=[np.array([-12., -3., -2.]), np.array([27., 0., 3., -42.])])
SDP = dict(
    c=np.array([1., -1., 1.]),
    Gs=[np.array([[-7., -11., -11., 3.], [7., -18., -18., 8.],
                  [-2., -8., -8., 1.]]).T,
        np.array([[-21., -11., 0., -11., 10., 8., 0., 8., 5.],
                  [0., 10., 16., 10., -10., -10., 16., -10., 3.],
                  [-5., 2., -17., 2., -6., 8., -17., -7., 6.]]).T],
    hs=[np.array([[33., -9.], [-9., 26.]]),
        np.array([[14., 9., 40.], [9., 91., 10.], [40., 10., 15.]])])


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _same_blocks(out, ref, lkey, bkey):
    for k in ("s", "z"):
        np.testing.assert_allclose(_np(out[k + lkey]),
                                   np.asarray(ref[k + lkey]), atol=1e-8)
        assert len(out[k + bkey]) == len(ref[k + bkey])
        for u, v in zip(out[k + bkey], ref[k + bkey]):
            assert tuple(u.shape) == np.asarray(v).shape
            np.testing.assert_allclose(_np(u), np.asarray(v), atol=1e-8)


def test_lp_matches_jax():
    c = np.array([-4., -5.])
    G = np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]])
    h = np.array([3., 3., 0., 0.])
    ref, out = js.lp(c, G, h), ts.lp(c, G, h, device="cpu")
    assert out["status"] == ref["status"] == "optimal"
    assert out["iterations"] == ref["iterations"]
    np.testing.assert_allclose(_np(out["x"]), np.asarray(ref["x"]),
                               atol=1e-8)
    np.testing.assert_allclose(_np(out["x"]), [1.0, 1.0], atol=1e-5)
    # with an equality constraint
    A, b = np.array([[1., 1.]]), np.array([1.])
    out = ts.lp(np.array([-1., -1.]), -np.eye(2), np.zeros(2), A, b,
                device="cpu")
    assert out["status"] == "optimal"
    assert abs(out["primal objective"] + 1.0) < 1e-7


def test_qp_matches_jax():
    """The Markowitz QP of tests/test_solvers.py, and an initvals warm
    start through the front end."""
    rng = np.random.default_rng(3)
    n = 20
    F = rng.standard_normal((n, 2 * n)) / np.sqrt(2 * n)
    S = F @ F.T + 0.01 * np.eye(n)
    pbar = rng.uniform(0.0, 0.1, n)
    args = (S, -pbar, -np.eye(n), np.zeros(n), np.ones((1, n)),
            np.array([1.0]))
    ref, out = js.qp(*args), ts.qp(*args, device="cpu")
    assert out["status"] == ref["status"] == "optimal"
    assert out["iterations"] == ref["iterations"]
    x = _np(out["x"])
    np.testing.assert_allclose(x, np.asarray(ref["x"]), atol=1e-8)
    assert abs(x.sum() - 1.0) < 1e-6 and x.min() > -1e-7
    # unconstrained apart from the equality (cdim == 0)
    out = ts.qp(np.array([[2., 0.], [0., 2.]]), np.array([-2., -4.]),
                A=np.array([[1., 1.]]), b=np.array([1.]), device="cpu")
    np.testing.assert_allclose(_np(out["x"]), [0.0, 1.0], atol=1e-6)


def test_socp_matches_jax():
    ref, out = js.socp(**SOCP), ts.socp(device="cpu", **SOCP)
    assert out["status"] == ref["status"] == "optimal"
    assert out["iterations"] == ref["iterations"]
    np.testing.assert_allclose(_np(out["x"]), np.asarray(ref["x"]),
                               atol=1e-8)
    np.testing.assert_allclose(_np(out["x"]),
                               [-5.0147, -5.7669, -8.5218], atol=2e-3)
    assert "s" not in out and "z" not in out
    assert out["zq"][0].shape == (3,) and out["zq"][1].shape == (4,)
    _same_blocks(out, ref, "l", "q")


def test_socp_with_linear_block_and_equality():
    """An 'l' block on top of the 'q' blocks, one SOC of dimension 1, and
    an equality row."""
    Gl, hl = -np.eye(3), np.array([10.0, 10.0, 10.0])
    Gq = SOCP["Gq"] + [np.array([[0., 0., -1.]])]
    hq = SOCP["hq"] + [np.array([20.0])]
    A, b = np.array([[1., 0., -1.]]), np.array([3.5])
    kw = dict(c=SOCP["c"], Gl=Gl, hl=hl, Gq=Gq, hq=hq, A=A, b=b)
    ref, out = js.socp(**kw), ts.socp(device="cpu", **kw)
    assert out["status"] == ref["status"] == "optimal"
    assert out["iterations"] == ref["iterations"]
    np.testing.assert_allclose(_np(out["x"]), np.asarray(ref["x"]),
                               atol=1e-8)
    np.testing.assert_allclose(_np(out["y"]), np.asarray(ref["y"]),
                               atol=1e-8)
    _same_blocks(out, ref, "l", "q")


def test_sdp_matches_jax():
    ref, out = js.sdp(**SDP), ts.sdp(device="cpu", **SDP)
    assert out["status"] == ref["status"] == "optimal"
    assert out["iterations"] == ref["iterations"]
    np.testing.assert_allclose(_np(out["x"]), np.asarray(ref["x"]),
                               atol=1e-8)
    np.testing.assert_allclose(_np(out["x"]),
                               [-0.3677, 1.8983, -0.8876], atol=2e-3)
    assert out["zs"][0].shape == (2, 2) and out["zs"][1].shape == (3, 3)
    _same_blocks(out, ref, "l", "s")


def test_infeasible_socp_splits_none():
    """||x|| <= -1: primal infeasible; the missing s splits into None."""
    out = ts.socp(np.array([1.0]), Gq=[np.array([[0.0], [-1.0]])],
                  hq=[np.array([-1.0, 0.0])], device="cpu")
    assert out["status"] == "primal infeasible"
    assert out["sl"] is None and out["sq"] is None
    assert out["zq"][0].shape == (2,)


def test_options_are_read_at_call_time():
    c = np.array([-4., -5.])
    G = np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]])
    h = np.array([3., 3., 0., 0.])
    ts.options["maxiters"] = 1
    try:
        sol = ts.lp(c, G, h, device="cpu")
        assert sol["status"] == "unknown" and sol["iterations"] == 1
        # a per-call option wins over the module's
        sol = ts.lp(c, G, h, options={"maxiters": 50}, device="cpu")
        assert sol["status"] == "optimal"
    finally:
        ts.options.clear()
    assert ts.lp(c, G, h, device="cpu")["status"] == "optimal"


def test_external_solvers(monkeypatch):
    """solver='glpk' runs the port's simplex; solver='mosek' reaches the
    MOSEK bridge, which raises ImportError without the `mosek` package
    (tests/test_torch_msk.py drives it on a stub); sdp has no 'mosek'
    branch, as in the JAX package; 'dsdp' and unknown names raise."""
    c, G, h = np.array([1.0]), np.array([[-1.0]]), np.array([0.0])
    sol = ts.lp(c, G, h, solver="glpk", device="cpu")
    assert sol["status"] == "optimal" and sol["x"].tolist() == [0.0]
    monkeypatch.setitem(sys.modules, "mosek", None)
    with pytest.raises(ImportError):
        ts.lp(c, G, h, solver="mosek", device="cpu")
    with pytest.raises(ImportError):
        ts.qp(np.eye(1), c, solver="mosek", device="cpu")
    with pytest.raises(ValueError):
        ts.sdp(c, solver="mosek", device="cpu")
    with pytest.raises(ValueError):
        ts.sdp(c, solver="dsdp", device="cpu")
    with pytest.raises(ValueError):
        ts.socp(c, solver="nonsense", device="cpu")


def test_solvers_namespace():
    for name in ("conelp", "coneqp", "lp", "qp", "socp", "sdp", "options",
                 "make_conelp", "make_coneqp", "make_coneqp_cascade",
                 "make_conelp_cascade", "make_conelp_ws",
                 "make_conelp_refresh"):
        assert name in ts.__all__ and hasattr(ts, name)
    assert ts.options == {}

"""The port's simplex (cvxopt_tpu_torch/simplex.py, the glpk.lp surface)
against cvxopt_tpu/simplex.py on the CPU in float64, on the same numpy
problems — twins of the cases of tests/test_simplex.py:

  - equal statuses, x within 1e-9 where the vertex is unique, and the
    JAX tests' own checks (KKT, complementary slackness, the IPM optimum);
  - the degenerate and redundant-row LPs through the private `_setup` and
    `_phase` of both packages: each phase's pivot count and final basis
    equal;
  - boeing2.mps (highly degenerate: its optimal vertex is not unique, so
    the objectives are compared, within 1e-9 relative);
  - the batched mode against `jax.vmap`;
  - the options plumbing, it_lim, and tm_lim with the port's clock
    replaced by a fake one."""

import os
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cvxopt_tpu import glpk as jglpk, simplex as js, solvers as jsolvers
from cvxopt_tpu.mpsio import mps_load
from cvxopt_tpu_torch import glpk as tglpk, simplex as ts
from cvxopt_tpu_torch import solvers as tsolvers

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

CPU = dict(device="cpu")
DOC = (np.array([-4., -5.]),
       np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]]),
       np.array([3., 3., 0., 0.]))
DEGENERATE = (np.array([-1.0, -1.0]),
              np.array([[1., 0.], [0., 1.], [1., 1.], [-1., 0.],
                        [0., -1.]]),
              np.array([1., 1., 2., 0., 0.]), np.zeros((0, 2)),
              np.zeros(0))
REDUNDANT = (np.array([1.0, 2.0]), -np.eye(2), np.zeros(2),
             np.array([[1.0, 1.0], [1.0, 1.0]]), np.array([1.0, 1.0]))


def _same(out, ref, tol=1e-9):
    assert out[0] == ref[0]
    for u, v in zip(out[1:], ref[1:]):
        if v is None:
            assert u is None
        else:
            np.testing.assert_allclose(u, np.asarray(v), atol=tol)


def test_doc_lp_vertex():
    c, G, h = DOC
    status, x, z = tglpk.lp(c, G, h, **CPU)
    _same((status, x, z), jglpk.lp(c, G, h))
    assert status == "optimal"
    np.testing.assert_allclose(x, [1.0, 1.0], atol=1e-9)
    np.testing.assert_allclose(c + G.T @ z, 0.0, atol=1e-9)
    assert np.all(z >= -1e-12)
    np.testing.assert_allclose((h - G @ x) * z, 0.0, atol=1e-9)


@pytest.mark.parametrize("boxed", [False, True])
def test_equalities_and_duals(boxed):
    """The JAX test's LP (unbounded at this seed: both packages say
    'dual infeasible'), and the same LP with upper bounds x <= x0 + 1,
    whose vertex and duals are compared."""
    rng = np.random.default_rng(3)
    n, m, p = 8, 14, 2
    A = rng.standard_normal((p, n))
    x0 = rng.standard_normal(n)
    b = A @ x0
    G = np.concatenate([rng.standard_normal((m - n, n)), -np.eye(n)])
    h = np.concatenate([G[:m - n] @ x0 + rng.uniform(0.5, 1.0, m - n),
                        -x0 + rng.uniform(0.5, 1.0, n)])
    c = rng.standard_normal(n)
    if boxed:
        G = np.concatenate([G, np.eye(n)])
        h = np.concatenate([h, x0 + 1.0])
    out = tglpk.lp(c, G, h, A, b, **CPU)
    _same(out, jglpk.lp(c, G, h, A, b))
    status, x, z, y = out
    if not boxed:
        assert status == "dual infeasible"
        return
    assert status == "optimal"
    np.testing.assert_allclose(c + G.T @ z + A.T @ y, 0.0, atol=1e-8)
    np.testing.assert_allclose(A @ x, b, atol=1e-8)
    assert np.all(G @ x - h <= 1e-8)
    ipm = tsolvers.lp(c, G, h, A=A, b=b, **CPU)
    assert ipm["status"] == "optimal"
    assert abs(float(c @ x) - ipm["primal objective"]) < 1e-5


@pytest.mark.parametrize("case", ["primal infeasible", "dual infeasible"])
def test_infeasible_statuses(case):
    if case == "primal infeasible":      # x <= -1 and x >= 1
        c, G, h = np.array([1.0]), np.array([[1.0], [-1.0]]), \
            np.array([-1.0, -1.0])
    else:                                # min -x, x >= 0
        c, G, h = np.array([-1.0]), np.array([[-1.0]]), np.array([0.0])
    out = tglpk.lp(c, G, h, **CPU)
    assert out == jglpk.lp(c, G, h) == (case, None, None)


@pytest.mark.parametrize("case", ["degenerate", "redundant"])
def test_phases_match_jax(case):
    """Each phase's pivot count, exit code and final basis equal the JAX
    package's, and so does the vertex (the degenerate LP's optimum is a
    vertex where three constraints are active; the redundant equality
    rows leave an artificial basic)."""
    c, G, h, A, b = DEGENERATE if case == "degenerate" else REDUNDANT
    Sj = js._setup(*map(jnp.asarray, (c, G, h, A, b)))
    St = ts._setup(*(torch.as_tensor(u).unsqueeze(0)
                     for u in (c, G, h, A, b)))
    bj, bt = Sj["basis0"], St["basis0"]
    for cost, cap_art in (("c1", False), ("c2", True)):
        bj, cj, itj, _ = js._phase(
            Sj["W"], Sj["r"], Sj[cost], ~Sj["is_art"], bj, 100,
            cap_art=Sj["is_art"] if cap_art else None)
        bt, ct, itt, _ = ts._phase(
            St["W"], St["r"], St[cost], ~St["is_art"], bt, 100,
            cap_art=St["is_art"] if cap_art else None)
        assert int(itt[0]) == int(itj), cost
        assert int(ct[0]) == int(cj) == 0, cost
        np.testing.assert_array_equal(bt[0].numpy(), np.asarray(bj))
    out = tglpk.lp(c, G, h, A, b, **CPU)
    _same(out, jglpk.lp(c, G, h, A, b))
    expect = [1.0, 1.0] if case == "degenerate" else [1.0, 0.0]
    np.testing.assert_allclose(out[1], expect, atol=1e-9)


def test_solvers_lp_glpk_dispatch():
    c, G, h = DOC
    sol = tsolvers.lp(c, G, h, solver="glpk", **CPU)
    ref = jsolvers.lp(c, G, h, solver="glpk")
    assert sol["status"] == ref["status"] == "optimal"
    for k in ("x", "s", "y", "z"):
        np.testing.assert_allclose(sol[k], np.asarray(ref[k]), atol=1e-9)
    for k in ("primal objective", "dual objective", "gap",
              "primal infeasibility", "dual infeasibility",
              "primal slack", "dual slack"):
        assert abs(sol[k] - ref[k]) <= 1e-9, k
    assert sol["gap"] < 1e-9
    assert sol["primal infeasibility"] < 1e-9
    assert sol["dual infeasibility"] < 1e-9
    assert sol["primal slack"] >= -1e-12
    sol = tsolvers.lp(np.array([1.0]), np.array([[1.0], [-1.0]]),
                      np.array([-1.0, -1.0]), solver="glpk", **CPU)
    assert sol["status"] == "primal infeasible"
    assert sol["x"] is None and sol["gap"] is None


def test_batched_simplex_matches_vmap():
    rng = np.random.default_rng(7)
    nb, n, m = 16, 6, 12
    c = rng.standard_normal((nb, n))
    x0 = rng.standard_normal((nb, n))
    G = np.concatenate(
        [rng.standard_normal((nb, m - n, n)),
         np.broadcast_to(-np.eye(n), (nb, n, n))], axis=1)
    h = np.einsum("bij,bj->bi", G, x0) + rng.uniform(0.5, 1.5, (nb, m))
    A = np.zeros((nb, 0, n))
    b = np.zeros((nb, 0))
    ref = js.make_simplex(n, m, 0, 2000, batched=True)(
        *map(jnp.asarray, (c, G, h, A, b)))
    code, x, z, y = ts.make_simplex(n, m, 0, 2000, batched=True,
                                    **CPU)(c, G, h, A, b)
    code = code.numpy()
    np.testing.assert_array_equal(code, np.asarray(ref[0]))
    ok = code == 0
    assert ok.sum() >= nb // 2
    np.testing.assert_allclose(x.numpy()[ok], np.asarray(ref[1])[ok],
                               atol=1e-9)
    np.testing.assert_allclose(z.numpy()[ok], np.asarray(ref[2])[ok],
                               atol=1e-9)
    for k in np.flatnonzero(ok):
        assert np.all(G[k] @ x[k].numpy() - h[k] <= 1e-7)
        np.testing.assert_allclose(c[k] + G[k].T @ z[k].numpy(), 0.0,
                                   atol=1e-7)
    k = int(np.flatnonzero(ok)[0])
    ipm = tsolvers.lp(c[k], G[k], h[k], **CPU)
    assert abs(float(c[k] @ x[k].numpy()) - ipm["primal objective"]) < 1e-5


def test_unbatched_make_simplex():
    c, G, h = DOC
    code, x, z, y = ts.make_simplex(2, 4, 0, 100, **CPU)(
        c, G, h, np.zeros((0, 2)), np.zeros(0))
    assert int(code) == 0 and x.shape == (2,) and y.shape == (0,)
    np.testing.assert_allclose(x.numpy(), [1.0, 1.0], atol=1e-9)


def test_boeing2_via_simplex():
    """boeing2.mps (166 rows, 143 columns): the same NETLIB objective as
    the JAX package's simplex and the IPM path."""
    d = mps_load(os.path.join(os.path.dirname(__file__), "data",
                              "boeing2.mps"))
    c, G, h, A, b = d.to_lp()
    opts = {"glpk": {"it_lim": 20000}}
    sol = tsolvers.lp(c, G, h, A=A, b=b, solver="glpk", options=opts,
                      **CPU)
    ref = jsolvers.lp(c, G, h, A=A, b=b, solver="glpk", options=opts)
    assert sol["status"] == ref["status"] == "optimal"
    assert abs(sol["primal objective"] - (-315.0187280)) < 1e-3
    assert abs(sol["primal objective"] - ref["primal objective"]) <= \
        1e-9 * abs(ref["primal objective"])
    assert sol["primal infeasibility"] < 1e-7
    assert sol["dual infeasibility"] < 1e-7


@pytest.mark.parametrize("it_lim", [1, 2])
def test_it_lim_total_across_phases(it_lim):
    """it_lim caps the TOTAL pivots of both phases (GLPK semantics)."""
    rng = np.random.default_rng(3)
    n = 20
    Gm = np.vstack([np.eye(n), -np.eye(n)])
    h = np.concatenate([np.ones(n), np.zeros(n)])
    A = np.ones((1, n))
    b = np.array([n / 2.0])
    c = rng.standard_normal(n)
    full = tglpk.lp(c, Gm, h, A, b, **CPU)
    _same(full, jglpk.lp(c, Gm, h, A, b))
    assert full[0] == "optimal"
    opts = {"it_lim": it_lim}
    st = tglpk.lp(c, Gm, h, A, b, options=opts, **CPU)[0]
    assert st == jglpk.lp(c, Gm, h, A, b, options=opts)[0] == "unknown"
    c, G, h = DOC
    assert tglpk.lp(c, G, h, options={"it_lim": 1}, **CPU)[0] == "unknown"


def test_options_plumbing_reference_semantics():
    """Module glpk.options fallback, per-call override, msg_lev levels,
    solvers.options['glpk'] and options={'glpk': ...} dispatch."""
    c, G, h = DOC
    A = np.array([[1.0, 1.0]])
    b = np.array([1.0])
    saved = tglpk.options
    try:
        tglpk.options = {"msg_lev": "GLP_MSG_OFF"}
        assert tglpk.lp(c, G, h, **CPU)[0] == "optimal"
        assert tglpk.lp(c, G, h, A, b, **CPU)[0] == "optimal"
        assert tglpk.lp(c, G, h, options={"msg_lev": "GLP_MSG_ON"},
                        **CPU)[0] == "optimal"
        assert tglpk.lp(c, G, h, A, b, options={"msg_lev": "GLP_MSG_ERR"},
                        **CPU)[0] == "optimal"
        sol = tsolvers.lp(c, G, h, solver="glpk",
                          options={"glpk": {"msg_lev": "GLP_MSG_ON"}},
                          **CPU)
        assert sol["status"] == "optimal"
        # the module it_lim applies when no options kwarg is passed
        tglpk.options = {"it_lim": 1}
        assert tglpk.lp(c, G, h, **CPU)[0] == "unknown"
        tglpk.options = {}
        tsolvers.options["glpk"] = {"it_lim": 1}
        try:
            sol = tsolvers.lp(c, G, h, solver="glpk", **CPU)
            assert sol["status"] == "unknown"
        finally:
            tsolvers.options.pop("glpk", None)
    finally:
        tglpk.options = saved


def test_bad_option_values_warn_and_default():
    c, G, h = DOC
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        status, *_ = tglpk.lp(c, G, h, options={
            "msg_lev": "BOGUS", "it_lim": "many", "tm_lim": 1.5}, **CPU)
    assert status == "optimal"
    msgs = " ".join(str(w.message) for w in rec)
    assert "msg_lev" in msgs and "it_lim" in msgs and "tm_lim" in msgs


def test_tm_lim_enforced(monkeypatch):
    """tm_lim (wall-clock ms) ends the solve with 'unknown' when it is
    exceeded and leaves an ample budget's solve as it was."""
    c, G, h = DOC
    status, x, z = tglpk.lp(c, G, h, options={"tm_lim": 60_000}, **CPU)
    _same((status, x, z), jglpk.lp(c, G, h))
    # a fake clock advancing 10 ms per reading: the 5 ms budget expires
    # at the first check between chunks of pivots
    t = {"v": 0.0}

    def fake():
        t["v"] += 0.010
        return t["v"]

    monkeypatch.setattr(ts, "_clock", fake)
    assert tglpk.lp(c, G, h, options={"tm_lim": 5}, **CPU) == \
        ("unknown", None, None)

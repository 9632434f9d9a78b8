"""The port's block-arrow kktsolver (cvxopt_tpu_torch/parallel/schur.py)
against cvxopt_tpu/parallel/schur.py: twins of tests/test_schur.py on
the same seeded data, in float64.  The kktsolver's outputs within 1e-9,
solved x within 1e-7, status and iterations equal.  The sharded twins
run the port on 2 and 4 spawned gloo ranks and JAX on as many virtual
devices."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cvxopt_tpu import solvers as jsolvers
from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu.parallel import make_mesh as jmake_mesh
from cvxopt_tpu.parallel import schur as js
from cvxopt_tpu.scaling import identity_scaling as jidentity
from cvxopt_tpu_torch.coneqp import coneqp
from cvxopt_tpu_torch.parallel import schur as ts

from test_torch_mesh import run_world, rank_schur, assert_replicated, _arrow_w

torch.set_num_threads(1)

KKT_TOL = 1e-9
X_TOL = 1e-7


def _jax_w(d):
    W = jidentity(JDims(l=d.shape[0]))
    W["d"], W["di"] = jnp.asarray(d), jnp.asarray(1.0 / d)
    return W


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def test_random_arrow_qp_draws_the_jax_data():
    jq = js.random_arrow_qp(4, 6, 3, 6, seed=3)
    tq = ts.random_arrow_qp(4, 6, 3, 6, seed=3, device="cpu")
    for f in ("Pk", "Pc", "P0", "qk", "q0", "Gk", "Ek", "hk"):
        np.testing.assert_array_equal(getattr(tq, f).numpy(),
                                      np.asarray(getattr(jq, f)), f)
    for f in ("flat_P", "flat_q", "flat_G", "flat_h"):
        np.testing.assert_array_equal(getattr(tq, f)().numpy(),
                                      np.asarray(getattr(jq, f)()), f)


def test_arrow_kkt_solve_matches_dense():
    """tests/test_schur.py:20-49: the factor/solve equals JAX's and the
    dense 3x3 solve."""
    K, nk, n0, mk = 6, 5, 4, 5
    m, n = K * mk, K * nk + n0
    jq = js.random_arrow_qp(K, nk, n0, mk)
    tq = ts.random_arrow_qp(K, nk, n0, mk, device="cpu")
    d, W, rng = _arrow_w(m, 1)
    bx, bz = rng.standard_normal(n), rng.standard_normal(m)
    ux, _, Wuz = ts.make_arrow_kktsolver(tq)(W)(
        torch.as_tensor(bx), torch.zeros(0, dtype=torch.float64),
        torch.as_tensor(bz))
    jux, _, jWuz = js.make_arrow_kktsolver(jq)(_jax_w(d))(
        jnp.asarray(bx), jnp.zeros(0), jnp.asarray(bz))
    _close(ux, jux, KKT_TOL)
    _close(Wuz, jWuz, KKT_TOL)
    P, G = tq.flat_P().numpy(), tq.flat_G().numpy()
    S = P + (G.T / d ** 2) @ G
    ux_ref = np.linalg.solve(S, bx + G.T @ (bz / d ** 2))
    _close(ux, ux_ref, KKT_TOL)
    _close(Wuz, (G @ ux_ref - bz) / d, KKT_TOL)


def test_arrow_qp_via_custom_kkt():
    """tests/test_schur.py:52-65: a full coneqp with the arrow
    kktsolver, against JAX's and the port's dense solve."""
    K, nk, n0, mk = 4, 6, 3, 6
    jq = js.random_arrow_qp(K, nk, n0, mk, seed=3)
    tq = ts.random_arrow_qp(K, nk, n0, mk, seed=3, device="cpu")
    args = (tq.flat_P(), tq.flat_q(), tq.flat_G(), tq.flat_h())
    sol = coneqp(*args, kktsolver=ts.make_arrow_kktsolver(tq), device="cpu")
    dense = coneqp(*args, device="cpu")
    ref = jsolvers.coneqp(jq.flat_P(), jq.flat_q(), jq.flat_G(),
                          jq.flat_h(), kktsolver=js.make_arrow_kktsolver(jq))
    assert sol["status"] == ref["status"] == dense["status"] == "optimal"
    assert sol["iterations"] == ref["iterations"]
    _close(sol["x"], ref["x"], X_TOL)
    _close(sol["x"], dense["x"], 1e-6)


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    nd = request.param
    K, nk, n0, mk = 2 * nd, 4, 3, 4
    res = run_world(rank_schur, nd, tmp_path_factory.mktemp("w"),
                    K, nk, n0, mk)
    return nd, (K, nk, n0, mk), res


def test_arrow_sharded_matches_unsharded(world):
    """tests/test_schur.py:85-113: the sharded kktsolver equals its
    mesh=None run and JAX's under shard_map."""
    nd, (K, nk, n0, mk), res = world
    assert_replicated(res, ["ux", "Wuz"])
    m, n = K * mk, K * nk + n0
    d, _, rng = _arrow_w(m, 2)
    bx, bz = rng.standard_normal(n), rng.standard_normal(m)
    jq = js.random_arrow_qp(K, nk, n0, mk, seed=5)
    solve = js.make_arrow_kktsolver(jq, mesh=jmake_mesh(nd))(_jax_w(d))
    jux, _, jWuz = jax.jit(lambda a, c: solve(a, jnp.zeros(0), c))(
        jnp.asarray(bx), jnp.asarray(bz))
    for r in res:
        _close(r["ux"], r["ux1"], KKT_TOL)
        _close(r["Wuz"], r["Wuz1"], KKT_TOL)
    _close(res[0]["ux"], jux, KKT_TOL)
    _close(res[0]["Wuz"], jWuz, KKT_TOL)


def test_arrow_qp_sharded_full_solve(world):
    """tests/test_schur.py:68-82: the whole IPM with the sharded arrow
    kktsolver, against JAX's with its sharded kktsolver."""
    nd, (K, nk, n0, mk), res = world
    assert_replicated(res, ["x", "z", "status", "iterations"])
    jq = js.random_arrow_qp(K, nk, n0, mk, seed=7)
    ref = jsolvers.coneqp(
        jq.flat_P(), jq.flat_q(), jq.flat_G(), jq.flat_h(),
        kktsolver=js.make_arrow_kktsolver(jq, mesh=jmake_mesh(nd)))
    assert res[0]["status"] == ref["status"] == "optimal"
    assert res[0]["iterations"] == ref["iterations"]
    _close(res[0]["x"], ref["x"], X_TOL)

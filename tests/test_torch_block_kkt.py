"""The port's block-partitioned kktsolver (cvxopt_tpu_torch/parallel/
schur.py BlockQP) against cvxopt_tpu/parallel/schur.py: twins of
tests/test_block_kkt.py on the same seeded data, in float64.

Tolerances: the kktsolver's (ux, uy, W uz) within 1e-9; solved x and y
within 1e-7; status and iterations equal to JAX's coneqp run.

The kktsolver twins hold the port to two oracles: the JAX kktsolver at
the scaling that JAX's own `compute_scaling` makes of the same s and z,
and a dense solve of the 3x3 KKT system.  Where there are 'q' cones the
JAX side runs eagerly: under `jax.jit` its block kktsolver returns other
values on XLA:CPU than its eager run and the dense solve (ROADMAP,
Queue 3, known faults of the JAX package).  The sharded twins run the
port on 2 and 4 spawned gloo ranks and JAX on as many virtual devices.
The n = 10,240 data of tests/test_block_kkt.py:90-130 is not a convex
QP; its twin runs it at full width on one rank and holds the port to
JAX's non-finite outputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from cvxopt_tpu.coneqp import coneqp as jconeqp
from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu.parallel import schur as js
from cvxopt_tpu.scaling import (
    identity_scaling as jidentity, compute_scaling as jcompute_scaling,
)
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.coneqp import coneqp
from cvxopt_tpu_torch.parallel import schur as ts
from cvxopt_tpu_torch.scaling import (
    identity_scaling, compute_scaling, scale,
)

from test_torch_mesh import (
    run_world, rank_block, assert_replicated, block_w, solve_block,
    BLOCK_SHARDED,
)

torch.set_num_threads(1)

KKT_TOL = 1e-9
X_TOL = 1e-7


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _jax_solve(qp, mesh=None):
    return jconeqp(qp.flat_P(), qp.flat_q(), qp.flat_G(), qp.flat_h(),
                   dims=qp.dims, A=qp.flat_A(), b=qp.flat_b(),
                   kktsolver=js.make_block_kktsolver(qp, mesh=mesh))


def _jax_mesh(nd):
    return Mesh(np.array(jax.devices()[:nd]), ("batch",))


def _port_w(qp, s, z):
    return compute_scaling(torch.as_tensor(s), torch.as_tensor(z),
                           qp.dims)[0]


def _jax_kkt(jq, s, z, rhs, mesh=None):
    """JAX's block kktsolver, run eagerly, at the scaling JAX's own
    compute_scaling makes of s and z."""
    jW, _ = jcompute_scaling(jnp.asarray(s), jnp.asarray(z), jq.dims)
    solve = js.make_block_kktsolver(jq, mesh=mesh)(jW)
    return solve(*(jnp.asarray(r) for r in rhs))


def _dense_kkt(qp, W, rhs):
    """The 3x3 KKT system of the flat problem, solved densely:
    [[P, A', G'], [A, 0, 0], [G, 0, -W'W]] [ux; uy; uz] = [bx; by; bz];
    returns (ux, uy, W uz)."""
    P, G, A = (f().numpy() for f in (qp.flat_P, qp.flat_G, qp.flat_A))
    m = G.shape[0]
    # row i of scale(I) is W e_i: the transpose of W's matrix
    Wm = scale(torch.eye(m, dtype=torch.float64), W, qp.dims).numpy().T
    n, p = P.shape[0], A.shape[0]
    KKT = np.block([[P, A.T, G.T],
                    [A, np.zeros((p, p)), np.zeros((p, m))],
                    [G, np.zeros((m, p)), -Wm.T @ Wm]])
    u = np.linalg.solve(KKT, np.concatenate(rhs))
    return u[:n], u[n:n + p], Wm @ u[n + p:]


def _agree(sol, ref):
    assert sol["status"] == ref["status"] == "optimal"
    assert sol["iterations"] == ref["iterations"]
    _close(sol["x"], ref["x"], X_TOL)
    _close(sol["y"], ref["y"], X_TOL)


def test_split_merge_roundtrip():
    """tests/test_block_kkt.py:33-40, and the layout helpers equal
    JAX's."""
    dl, K = ConeDims(l=3, q=(3, 4)), 5
    v = torch.arange(K * dl.cdim, dtype=torch.float64)
    vk = ts.split_cone_vec(v, dl, K)
    assert vk.shape == (K, dl.cdim)
    np.testing.assert_array_equal(ts.merge_cone_vec(vk, dl, K).numpy(),
                                  v.numpy())
    jdl = JDims(l=3, q=(3, 4))
    np.testing.assert_array_equal(
        vk.numpy(), np.asarray(js.split_cone_vec(jnp.asarray(v.numpy()),
                                                 jdl, K)))
    gd, jgd = ts.global_dims(dl, K), js.global_dims(jdl, K)
    assert (gd.l, gd.q, gd.s) == (jgd.l, jgd.q, jgd.s)
    rng = np.random.default_rng(0)
    W = identity_scaling(gd, device="cpu")
    W["beta"] = [torch.as_tensor(rng.uniform(0.5, 2, b.shape))
                 for b in W["beta"]]
    W["v"] = [torch.as_tensor(rng.standard_normal(u.shape)) for u in W["v"]]
    jW = {k: ([jnp.asarray(u.numpy()) for u in x] if isinstance(x, list)
              else jnp.asarray(x.numpy())) for k, x in W.items()}
    Wk, jWk = ts.split_w(W, dl, K), js.split_w(jW, jdl, K)
    for k in ("d", "di"):
        np.testing.assert_array_equal(Wk[k].numpy(), np.asarray(jWk[k]))
    for k in ("beta", "v"):
        for a, b in zip(Wk[k], jWk[k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kw", [
    dict(K=4, nk=8, n0=4, l=8, q=(), pk=2, seed=1),
    dict(K=4, nk=8, n0=4, l=5, q=(3,), pk=2, seed=2),
    dict(K=4, nk=8, n0=6, l=8, q=(3,), pk=2, p0=2, seed=3),
], ids=["orthant_equalities", "q_cones", "shared_equalities"])
def test_block_matches_jax(kw):
    """tests/test_block_kkt.py:43-73: the whole IPM with the block
    kktsolver (local equalities; 'q' cones; shared equalities), the data
    drawn as JAX draws it: status, iterations, x and y equal to JAX's
    coneqp run, and x within the JAX test's 1e-6 of the port's dense
    solve."""
    jq = js.random_block_qp(**kw)
    tq = ts.random_block_qp(**kw, device="cpu")
    for f in ("flat_P", "flat_q", "flat_G", "flat_h", "flat_A", "flat_b"):
        np.testing.assert_array_equal(getattr(tq, f)().numpy(),
                                      np.asarray(getattr(jq, f)()), f)
    sol = solve_block(tq)
    _agree(sol, _jax_solve(jq))
    dense = coneqp(tq.flat_P(), tq.flat_q(), tq.flat_G(), tq.flat_h(),
                   dims=tq.dims, A=tq.flat_A(), b=tq.flat_b(), device="cpu")
    assert dense["status"] == "optimal"
    np.testing.assert_allclose(sol["x"].numpy(), dense["x"].numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(K=4, nk=8, n0=6, l=5, q=(3,), pk=2, p0=2, seed=6),
    dict(K=4, nk=8, n0=6, l=5, q=(3,), pk=2, p0=0, seed=6),
    dict(K=4, nk=8, n0=6, l=5, q=(3,), pk=0, p0=2, seed=6),
    dict(K=4, nk=8, n0=6, l=8, q=(), pk=2, p0=2, seed=6),
], ids=["q_cones_shared_eq", "q_cones_no_shared_eq", "q_cones_no_local_eq",
        "orthant"])
def test_block_kkt_solve_matches_jax(kw):
    """The kktsolver's (ux, uy, W uz) at a non-identity scaling against
    JAX's (eager; on the orthant also under jax.jit, which agrees there)
    and against the dense 3x3 solve."""
    tq = ts.random_block_qp(**kw, device="cpu")
    jq = js.random_block_qp(**kw)
    s, z, rhs = block_w(tq, 8)
    W = _port_w(tq, s, z)
    out = ts.make_block_kktsolver(tq)(W)(*(torch.as_tensor(r) for r in rhs))
    dense = _dense_kkt(tq, W, rhs)
    refs = [_jax_kkt(jq, s, z, rhs)]
    if not kw["q"]:
        jW, _ = jcompute_scaling(jnp.asarray(s), jnp.asarray(z), jq.dims)
        solve = js.make_block_kktsolver(jq)(jW)
        refs.append(jax.jit(solve)(*(jnp.asarray(r) for r in rhs)))
    for a, d, *rs in zip(out, dense, *refs):
        _close(a, d, KKT_TOL)
        for r in rs:
            _close(a, r, KKT_TOL)


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    nd = request.param
    return nd, run_world(rank_block, nd, tmp_path_factory.mktemp("w"))


def test_block_sharded_matches_single_device(world):
    """tests/test_block_kkt.py:76-87: the sharded solve equals the
    single-device one and JAX's coneqp with its sharded kktsolver."""
    nd, res = world
    assert_replicated(res, ["x", "y", "z", "status", "iterations", "ux",
                            "uy", "Wuz"])
    jq = js.random_block_qp(**BLOCK_SHARDED)
    _agree(res[0], _jax_solve(jq, mesh=_jax_mesh(nd)))
    tq = ts.random_block_qp(**BLOCK_SHARDED, device="cpu")
    one = solve_block(tq)
    assert one["iterations"] == res[0]["iterations"]
    _close(res[0]["x"], one["x"], X_TOL)


@pytest.fixture(scope="module")
def sharded_kkt_refs():
    """The oracles of the sharded kktsolver at block_w's scaling (seed
    9): JAX's kktsolver (eager: 'q' cones) and the dense 3x3 solve."""
    tq = ts.random_block_qp(**BLOCK_SHARDED, device="cpu")
    s, z, rhs = block_w(tq, 9)
    jax_out = _jax_kkt(js.random_block_qp(**BLOCK_SHARDED), s, z, rhs)
    return jax_out, _dense_kkt(tq, _port_w(tq, s, z), rhs)


def test_block_sharded_kkt_matches_jax(world, sharded_kkt_refs):
    """The sharded kktsolver's (ux, uy, W uz) at one scaling against its
    mesh=None run, JAX's kktsolver and the dense 3x3 solve (JAX's own
    sharded and single-device kktsolvers are held equal by
    tests/test_block_kkt.py:76-87 and test_block_sharded_matches_single_
    device above)."""
    _, res = world
    ref, dense = sharded_kkt_refs
    for r in res:
        for i, k in enumerate(("ux", "uy", "Wuz")):
            _close(r[k], r[k + "1"], KKT_TOL)
            _close(r[k], dense[i], KKT_TOL)
            _close(r[k], ref[i], KKT_TOL)


def _schur_min_eig(qp):
    """Least eigenvalue of P's Schur complement on the coupling block,
    P0 - sum_k Pc_k' P_k^-1 Pc_k: P is positive definite iff it is
    positive (the P_k are)."""
    X = torch.cholesky_solve(qp.Pc, torch.linalg.cholesky(qp.Pk))
    S = qp.P0 - torch.einsum("kia,kib->ab", qp.Pc, X)
    return float(torch.linalg.eigvalsh(S)[0])


def test_n10240_block_qp_is_not_convex_in_either_package():
    """tests/test_block_kkt.py:90-130's data at full width (K = 8
    scenarios of nk = 1248, n0 = 256, pk = 4; n = 10,240) on one rank:
    the port's generator equals JAX's bit for bit; P is indefinite (its
    Schur complement on x0 has least eigenvalue -79.35), so the reduced
    factor fails, and one factor + solve at W = 1.1 I gives non-finite
    ux, uy and W uz in both packages, in the same places (JAX's
    kktsolver run eagerly: under jax.jit its compile alone takes
    longer).  It stays at full width: at a quarter width (nk = 312) P
    is indefinite too, but the reduced matrix at W = 1.1 I is positive
    definite and the outputs are finite."""
    kw = dict(K=8, nk=1248, n0=256, l=1248, q=(), pk=4, seed=0)
    tq = ts.random_block_qp(**kw, device="cpu")
    jq = js.random_block_qp(**kw)
    for f in ("Pk", "Pc", "P0", "qk", "q0", "Gk", "Ek", "hk", "Ak", "Ck",
              "bk", "A0", "b0"):
        np.testing.assert_array_equal(getattr(tq, f).numpy(),
                                      np.asarray(getattr(jq, f)), f)
    assert round(_schur_min_eig(tq), 2) == -79.35
    n, p, m = 10240, 32, tq.dims.cdim
    rhs = (np.ones(n), np.zeros(p), np.ones(m))
    W = identity_scaling(tq.dims, device="cpu")
    W["d"], W["di"] = W["d"] * 1.1, W["di"] / 1.1
    out = ts.make_block_kktsolver(tq)(W)(*(torch.as_tensor(r) for r in rhs))
    jW = jidentity(jq.dims)
    jW["d"], jW["di"] = jW["d"] * 1.1, jW["di"] / 1.1
    ref = js.make_block_kktsolver(jq)(jW)(*(jnp.asarray(r) for r in rhs))
    for a, b in zip(out, ref):
        fin = np.isfinite(a.numpy())
        assert not fin.any()
        np.testing.assert_array_equal(fin, np.isfinite(np.asarray(b)))

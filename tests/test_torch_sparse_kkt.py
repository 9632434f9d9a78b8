"""The port's sparse KKT path (cvxopt_tpu_torch/ops/sparse_kkt.py:
RCM ordering, fixed-pattern band assembly, the banded kktsolver and the
lp_sparse/qp_sparse front ends) against cvxopt_tpu/ops/sparse_kkt.py on
the CPU - twins of the cases of tests/test_sparse_kkt.py on the same
seeded numpy data.

Tolerances: ELL products, band assembly and spsolve solves within
1e-12 relative of the JAX function; lp_sparse/qp_sparse/
kkt_chol2_banded solves with equal status and iterations and x within
1e-6 of the JAX package's.  The n = 100,000 case of
test_lp_sparse_large_scales is not twinned here: chip_smoke.py's
`sparse` phase runs it on the card.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from cvxopt_tpu.ops import sparse_kkt as jsk
from cvxopt_tpu import solvers as js
from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu_torch.ops import sparse_kkt as tsk
from cvxopt_tpu_torch import solvers as ts
from cvxopt_tpu_torch.cones import ConeDims

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _chain_lp(n, seed=0):
    """tests/test_sparse_kkt.py's banded LP: min c'x s.t. 0 <= x <= 1
    and |x_i - x_{i+1}| <= 0.5."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(n) * 0.1
    rows, cols, vals, h = [], [], [], []
    r = 0
    for i in range(n):
        rows += [r, r + 1]
        cols += [i, i]
        vals += [-1.0, 1.0]
        h += [0.0, 1.0]
        r += 2
    for i in range(n - 1):
        rows += [r, r, r + 1, r + 1]
        cols += [i, i + 1, i, i + 1]
        vals += [1.0, -1.0, -1.0, 1.0]
        h += [0.5, 0.5]
        r += 2
    G = sp.coo_matrix((vals, (rows, cols)), shape=(r, n)).tocsr()
    return c, G, np.asarray(h)


def test_chip_smoke_chain_lp_is_this_generator():
    """chip_smoke.chain_lp (vectorized, for n = 100,000) builds the same
    LP as this loop (bench.py's `_chain_lp`)."""
    import chip_smoke
    for n, seed in ((5, 0), (300, 1)):
        a, b = chip_smoke.chain_lp(n, seed), _chain_lp(n, seed)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[2], b[2])
        assert (a[1] != b[1]).nnz == 0 and a[1].shape == b[1].shape


def _same_solve(sol, ref, key="x"):
    assert sol["status"] == ref["status"]
    assert sol["iterations"] == ref["iterations"]
    np.testing.assert_allclose(sol[key].numpy(), np.asarray(ref[key]),
                               atol=1e-6)


def test_ell_matvec():
    rng = np.random.default_rng(0)
    A = sp.random(13, 7, density=0.3, random_state=1, format="csr")
    E = tsk.SparseELL.from_scipy(A, device="cpu")
    J = jsk.SparseELL.from_scipy(A)
    x = rng.standard_normal(7)
    y = rng.standard_normal(13)
    np.testing.assert_array_equal(E.cols.numpy(), np.asarray(J.cols))
    for got, want in ((E.matvec(torch.as_tensor(x)), J.matvec(jnp.asarray(x))),
                      (E.rmatvec(torch.as_tensor(y)),
                       J.rmatvec(jnp.asarray(y))),
                      (E.todense(), J.todense())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(E.todense().numpy(), A.toarray(), atol=1e-12)


def test_band_plan_and_assembly_vs_jax():
    rng = np.random.default_rng(2)
    n = 20
    _, G, _ = _chain_lp(n, seed=2)
    plan = tsk.make_band_plan(G, device="cpu")
    jplan = jsk.make_band_plan(G)
    np.testing.assert_array_equal(plan.perm, jplan.perm)
    assert plan.kd == jplan.kd
    np.testing.assert_array_equal(plan.scatter_idx.numpy(),
                                  np.asarray(jplan.scatter_idx))
    w = rng.uniform(0.5, 2.0, G.shape[0])
    band = tsk.assemble_band(plan, torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(
        band, np.asarray(jsk.assemble_band(jplan, jnp.asarray(w))),
        rtol=1e-12, atol=1e-12)
    S = (G.T @ sp.diags(w) @ G).toarray()[np.ix_(plan.perm, plan.perm)]
    dense = np.zeros((n, n))
    for j in range(plan.kd + 1):
        dense += np.diag(band[j, :n - j], -j)
        if j:
            dense += np.diag(band[j, :n - j], j)
    np.testing.assert_allclose(dense, S, atol=1e-10)


def test_band_plan_with_P():
    _, G, _ = _chain_lp(15, seed=3)
    P = sp.diags([np.full(14, 0.3), np.full(15, 2.0), np.full(14, 0.3)],
                 [-1, 0, 1]).tocsr()
    w = np.random.default_rng(3).uniform(0.5, 2.0, G.shape[0])
    plan = tsk.make_band_plan(G, P_sp=P, device="cpu")
    jplan = jsk.make_band_plan(G, P_sp=P)
    np.testing.assert_allclose(
        tsk.assemble_band(plan, torch.as_tensor(w)).numpy(),
        np.asarray(jsk.assemble_band(jplan, jnp.asarray(w))), rtol=1e-12,
        atol=1e-12)


def test_banded_lp_matches_jax_and_dense():
    n = 40
    c, G, h = _chain_lp(n, seed=3)
    r = G.shape[0]
    ref = js.conelp(c, G.toarray(), h, kktsolver=jsk.kkt_chol2_banded(
        G, JDims(l=r)))
    kkt = tsk.kkt_chol2_banded(G, ConeDims(l=r), device="cpu")
    sol = ts.conelp(c, G.toarray(), h, kktsolver=kkt, device="cpu")
    assert sol["status"] == "optimal"
    _same_solve(sol, ref)
    dense = ts.conelp(c, G.toarray(), h, device="cpu")
    np.testing.assert_allclose(sol["x"].numpy(), dense["x"].numpy(),
                               atol=1e-6)
    assert kkt.plan.kd <= 4


def test_banded_qp_with_equalities_matches_jax():
    n = 30
    c, G, h = _chain_lp(n, seed=4)
    Pd = sp.diags([np.full(n - 1, 0.3), np.full(n, 2.0),
                   np.full(n - 1, 0.3)], [-1, 0, 1]).tocsr()
    A = np.ones((1, n))
    b = np.array([n / 2.0])
    r = G.shape[0]
    ref = js.coneqp(Pd.toarray(), c, G.toarray(), h, A=A, b=b,
                    kktsolver=jsk.kkt_chol2_banded(G, JDims(l=r), A=A,
                                                   P_sp=Pd))
    kkt = tsk.kkt_chol2_banded(G, ConeDims(l=r), A=A, P_sp=Pd,
                               device="cpu")
    sol = ts.coneqp(Pd.toarray(), c, G.toarray(), h, A=A, b=b,
                    kktsolver=kkt, device="cpu")
    assert sol["status"] == "optimal"
    _same_solve(sol, ref)


def test_banded_kkt_float32_factor():
    """factor_dtype=float32 factors the Jacobi-equilibrated band in
    float32: one kktsolver solve within 1e-5 (relative) of the JAX
    package's float32 solve and of the port's float64 one."""
    c, G, h = _chain_lp(40, seed=5)
    r, n = G.shape
    rng = np.random.default_rng(5)
    di = rng.uniform(0.5, 2.0, r)
    bx, bz = rng.standard_normal(n), rng.standard_normal(r)
    by = np.zeros(0)
    W = {"di": torch.as_tensor(di)}
    u32 = tsk.kkt_chol2_banded(G, ConeDims(l=r), factor_dtype=torch.float32,
                               device="cpu")(W)(*map(torch.as_tensor,
                                                     (bx, by, bz)))
    u64 = tsk.kkt_chol2_banded(G, ConeDims(l=r), device="cpu")(W)(
        *map(torch.as_tensor, (bx, by, bz)))
    j32 = jsk.kkt_chol2_banded(G, JDims(l=r), factor_dtype=jnp.float32)(
        {"di": jnp.asarray(di)})(*map(jnp.asarray, (bx, by, bz)))
    for k in (0, 2):
        ref = np.asarray(j32[k])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(u32[k].numpy(), ref, atol=1e-5 * scale)
        np.testing.assert_allclose(u32[k].numpy(), u64[k].numpy(),
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("n", [200, 800])
def test_scaling_with_structure(n):
    """The band plan size is linear in n (O(n kd^2) work)."""
    _, G, _ = _chain_lp(n)
    plan = tsk.make_band_plan(G, device="cpu")
    assert plan.kd <= 4
    assert plan.scatter_idx.shape[0] <= G.shape[0] * 9


def test_lp_sparse_frontend_matches_jax():
    n = 50
    c, G, h = _chain_lp(n, seed=6)
    ref = jsk.lp_sparse(c, G, h)
    sol = tsk.lp_sparse(c, G, h, device="cpu")
    assert sol["status"] == "optimal"
    _same_solve(sol, ref)
    dense = ts.lp(c, G.toarray(), h, device="cpu")
    np.testing.assert_allclose(sol["x"].numpy(), dense["x"].numpy(),
                               atol=1e-6)


def test_lp_sparse_auto_method_by_device(monkeypatch):
    """'auto' picks the one-row-per-step factor on the CPU (the blocked
    one on the card, tests/test_torch_gpu.py)."""
    import cvxopt_tpu_torch.ops.banded as bnd
    _, G, _ = _chain_lp(10)
    kkt = tsk._pick_sparse_kkt(G, ConeDims(l=G.shape[0]), None, None,
                               torch.float64, device="cpu")
    calls = []
    orig = bnd.pbtrf
    monkeypatch.setattr(bnd, "pbtrf",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    monkeypatch.setattr(bnd, "pbtrf_blocked", None)
    kkt({"di": torch.ones(G.shape[0], dtype=torch.float64)})
    assert calls == [1]


def test_qp_sparse_matches_jax():
    n = 30
    c, G, h = _chain_lp(n, seed=8)
    P = sp.diags([np.full(n - 1, 0.2), np.full(n, 1.5),
                  np.full(n - 1, 0.2)], [-1, 0, 1]).tocsr()
    ref = jsk.qp_sparse(P, c, G, h)
    sol = tsk.qp_sparse(P, c, G, h, device="cpu")
    assert sol["status"] == "optimal"
    _same_solve(sol, ref)


def test_lp_sparse_arrow_routes_blocksparse():
    """A hub-coupled LP whose Gram pattern RCM cannot band takes the
    tile-map kktsolver in both packages, with the same answer."""
    from test_torch_blocksparse import _hub_lp
    c, G, h = _hub_lp(120)
    kkt = tsk._pick_sparse_kkt(G, ConeDims(l=G.shape[0]), None, None,
                               torch.float64, device="cpu")
    assert hasattr(kkt.plan, "symb")
    ref = jsk.lp_sparse(c, G, h, options={"maxiters": 30})
    sol = tsk.lp_sparse(c, G, h, options={"maxiters": 30}, device="cpu")
    _same_solve(sol, ref)


def test_spsolve_banded_backend():
    from cvxopt_tpu.ops import spsolve as jsp
    from cvxopt_tpu_torch.ops import spsolve
    rng = np.random.default_rng(8)
    n = 60
    d = rng.uniform(3, 4, n)
    e = rng.uniform(-1, 1, n - 1)
    f = rng.uniform(-0.5, 0.5, n - 2)
    S = sp.diags([f, e, d, e, f], [-2, -1, 0, 1, 2]).tocsr()
    symb = spsolve.symbolic(S)
    jsymb = jsp.symbolic(S)
    assert symb.banded and symb.kd == jsymb.kd <= 4
    np.testing.assert_array_equal(symb.perm, jsymb.perm)
    F = spsolve.numeric(S, symb, device="cpu")
    jF = jsp.numeric(S, jsymb)
    np.testing.assert_allclose(F.L.numpy(), np.asarray(jF.L), rtol=1e-12,
                               atol=1e-12)
    for b in (rng.standard_normal(n), rng.standard_normal((n, 3))):
        x = spsolve.solve(F, torch.as_tensor(b))
        np.testing.assert_allclose(x.numpy(), np.asarray(jsp.solve(jF, b)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(x.numpy(), np.linalg.solve(S.toarray(), b),
                                   atol=1e-8)
    x3 = spsolve.linsolve(S, torch.as_tensor(b[:, 0]))
    np.testing.assert_allclose(x3.numpy(), x[:, 0].numpy(), atol=1e-10)


def test_blocked_band_factor_matches_scalar():
    """The card's band factor (block panels written into band storage)
    equals the JAX package's one-row-per-step pbtrf at 1e-12."""
    from cvxopt_tpu.ops import banded as jb
    from cvxopt_tpu_torch.ops.spsolve import _blocked_band
    rng = np.random.default_rng(11)
    for n, kd in ((300, 3), (129, 1), (60, 5)):
        AB = np.zeros((kd + 1, n))
        AB[0] = rng.uniform(2.0 + kd, 3.0 + kd, n)
        for j in range(1, kd + 1):
            AB[j, :n - j] = rng.uniform(-1, 1, n - j)
        LB = _blocked_band(torch.as_tensor(AB))
        want = np.asarray(jb.pbtrf(jnp.asarray(AB)))
        np.testing.assert_allclose(LB.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def test_spsolve_options_semantics():
    """cholmod.options analogues: supernodal=0 forces the banded path,
    nmethods >= 2 tries minimum degree too, dbound clamps the factor
    diagonal - as in the JAX package."""
    from cvxopt_tpu.ops import spsolve as jsp
    from cvxopt_tpu_torch.ops import spsolve
    rng = np.random.default_rng(9)
    n = 40
    d = rng.uniform(3, 4, n)
    e = rng.uniform(-1, 1, n - 1)
    S = sp.diags([e, d, e], [-1, 0, 1]).tocsr()
    old = dict(spsolve.options)
    jold = dict(jsp.options)
    try:
        for o in (spsolve.options, jsp.options):
            o["supernodal"] = 0
        symb = spsolve.symbolic(S)
        assert symb.banded
        for o in (spsolve.options, jsp.options):
            o["nmethods"] = 2
        symb2 = spsolve.symbolic(S)
        assert symb2.kd <= symb.kd
        assert symb2.kd == jsp.symbolic(S).kd
        F = spsolve.numeric(S, symb2, device="cpu")
        b = rng.standard_normal(n)
        np.testing.assert_allclose(spsolve.solve(F, b).numpy(),
                                   np.linalg.solve(S.toarray(), b),
                                   atol=1e-8)
        S2 = S.copy().tolil()
        S2[5, 5] = 0.0
        S2 = S2.tocsr()
        for o in (spsolve.options, jsp.options):
            o["dbound"] = 1e-8
        F2 = spsolve.numeric(S2, spsolve.symbolic(S2), device="cpu")
        assert not torch.isnan(F2.L).any()
        jF2 = jsp.numeric(S2, jsp.symbolic(S2))
        np.testing.assert_allclose(F2.L.numpy(), np.asarray(jF2.L),
                                   rtol=1e-12, atol=1e-12)
    finally:
        spsolve.options.clear()
        spsolve.options.update(old)
        jsp.options.clear()
        jsp.options.update(jold)


def test_spmatrix_accessors():
    """sp_I/J/V/CCS on the port's sparse matrix equal the JAX package's
    on its BCOO, element for element."""
    import cvxopt_tpu as jcvx
    from cvxopt_tpu.base import sp_CCS as jccs
    import cvxopt_tpu_torch as cvx
    from cvxopt_tpu_torch.base import sp_I, sp_J, sp_V, sp_CCS
    X = cvx.spmatrix([1.0, 2.0, 3.0], [0, 2, 1], [1, 0, 1], size=(3, 2),
                     device="cpu")
    JX = jcvx.spmatrix([1.0, 2.0, 3.0], [0, 2, 1], [1, 0, 1], size=(3, 2))
    np.testing.assert_array_equal(sp_I(X).numpy(), [0, 2, 1])
    np.testing.assert_array_equal(sp_J(X).numpy(), [1, 0, 1])
    np.testing.assert_allclose(sp_V(X).numpy(), [1.0, 2.0, 3.0])
    for got, want in zip(sp_CCS(X), jccs(JX)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

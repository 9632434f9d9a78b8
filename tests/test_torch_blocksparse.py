"""The port's tile-map block-sparse Cholesky and LU
(cvxopt_tpu_torch/ops/blocksparse.py) against
cvxopt_tpu/ops/blocksparse.py on the CPU - twins of the cases of
tests/test_blocksparse.py on the same seeded numpy data.

Tolerances: the symbolic tables equal; assemblies, factors and solves
within 1e-12 relative (float64) of the JAX function; the kktsolver LP
with equal status and iterations and x within 1e-6 of the JAX
package's; umfpack's residual <= 1e-12 relative, as in the JAX test.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from cvxopt_tpu.ops import blocksparse as jbsp
from cvxopt_tpu_torch.ops import blocksparse as bsp

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _arrow(n, rng, scale=None):
    d = 3.0 + rng.uniform(0, 1, n)
    A = sp.lil_matrix((n, n))
    A.setdiag(d)
    v = (scale if scale is not None
         else 0.5 / np.sqrt(n)) * rng.standard_normal(n - 1)
    A[n - 1, :n - 1] = v
    A[:n - 1, n - 1] = np.asarray(v)[:, None]
    return sp.csr_matrix(A)


def _cases():
    rng = np.random.default_rng(0)
    cases = [("arrow", _arrow(300, rng), 16)]
    B = sp.random(400, 400, density=0.02, random_state=1)
    cases.append(("random spd",
                  (B @ B.T + sp.diags(3.0 + rng.uniform(0, 1, 400))).tocsr(),
                  16))
    k = 20
    I = sp.eye(k)
    T = sp.diags([-1., 4., -1.], [-1, 0, 1], shape=(k, k))
    L2 = (sp.kron(I, T)
          + sp.kron(sp.diags([-1., -1.], [-1, 1], shape=(k, k)), I))
    cases.append(("2d laplacian", sp.csr_matrix(L2), 16))
    return cases


@pytest.mark.parametrize("case", range(3))
def test_blocksparse_patterns_vs_jax(case):
    name, S, t = _cases()[case]
    n = S.shape[0]
    b = np.random.default_rng(case).standard_normal(n)
    symb = bsp.analyze(S, t=t)
    jsymb = jbsp.analyze(S, t=t)
    np.testing.assert_array_equal(symb.perm, jsymb.perm)
    for k in ("col_slots", "col_rows", "upd_dst", "upd_src1", "upd_src2",
              "row_slots", "row_js"):
        np.testing.assert_array_equal(getattr(symb, k), getattr(jsymb, k),
                                      err_msg=k)
    A = bsp.assemble(symb, S, device="cpu")
    jA = jbsp.assemble(jsymb, S)
    assert rel(A, jA) <= 1e-12
    L = bsp.factor(symb, A)
    assert rel(L, jbsp.factor(jsymb, jA)) <= 1e-12, name
    x = bsp.linsolve(S, torch.as_tensor(b), t=t)
    assert rel(x, jbsp.linsolve(S, b, t=t)) <= 1e-12, name
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(S.toarray(), b),
                               atol=1e-8, err_msg=name)


def test_blocksparse_structure_scaling():
    """The arrow pattern's block count is O(nt), not O(nt^2)."""
    rng = np.random.default_rng(1)
    S = _arrow(2000, rng)
    symb = bsp.analyze(S, t=32)
    assert symb.nnzb <= 3 * symb.nt, (symb.nnzb, symb.nt)
    assert symb.nnzb == jbsp.analyze(S, t=32).nnzb
    b = rng.standard_normal(2000)
    x = bsp.linsolve(S, b, t=32, device="cpu")
    assert np.abs(S @ x.numpy() - b).max() < 1e-9


def test_blocksparse_multi_rhs_and_assembly_paths():
    rng = np.random.default_rng(2)
    S = _arrow(200, rng)
    symb = bsp.analyze(S, t=16)
    A1 = bsp.assemble(symb, S, device="cpu")
    A2 = bsp.assemble_scipy(symb, S, device="cpu")
    np.testing.assert_allclose(A1.numpy(), A2.numpy())
    L = bsp.factor(symb, A1)
    B = rng.standard_normal((200, 3))
    X = bsp.solve(symb, L, torch.as_tensor(B))
    jsymb = jbsp.analyze(S, t=16)
    jX = jbsp.solve(jsymb, jbsp.factor(jsymb, jbsp.assemble(jsymb, S)),
                    jnp.asarray(B))
    assert rel(X, jX) <= 1e-12
    np.testing.assert_allclose(X.numpy(), np.linalg.solve(S.toarray(), B),
                               atol=1e-8)


def test_blocksparse_non_pd_nan():
    rng = np.random.default_rng(4)
    S = _arrow(100, rng).tolil()
    S[40, 40] = -3.0
    S = sp.csr_matrix(S)
    symb = bsp.analyze(S, t=16)
    L = bsp.factor(symb, bsp.assemble(symb, S, device="cpu"))
    assert torch.isnan(L).any()


def test_cholmod_api_routes_blocksparse():
    from cvxopt_tpu.ops import spsolve as jsp
    from cvxopt_tpu_torch.ops import spsolve
    rng = np.random.default_rng(3)
    S = _arrow(1500, rng)
    symb = spsolve.symbolic(S)
    assert symb.bsp is not None
    F = spsolve.numeric(S, symb, device="cpu")
    b = rng.standard_normal(1500)
    x = spsolve.solve(F, b)
    assert np.abs(S @ x.numpy() - b).max() < 1e-9
    assert rel(x, jsp.solve(jsp.numeric(S, jsp.symbolic(S)), b)) <= 1e-12


def _hub_lp(n, seed=0):
    """tests/test_blocksparse.py's arrow-patterned LP: box bounds and
    hub-coupling rows x_i + x_hub terms."""
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
        rows += [r, r]
        cols += [i, n - 1]
        vals += [0.3, 0.2]
        h += [1.0]
        r += 1
    G = sp.coo_matrix((vals, (rows, cols)), shape=(r, n)).tocsr()
    return c, G, np.asarray(h)


def test_blocksparse_kktsolver_end_to_end():
    """The tile-map kktsolver through conelp on an arrow-patterned LP,
    against the JAX package and the port's dense path."""
    from cvxopt_tpu.ops.blocksparse import kkt_chol2_blocksparse as jk
    from cvxopt_tpu.ops.sparse_kkt import _as_ops as jops
    from cvxopt_tpu.cones import ConeDims as JDims
    from cvxopt_tpu import solvers as js
    from cvxopt_tpu_torch.ops.sparse_kkt import _as_ops
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch import solvers
    c, G, h = _hub_lp(200)
    r = G.shape[0]
    kkt = bsp.kkt_chol2_blocksparse(G, ConeDims(l=r), t=16, device="cpu")
    assert kkt.plan.symb.nnzb < 0.3 * kkt.plan.symb.nt ** 2
    sol = solvers.conelp(torch.as_tensor(c), _as_ops(G, torch.float64,
                                                     "cpu"),
                         torch.as_tensor(h), dims=ConeDims(l=r),
                         kktsolver=kkt, options={"maxiters": 30},
                         device="cpu")
    ref = js.conelp(jnp.asarray(c), jops(G, jnp.float64), jnp.asarray(h),
                    dims=JDims(l=r), kktsolver=jk(G, JDims(l=r), t=16),
                    options={"maxiters": 30})
    assert sol["status"] == ref["status"] == "optimal"
    assert sol["iterations"] == ref["iterations"]
    np.testing.assert_allclose(sol["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-6)
    dense = solvers.conelp(c, G.toarray(), h, dims=ConeDims(l=r),
                           options={"maxiters": 30}, device="cpu")
    np.testing.assert_allclose(sol["x"].numpy(), dense["x"].numpy(),
                               atol=1e-7)


def test_kkt_plan_assembly_with_P_vs_jax():
    c, G, h = _hub_lp(60, seed=2)
    n = G.shape[1]
    P = sp.diags([np.full(n, 2.0)], [0]).tocsr()
    w = np.random.default_rng(2).uniform(0.5, 2.0, G.shape[0])
    plan = bsp.make_kkt_plan(G, P_sp=P, t=16, device="cpu")
    jplan = jbsp.make_kkt_plan(G, P_sp=P, t=16)
    np.testing.assert_array_equal(plan.scatter_idx.numpy(),
                                  np.asarray(jplan.scatter_idx))
    assert rel(bsp.assemble_kkt(plan, torch.as_tensor(w)),
               jbsp.assemble_kkt(jplan, jnp.asarray(w))) <= 1e-12


# ---- unsymmetric tile-map block LU (the umfpack general-sparsity path) ----

def _unsym_arrow(n, head=10, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.lil_matrix((n, n))
    A.setdiag(rng.uniform(5.0, 9.0, n))
    A[:head, head:] = 0.4 * rng.standard_normal((head, n - head))
    A[head:, :head] = 0.2 * rng.standard_normal((n - head, head))
    for d in (1, 2):
        A.setdiag(0.3 * rng.standard_normal(n - d), d)
        A.setdiag(0.2 * rng.standard_normal(n - d), -d)
    return sp.csr_matrix(A)


def test_blocksparse_lu_small_vs_jax():
    import scipy.sparse.linalg as spl
    A = _unsym_arrow(300, head=7)
    b = np.random.default_rng(1).standard_normal(300)
    x = bsp.lu_linsolve_blocksparse(A, b, t=16, device="cpu")
    assert rel(x, jbsp.lu_linsolve_blocksparse(A, b, t=16)) <= 1e-12
    np.testing.assert_allclose(x.numpy(), spl.spsolve(A, b), atol=1e-12)


def test_blocksparse_lu_transpose_and_multirhs():
    A = _unsym_arrow(200, head=5, seed=3)
    pat = (A + A.T) != 0
    symb = bsp.analyze(pat, t=16)
    jsymb = jbsp.analyze(pat, t=16)
    Alow, Aupt = bsp.assemble_lu(symb, A, device="cpu")
    jAlow, jAupt = jbsp.assemble_lu(jsymb, A)
    assert rel(Alow, jAlow) <= 1e-12 and rel(Aupt, jAupt) <= 1e-12
    Lt, Ut = bsp.factor_lu(symb, Alow, Aupt)
    jLt, jUt = jbsp.factor_lu(jsymb, jAlow, jAupt)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(200)
    xt = bsp.solve_lu(symb, Lt, Ut, torch.as_tensor(b), trans="T")
    assert rel(xt, jbsp.solve_lu(jsymb, jLt, jUt, jnp.asarray(b),
                                 trans="T")) <= 1e-12
    assert np.linalg.norm(A.T @ xt.numpy() - b) < 1e-11 * np.linalg.norm(b)
    Bm = rng.standard_normal((200, 4))
    Xm = bsp.solve_lu(symb, Lt, Ut, torch.as_tensor(Bm))
    assert rel(Xm, jbsp.solve_lu(jsymb, jLt, jUt, jnp.asarray(Bm))) <= 1e-12
    assert np.linalg.norm(A @ Xm.numpy() - Bm) < 1e-11 * np.linalg.norm(Bm)


def test_umfpack_arrow_n3000_never_densifies():
    """An arrow-pattern unsymmetric n = 3000 system factors through the
    umfpack API on the tile-map LU, residual <= 1e-12."""
    from cvxopt_tpu_torch import umfpack
    n = 3000
    A = _unsym_arrow(n, head=12, seed=7)
    symb = umfpack.symbolic(A)
    assert not symb.banded and symb.bsp is not None
    t = symb.bsp.t
    assert symb.bsp.nnzb * t * t < 0.35 * n * n
    F = umfpack.numeric(A, symb, device="cpu")
    b = np.random.default_rng(4).standard_normal(n)
    x = umfpack.solve(F, b).numpy()
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-12
    xt = umfpack.solve(F, b, trans="T").numpy()
    assert np.linalg.norm(A.T @ xt - b) / np.linalg.norm(b) <= 1e-12

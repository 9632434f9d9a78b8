"""The port's packaged structure-exploiting kktsolvers
(cvxopt_tpu_torch/kkt_structured.py) against cvxopt_tpu/kkt_structured.py
on the CPU in float64 — twins of the cases of
tests/test_kkt_structured.py on the same numpy data: the Woodbury
solve within 1e-9 (relative) of numpy's dense solve and of the JAX
package's, the l1 and l1regls solvers with equal status and iterations
and u within 1e-6 of the JAX solution, plus the checks of the JAX
tests (the dense default path, dual feasibility, optimality
conditions)."""

import numpy as np
import jax.numpy as jnp
import torch

from cvxopt_tpu import kkt_structured as jks
from cvxopt_tpu_torch import kkt_structured as tks
from cvxopt_tpu_torch import solvers as ts

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def test_woodbury_solver():
    rng = np.random.default_rng(0)
    n, k = 30, 4
    d = rng.uniform(0.5, 2.0, n)
    U = rng.standard_normal((n, k))
    M = np.diag(d) + 3.0 * U @ U.T
    # numpy input, as the JAX twin takes it, lands on the asked device
    solve = tks.woodbury_solver(d, U, c=3.0, device="cpu")
    jsolve = jks.woodbury_solver(d, U, c=3.0)
    for r in (rng.standard_normal(n), rng.standard_normal((n, 5))):
        out = solve(torch.as_tensor(r)).numpy()
        np.testing.assert_allclose(out, np.linalg.solve(M, r), rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(out, np.asarray(jsolve(jnp.asarray(r))),
                                   rtol=1e-9, atol=1e-11)


def test_woodbury_solver_takes_numpy_rhs():
    """solve(r) with r a numpy vector or matrix, as the JAX twin takes
    it, equals the JAX solve at 1e-12."""
    rng = np.random.default_rng(1)
    n, k = 25, 3
    d = rng.uniform(0.5, 2.0, n)
    U = rng.standard_normal((n, k))
    solve = tks.woodbury_solver(d, U, c=2.0, device="cpu")
    jsolve = jks.woodbury_solver(d, U, c=2.0)
    for r in (rng.standard_normal(n), rng.standard_normal((n, 4))):
        out = solve(r)
        assert out.dtype == torch.float64 and out.shape == r.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(jsolve(r)),
                                   rtol=1e-12, atol=1e-12)


def test_l1_library_solver():
    rng = np.random.default_rng(2)
    m, n = 60, 20
    P = rng.standard_normal((m, n))
    q = rng.standard_normal(m)
    sol = tks.l1(P, q, device="cpu")
    ref = jks.l1(P, q)
    assert sol["status"] == ref["status"] == "optimal"
    assert sol["iterations"] == ref["iterations"]
    u = sol["u"].numpy()
    np.testing.assert_allclose(u, np.asarray(ref["u"]), atol=1e-6)
    I = np.eye(m)
    sd = ts.conelp(np.concatenate([np.zeros(n), np.ones(m)]),
                   np.block([[P, -I], [-P, -I]]),
                   np.concatenate([q, -q]), device="cpu")
    assert sd["status"] == "optimal"
    np.testing.assert_allclose(u, sd["x"][:n].numpy(), atol=1e-4)
    z = sol["z"].numpy()
    np.testing.assert_allclose(P.T @ (z[m:] - z[:m]), np.zeros(n),
                               atol=1e-5)


def test_l1regls_library_solver():
    rng = np.random.default_rng(4)
    m, n = 15, 30                   # m << n: the Woodbury fast path
    A = rng.standard_normal((m, n))
    y = rng.standard_normal(m)
    sol = tks.l1regls(A, y, device="cpu")
    ref = jks.l1regls(A, y)
    assert sol["status"] == ref["status"] == "optimal"
    assert sol["iterations"] == ref["iterations"]
    u = sol["u"].numpy()
    np.testing.assert_allclose(u, np.asarray(ref["u"]), atol=1e-6)
    g = 2 * A.T @ (A @ u - y)
    on = np.abs(u) > 1e-6
    assert np.max(np.abs(g[on] + np.sign(u[on]))) < 1e-4
    assert np.max(np.abs(g[~on])) <= 1.0 + 1e-4

"""The BASELINE.md benchmark configurations at the reduced sizes of
tests/test_benchmark_configs.py, through the port's front doors on the
CPU, against the JAX package on the same data: Markowitz portfolio QP
(n = 60), robust least squares as an SOCP with 100 SOC(3) blocks, and
the mcsdp max-cut relaxation (n = 25).  Statuses equal, x within 1e-6
(the SDP's within 1e-4: its optimum near a degenerate face is less
sharply determined than its value, which agrees within 1e-6), and each
JAX test's own checks."""

import numpy as np
import torch

from cvxopt_tpu import solvers as jsolvers
from cvxopt_tpu_torch import solvers as tsolvers
from cvxopt_tpu_torch.cones import ConeDims
from test_benchmark_configs import markowitz, robls_socp

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def test_markowitz_portfolio():
    S, pbar, G, h, A, b = markowitz(60)
    sol = tsolvers.coneqp(S, -pbar, G, h, A=A, b=b, device="cpu")
    ref = jsolvers.coneqp(S, -pbar, G, h, A=A, b=b)
    assert sol["status"] == ref["status"] == "optimal"
    assert sol["iterations"] == ref["iterations"]
    x = sol["x"].numpy()
    np.testing.assert_allclose(x, np.asarray(ref["x"]), atol=1e-6)
    assert abs(x.sum() - 1.0) < 1e-7 and x.min() > -1e-8


def test_robls_socp_100_blocks():
    m, n, rho = 100, 20, 0.1
    c, G, h, dims, A, b = robls_socp(m, n, rho)
    tdims = ConeDims(q=(3,) * m)
    assert len(tdims.q_runs) == 1          # one run of equal blocks
    sol = tsolvers.conelp(c, G, h, dims=dims.as_dict(), device="cpu")
    ref = jsolvers.conelp(c, G, h, dims=dims.as_dict())
    assert sol["status"] == ref["status"] == "optimal"
    xs = sol["x"].numpy()
    np.testing.assert_allclose(xs, np.asarray(ref["x"]), atol=1e-6)
    x = xs[:n]
    r = A @ x - b
    assert np.abs(A.T @ (r / np.sqrt(rho + r * r))).max() < 5e-3
    obj = np.sqrt(rho + r * r).sum()
    assert abs(sol["primal objective"] - obj) < 1e-4 * obj


def test_mcsdp():
    n = 25
    rng = np.random.default_rng(0)
    w = rng.standard_normal((n, n))
    w = (w + w.T) / 2.0
    G = np.zeros((n * n, n))
    for i in range(n):
        G[i * n + i, i] = -1.0
    dims = {"l": 0, "q": [], "s": [n]}
    sol = tsolvers.conelp(np.ones(n), G, w.reshape(-1), dims=dims,
                          device="cpu")
    ref = jsolvers.conelp(np.ones(n), G, w.reshape(-1), dims=dims)
    assert sol["status"] == ref["status"] == "optimal"
    x = sol["x"].numpy()
    np.testing.assert_allclose(x, np.asarray(ref["x"]), atol=1e-4)
    assert abs(sol["primal objective"] - ref["primal objective"]) <= \
        1e-6 * abs(ref["primal objective"])
    z = sol["z"].numpy().reshape(n, n)
    np.testing.assert_allclose(np.diag(z), np.ones(n), atol=1e-5)
    assert np.linalg.eigvalsh(w + np.diag(x)).min() > -1e-6

"""The port's progressive-precision cascades and rescue mode against the
JAX package's, on the cases of tests/test_cascade.py that no other port
test twins: infeasibility detection in the cone-LP cascade, the
per-instance f64 rescue in a mixed batch, and the SOC cascade staying
mixed (no instance reaches phase C) at the JAX test's size.  On the CPU,
in float64 inputs; statuses equal, x within the tolerances stated."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu.coneqp import make_coneqp as jmake_coneqp, \
    make_coneqp_cascade as jqp_cascade
from cvxopt_tpu.conelp import make_conelp_cascade as jlp_cascade
from cvxopt_tpu_torch.cones import ConeDims as TDims
from cvxopt_tpu_torch.coneqp import make_coneqp, make_coneqp_cascade
from cvxopt_tpu_torch.conelp import make_conelp_cascade

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

TOLS = dict(abstol=1e-7, reltol=1e-7, feastol=1e-7)


def test_conelp_cascade_detects_infeasible():
    """x <= -1 and x >= 1: every instance primal infeasible (status 1)."""
    G = np.array([[1.0], [-1.0]])
    h = np.array([-1.0, -1.0])
    c = np.ones((4, 1))
    A, b = np.zeros((0, 1)), np.zeros(0)
    out = make_conelp_cascade(TDims(l=2), device="cpu", **TOLS)(
        c, G, h, A, b)
    ref = jlp_cascade(JDims(l=2), **TOLS)(
        *map(jnp.asarray, (c, G, h, A, b)))
    np.testing.assert_array_equal(out["status"].numpy(),
                                  np.asarray(ref["status"]))
    assert (out["status"].numpy() == 1).all()


def test_rescue_engages_per_instance_in_mixed_batch():
    """Five well-conditioned QPs and a near-degenerate one (instance 3)
    through make_coneqp with an f32 phase and the per-instance f64
    rescue: every instance meets the 1e-7 contract, equal to the JAX
    package's statuses and within 1e-6 of its x, and within 1e-5 of the
    pure-f64 solve."""
    n, nb = 16, 6
    rng = np.random.default_rng(3)
    I = np.eye(n)
    G = np.concatenate([-I, I], 0)
    h = np.tile(np.concatenate([np.zeros(n), np.ones(n)]), (nb, 1))
    A, b = np.ones((1, n)), np.ones(1)
    P = np.zeros((nb, n, n))
    q = np.zeros((nb, n))
    for i in range(nb):
        F = rng.standard_normal((n, n // 4)) / np.sqrt(n)
        P[i] = F @ F.T + 0.1 * I
        q[i] = -rng.uniform(0, 0.1, n)
    P[3] = 1e-6 * np.eye(n)
    q[3] = -np.ones(n) * 0.5
    kw = dict(kktsolver="chol2_inv", maxiters=60, refinement=1,
              factor_dtype="rescue", **TOLS)
    out = make_coneqp(TDims(l=2 * n), device="cpu", **kw)(P, q, G, h, A, b)
    jcore = jmake_coneqp(JDims(l=2 * n), **kw)
    ref = jax.vmap(lambda Pk, qk, hk: jcore(
        Pk, qk, jnp.asarray(G), hk, jnp.asarray(A), jnp.asarray(b)))(
        *map(jnp.asarray, (P, q, h)))
    st = out["status"].numpy()
    np.testing.assert_array_equal(st, np.asarray(ref["status"]))
    assert (st == 0).all()
    assert float(out["pres"].max()) <= 1e-7
    assert float(out["dres"].max()) <= 1e-7
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-6)
    f64 = make_coneqp(TDims(l=2 * n), kktsolver="chol2", maxiters=60,
                      device="cpu", **TOLS)(P, q, G, h, A, b)
    np.testing.assert_allclose(out["x"].numpy(), f64["x"].numpy(),
                               atol=1e-5)


def test_coneqp_cascade_soc_stays_mixed():
    """The JAX test's SOC batch (8 x n = 32, 20 blocks of 4, seed 1):
    phase B's f32 'cholqr_inv' solves every instance, so no instance
    reaches the f64 rescue, in both packages."""
    nb, n, nq, mq = 8, 32, 20, 4
    m = nq * mq
    rng = np.random.default_rng(1)
    P = np.zeros((nb, n, n))
    q = np.zeros((nb, n))
    G = np.zeros((nb, m, n))
    h = np.zeros((nb, m))
    for i in range(nb):
        F = rng.standard_normal((n, n // 4)) / np.sqrt(n)
        P[i] = F @ F.T + 0.1 * np.eye(n)
        q[i] = -rng.uniform(0, .1, n)
        G[i] = 0.3 * rng.standard_normal((m, n))
        hh = (0.1 * rng.standard_normal(m)).reshape(nq, mq)
        hh[:, 0] = 1.0
        h[i] = hh.reshape(-1)
    data = (P, q, G, h, np.zeros((nb, 0, n)), np.zeros((nb, 0)))
    kw = dict(kktsolver="chol2_inv", maxiters=50, shared_GhAb=False,
              **TOLS)
    out = make_coneqp_cascade(TDims(q=(mq,) * nq), device="cpu", **kw)(
        *data)
    ref = jqp_cascade(JDims(q=(mq,) * nq), **kw)(*map(jnp.asarray, data))
    assert (out["status"].numpy() == 0).all()
    assert (np.asarray(ref["status"]) == 0).all()
    assert float(out["gap"].max()) <= 1e-7 * 1.01
    assert max(float(out["pres"].max()), float(out["dres"].max())) <= 1e-7
    assert int(out["rescue_iterations"].sum()) == 0
    assert int(jnp.sum(ref["rescue_iterations"])) == 0
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-6)

"""The port's coneqp (cvxopt_tpu_torch) against the single-core numpy
golden reference cvxopt_tpu/_npref.py (`coneqp_np`, `coneqp_np_cones`):
same algorithm, independent implementations — twins of
tests/test_npref_golden.py, with the JAX package's coneqp run on the
same inputs beside them.

The port and the golden reference run the same iterations, so their
solutions agree to 1e-7 (x, z and the objective); the iteration counts
are equal.  The mcsdp case compares the conelp optimum (P = 0) with the
coneqp reference's, as the JAX test does."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cvxopt_tpu import solvers as jsolvers
from cvxopt_tpu._npref import coneqp_np, coneqp_np_cones
from cvxopt_tpu.coneqp import make_coneqp as jmake_coneqp
from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu_torch import solvers as tsolvers
from cvxopt_tpu_torch.cones import ConeDims as TDims
from cvxopt_tpu_torch.coneqp import make_coneqp

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

TOL = 1e-7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coneqp_matches_npref(seed):
    rng = np.random.default_rng(seed)
    n, m, p = 15, 30, 2
    F = rng.standard_normal((n, n))
    P = F @ F.T + np.eye(n)
    q = rng.standard_normal(n)
    G = np.concatenate([-np.eye(n), rng.standard_normal((m - n, n))])
    h = np.concatenate([np.zeros(n), rng.uniform(1, 2, m - n)])
    A = rng.standard_normal((p, n))
    b = rng.standard_normal(p) * 0.1
    ref = coneqp_np(P, q, G, h, A, b)
    sol = tsolvers.coneqp(P, q, G, h, A=A, b=b, device="cpu")
    jsol = jsolvers.coneqp(P, q, G, h, A=A, b=b)
    assert ref["status"] == sol["status"] == jsol["status"] == "optimal"
    assert sol["iterations"] == ref["iterations"]
    for k in ("x", "z"):
        np.testing.assert_allclose(sol[k].numpy(), ref[k], atol=TOL,
                                   err_msg=k)
        np.testing.assert_allclose(sol[k].numpy(), np.asarray(jsol[k]),
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("seed", [0, 3])
def test_coneqp_cones_matches_npref_soc(seed):
    rng = np.random.default_rng(seed)
    n, nq, mq = 24, 8, 4
    m = nq * mq
    F = rng.standard_normal((n, 8)) / np.sqrt(n)
    P = F @ F.T + 0.1 * np.eye(n)
    q = -rng.uniform(0, .1, n)
    G = 0.3 * rng.standard_normal((m, n))
    hh = (0.1 * rng.standard_normal(m)).reshape(nq, mq)
    hh[:, 0] = 1.0
    h = hh.reshape(-1)
    A, b = np.ones((1, n)), np.ones(1)
    tol = dict(abstol=1e-7, reltol=1e-7, feastol=1e-7)
    ref = coneqp_np_cones(P, q, G, h, {"q": [mq] * nq}, A, b, **tol)
    dims = {"l": 0, "q": [mq] * nq, "s": []}
    sol = tsolvers.coneqp(P, q, G, h, dims=dims, A=A, b=b, options=tol,
                          device="cpu")
    assert ref["status"] == sol["status"] == "optimal"
    np.testing.assert_allclose(sol["x"].numpy(), ref["x"], atol=TOL)
    pref = 0.5 * ref["x"] @ P @ ref["x"] + q @ ref["x"]
    assert abs(sol["primal objective"] - pref) <= TOL


def test_coneqp_cones_matches_npref_sdp():
    """mcsdp (m = 10): the port's conelp optimum against the coneqp
    reference with P = 0; the objective within 1e-7 relative, x loosely
    (an SDP optimum near a degenerate face is less sharply determined
    than its value)."""
    rng = np.random.default_rng(7)
    m = 10
    w = rng.standard_normal((m, m))
    w = (w + w.T) / np.sqrt(m)
    G = np.zeros((m * m, m))
    for j in range(m):
        G[j * m + j, j] = -1.0
    ref = coneqp_np_cones(np.zeros((m, m)), np.ones(m), G, w.reshape(-1),
                          {"s": [m]}, abstol=1e-7, reltol=1e-6,
                          feastol=1e-7)
    sol = tsolvers.conelp(np.ones(m), G, w.reshape(-1),
                          dims={"l": 0, "q": [], "s": [m]}, device="cpu")
    assert ref["status"] == sol["status"] == "optimal"
    x = sol["x"].numpy()
    assert abs(x.sum() - ref["x"].sum()) <= 1e-5 * abs(ref["x"].sum())
    np.testing.assert_allclose(x, ref["x"], atol=2e-3)


CONFIGS = [dict(l=3, q=(3, 4), s=()), dict(l=0, q=(5,), s=(3,)),
           dict(l=4, q=(), s=(2, 3)), dict(l=2, q=(3, 3, 3), s=(2,))]


def _fuzz_instance(rng, cfg, n=6):
    """tests/test_npref_golden.py's generator: P = F F' + I/2, G with
    symmetric 's' blocks, h = G x0 + s0 with s0 interior."""
    m = TDims(**cfg).cdim
    F = rng.standard_normal((n, n)) / np.sqrt(n)
    P = F @ F.T + 0.5 * np.eye(n)
    qv = 0.3 * rng.standard_normal(n)
    G = 0.4 * rng.standard_normal((m, n))
    soff = cfg["l"] + sum(cfg["q"])
    for ms in cfg["s"]:
        blk = G[soff:soff + ms * ms, :].reshape(ms, ms, n)
        G[soff:soff + ms * ms, :] = (
            0.5 * (blk + blk.transpose(1, 0, 2))).reshape(ms * ms, n)
        soff += ms * ms
    x0 = 0.1 * rng.standard_normal(n)
    s0 = np.zeros(m)
    off = 0
    for _ in range(cfg["l"]):
        s0[off] = 1.0 + rng.uniform(0, 0.5)
        off += 1
    for mq in cfg["q"]:
        s0[off] = 2.0
        s0[off + 1:off + mq] = 0.2 * rng.standard_normal(mq - 1)
        off += mq
    for ms in cfg["s"]:
        E = 0.2 * rng.standard_normal((ms, ms))
        s0[off:off + ms * ms] = (E @ E.T + np.eye(ms)).reshape(-1)
        off += ms * ms
    return P, qv, G, G @ x0 + s0


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_fuzz_random_cone_mixes_vs_golden(ci):
    """Random (l, q, s) cone mixes (the JAX test's configurations and
    generator, two instances each) through the batched make_coneqp at
    1e-7 tolerances: x within 1e-7 of the golden reference where it
    certifies the instance, and of the JAX core."""
    cfg = CONFIGS[ci]
    rng = np.random.default_rng(20260821 + ci)
    insts = [_fuzz_instance(rng, cfg) for _ in range(2)]
    tol = dict(abstol=1e-7, reltol=1e-7, feastol=1e-7)
    dref = {"l": cfg["l"], "q": list(cfg["q"]), "s": list(cfg["s"])}
    refs = [coneqp_np_cones(*inst, dref, **tol) for inst in insts]
    P, q, G, h = (np.stack(u) for u in zip(*insts))
    n = q.shape[1]
    A, b = np.zeros((0, n)), np.zeros(0)
    out = make_coneqp(TDims(**cfg), maxiters=60, device="cpu", **tol)(
        P, q, G, h, A, b)
    jcore = jmake_coneqp(JDims(**cfg), maxiters=60, **tol)
    compared = 0
    for k, ref in enumerate(refs):
        jout = jcore(*map(jnp.asarray, (P[k], q[k], G[k], h[k], A, b)))
        assert int(out["status"][k]) == int(jout["status"]) == 0
        x = out["x"][k].numpy()
        np.testing.assert_allclose(x, np.asarray(jout["x"]), atol=TOL)
        if ref["status"] != "optimal":
            continue
        compared += 1
        np.testing.assert_allclose(x, ref["x"], atol=TOL)
        xr = ref["x"]
        pref = 0.5 * xr @ P[k] @ xr + q[k] @ xr
        assert abs(float(out["pcost"][k]) - pref) <= TOL
    assert compared >= 1

"""The port's batched cone-QP solver (cvxopt_tpu_torch/coneqp.py) against
cvxopt_tpu/coneqp.py on the CPU, on the same seeded numpy problems:

  - make_coneqp in float64 on __graft_entry__'s problem (B=4, n=8) and on
    bench.py's scenario QPs (B=4, n=64): equal statuses and iterations,
    iterates within 1e-7 * max(1, |.|);
  - the precision cascade (B=8, n=64): all optimal in both, x within
    1e-6, iterations within +-1 (phase A runs in f32, whose sums are
    taken in another order);
  - phase B warm-started from the JAX package's phase-A iterates: equal
    phase-B iterations;
  - a singular instance: status 4 in both, its neighbour optimal;
  - the single-problem `coneqp`, and 'q'/'s' cones through the loop."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu.coneqp import make_coneqp as jmake, \
    make_coneqp_cascade as jcascade
from cvxopt_tpu_torch import convert
from cvxopt_tpu_torch.coneqp import make_coneqp, make_coneqp_cascade, \
    coneqp

TOLS = dict(abstol=1e-7, reltol=1e-7, feastol=1e-7)


def entry_batch(nb, n):
    """__graft_entry__._qp_batch: x >= 0, sum x = 1, per-instance G."""
    rng = np.random.default_rng(0)
    F = rng.standard_normal((nb, n, n))
    P = F @ F.transpose(0, 2, 1) + np.eye(n)
    q = rng.standard_normal((nb, n))
    G = np.broadcast_to(-np.eye(n), (nb, n, n)).copy()
    h = np.zeros((nb, n))
    A = np.broadcast_to(np.ones((1, n)), (nb, 1, n)).copy()
    b = np.ones((nb, 1))
    return P, q, G, h, A, b


def scenario_batch(nb, n, seed=0):
    """bench.py make_batch with shared G/h/A/b: 0 <= x <= 1, sum x = 1."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((nb, n, n // 4)) / np.sqrt(n)
    P = F @ F.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = -rng.uniform(0.0, 0.1, (nb, n))
    eye = np.eye(n)
    G = np.concatenate([-eye, eye], axis=0)
    h = np.concatenate([np.zeros(n), np.ones(n)])
    return P, q, G, h, np.ones((1, n)), np.ones(1)


def _jax_batched(core, data, shared):
    axes = (0, 0, None, None, None, None) if shared else 0
    return jax.vmap(core, in_axes=axes)(*map(jnp.asarray, data))


def _port(data):
    return convert.problem_from_numpy(*data, device="cpu")


def _assert_iterates(out, ref):
    for k in ("x", "y", "s", "z"):
        v = np.asarray(ref[k])
        tol = 1e-7 * max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(out[k].numpy(), v, atol=tol, err_msg=k)


@pytest.mark.parametrize("case", ["entry", "scenario"])
def test_make_coneqp_matches_jax_f64(case):
    if case == "entry":
        data, n, shared = entry_batch(4, 8), 8, False
        dims, kw = (8,), dict(maxiters=30, abstol=1e-4, reltol=1e-4,
                              feastol=1e-4)
    else:
        data, n, shared = scenario_batch(4, 64), 64, True
        dims, kw = (128,), TOLS
    ref = _jax_batched(jmake(JDims(l=dims[0]), **kw), data, shared)
    out = make_coneqp(convert.dims_from(JDims(l=dims[0])), device="cpu",
                      **kw)(*_port(data))
    np.testing.assert_array_equal(out["status"].numpy(),
                                  np.asarray(ref["status"]))
    np.testing.assert_array_equal(out["iterations"].numpy(),
                                  np.asarray(ref["iterations"]))
    _assert_iterates(out, ref)


@pytest.fixture(scope="module")
def cascade_runs():
    """The JAX cascade and its phase A (make_coneqp on the f32 data with
    the cascade's phase-A settings), and the port's cascade."""
    n, nb = 64, 8
    data = scenario_batch(nb, n)
    jd = JDims(l=2 * n)
    kw = dict(kktsolver="chol2_inv", maxiters=50, **TOLS)
    jout = jcascade(jd, **kw)(*map(jnp.asarray, data))
    pa = jmake(jd, kktsolver="chol2_inv", maxiters=50, abstol=1e-4,
               reltol=1e-4, feastol=1e-4, refinement=0)
    ja = _jax_batched(pa, [u.astype(np.float32) for u in data], True)
    solve = make_coneqp_cascade(convert.dims_from(jd), device="cpu", **kw)
    tout = solve(*_port(data))
    return dict(data=data, jout=jout, ja=ja, solve=solve, tout=tout)


def test_cascade_matches_jax(cascade_runs):
    j, t = cascade_runs["jout"], cascade_runs["tout"]
    assert (np.asarray(j["status"]) == 0).all()
    assert (t["status"].numpy() == 0).all()
    assert float(t["gap"].max()) <= 1e-7
    dx = np.abs(t["x"].numpy() - np.asarray(j["x"])).max()
    assert dx <= 1e-6
    di = t["iterations"].numpy() - np.asarray(j["iterations"])
    assert np.abs(di).max() <= 1
    assert (t["rescue_iterations"].numpy() == 0).all()


def test_phase_b_from_jax_phase_a(cascade_runs):
    """Phase B of the port, warm-started from the JAX package's phase-A
    iterates, takes exactly the JAX phase B's iterations."""
    j, ja = cascade_runs["jout"], cascade_runs["ja"]
    # the replayed phase A is the cascade's own
    np.testing.assert_array_equal(np.asarray(ja["iterations"]),
                                  np.asarray(j["phase1_iterations"]))
    jb_iters = (np.asarray(j["iterations"]) - np.asarray(ja["iterations"])
                - np.asarray(j["rescue_iterations"]))
    iv = {k: np.asarray(ja[k]).astype(np.float64)
          for k in ("x", "y", "s", "z")}
    iv["_valid"] = np.asarray(ja["status"]) == 0
    data = _port(cascade_runs["data"])
    out = cascade_runs["solve"].phase_b(
        *data, convert.initvals_from_numpy(iv, device="cpu"))
    np.testing.assert_array_equal(out["iterations"].numpy(), jb_iters)
    assert (out["status"].numpy() == 0).all()


def test_singular_instance_status_4():
    """P = 0 with a zero column of G: the first KKT factor is singular
    (NaN) and the instance exits with status 4; its neighbour solves."""
    n = 8
    P = np.zeros((2, n, n))
    P[1] = np.eye(n)
    q = np.ones((2, n))
    G = -np.eye(n)
    G[:, -1] = 0.0
    h = np.zeros(n)
    A, b = np.ones((1, n)), np.ones(1)
    data = (P, q, G, h, A, b)
    ref = _jax_batched(jmake(JDims(l=n), kktsolver="chol2"), data, True)
    out = make_coneqp(convert.dims_from(JDims(l=n)), kktsolver="chol2",
                      device="cpu")(*_port(data))
    assert np.asarray(ref["status"]).tolist() == [4, 0]
    assert out["status"].tolist() == [4, 0]


def test_coneqp_front_door_matches_jax():
    """The single-problem `coneqp` (reference result dict)."""
    from cvxopt_tpu.coneqp import coneqp as jconeqp
    P, q, G, h, A, b = scenario_batch(1, 16, seed=3)
    ref = jconeqp(P[0], q[0], G, h, A=A, b=b)
    out = coneqp(P[0], q[0], G, h, A=A, b=b, device="cpu")
    assert out["status"] == ref["status"] == "optimal"
    assert out["iterations"] == ref["iterations"]
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-9)
    np.testing.assert_allclose(out["primal objective"],
                               ref["primal objective"], rtol=1e-9)


def test_make_coneqp_qs_cones_matches_jax():
    """'q' and 's' cones through the solver loop (the 's' update branch)
    with the 'chol2' strategy: x >= 0, ||x|| <= 1 and
    [[1 + x1, x2], [x2, 1 + x3]] PSD."""
    n = 3
    dims = dict(l=3, q=(4,), s=(2,))
    G = np.concatenate([-np.eye(n),
                        np.vstack([np.zeros((1, n)), -np.eye(n)]),
                        np.array([[-1.0, 0, 0], [0, -1, 0], [0, -1, 0],
                                  [0, 0, -1]])])
    h = np.concatenate([np.zeros(n), [1.0, 0, 0, 0], [1.0, 0, 0, 1]])
    rng = np.random.default_rng(8)
    F = rng.standard_normal((2, n, n))
    P = F @ F.transpose(0, 2, 1) + np.eye(n)
    q = rng.standard_normal((2, n)) * 3
    A, b = np.zeros((0, n)), np.zeros(0)
    data = (P, q, G, h, A, b)
    ref = _jax_batched(jmake(JDims(**dims), kktsolver="chol2"), data, True)
    out = make_coneqp(convert.dims_from(JDims(**dims)), kktsolver="chol2",
                      device="cpu")(*_port(data))
    np.testing.assert_array_equal(out["status"].numpy(),
                                  np.asarray(ref["status"]))
    assert (out["status"].numpy() == 0).all()
    np.testing.assert_array_equal(out["iterations"].numpy(),
                                  np.asarray(ref["iterations"]))
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-7)
    np.testing.assert_allclose(out["s"].numpy(), np.asarray(ref["s"]),
                               atol=1e-7)


def test_make_coneqp_rescue_mode_matches_jax():
    """factor_dtype='rescue': an f32 factor with f64 refinement, and an
    in-loop f64 restart for the instances it cannot finish."""
    data = scenario_batch(4, 64, seed=5)
    kw = dict(factor_dtype="rescue", refinement=1, **TOLS)
    ref = _jax_batched(jmake(JDims(l=128), **kw), data, True)
    out = make_coneqp(convert.dims_from(JDims(l=128)), device="cpu",
                      **kw)(*_port(data))
    np.testing.assert_array_equal(out["status"].numpy(),
                                  np.asarray(ref["status"]))
    di = out["iterations"].numpy() - np.asarray(ref["iterations"])
    assert np.abs(di).max() <= 1
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-6)


@pytest.mark.parametrize("build", [
    lambda dims: make_coneqp(dims, factor_dtype="rescue", device="cpu"),
    lambda dims: make_coneqp_cascade(dims, device="cpu"),
])
def test_qs_cones_refuse_cholqr_modes_up_front(build):
    """The rescue mode and the cascade factor 'q'/'s' cones with
    'cholqr', which is not ported: they refuse when built."""
    with pytest.raises(NotImplementedError, match="cholqr"):
        build(convert.dims_from(JDims(l=3, q=(4,), s=(2,))))


def test_coneqp_warm_start_matches_jax():
    """`initvals` warm start through the single-problem `coneqp`."""
    from cvxopt_tpu.coneqp import coneqp as jconeqp
    P, q, G, h, A, b = scenario_batch(1, 16, seed=4)
    cold = jconeqp(P[0], q[0], G, h, A=A, b=b)
    iv = {k: 0.5 * np.asarray(cold[k]) + 0.5 * v for k, v in
          (("x", np.full(16, 1 / 16)), ("y", np.zeros(1)),
           ("s", np.ones(32)), ("z", np.ones(32)))}
    ref = jconeqp(P[0], q[0], G, h, A=A, b=b, initvals=iv)
    out = coneqp(P[0], q[0], G, h, A=A, b=b, initvals=iv, device="cpu")
    assert out["status"] == ref["status"] == "optimal"
    assert out["iterations"] == ref["iterations"]
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-9)
    with pytest.raises(ValueError):
        coneqp(P[0], q[0], G, h, A=A, b=b, device="cpu",
               initvals={"s": -np.ones(32)})

"""The port's cone-sharded coneqp (cvxopt_tpu_torch/parallel/
conesolve.py) against cvxopt_tpu/parallel/conesolve.py: twins of
tests/test_conesolve.py on the same seeded problems, in float64, the
port on 2 and 4 spawned gloo ranks (and one rank without a group), JAX
under shard_map on as many virtual devices.  Solved x within 1e-7,
status and iterations equal, s/z within 1e-7."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P_

from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu.coneqp import make_coneqp as jmake_coneqp
from cvxopt_tpu.parallel import make_mesh as jmake_mesh
from cvxopt_tpu.parallel.conesolve import make_coneqp_sharded as jsharded
from cvxopt_tpu_torch.cones import ConeDims

from test_torch_mesh import run_world, rank_conesolve, assert_replicated

torch.set_num_threads(1)

X_TOL = 1e-7
TOLS = dict(maxiters=50, abstol=1e-7, reltol=1e-6, feastol=1e-7)
WEAK_BLOCKS = 4     # the weak-scaling problem's cone blocks


def _problem(nd, n=12, l=4, q=(3,), s=(), seed=0):
    """tests/test_conesolve.py's `_problem` for nd shards (rows laid out
    per shard), with optional 's' blocks: symmetric rows of G, the
    identity in h."""
    ldims = dict(l=l, q=q, s=s)
    mk = ConeDims(**ldims).cdim
    m = nd * mk
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, n)) / np.sqrt(n)
    P = F @ F.T + np.eye(n)
    qv = rng.standard_normal(n) * 0.1
    G = 0.3 * rng.standard_normal((m, n))
    h = 0.1 * rng.standard_normal(m)
    for k in range(nd):
        h[k * mk + l] = 1.0
        h[k * mk:k * mk + l] = 1.0 + np.abs(h[k * mk:k * mk + l])
        off = k * mk + l + sum(q)
        for ms in s:
            Gb = G[off:off + ms * ms].reshape(ms, ms, n)
            G[off:off + ms * ms] = (0.5 * (Gb + Gb.transpose(1, 0, 2))
                                    ).reshape(ms * ms, n)
            h[off:off + ms * ms] = np.eye(ms).ravel()
            off += ms * ms
    return ldims, P, qv, G, h


def _l_only(nd):
    """tests/test_conesolve.py:100-121's problem for nd shards."""
    rng = np.random.default_rng(3)
    n, m = 10, nd * 6
    F = rng.standard_normal((n, n)) / np.sqrt(n)
    P = F @ F.T + np.eye(n)
    qv = rng.standard_normal(n) * 0.2
    G = rng.standard_normal((m, n)) * 0.4
    h = 1.0 + np.abs(rng.standard_normal(m))
    return dict(l=6), P, qv, G, h


def _with_equalities(nd):
    """tests/test_conesolve.py:124-156's problem for nd shards."""
    ldims, P, qv, G, h = _problem(nd, seed=5)
    rng = np.random.default_rng(11)
    A = rng.standard_normal((2, P.shape[0]))
    b = A @ (0.01 * rng.standard_normal(P.shape[0]))
    return ldims, P, qv, G, h, A, b


def _weak(nd):
    """tests/test_conesolve.py:159-178: one global problem of
    WEAK_BLOCKS (l, q) blocks, regrouped into nd shards whose rows are
    [all l; all q] within the shard."""
    ldims, P, qv, G, h = _problem(WEAK_BLOCKS, seed=7)
    rep, l, mk = WEAK_BLOCKS // nd, 4, 7
    order = []
    for j in range(nd):
        blocks = range(j * rep, (j + 1) * rep)
        order += [np.arange(k * mk, k * mk + l) for k in blocks]
        order += [np.arange(k * mk + l, (k + 1) * mk) for k in blocks]
    order = np.concatenate(order)
    return dict(l=l * rep, q=(3,) * rep), P, qv, G[order], h[order]


def _cases(nd):
    return dict(single=_problem(nd), l_only=_l_only(nd),
                equalities=_with_equalities(nd),
                psd=_problem(nd, n=8, l=2, q=(3,), s=(2,), seed=2),
                weak=_weak(nd))


def _jax(nd, ldims, P, q, G, h, A=None, b=None):
    mesh = jmake_mesh(nd, axis="cone")
    solve = jsharded(JDims(**ldims), mesh, axis="cone", **TOLS)
    rows = NamedSharding(mesh, P_("cone"))
    args = [jnp.asarray(P), jnp.asarray(q),
            jax.device_put(jnp.asarray(G), NamedSharding(mesh, P_("cone",
                                                                   None))),
            jax.device_put(jnp.asarray(h), rows)]
    if A is not None:
        args += [jnp.asarray(A), jnp.asarray(b)]
    return {k: np.asarray(v) for k, v in solve(*args).items()}


def _port_args(case):
    ldims, *arrays = case
    return (ConeDims(**ldims), *arrays)


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    nd = request.param
    cases = _cases(nd)
    res = run_world(rank_conesolve, nd, tmp_path_factory.mktemp("w"),
                    [_port_args(c) for c in cases.values()])
    return nd, cases, [dict(zip(cases, r)) for r in res]


def _agree(out, ref):
    assert int(out["status"]) == int(ref["status"]) == 0
    assert int(out["iterations"]) == int(ref["iterations"])
    for k in ("x", "y", "s", "z"):
        np.testing.assert_allclose(out[k], ref[k], atol=X_TOL, err_msg=k)
    assert float(out["pres"]) <= 1e-7 and float(out["dres"]) <= 1e-7


def _check(world, name):
    nd, cases, res = world
    assert_replicated([r[name] for r in res])
    _agree(res[0][name], _jax(nd, *cases[name]))
    return cases[name], res[0][name]


def test_sharded_coneqp_matches_single_device(world):
    """tests/test_conesolve.py:47-97: the sharded loop equals JAX's, and
    its s maps back to the single-device coneqp's."""
    nd = world[0]
    (ldims, P, q, G, h), out = _check(world, "single")
    perm = np.concatenate(
        [np.concatenate([np.arange(k * 7, k * 7 + 4) for k in range(nd)]),
         np.concatenate([np.arange(k * 7 + 4, (k + 1) * 7)
                         for k in range(nd)])])
    core = jmake_coneqp(JDims(l=4 * nd, q=(3,) * nd), **TOLS)
    ref = core(jnp.asarray(P), jnp.asarray(q), jnp.asarray(G[perm]),
               jnp.asarray(h[perm]), jnp.zeros((0, P.shape[0])),
               jnp.zeros((0,)))
    np.testing.assert_allclose(out["x"], np.asarray(ref["x"]), atol=5e-6)
    np.testing.assert_allclose(out["s"][perm], np.asarray(ref["s"]),
                               atol=5e-5)


def test_sharded_coneqp_l_only(world):
    """tests/test_conesolve.py:100-121, and P x + q + G'z = 0."""
    (_, P, q, G, _), out = _check(world, "l_only")
    assert np.linalg.norm(P @ out["x"] + q + G.T @ out["z"]) < 1e-6


def test_sharded_coneqp_with_equalities(world):
    """tests/test_conesolve.py:124-156: A x = b through the replicated
    saddle elimination."""
    (_, _, _, _, _, A, b), out = _check(world, "equalities")
    np.testing.assert_allclose(A @ out["x"], b, atol=1e-7)


def test_sharded_coneqp_psd_blocks(world):
    """An 's' block per shard: the loop's eigenvector rescaling of the
    'PSD' part of the step (conesolve.py:200-216)."""
    _check(world, "psd")


@pytest.fixture(scope="module")
def jax_weak_iterations():
    """JAX's iteration counts on the weak-scaling problem on 1, 2 and 4
    devices."""
    return {int(_jax(k, *_weak(k))["iterations"]) for k in (1, 2, 4)}


def test_sharded_coneqp_weak_scaling_iterations(world, jax_weak_iterations):
    """tests/test_conesolve.py:159-178: the same global problem sharded
    over 2 and 4 ranks takes the iterations JAX takes on 1, 2 and 4
    devices (which are one count)."""
    _, _, res = world
    _check(world, "weak")
    assert jax_weak_iterations == {int(res[0]["weak"]["iterations"])}

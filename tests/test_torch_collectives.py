"""The port's collectives (cvxopt_tpu_torch/parallel/collectives.py) on
2 and 4 spawned gloo ranks against cvxopt_tpu/parallel/collectives.py
under shard_map on as many virtual devices, on the same seeded numpy
shards: the cone-aware reductions of tests/test_collectives.py and the
plain ones (psum, pmax, pmin, pnorm2, pdot, all_gather, ppermute_ring).
Reductions sum in another order than XLA: within 1e-12 relative;
gathers and permutations are exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:                      # older jax
    from jax.experimental.shard_map import shard_map

from cvxopt_tpu import cones as jc
from cvxopt_tpu.parallel import collectives as jcoll
from cvxopt_tpu_torch.cones import ConeDims

from test_torch_mesh import run_world, rank_collectives, assert_replicated

torch.set_num_threads(1)

LDIMS = dict(l=4, q=(3, 3), s=(2,))    # tests/test_collectives.py's shard
TOL = 1e-12


def _interior(dims, rng):
    """tests/test_collectives.py's interior shard vectors."""
    x = rng.standard_normal(dims.cdim) * 0.1
    e = np.asarray(jc.cone_identity(dims))
    t = float(jc.max_step(jnp.asarray(x), dims))
    return np.asarray(jc.symmetrize(jnp.asarray(x + (t + 1.0) * e), dims))


def _data(nd):
    jd = jc.ConeDims(**LDIMS)
    rng = np.random.default_rng(0)
    xs = np.stack([_interior(jd, rng) for _ in range(nd)])
    ys = np.stack([_interior(jd, rng) for _ in range(nd)])
    v = rng.standard_normal((nd, 5))
    w = rng.standard_normal((nd, 5))
    return xs, ys, v, w


def _jax(nd, xs, ys, v, w):
    """The same collectives under shard_map on nd virtual devices."""
    jd = jc.ConeDims(**LDIMS)
    mesh = Mesh(np.array(jax.devices()[:nd]), ("shards",))
    ax = "shards"

    def f(x, y, a, b):
        x, y, a, b = x[0], y[0], a[0], b[0]
        rep = dict(
            psdot=jcoll.psdot(x, y, jd, ax), psnrm2=jcoll.psnrm2(x, jd, ax),
            pmax_step=jcoll.pmax_step(-x, jd, ax),
            pstep_length=jcoll.pstep_length(-x, -y, jd, ax),
            psum=jcoll.psum(a, ax), pmax=jcoll.pmax(a, ax),
            pmin=jcoll.pmin(a, ax), pnorm2=jcoll.pnorm2(a, ax),
            pdot=jcoll.pdot(a, b, ax))
        # each shard's copy of the gathers, stacked by shard
        per = dict(all_gather=jcoll.all_gather(a, ax),
                   all_gather_tiled=jcoll.all_gather(a, ax, tiled=True),
                   ring=jcoll.ppermute_ring(a, ax, nd),
                   ring_back=jcoll.ppermute_ring(a, ax, nd, shift=-1),
                   ring_part=jcoll.ppermute_ring(a, ax, nd - 1))
        return rep, {k: u[None] for k, u in per.items()}

    specs = {k: P() for k in ("psdot", "psnrm2", "pmax_step", "pstep_length",
                              "psum", "pmax", "pmin", "pnorm2", "pdot")}
    pspecs = {k: P(ax) for k in ("all_gather", "all_gather_tiled", "ring",
                                 "ring_back", "ring_part")}
    rep, per = jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P(ax),) * 4, out_specs=(specs, pspecs)))(
            *(jnp.asarray(u) for u in (xs, ys, v, w)))
    return ({k: np.asarray(u) for k, u in rep.items()},
            {k: np.asarray(u) for k, u in per.items()})


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    nd = request.param
    data = _data(nd)
    res = run_world(rank_collectives, nd, tmp_path_factory.mktemp("w"),
                    ConeDims(**LDIMS), *data)
    return nd, data, res


def test_sharded_cone_reductions_match(world):
    """tests/test_collectives.py: the block-sharded duality gap, norm,
    step and step length equal JAX's and the single-device cone
    functions' on the grouped vector."""
    nd, (xs, ys, v, w), res = world
    rep, _ = _jax(nd, xs, ys, v, w)
    assert_replicated(res, ["psdot", "psnrm2", "pmax_step",
                            "pstep_length"])
    jd = jc.ConeDims(**LDIMS)
    gd = jc.ConeDims(l=4 * nd, q=(3,) * (2 * nd), s=(2,) * nd)
    group = lambda a: np.concatenate([a[:, :4].ravel(), a[:, 4:10].ravel(),
                                      a[:, 10:].ravel()])
    xg, yg = jnp.asarray(group(xs)), jnp.asarray(group(ys))
    tref = max(float(jc.max_step(-xg, gd)), float(jc.max_step(-yg, gd)), 0)
    single = dict(psdot=float(jc.sdot(xg, yg, gd)),
                  psnrm2=float(jc.snrm2(xg, gd)),
                  pmax_step=float(jc.max_step(-xg, gd)),
                  pstep_length=1.0 if tref == 0 else min(1.0, 0.99 / tref))
    for k, ref in single.items():
        np.testing.assert_allclose(res[0][k], rep[k], rtol=TOL, err_msg=k)
        np.testing.assert_allclose(res[0][k], ref, rtol=TOL, err_msg=k)
    assert jd.cdim == xs.shape[1]


def test_plain_collectives_match(world):
    nd, data, res = world
    rep, per = _jax(nd, *data)
    assert_replicated(res, ["psum", "pmax", "pmin", "pnorm2", "pdot",
                            "all_gather", "all_gather_tiled"])
    for k in ("psum", "pnorm2", "pdot"):
        np.testing.assert_allclose(res[0][k], rep[k], rtol=TOL, err_msg=k)
    for k in ("pmax", "pmin"):
        np.testing.assert_array_equal(res[0][k], rep[k], k)
    for k in ("all_gather", "all_gather_tiled", "ring", "ring_back",
              "ring_part"):
        for r in range(nd):
            np.testing.assert_array_equal(res[r][k], per[k][r], k)

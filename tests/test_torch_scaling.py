"""The port's Nesterov-Todd scaling (cvxopt_tpu_torch/scaling.py) against
cvxopt_tpu/scaling.py in float64 on the same seeded numpy inputs, with
a batch of instances (vmapped on the JAX side), within 1e-12.

Eigenvectors of the 's' blocks are fixed only up to sign, so the 's'
parts of W are compared through r r' and rti rti'; the scale functions
are compared on one W (the JAX package's) handed to both."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cvxopt_tpu import scaling as js
from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu_torch import scaling as ts
from cvxopt_tpu_torch.cones import ConeDims as TDims

from test_torch_cones import _interior, _diag_interior

DIMS = dict(l=3, q=(4, 3), s=(3, 2))
JD, TD = JDims(**DIMS), TDims(**DIMS)
B = 2
TOL = 1e-12


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol,
                               atol=tol)


def _to_torch(W):
    return {k: ([torch.as_tensor(np.array(u)) for u in v]
                if isinstance(v, list) else torch.as_tensor(np.array(v)))
            for k, v in W.items()}


def _check_W(Wt, Wj):
    for k in ("d", "di"):
        _close(Wt[k], Wj[k])
    for u, v in zip(Wt["beta"] + Wt["v"], Wj["beta"] + Wj["v"]):
        _close(u, v)
    for key in ("r", "rti"):
        for u, v in zip(Wt[key], Wj[key]):
            v = np.asarray(v)
            _close(u @ u.transpose(-1, -2), v @ np.swapaxes(v, -1, -2),
                   1e-11)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    s = _interior(rng, JD, (B,))
    z = _interior(rng, JD, (B,))
    Wj, lj = jax.vmap(lambda a, b: js.compute_scaling(a, b, JD))(
        jnp.asarray(s), jnp.asarray(z))
    x = rng.standard_normal((B, JD.cdim))
    M = rng.standard_normal((B, JD.cdim, 4))
    lam = _diag_interior(rng, JD, (B,))
    return dict(s=s, z=z, Wj=Wj, lj=lj, x=x, M=M, lam=lam, rng=rng)


def test_identity_scaling():
    Wt = ts.identity_scaling(TD, dtype=torch.float64, batch=(B,))
    Wj = js.identity_scaling(JD, dtype=jnp.float64)
    for k in ("d", "di"):
        _close(Wt[k][0], Wj[k])
    for key in ("beta", "v", "r", "rti"):
        for u, v in zip(Wt[key], Wj[key]):
            _close(u[1], v)


def test_compute_scaling(data):
    Wt, lt = ts.compute_scaling(torch.as_tensor(data["s"]),
                                torch.as_tensor(data["z"]), TD)
    _close(lt, data["lj"])
    _check_W(Wt, data["Wj"])


@pytest.mark.parametrize("trans,inverse", [("N", "N"), ("T", "N"),
                                           ("N", "I"), ("T", "I")])
def test_scale(data, trans, inverse):
    Wt = _to_torch(data["Wj"])
    t = ts.scale(torch.as_tensor(data["x"]), Wt, TD, trans=trans,
                 inverse=inverse)
    j = jax.vmap(lambda x, W: js.scale(x, W, JD, trans=trans,
                                       inverse=inverse))(
        jnp.asarray(data["x"]), data["Wj"])
    _close(t, j)


def test_scale_w2inv_and_rows(data):
    Wt = _to_torch(data["Wj"])
    _close(ts.scale_w2inv(torch.as_tensor(data["x"]), Wt, TD),
           jax.vmap(lambda x, W: js.scale_w2inv(x, W, JD))(
               jnp.asarray(data["x"]), data["Wj"]))
    _close(ts.scale_rows(torch.as_tensor(data["M"]), Wt, TD, trans="T",
                         inverse="I"),
           jax.vmap(lambda M, W: js.scale_rows(M, W, JD, trans="T",
                                               inverse="I"))(
               jnp.asarray(data["M"]), data["Wj"]))


@pytest.mark.parametrize("inverse", ["N", "I"])
def test_scale2(data, inverse):
    t = ts.scale2(torch.as_tensor(data["lam"]), torch.as_tensor(data["x"]),
                  TD, inverse=inverse)
    j = js.scale2(jnp.asarray(data["lam"]), jnp.asarray(data["x"]), JD,
                  inverse=inverse)
    _close(t, j)


def test_update_scaling(data):
    """New iterates in the current scaling: interior 'l'/'q' parts,
    square (nonsingular) factors in the 's' parts."""
    rng = data["rng"]
    s_new = _interior(rng, JD, (B,))
    z_new = _interior(rng, JD, (B,))
    for run in TD.s_runs:
        off, _, cnt, m = run
        for v in (s_new, z_new):
            v[:, off:off + cnt * m * m] = (
                rng.standard_normal((B, cnt, m, m))
                + 3 * np.eye(m)).reshape(B, -1)
    Wj, lj = jax.vmap(lambda W, l_, a, b: js.update_scaling(
        W, l_, a, b, JD))(data["Wj"], data["lj"], jnp.asarray(s_new),
                          jnp.asarray(z_new))
    Wt, lt = ts.update_scaling(_to_torch(data["Wj"]),
                               torch.as_tensor(np.array(data["lj"])),
                               torch.as_tensor(s_new),
                               torch.as_tensor(z_new), TD)
    _close(lt, lj, 1e-11)
    _check_W(Wt, Wj)

"""The port's cone algebra (cvxopt_tpu_torch/cones.py) against
cvxopt_tpu/cones.py in float64 on the same seeded numpy inputs, with a
leading batch axis, within 1e-12."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cvxopt_tpu import cones as jc
from cvxopt_tpu_torch import cones as tc

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

DIMS = dict(l=3, q=(4, 4, 3), s=(3, 3, 2))
JD, TD = jc.ConeDims(**DIMS), tc.ConeDims(**DIMS)
B = 3
TOL = 1e-12


def _interior(rng, dims, batch):
    """Strictly interior cone vectors in full storage."""
    parts = [rng.uniform(0.5, 2.0, batch + (dims.l,))]
    for m in dims.q:
        v = rng.standard_normal(batch + (m,))
        v[..., 0] = np.linalg.norm(v[..., 1:], axis=-1) + \
            rng.uniform(0.5, 1.5, batch)
        parts.append(v)
    for m in dims.s:
        F = rng.standard_normal(batch + (m, m))
        parts.append((F @ np.swapaxes(F, -1, -2)
                      + m * np.eye(m)).reshape(batch + (-1,)))
    return np.concatenate(parts, axis=-1)


def _diag_interior(rng, dims, batch):
    """Interior vectors in diagonal storage (like lambda)."""
    parts = [rng.uniform(0.5, 2.0, batch + (dims.l,))]
    for m in dims.q:
        v = rng.standard_normal(batch + (m,)) * 0.3
        v[..., 0] = np.linalg.norm(v[..., 1:], axis=-1) + 1.0
        parts.append(v)
    for m in dims.s:
        parts.append(rng.uniform(0.5, 2.0, batch + (m,)))
    return np.concatenate(parts, axis=-1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, JD.cdim))
    y = rng.standard_normal((B, JD.cdim))
    lam = _diag_interior(rng, JD, (B,))
    s = _interior(rng, JD, (B,))
    return dict(x=x, y=y, lam=lam, s=s)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol,
                               atol=tol)


def test_conedims_sizes_and_runs():
    for k in ("lnl", "qdim", "sdim_full", "sdim_packed", "sdim_diag",
              "cdim", "cdim_packed", "cdim_diag", "offq", "offs",
              "q_runs", "s_runs"):
        assert getattr(TD, k) == getattr(JD, k), k
    assert TD.as_dict() == JD.as_dict()
    assert tc.ConeDims.from_dict(JD.as_dict()) == TD


@pytest.mark.parametrize("name", ["sdot", "sprod"])
def test_binary(data, name):
    t = getattr(tc, name)(torch.as_tensor(data["x"]),
                          torch.as_tensor(data["y"]), TD)
    j = getattr(jc, name)(jnp.asarray(data["x"]), jnp.asarray(data["y"]),
                          JD)
    _close(t, j)


@pytest.mark.parametrize("name", ["sprod_diag", "sinv"])
def test_with_lambda(data, name):
    t = getattr(tc, name)(torch.as_tensor(data["x"]),
                          torch.as_tensor(data["lam"]), TD)
    j = getattr(jc, name)(jnp.asarray(data["x"]), jnp.asarray(data["lam"]),
                          JD)
    _close(t, j)


@pytest.mark.parametrize("name,arg", [
    ("snrm2", "x"), ("symmetrize", "x"), ("symmetrize_lower", "x"),
    ("pack", "x"), ("diag_part", "x"), ("max_step", "x"),
    ("max_step", "s"), ("ssqr", "lam"), ("diag_embed", "lam")])
def test_unary(data, name, arg):
    t = getattr(tc, name)(torch.as_tensor(data[arg]), TD)
    j = getattr(jc, name)(jnp.asarray(data[arg]), JD)
    _close(t, j)


def test_unpack_and_matrix_cols(data):
    packed = np.array(jc.pack(jnp.asarray(data["x"]), JD))
    _close(tc.unpack(torch.as_tensor(packed), TD),
           jc.unpack(jnp.asarray(packed), JD))
    M = data["x"][0][:, None] * np.arange(1.0, 4.0)[None, :]   # (cdim, 3)
    _close(tc.pack_matrix_cols(torch.as_tensor(M), TD),
           jc.pack_matrix_cols(jnp.asarray(M), JD))


def test_cone_identity():
    _close(tc.cone_identity(TD, dtype=torch.float64, device="cpu"),
           jc.cone_identity(JD, dtype=jnp.float64))


def test_max_step_eig(data):
    """Step and eigenvalues agree; eigenvectors are fixed only up to
    sign, so each 's' block is rebuilt from them instead."""
    x = data["x"] + np.asarray(jc.symmetrize(jnp.asarray(data["x"]), JD))
    t, sig, Q = tc.max_step_eig(torch.as_tensor(x), TD)
    tj, sigj, _ = jc.max_step_eig(jnp.asarray(x), JD)
    _close(t, tj)
    _close(sig, sigj)
    xs = np.array(jc.symmetrize(jnp.asarray(x), JD))
    for run in TD.s_runs:
        V = tc.sview(Q, run).numpy()
        _, doff, cnt, m = run
        i0 = doff - TD.offs          # sig holds the 's' part only
        w = sig[:, i0:i0 + cnt * m].reshape(B, cnt, m).numpy()
        X = (V * w[..., None, :]) @ np.swapaxes(V, -1, -2)
        _close(X, tc.sview(torch.as_tensor(xs), run).numpy(), 1e-11)
    _close(Q[:, :TD.offs], x[:, :TD.offs])

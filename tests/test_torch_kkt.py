"""The port's condensed-KKT factor (cvxopt_tpu_torch/kkt.py, kkt_chol2)
against cvxopt_tpu.kkt.kkt_chol2 on the same seeded numpy inputs: 'chol2'
and 'chol2_inv', factoring in the working dtype (f64) and in float32
with Jacobi equilibration, at n = 8, 40 and 128 (the first two are
padded to a multiple of 64 for the fused kernels' panel width)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cvxopt_tpu import kkt as jk
from cvxopt_tpu import scaling as jsc
from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu_torch import kkt as tk
from cvxopt_tpu_torch import scaling as tsc
from cvxopt_tpu_torch.cones import ConeDims as TDims

B = 3


def _problem(n, per_instance_G, seed=0):
    rng = np.random.default_rng(seed)
    m = 2 * n
    F = rng.standard_normal((B, n, n // 2 + 1)) / np.sqrt(n)
    P = F @ F.transpose(0, 2, 1) + 0.1 * np.eye(n)
    G = rng.standard_normal((B, m, n) if per_instance_G else (m, n))
    A = np.ones((1, n))
    s = rng.uniform(0.1, 10.0, (B, m))
    z = rng.uniform(0.1, 10.0, (B, m))
    bx = rng.standard_normal((B, n))
    by = rng.standard_normal((B, 1))
    bz = rng.standard_normal((B, m))
    return P, G, A, s, z, bx, by, bz


def _solve_both(name, n, fd, per_instance_G=False):
    P, G, A, s, z, bx, by, bz = _problem(n, per_instance_G)
    m = 2 * n
    jd, td = JDims(l=m), TDims(l=m)
    g_axis = 0 if per_instance_G else None

    def jax_one(Gk, Pk, sk, zk, bxk, byk, bzk):
        W, _ = jsc.compute_scaling(sk, zk, jd)
        f = jk.get_kktsolver(name, Gk, jd, jnp.asarray(A),
                             factor_dtype=fd)
        return f(W, Pk)(bxk, byk, bzk)

    ref = jax.vmap(jax_one, in_axes=(g_axis, 0, 0, 0, 0, 0, 0))(
        *map(jnp.asarray, (G, P, s, z, bx, by, bz)))
    t = [torch.as_tensor(u) for u in (P, G, A, s, z, bx, by, bz)]
    W, _ = tsc.compute_scaling(t[3], t[4], td)
    f = tk.get_kktsolver(name, t[1], td, t[2], factor_dtype=fd)
    out = f(W, t[0])(t[5], t[6], t[7])
    return out, ref


@pytest.mark.parametrize("fd,tol", [(None, 1e-10), ("float32", 1e-4)])
@pytest.mark.parametrize("name", ["chol2", "chol2_inv"])
@pytest.mark.parametrize("n", [8, 40, 128])
def test_kkt_chol2_matches_jax(n, name, fd, tol):
    """f64: agreement to roundoff; float32 factor: both sides carry an
    f32 factor error of ~eps_f32 * kappa(S_eq), so the bound is set
    relative to the solution's scale."""
    out, ref = _solve_both(name, n, fd)
    for u, v in zip(out, ref):
        v = np.asarray(v)
        assert u.dtype == torch.float64
        scale = max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(u.numpy(), v, atol=tol * scale)


@pytest.mark.parametrize("name", ["chol2", "chol2_inv"])
def test_kkt_chol2_per_instance_G(name):
    """A per-instance G takes the unbatched kernel pair."""
    out, ref = _solve_both(name, 40, None, per_instance_G=True)
    for u, v in zip(out, ref):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), atol=1e-10)


def test_singular_factor_is_nan():
    """P = 0 and a zero column of G make S singular: NaN, per instance."""
    n, m = 8, 8
    G = -np.eye(m, n)
    G[:, -1] = 0.0
    td = TDims(l=m)
    P = torch.zeros((2, n, n), dtype=torch.float64)
    P[1] = torch.eye(n, dtype=torch.float64)
    s = torch.ones((2, m), dtype=torch.float64)
    W, _ = tsc.compute_scaling(s, s, td)
    f = tk.get_kktsolver("chol2", torch.as_tensor(G), td,
                         torch.zeros((0, n), dtype=torch.float64))
    ux, _, _ = f(W, P)(torch.ones((2, n), dtype=torch.float64),
                       torch.zeros((2, 0), dtype=torch.float64),
                       torch.ones((2, m), dtype=torch.float64))
    assert torch.isnan(ux[0]).all() and torch.isfinite(ux[1]).all()


def test_strategy_names():
    td = TDims(l=2)
    G = torch.eye(2, dtype=torch.float64)
    A = torch.zeros((0, 2), dtype=torch.float64)
    for name in ("ldl", "ldl2", "qr", "chol", "cholqr_inv"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tk.get_kktsolver(name, G, td, A)
    with pytest.raises(ValueError):
        tk.get_kktsolver("nonsense", G, td, A)
    assert tk.robust_name("chol2_inv") == "chol2"
    assert tk.resolve_factor_dtype("auto") is None
    assert tk.resolve_factor_dtype("float32") == "float32"
    P = torch.eye(2)
    assert tk.wrap_P("chol2", P) is P


@pytest.mark.parametrize("name", ["chol2", "chol2_inv"])
def test_kkt_chol2_qs_cones_matches_jax(name):
    """'q'/'s' cones take the plain torch factor; one W (the JAX
    package's) is handed to both, since an 's' block's W is fixed only
    up to the signs of its eigenvectors."""
    dims = dict(l=2, q=(3,), s=(2,))
    jd, td = JDims(**dims), TDims(**dims)
    rng = np.random.default_rng(7)
    n, m = 5, jd.cdim
    F = rng.standard_normal((B, n, n))
    P = F @ F.transpose(0, 2, 1) + np.eye(n)
    G = rng.standard_normal((m, n))
    A = np.ones((1, n))

    def interior():
        v = np.concatenate([rng.uniform(0.5, 2.0, (B, 2)),
                            np.zeros((B, 3)), np.zeros((B, 4))], axis=1)
        v[:, 3:5] = rng.standard_normal((B, 2)) * 0.3
        v[:, 2] = 1.0
        X = rng.standard_normal((B, 2, 2))
        v[:, 5:] = (X @ X.transpose(0, 2, 1) + np.eye(2)).reshape(B, 4)
        return v

    s, z = interior(), interior()
    bx, by, bz = (rng.standard_normal((B, k)) for k in (n, 1, m))
    Wj, _ = jax.vmap(lambda a, b: jsc.compute_scaling(a, b, jd))(
        jnp.asarray(s), jnp.asarray(z))

    def jax_one(W, Pk, bxk, byk, bzk):
        f = jk.get_kktsolver(name, jnp.asarray(G), jd, jnp.asarray(A))
        return f(W, Pk)(bxk, byk, bzk)

    ref = jax.vmap(jax_one)(Wj, *map(jnp.asarray, (P, bx, by, bz)))
    Wt = {k: ([torch.as_tensor(np.array(u)) for u in v]
              if isinstance(v, list) else torch.as_tensor(np.array(v)))
          for k, v in Wj.items()}
    f = tk.get_kktsolver(name, torch.as_tensor(G), td, torch.as_tensor(A))
    out = f(Wt, torch.as_tensor(P))(*map(torch.as_tensor, (bx, by, bz)))
    for u, v in zip(out, ref):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), atol=1e-10)

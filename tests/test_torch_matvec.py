"""The port's matrix-vector products (cvxopt_tpu_torch/ops/matvec.py)
against cvxopt_tpu/ops/matvec.py and `@` — twins of tests/test_matvec.py:
shared and batched matrices, empty shapes and a matrix right-hand side,
in float64 within 1e-13 (relative)."""

import numpy as np
import jax.numpy as jnp
import torch

from cvxopt_tpu.ops import matvec as jmv
from cvxopt_tpu_torch.ops.matvec import mv, mvt, vdot

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(a)


def test_mv_matches_dot():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((7, 5))
    x, z = rng.standard_normal(5), rng.standard_normal(7)
    for out, ref, jref in ((mv(_t(A), _t(x)), A @ x, jmv.mv(A, x)),
                           (mvt(_t(A), _t(z)), A.T @ z, jmv.mvt(A, z))):
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-13)
        np.testing.assert_allclose(out.numpy(), np.asarray(jref),
                                   rtol=1e-13)


def test_shared_matrix_batched_vectors():
    """A (m, n) matrix shared across a batch of vectors (B, n), the
    port's layout for shared G."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((64, 33))
    X = rng.standard_normal((4, 33))
    Z = rng.standard_normal((4, 64))
    np.testing.assert_allclose(mv(_t(A), _t(X)).numpy(), X @ A.T,
                               rtol=1e-12)
    np.testing.assert_allclose(mvt(_t(A), _t(Z)).numpy(), Z @ A,
                               rtol=1e-12)
    np.testing.assert_allclose(vdot(_t(X), _t(X)).numpy(),
                               (X * X).sum(-1), rtol=1e-13)


def test_mv_batched_and_empty():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((4, 7, 5))
    x = rng.standard_normal((4, 5))
    ref = np.einsum("bij,bj->bi", A, x)
    np.testing.assert_allclose(mv(_t(A), _t(x)).numpy(), ref, rtol=1e-12)
    jout = np.stack([np.asarray(jmv.mv(jnp.asarray(A[k]), x[k]))
                     for k in range(4)])
    np.testing.assert_allclose(mv(_t(A), _t(x)).numpy(), jout, rtol=1e-12)
    E = torch.zeros((0, 5), dtype=torch.float64)
    assert mv(E, _t(x[0])).shape == (0,)
    assert mvt(E, torch.zeros(0, dtype=torch.float64)).shape == (5,)


def test_mv_batched_matrix_rhs():
    """A stack of matrices against a stack of matrix right-hand sides
    (B, n, k) goes through the batched product."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((2, 6, 4))
    X = rng.standard_normal((2, 4))
    np.testing.assert_allclose((_t(A) @ _t(X).unsqueeze(-1)).squeeze(-1)
                               .numpy(), mv(_t(A), _t(X)).numpy(),
                               rtol=1e-13)
    np.testing.assert_allclose(
        mvt(_t(A), mv(_t(A), _t(X))).numpy(),
        np.einsum("bji,bj->bi", A, np.einsum("bij,bj->bi", A, X)),
        rtol=1e-12)

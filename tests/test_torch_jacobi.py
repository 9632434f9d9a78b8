"""The port's symmetric eigensolvers (cvxopt_tpu_torch/ops/jacobi.py) on
the cases of tests/test_jacobi.py: `eigh_jacobi` is a real cyclic Jacobi
held to numpy and to cvxopt_tpu.ops.jacobi.eigh_jacobi on the same
inputs (eigenvalues at 1e-11); the `*_accurate` wrappers are float64
eigh of the symmetrized input."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cvxopt_tpu.ops import jacobi as jj
from cvxopt_tpu_torch.ops import jacobi as tj

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _spd(m, kappa, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    lam = np.logspace(0.0, -np.log10(kappa), m)
    S = (Q * lam) @ Q.T
    return (S + S.T) / 2


def test_eigh_jacobi_matches_numpy_and_jax():
    S = _spd(24, 1e6, seed=1)
    w, V = tj.eigh_jacobi(torch.as_tensor(S))
    w, V = w.numpy(), V.numpy()
    np.testing.assert_allclose(w, np.linalg.eigvalsh(S), rtol=1e-9,
                               atol=1e-12)
    assert np.abs(V * w @ V.T - S).max() < 1e-12
    wj, _ = jj.eigh_jacobi(jnp.asarray(S))
    np.testing.assert_allclose(w, np.asarray(wj), rtol=1e-9, atol=1e-13)


@pytest.mark.parametrize("b,m", [(16, 8), (16, 50), (4, 64), (100, 4),
                                 (1, 33)])
def test_eigh_jacobi_shapes(b, m):
    """Even and odd m (odd pads with a decoupled unit diagonal)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((b, m, m))
    A = (X + X.transpose(0, 2, 1)) / 2
    w, V = tj.eigh_jacobi(torch.as_tensor(A))
    w, V = w.numpy(), V.numpy()
    wref = np.linalg.eigvalsh(A)
    assert np.abs(w - wref).max() < 1e-11 * max(1, np.abs(wref).max())
    recon = np.einsum("bij,bj,bkj->bik", V, w, V)
    assert np.abs(recon - A).max() < 1e-11
    orth = np.einsum("bij,bik->bjk", V, V)
    assert np.abs(orth - np.eye(m)).max() < 1e-11


def test_eigh_jacobi_relative_accuracy_spd():
    """Small-eigenvalue relative accuracy on a graded SPD matrix."""
    rng = np.random.default_rng(1)
    m = 12
    d = 10.0 ** np.linspace(-8, 0, m)
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    A = (Q * d) @ Q.T
    A = (A + A.T) / 2
    w = tj.eigvalsh_jacobi(torch.as_tensor(A), sweeps=16).numpy()
    rel = np.abs(np.sort(w) - np.sort(d)) / np.sort(d)
    assert rel.max() < 1e-6, rel.max()


def test_accurate_wrappers_symmetrize_and_keep_dtype():
    """torch's eigh reads one triangle; the wrappers symmetrize first,
    as the JAX package's eigh does, and return the input's dtype."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((3, 6, 6))
    sym = 0.5 * (A + A.transpose(0, 2, 1))
    w, V = tj.eigh_accurate(torch.as_tensor(A))
    wj, _ = jj.eigh_accurate(jnp.asarray(A))
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), atol=1e-12)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(sym),
                               atol=1e-12)
    recon = np.einsum("bij,bj,bkj->bik", V.numpy(), w.numpy(), V.numpy())
    np.testing.assert_allclose(recon, sym, atol=1e-12)
    np.testing.assert_allclose(
        tj.eigvalsh_accurate(torch.as_tensor(A)).numpy(), w.numpy(),
        atol=1e-12)
    w32, V32 = tj.eigh_accurate(torch.as_tensor(A, dtype=torch.float32))
    assert w32.dtype == V32.dtype == torch.float32


def test_gram_eigh_accurate_batched():
    rng = np.random.default_rng(4)
    Ms = []
    for _ in range(3):
        U, _ = np.linalg.qr(rng.standard_normal((8, 8)))
        Ms.append((U * np.logspace(0, -4, 8)) @ U.T)
    M = np.stack(Ms)
    w, V = tj.gram_eigh_accurate(torch.as_tensor(M))
    wj, _ = jj.gram_eigh_accurate(jnp.asarray(M))
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-8,
                               atol=1e-15)
    G = M.transpose(0, 2, 1) @ M
    off = V.numpy().transpose(0, 2, 1) @ G @ V.numpy()
    for k in range(3):
        np.testing.assert_allclose(off[k], np.diag(w.numpy()[k]),
                                   atol=1e-12)

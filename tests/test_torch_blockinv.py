"""The port's block-recursive SPD inverse and blocked Cholesky
factorizations (cvxopt_tpu_torch/ops/blockinv.py) on the cases of
tests/test_blockinv.py, and against cvxopt_tpu/ops/blockinv.py on the
same seeded numpy inputs (float64, 1e-10)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cvxopt_tpu.ops import blockinv as jb
from cvxopt_tpu_torch.ops import blockinv as tb

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


def _spd(n, b=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, n, n) if b else (n, n)
    F = rng.standard_normal(shape) / np.sqrt(n)
    return F @ np.swapaxes(F, -1, -2) + np.eye(n)


@pytest.mark.parametrize("n", [8, 32, 48, 96, 256])
def test_spd_inverse_matches_inv_and_jax(n):
    S = _spd(n, seed=n)
    X = tb.spd_inverse(torch.as_tensor(S)).numpy()
    np.testing.assert_allclose(X @ S, np.eye(n), atol=1e-8)
    np.testing.assert_allclose(X, X.T, atol=1e-12)
    np.testing.assert_allclose(X, np.asarray(jb.spd_inverse(jnp.asarray(S))),
                               atol=1e-10)


def test_spd_inverse_batched():
    S = _spd(64, b=5, seed=3)
    X = tb.spd_inverse(torch.as_tensor(S)).numpy()
    np.testing.assert_allclose(X @ S, np.broadcast_to(np.eye(64), S.shape),
                               atol=1e-8)


def test_non_pd_gives_nan_per_instance():
    """NaN, not an exception; the PD neighbour stays finite."""
    S = np.stack([np.eye(64), np.eye(64)])
    S[0, 40, 40] = -1.0
    X = tb.spd_inverse(torch.as_tensor(S))
    assert torch.isnan(X[0]).any() and torch.isfinite(X[1]).all()


def test_ill_conditioned_f32():
    """kappa ~ 1e5 in float32: the error stays ~eps32 * kappa."""
    rng = np.random.default_rng(1)
    n = 128
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    S = (Q * np.logspace(0, 5, n)) @ Q.T
    X = tb.spd_inverse(torch.as_tensor(S, dtype=torch.float32))
    err = np.abs(X.double().numpy() @ S - np.eye(n)).max()
    assert err < 1e5 * 1.2e-7 * 50, err


@pytest.mark.parametrize("n", [64, 200, 1030])
def test_blocked_cholesky_matches(n):
    S = _spd(n, seed=n + 1)
    L = tb.blocked_cholesky(torch.as_tensor(S), block=128).numpy()
    np.testing.assert_allclose(L @ L.T, S, atol=1e-9)
    assert np.allclose(np.triu(L, 1), 0.0)
    ref = np.asarray(jb.blocked_cholesky(jnp.asarray(S), block=128))
    np.testing.assert_allclose(L, ref, atol=1e-10)


def test_blocked_cholesky_nan_on_non_pd():
    S = np.eye(300)
    S[200, 200] = -1.0
    L = tb.blocked_cholesky(torch.as_tensor(S), block=128)
    assert torch.isnan(L).any()


def test_panel_cholesky_matches_numpy():
    rng = np.random.default_rng(3)
    n = 768
    A = rng.standard_normal((n, n))
    S = A @ A.T + n * np.eye(n)
    L = tb.panel_cholesky(torch.as_tensor(S), panel=256).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(S), atol=1e-8 * n)
    Lb = tb.panel_cholesky(torch.as_tensor(S - 10 * n * np.eye(n)),
                           panel=256)
    assert torch.isnan(Lb).any()
    with pytest.raises(ValueError):
        tb.panel_cholesky(torch.eye(10, dtype=torch.float64), panel=4)


def test_tri_inverse_lower():
    rng = np.random.default_rng(4)
    L = np.tril(rng.standard_normal((200, 200))) + 5 * np.eye(200)
    Li = tb.tri_inverse_lower(torch.as_tensor(L), base=64).numpy()
    np.testing.assert_allclose(Li @ L, np.eye(200), atol=1e-10)
    ref = np.asarray(jb.tri_inverse_lower(jnp.asarray(L), base=64))
    np.testing.assert_allclose(Li, ref, atol=1e-10)

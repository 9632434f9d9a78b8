"""The port's fused-Cholesky module (cvxopt_tpu_torch/ops/fused_chol.py)
against the JAX package's Pallas kernels (interpret mode on the CPU) and
their jnp `_ref` oracles, on the same seeded numpy inputs.

On the CPU the wrappers compute their plain PyTorch versions; the CUDA
kernels themselves are compared with those on the card by
tests/test_torch_gpu.py (skipped without a card) and chip_smoke.py."""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import jax.experimental.pallas as pl

from cvxopt_tpu_torch.ops import fused_chol as fc


@pytest.fixture()
def pallas_interpret():
    """Force interpret mode (CPU) for pallas_call."""
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", interp):
        import importlib
        import cvxopt_tpu.ops.pallas_chol as pc
        importlib.reload(pc)
        yield pc
    import importlib
    import cvxopt_tpu.ops.pallas_chol as pc
    importlib.reload(pc)


def _data(n, m, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, n)).astype(np.float32)
    P = (F @ F.T + n * np.eye(n)).astype(np.float32)
    Gt = rng.standard_normal((n, m)).astype(np.float32)
    dinv2 = rng.uniform(0.5, 2.0, m).astype(np.float32)
    B = rng.standard_normal((8, n)).astype(np.float32)
    return P, Gt, dinv2, B


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


CASES = [(64, 96), (128, 192), (192, 128)]


@pytest.mark.parametrize("n,m", CASES)
def test_plain_matches_jax_reference(n, m):
    """Same cases and tolerances as tests/test_pallas_chol.py."""
    from cvxopt_tpu.ops import pallas_chol as pc
    P, Gt, dinv2, B = _data(n, m)
    Lr, Dr = pc.fused_schur_cholesky_ref(jnp.asarray(P), jnp.asarray(Gt),
                                         jnp.asarray(dinv2))
    L, Dinv = fc.fused_schur_cholesky(*_t(P, Gt, dinv2), device="cpu")
    scale = float(jnp.max(jnp.abs(Lr)))
    np.testing.assert_allclose(L.numpy(), np.asarray(Lr),
                               atol=3e-6 * scale)
    np.testing.assert_allclose(Dinv.numpy(), np.asarray(Dr), atol=1e-5)
    xr = pc.fused_cholesky_solve_ref(Lr, Dr, jnp.asarray(B))
    x = fc.fused_cholesky_solve(L, Dinv, torch.as_tensor(B), device="cpu")
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), atol=1e-5)


@pytest.mark.parametrize("n,m", CASES)
def test_plain_matches_pallas_interpret(pallas_interpret, n, m):
    pc = pallas_interpret
    P, Gt, dinv2, B = _data(n, m, seed=1)
    Lk, Dk = pc.fused_schur_cholesky(jnp.asarray(P), jnp.asarray(Gt),
                                     jnp.asarray(dinv2))
    xk = pc.fused_cholesky_solve(Lk, Dk, jnp.asarray(B))
    L, Dinv = fc.fused_schur_cholesky(*_t(P, Gt, dinv2), device="cpu")
    x = fc.fused_cholesky_solve(L, Dinv, torch.as_tensor(B), device="cpu")
    scale = float(jnp.max(jnp.abs(Lk)))
    np.testing.assert_allclose(L.numpy(), np.asarray(Lk),
                               atol=3e-6 * scale)
    np.testing.assert_allclose(Dinv.numpy(), np.asarray(Dk), atol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(xk), atol=1e-5)


def test_batched_plain_matches_pallas_interpret(pallas_interpret):
    """Shared Gt, per-instance P and dinv2 (tests/test_pallas_chol.py's
    batched case)."""
    pc = pallas_interpret
    rng = np.random.default_rng(1)
    B, n, m, tb = 4, 128, 160, 2
    F = rng.standard_normal((B, n, n)).astype(np.float32)
    P = (F @ F.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    Gt = rng.standard_normal((n, m)).astype(np.float32)
    dinv2 = rng.uniform(0.5, 2.0, (B, m)).astype(np.float32)
    rhs = rng.standard_normal((B, 4, n)).astype(np.float32)
    Lk, Dk = pc.fused_schur_cholesky_batched(
        jnp.asarray(P), jnp.asarray(Gt), jnp.asarray(dinv2), tb=tb)
    xk = pc.fused_cholesky_solve_batched(Lk, Dk, jnp.asarray(rhs), tb=tb)
    L, Dinv = fc.fused_schur_cholesky_batched(*_t(P, Gt, dinv2), tb=tb,
                                              device="cpu")
    x = fc.fused_cholesky_solve_batched(L, Dinv, torch.as_tensor(rhs),
                                        tb=tb, device="cpu")
    scale = float(jnp.max(jnp.abs(Lk)))
    np.testing.assert_allclose(L.numpy(), np.asarray(Lk),
                               atol=5e-6 * scale)
    np.testing.assert_allclose(Dinv.numpy(), np.asarray(Dk), atol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(xk), atol=2e-5)


def test_per_instance_gt_matches_vmapped_reference():
    """The unbatched wrapper with a per-instance Gt is the vmapped form
    of the JAX kernel."""
    from cvxopt_tpu.ops import pallas_chol as pc
    rng = np.random.default_rng(2)
    B, n, m = 3, 64, 80
    F = rng.standard_normal((B, n, n))
    P = F @ F.transpose(0, 2, 1) + n * np.eye(n)
    Gt = rng.standard_normal((B, n, m))
    dinv2 = rng.uniform(0.5, 2.0, (B, m))
    Lr, Dr = jax.vmap(pc.fused_schur_cholesky_ref)(
        jnp.asarray(P), jnp.asarray(Gt), jnp.asarray(dinv2))
    L, Dinv = fc.fused_schur_cholesky(*_t(P, Gt, dinv2), device="cpu")
    np.testing.assert_allclose(L.numpy(), np.asarray(Lr), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(Dinv.numpy(), np.asarray(Dr), atol=1e-12)


@pytest.mark.parametrize("fn", [fc.fused_schur_cholesky,
                                fc.fused_schur_cholesky_batched])
def test_rejects_bad_n(fn):
    P = torch.eye(100).expand(8, 100, 100)
    with pytest.raises(ValueError):
        fn(P, torch.ones((100, 8)), torch.ones((8, 8)), device="cpu")


def test_batched_rejects_bad_tb():
    P = torch.eye(64).expand(6, 64, 64)
    with pytest.raises(ValueError):
        fc.fused_schur_cholesky_batched(P, torch.ones((64, 8)),
                                        torch.ones((6, 8)), tb=4,
                                        device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_non_pd_instance_is_nan(dtype):
    """A non-PD instance comes back all NaN (the solvers' singularity
    contract) and does not touch its neighbours."""
    rng = np.random.default_rng(3)
    B, n, m = 3, 64, 32
    F = rng.standard_normal((B, n, n))
    P = torch.as_tensor(F @ F.transpose(0, 2, 1) + n * np.eye(n),
                        dtype=dtype)
    P[1] = -torch.eye(n, dtype=dtype)
    Gt = torch.as_tensor(rng.standard_normal((n, m)), dtype=dtype)
    d2 = torch.as_tensor(rng.uniform(0.5, 2.0, (B, m)), dtype=dtype)
    L, Dinv = fc.fused_schur_cholesky_batched(P, Gt, d2, tb=1,
                                              device="cpu")
    assert torch.isnan(L[1]).all() and torch.isnan(Dinv[1]).all()
    assert torch.isfinite(L[0]).all() and torch.isfinite(L[2]).all()
    x = fc.fused_cholesky_solve_batched(
        L, Dinv, torch.ones((B, 2, n), dtype=dtype), tb=1, device="cpu")
    assert torch.isnan(x[1]).all() and torch.isfinite(x[0]).all()


def test_equilibrate_matches_kkt_jacobi_scaling():
    """equilibrate=True factors D S D with D = diag(S)^{-1/2}, as
    cvxopt_tpu/kkt.py:456-458 does before its reduced-precision factor."""
    rng = np.random.default_rng(4)
    B, n, m = 2, 128, 96
    F = rng.standard_normal((B, n, n))
    P = F @ F.transpose(0, 2, 1) + np.diag(rng.uniform(1, 1e4, n))
    Gt = rng.standard_normal((n, m))
    d2 = rng.uniform(1e-3, 1e3, (B, m))

    def jax_one(Pk, dk):
        S = Pk + (jnp.asarray(Gt) * dk) @ jnp.asarray(Gt).T
        deq = jax.lax.rsqrt(jnp.maximum(jnp.diag(S),
                                        jnp.asarray(1e-30, S.dtype)))
        S = S * deq[:, None] * deq[None, :]
        return jnp.linalg.cholesky(S), deq

    Lr, deqr = jax.vmap(jax_one)(jnp.asarray(P), jnp.asarray(d2))
    L, Dinv, deq = fc.fused_schur_cholesky_batched(
        *_t(P, Gt, d2), tb=1, equilibrate=True, device="cpu")
    np.testing.assert_allclose(deq.numpy(), np.asarray(deqr), rtol=1e-13)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lr), atol=1e-12)
    # the panel inverses belong to the equilibrated factor
    blk = L[:, :fc.BP, :fc.BP]
    np.testing.assert_allclose((blk @ Dinv[:, 0]).numpy(),
                               np.broadcast_to(np.eye(fc.BP),
                                               (B, fc.BP, fc.BP)),
                               atol=1e-12)


def test_solve_accepts_shared_rhs_view():
    """chol2_inv solves against one identity for the whole batch,
    passed as an expanded (stride-0) view."""
    rng = np.random.default_rng(5)
    B, n = 2, 64
    F = rng.standard_normal((B, n, n))
    P = torch.as_tensor(F @ F.transpose(0, 2, 1) + n * np.eye(n))
    L, Dinv = fc.fused_schur_cholesky_batched(
        P, torch.zeros((n, 1), dtype=P.dtype),
        torch.zeros((B, 1), dtype=P.dtype), tb=1, device="cpu")
    eye = torch.eye(n, dtype=P.dtype).expand(B, n, n)
    X = fc.fused_cholesky_solve_batched(L, Dinv, eye, tb=1, device="cpu")
    np.testing.assert_allclose((X @ P).numpy(),
                               np.broadcast_to(np.eye(n), (B, n, n)),
                               atol=1e-10)


# (n, nrhs, element size, shared memory bytes) -> rows per solve block;
# 232448 bytes is an H100's opt-in shared memory per block
@pytest.mark.parametrize("n,nrhs,esize,smem,rows", [
    (256, 256, 4, 232448, 16),
    (256, 1, 8, 232448, 1),
    (1536, 1536, 8, 232448, 15),
    (3328, 3328, 4, 232448, 15),
    (24832, 24832, 8, 232448, 1),
])
def test_solve_rows_fit_shared_memory(n, nrhs, esize, smem, rows):
    """chol_solve's block holds R right-hand-side rows of y beside a
    64x65 tile and a 64-wide accumulator: R shrinks as n grows."""
    assert fc.solve_rows(n, nrhs, esize, smem) == rows
    assert (fc.BP * (fc.BP + 1) + rows * (fc.BP + n)) * esize <= smem


@pytest.mark.parametrize("esize,nmax", [(8, 24832), (4, 53888)])
def test_solve_rows_names_the_largest_n(esize, nmax):
    assert fc.solve_rows(nmax, 1, esize, 232448) == 1
    with pytest.raises(ValueError, match=f"exceeds {nmax}"):
        fc.solve_rows(nmax + fc.BP, 1, esize, 232448)

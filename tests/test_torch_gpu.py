"""The port's CUDA kernels against their plain PyTorch versions on the
card (marked `gpu`; skipped without a CUDA device).

This file imports no jax, so it runs on a machine with torch and a card
but without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from cvxopt_tpu_torch.ops import fused_chol as fc

# float32 and float64 tolerances on relative Frobenius error (the
# kernels sum in another order than the plain version)
TOLS = [(torch.float32, 1e-5), (torch.float64, 1e-12)]
# right-hand-side counts on both sides of fc.FEW_RHS and of one 64-row
# block of the many-right-hand-side kernel
NRHS = (1, 5, 63, 64, 65, 256)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def _problem(rng, B, n, m, kw):
    F = rng.standard_normal((B, n, n))
    P = torch.as_tensor(F @ F.transpose(0, 2, 1) + n * np.eye(n), **kw)
    Gt = torch.as_tensor(rng.standard_normal((n, m)), **kw)
    Gtb = torch.as_tensor(rng.standard_normal((B, n, m)), **kw)
    d2 = torch.as_tensor(rng.uniform(0.5, 2.0, (B, m)), **kw)
    return P, Gt, Gtb, d2


def _pairs(Gt, Gtb):
    """(factor, solve, Gt) for the batched pair (shared Gt) and the
    unbatched pair (per-instance Gt); tb = 1 takes any batch size."""
    def factor_b(P, G, d2, equilibrate=False):
        return fc.fused_schur_cholesky_batched(P, G, d2, tb=1,
                                               equilibrate=equilibrate)

    def solve_b(L, D, rhs):
        return fc.fused_cholesky_solve_batched(L, D, rhs, tb=1)

    return ((factor_b, solve_b, Gt),
            (fc.fused_schur_cholesky, fc.fused_cholesky_solve, Gtb))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("equilibrate", [False, True])
@pytest.mark.parametrize("B,n,m", [(8, 192, 200), (1, 64, 1),
                                   (3, 320, 512), (64, 192, 1),
                                   (3, 64, 200)])
def test_kernels_match_plain_on_card(cuda_device, dtype, tol, equilibrate,
                                     B, n, m):
    """Both factor wrappers (shared and per-instance Gt) at edge shapes
    of the 128-wide assembly tiles, and the solve at every NRHS."""
    rng = np.random.default_rng(6)
    kw = dict(dtype=dtype, device=cuda_device)
    P, Gt, Gtb, d2 = _problem(rng, B, n, m, kw)
    for factor, solve, G in _pairs(Gt, Gtb):
        out = factor(P, G, d2, equilibrate=equilibrate)
        ref = fc.fused_schur_cholesky_ref(P, G, d2, equilibrate)
        for a, b in zip(out, ref):
            assert _rel(a, b) <= tol
        assert bool((torch.triu(out[0], 1) == 0).all())
        for nrhs in NRHS:
            rhs = torch.as_tensor(rng.standard_normal((B, nrhs, n)), **kw)
            x = solve(out[0], out[1], rhs)
            xr = fc.fused_cholesky_solve_ref(ref[0], ref[1], rhs)
            assert _rel(x, xr) <= tol, nrhs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_solve_expanded_identity(cuda_device, dtype, tol):
    """chol2_inv's one identity for the whole batch (batch stride 0)."""
    rng = np.random.default_rng(9)
    B, n = 3, 320
    kw = dict(dtype=dtype, device=cuda_device)
    P, Gt, _, d2 = _problem(rng, B, n, 96, kw)
    L, D = fc.fused_schur_cholesky_batched(P, Gt, d2, tb=1)
    eye = torch.eye(n, **kw).expand(B, n, n)
    X = fc.fused_cholesky_solve_batched(L, D, eye, tb=1)
    assert _rel(X, fc.fused_cholesky_solve_ref(L, D, eye)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_non_pd_instance_between_pd_ones(cuda_device, dtype):
    """The middle instance is not PD: it comes back all NaN, in L, Dinv
    and the solve, and its neighbours stay finite."""
    rng = np.random.default_rng(10)
    B, n = 3, 192
    kw = dict(dtype=dtype, device=cuda_device)
    P, Gt, Gtb, d2 = _problem(rng, B, n, 64, kw)
    P[1] = -1e6 * torch.eye(n, **kw)
    for factor, solve, G in _pairs(Gt, Gtb):
        L, D = factor(P, G, d2)
        assert bool(torch.isnan(L[1]).all() and torch.isnan(D[1]).all())
        for k in (0, 2):
            assert bool(torch.isfinite(L[k]).all()
                        and torch.isfinite(D[k]).all())
        for nrhs in (1, 65):
            x = solve(L, D, torch.ones((B, nrhs, n), **kw))
            assert bool(torch.isnan(x[1]).all())
            assert bool(torch.isfinite(x[0]).all()
                        and torch.isfinite(x[2]).all())


@pytest.mark.gpu
def test_factor_reads_expanded_dinv2(cuda_device):
    """dinv2 may be one row expanded over the batch (batch stride 0)."""
    rng = np.random.default_rng(7)
    B, n, m = 4, 128, 96
    F = rng.standard_normal((B, n, n))
    kw = dict(dtype=torch.float64, device=cuda_device)
    P = torch.as_tensor(F @ F.transpose(0, 2, 1) + n * np.eye(n), **kw)
    Gt = torch.as_tensor(rng.standard_normal((n, m)), **kw)
    Gtb = Gt.expand(B, n, m).contiguous()
    d = torch.as_tensor(rng.uniform(0.5, 2.0, m), **kw)
    d2 = d.expand(B, m)
    ref = fc.fused_schur_cholesky_ref(P, Gt, d2.contiguous())
    for out in (fc.fused_schur_cholesky_batched(P, Gt, d2, tb=1),
                fc.fused_schur_cholesky(P, Gtb, d2)):
        for a, b in zip(out, ref):
            assert float((a - b).abs().max()) <= 1e-10


@pytest.mark.gpu
def test_solve_at_n_25600(cuda_device):
    """float64 at n = 25600, against the plain version: one right-hand
    side alone (200 KB) would nearly fill a block's 227 KB of shared
    memory, so the kernels keep finished panels in device memory."""
    n = 25600
    g = torch.Generator(device=cuda_device).manual_seed(8)
    kw = dict(dtype=torch.float64, device=cuda_device)
    L = torch.randn((n, n), generator=g, **kw).tril_(-1).div_(n)
    L.diagonal().add_(1.0)
    eye = torch.eye(fc.BP, **kw)
    Dinv = torch.linalg.solve_triangular(fc._diag_blocks(L), eye,
                                         upper=False).contiguous()
    rhs = torch.randn((2, n), generator=g, **kw)
    x = fc.fused_cholesky_solve(L, Dinv, rhs)
    xr = fc.fused_cholesky_solve_ref(L, Dinv, rhs)
    assert _rel(x, xr) <= 1e-12

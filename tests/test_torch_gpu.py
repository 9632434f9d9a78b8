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


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("equilibrate", [False, True])
def test_kernels_match_plain_on_card(cuda_device, dtype, tol, equilibrate):
    rng = np.random.default_rng(6)
    B, n, m = 8, 192, 200
    F = rng.standard_normal((B, n, n))
    kw = dict(dtype=dtype, device=cuda_device)
    P = torch.as_tensor(F @ F.transpose(0, 2, 1) + n * np.eye(n), **kw)
    Gt = torch.as_tensor(rng.standard_normal((n, m)), **kw)
    Gtb = torch.as_tensor(rng.standard_normal((B, n, m)), **kw)
    d2 = torch.as_tensor(rng.uniform(0.5, 2.0, (B, m)), **kw)
    rhs = torch.as_tensor(rng.standard_normal((B, 5, n)), **kw)

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    for factor, solve, G in (
            (fc.fused_schur_cholesky_batched,
             fc.fused_cholesky_solve_batched, Gt),
            (fc.fused_schur_cholesky, fc.fused_cholesky_solve, Gtb)):
        out = factor(P, G, d2, equilibrate=equilibrate)
        ref = fc.fused_schur_cholesky_ref(P, G, d2, equilibrate)
        for a, b in zip(out, ref):
            assert rel(a, b) <= tol
        x = solve(out[0], out[1], rhs)
        assert rel(x, fc.fused_cholesky_solve_ref(ref[0], ref[1], rhs)) \
            <= tol


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
def test_solve_at_largest_n(cuda_device):
    """float64 at the largest n whose right-hand-side row fits a block's
    shared memory, against the plain version; one more panel raises."""
    props = torch.cuda.get_device_properties(cuda_device)
    smem = fc._smem_optin(cuda_device)
    with pytest.raises(ValueError):
        fc.solve_rows(10 ** 6, 1, 8, smem)
    n = fc.BP
    while True:
        try:
            fc.solve_rows(n + fc.BP, 1, 8, smem)
        except ValueError:
            break
        n += fc.BP
    assert 8 * n * n * 3 < props.total_memory
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
    assert float(torch.linalg.vector_norm(x - xr)
                 / torch.linalg.vector_norm(xr)) <= 1e-12
    L2 = torch.zeros((n + fc.BP, n + fc.BP), **kw)
    with pytest.raises(ValueError, match="exceeds"):
        fc.fused_cholesky_solve(
            L2, torch.zeros(((n + fc.BP) // fc.BP, fc.BP, fc.BP), **kw),
            torch.zeros((1, n + fc.BP), **kw))

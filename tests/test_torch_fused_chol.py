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

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)


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


H100_SMEM = 232448   # an H100's opt-in shared memory per block, bytes


# (kind, B, n, m or nrhs) -> [(kernel, grid blocks, tile)]: PERF.md's
# rows 1-4' and B = 1
@pytest.mark.parametrize("kind,B,n,k,launches", [
    ("factor", 64, 256, 256, [("schur_assemble", 192, 128),
                              ("schur_factor", 64, 64)]),
    ("factor", 1024, 256, 512, [("schur_assemble", 3072, 128),
                                ("schur_factor", 1024, 64)]),
    ("factor", 1, 320, 1, [("schur_assemble", 6, 128),
                           ("schur_factor", 1, 64)]),
    ("solve", 64, 256, 1, [("solve_few", 64, 1)]),
    ("solve", 1024, 256, 256, [("solve_many", 4096, 64)]),
    ("solve", 1024, 256, 1, [("solve_few", 1024, 1)]),
    ("solve", 1, 192, 65, [("solve_many", 2, 64)]),
])
def test_launch_config_grids(kind, B, n, k, launches):
    for esize in (4, 8):
        got = fc.launch_config(kind, B, n, k, esize, H100_SMEM)
        assert [(c["kernel"], c["grid"], c["tile"]) for c in got] == \
            launches
        assert all(c["smem"] <= H100_SMEM for c in got)


@pytest.mark.parametrize("nrhs,kernel", [
    (1, "solve_few"), (fc.FEW_RHS, "solve_few"),
    (fc.FEW_RHS + 1, "solve_many"), (64, "solve_many")])
def test_launch_config_few_many_threshold(nrhs, kernel):
    (c,) = fc.launch_config("solve", 2, 128, nrhs, 4, H100_SMEM)
    assert c["kernel"] == kernel


@pytest.mark.parametrize("esize", [4, 8])
def test_launch_config_smem_independent_of_n(esize):
    """Every block holds one panel at most, never a whole right-hand
    side: each kernel's shared memory is the same at any n (n = 64 takes
    schur_chol64 alone, larger n schur_assemble and schur_factor) and
    stays within an H100's."""
    for kind, k in (("factor", 512), ("solve", 1), ("solve", 256)):
        sizes = {}
        for n in range(64, 8193, 64):
            for c in fc.launch_config(kind, 4, n, k, esize, H100_SMEM):
                sizes.setdefault(c["kernel"], set()).add(c["smem"])
        assert all(len(v) == 1 for v in sizes.values()), sizes
        assert max(max(v) for v in sizes.values()) <= H100_SMEM


def test_launch_config_has_no_n_cap():
    """n = 25600 in float64, more than one right-hand side's row would
    leave room for in a block's shared memory, launches like any n."""
    (c,) = fc.launch_config("solve", 1, 25600, 1, 8, H100_SMEM)
    assert c["kernel"] == "solve_few" and c["grid"] == 1


def test_launch_config_refuses():
    with pytest.raises(ValueError, match="multiple"):
        fc.launch_config("solve", 1, 100, 1, 4, H100_SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        fc.launch_config("solve", 1, 256, 256, 8, 48 * 1024)


# ---- schur_chol64: the one-launch factor at n = 64 -------------------------

@pytest.mark.parametrize("B", [1, 16, 1024])
@pytest.mark.parametrize("esize", [4, 8])
def test_launch_config_n64_is_one_launch(B, esize):
    """n = 64 (rows 5 and 14) is one launch of schur_chol64, one block per
    instance, within an H100's shared memory, with or without an SM count
    or equilibration; n = 128 keeps the assembly and the factor apart."""
    for sms in (0, 132):
        for eq in (False, True):
            (c,) = fc.launch_config("factor", B, 64, 400, esize, H100_SMEM,
                                    sms, equilibrate=eq)
            assert (c["kernel"], c["grid"], c["tile"]) == \
                ("schur_chol64", B, 64)
            assert c["smem"] <= H100_SMEM
            assert c["kc"] == fc.CHOL64_KC
    names = [c["kernel"] for c in
             fc.launch_config("factor", B, 128, 400, esize, H100_SMEM)]
    assert names == ["schur_assemble", "schur_factor"]


def _tri_inv_walk(L):
    """inv(L) for lower (B, 64, 64) L as diag_factor forms it: the 8x8
    diagonal blocks' inverses, then X21 = -C^-1 (B A^-1) for the 2x2
    blocks of sizes 16, 32 and 64."""
    eye8 = torch.eye(8, dtype=L.dtype)
    Li = torch.zeros_like(L)
    for base in range(0, 64, 8):
        blk = L[:, base:base + 8, base:base + 8]
        Li[:, base:base + 8, base:base + 8] = torch.linalg.solve_triangular(
            blk, eye8.expand_as(blk), upper=False)
    for h in (8, 16, 32):
        for base in range(0, 64, 2 * h):
            a, c = slice(base, base + h), slice(base + h, base + 2 * h)
            X = L[:, c, a] @ Li[:, a, a]
            Li[:, c, a] = -(Li[:, c, c] @ X)
    return Li


def walk_chol64(P, Gt, dinv2, equilibrate=False, kc=fc.CHOL64_KC):
    """schur_chol64's arithmetic in plain torch, step by step: S = P + Gt
    diag(dinv2) Gt' summed over k-chunks of kc, dinv2 on the row side;
    [equilibrate] S := D S D; the factor by 16-column sub-panels (the
    sub-panel's columns minus those to their left, its 16x16 block's
    Cholesky, the rows below by forward substitution); the inverse by
    8x8 blocks and the 2x2 recursion.  A bad pivot makes the instance all
    NaN.  Gt (B, 64, m) or shared (64, m); dinv2 (B, m)."""
    B = P.shape[0]
    Gt = Gt.expand(B, *Gt.shape[-2:]) if Gt.dim() == 2 else Gt
    m = Gt.shape[-1]
    S = torch.zeros_like(P)
    for k0 in range(0, m, kc):
        A = Gt[..., k0:k0 + kc]
        S = S + (A * dinv2[:, None, k0:k0 + kc]) @ A.transpose(1, 2)
    S = torch.tril(S + P)
    deq = None
    if equilibrate:
        deq = 1.0 / torch.sqrt(torch.clamp(
            torch.diagonal(S, dim1=1, dim2=2), min=1e-30))
        S = S * deq[:, :, None] * deq[:, None, :]
    L = S.clone()
    bad = torch.zeros(B, dtype=torch.bool)
    for q in range(0, 64, 16):
        if q:
            L[:, q:, q:q + 16] -= L[:, q:, :q] @ L[:, q:q + 16, :q].transpose(
                1, 2)
        D, info = torch.linalg.cholesky_ex(torch.tril(L[:, q:q + 16,
                                                        q:q + 16]))
        bad |= (info != 0) | ~torch.isfinite(D).all(-1).all(-1)
        L[:, q:q + 16, q:q + 16] = D
        L[:, q + 16:, q:q + 16] = torch.linalg.solve_triangular(
            D.transpose(1, 2), L[:, q + 16:, q:q + 16], upper=True,
            left=False)
    L = torch.tril(L)
    Dinv = _tri_inv_walk(L)[:, None]
    L[bad] = float("nan")
    Dinv[bad] = float("nan")
    return (L, Dinv) if deq is None else (L, Dinv, deq)


def _chol64_data(B, m, per_instance, seed):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, 64, 64))
    P = F @ F.transpose(0, 2, 1) / 64 + np.diag(rng.uniform(0.5, 1e3, 64))
    Gt = rng.standard_normal((B, 64, m) if per_instance else (64, m))
    d2 = rng.uniform(0.5, 2.0, (B, m))
    return P, Gt, d2


@pytest.mark.parametrize("per_instance", [True, False])
@pytest.mark.parametrize("equilibrate", [False, True])
def test_chol64_walk_matches_jax_reference(per_instance, equilibrate):
    """The walk of schur_chol64 against cvxopt_tpu's fused_schur_cholesky
    `_ref` (vmapped) in float64 at 1e-12 relative Frobenius, m = 157 (not
    a multiple of the chunk, rows not 16-byte aligned).  Equilibrated: the
    JAX reference of D P D and D Gt (D S D = D P D + (D Gt) diag(dinv2)
    (D Gt)'), deq to 1e-13."""
    from cvxopt_tpu.ops import pallas_chol as pc
    B, m = 5, 157
    P, Gt, d2 = _chol64_data(B, m, per_instance, seed=11)
    got = walk_chol64(*_t(P, Gt, d2), equilibrate=equilibrate)
    Pj, Gj, dj = jnp.asarray(P), jnp.asarray(Gt), jnp.asarray(d2)
    gax = 0 if per_instance else None
    if equilibrate:
        S = jax.vmap(lambda p, g, d: p + (g * d) @ g.T,
                     in_axes=(0, gax, 0))(Pj, Gj, dj)
        deq = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(S, axis1=1, axis2=2),
                                         1e-30))
        Pj = Pj * deq[:, :, None] * deq[:, None, :]
        Gj = (Gj if per_instance else Gj[None]) * deq[:, :, None]
        gax = 0
        np.testing.assert_allclose(got[2].numpy(), np.asarray(deq),
                                   rtol=1e-13)
    Lr, Dr = jax.vmap(pc.fused_schur_cholesky_ref,
                      in_axes=(0, gax, 0))(Pj, Gj, dj)
    rel = lambda a, b: float(np.linalg.norm(a.numpy() - np.asarray(b))
                             / np.linalg.norm(np.asarray(b)))
    assert rel(got[0], Lr) <= 1e-12
    assert rel(got[1], Dr) <= 1e-12
    # and the port's plain version, which the card's kernel is held to
    ref = fc.fused_schur_cholesky_ref(*_t(P, Gt, d2), equilibrate)
    for a, b in zip(got, ref):
        assert float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b)) <= 1e-12


def test_chol64_walk_poisons_only_the_bad_instance():
    """A pivot that fails in the third sub-panel makes that instance all
    NaN in L and Dinv, as the plain version does; the others are
    unchanged."""
    P, Gt, d2 = _chol64_data(3, 40, True, seed=12)
    P[1, 40, 40] = -1e6
    L, Dinv = walk_chol64(*_t(P, Gt, d2))
    Lr, Dr = fc.fused_schur_cholesky_ref(*_t(P, Gt, d2))
    assert torch.isnan(L[1]).all() and torch.isnan(Dinv[1]).all()
    assert torch.isnan(Lr[1]).all()
    for k in (0, 2):
        assert torch.allclose(L[k], Lr[k], rtol=0, atol=1e-12 *
                              float(Lr[k].abs().max()))
        assert torch.allclose(Dinv[k], Dr[k], rtol=0, atol=1e-12 *
                              float(Dr[k].abs().max()))

"""The port's CUDA kernels against their plain PyTorch versions on the
card (marked `gpu`; skipped without a CUDA device).

This file imports no jax, so it runs on a machine with torch and a card
but without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

import ctypes
import threading

import numpy as np
import pytest
import torch

from cvxopt_tpu_torch.ops import fused_chol as fc
from cvxopt_tpu_torch import kkt as tk
from cvxopt_tpu_torch import scaling as tsc
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.coneqp import make_coneqp_cascade
from cvxopt_tpu_torch.conelp import make_conelp_cascade

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
    memory, so the kernels keep finished panels in device memory.  Two
    right-hand sides of one instance take panel_solve: 800 blocks, two
    chains of 400 panels a sweep."""
    from chip_smoke import unit_lower
    n = 25600
    g = torch.Generator(device=cuda_device).manual_seed(8)
    kw = dict(dtype=torch.float64, device=cuda_device)
    L, Dinv = unit_lower(n, g, kw)
    rhs = torch.randn((2, n), generator=g, **kw)
    fc.reset_launch_counts()
    x = fc.fused_cholesky_solve(L, Dinv, rhs)
    assert fc.launch_counts()["panel_solve"] == 1
    xr = fc.fused_cholesky_solve_ref(L, Dinv, rhs)
    assert _rel(x, xr) <= 1e-12


# ---- schur_chol64: the one-launch factor at n = 64 ------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("equilibrate", [False, True])
@pytest.mark.parametrize("B,m", [(1, 1), (16, 157), (1024, 400)])
def test_chol64_matches_plain_on_card(cuda_device, dtype, tol, equilibrate,
                                      B, m):
    """schur_chol64 through both factor wrappers (per-instance and shared
    Gt) at rows 5 (B = 1024, m = 400) and 14 (B = 16, m = 157: rows not
    16-byte aligned) and at B = 1: L, Dinv (and deq) within 1e-5 / 1e-12
    of the plain version, L's strict upper triangle 0, one launch of
    schur_chol64 a call."""
    rng = np.random.default_rng(B + m)
    kw = dict(dtype=dtype, device=cuda_device)
    P, Gt, Gtb, d2 = _problem(rng, B, 64, m, kw)
    fc.reset_launch_counts()
    for factor, _, G in _pairs(Gt, Gtb):
        out = factor(P, G, d2, equilibrate=equilibrate)
        ref = fc.fused_schur_cholesky_ref(P, G, d2, equilibrate)
        for a, b in zip(out, ref):
            assert _rel(a, b) <= tol
        assert bool((torch.triu(out[0], 1) == 0).all())
    counts = fc.factor_kernel_counts()
    assert fc.launch_counts()["schur_chol64"] == 2
    assert all(c["schur_factor"] == 0 and c["panel_factor"] == 0
               for c in counts.values())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol64_non_pd_instance_between_pd_ones(cuda_device, dtype):
    """At n = 64, B = 16: instance 5, not PD, comes back all NaN in L and
    Dinv; the others equal, bit for bit, their factor without it."""
    rng = np.random.default_rng(21)
    kw = dict(dtype=dtype, device=cuda_device)
    B, m = 16, 157
    P, Gt, Gtb, d2 = _problem(rng, B, 64, m, kw)
    P[5, 40, 40] = -1e6
    keep = [k for k in range(B) if k != 5]
    for factor, _, G in _pairs(Gt, Gtb):
        L, D = factor(P, G, d2)
        assert bool(torch.isnan(L[5]).all() and torch.isnan(D[5]).all())
        Gk = G[keep].contiguous() if G.dim() == 3 else G
        L2, D2 = factor(P[keep].contiguous(), Gk, d2[keep].contiguous())
        assert torch.equal(L[keep], L2) and torch.equal(D[keep], D2)


# ---- the small-batch kernels (panel_factor, panel_solve) -------------------

def _kernel_of(kind, B, n, k, dtype, device):
    """The factor or solve kernel launch_config picks on this card."""
    esize = torch.empty((), dtype=dtype).element_size()
    cfg = fc.launch_config(kind, B, n, k, esize, fc._smem_optin(device),
                           fc._sms(device))
    return cfg[-1]["kernel"] if kind == "solve" else \
        ("schur_factor" if cfg[-1]["kernel"] == "schur_factor"
         else "panel_factor")


def _convex(B, n, m, kw, seed, shift):
    """S = F F' + shift I + Gt diag(d) Gt' with F (n, n/4), Gt scaled by
    1/sqrt(n): bench.py's large-KKT data (shift 1) at a smaller n."""
    rng = np.random.default_rng(seed)
    F = torch.as_tensor(rng.standard_normal((B, n, max(n // 4, 1))), **kw)
    P = F @ F.transpose(1, 2) + shift * torch.eye(n, **kw)
    Gt = torch.as_tensor(rng.standard_normal((B, n, m)) / np.sqrt(n), **kw)
    d2 = torch.as_tensor(rng.uniform(0.5, 2.0, (B, m)), **kw)
    return P, Gt, d2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("equilibrate", [False, True])
@pytest.mark.parametrize("B,n", [(1, 128), (2, 128), (8, 128), (1, 1280),
                                 (2, 1280), (8, 1280), (1, 4096),
                                 (2, 4096), (8, 4096)])
def test_small_batch_kernels_match_plain_on_card(cuda_device, monkeypatch,
                                                 dtype, tol, equilibrate,
                                                 B, n):
    """panel_factor (per-instance and shared Gt) and panel_solve at nrhs 1
    and 2 against the plain versions; L's strict upper triangle is 0.
    The n thresholds are set to one panel, so that n = 128 takes the
    small-batch kernels too.
    P is shifted by n I, as the other kernel tests' data, so that S's
    condition number stays near 3 and the float32 tolerance measures the
    kernel's arithmetic rather than the condition number."""
    monkeypatch.setattr(fc, "PANEL_FACTOR_MIN_N", fc.BP)
    monkeypatch.setattr(fc, "PANEL_SOLVE_MIN_N", fc.BP)
    kw = dict(dtype=dtype, device=cuda_device)
    P, Gtb, d2 = _convex(B, n, 192, kw, seed=n + B, shift=n)
    assert _kernel_of("factor", B, n, 1, dtype, cuda_device) == \
        "panel_factor"
    fc.reset_launch_counts()
    for Gt, factor in ((Gtb, fc.fused_schur_cholesky),
                       (Gtb[0], lambda P, G, d, equilibrate:
                        fc.fused_schur_cholesky_batched(
                            P, G, d, tb=1, equilibrate=equilibrate))):
        out = factor(P, Gt, d2, equilibrate=equilibrate)
        ref = fc.fused_schur_cholesky_ref(P, Gt, d2, equilibrate)
        for a, b in zip(out, ref):
            assert _rel(a, b) <= tol
        assert bool((torch.triu(out[0], 1) == 0).all())
    assert fc.launch_counts()["panel_factor"] == 2
    g = torch.Generator(device=cuda_device).manual_seed(n)
    for nrhs in (1, 2):
        assert _kernel_of("solve", B, n, nrhs, dtype, cuda_device) == \
            "panel_solve"
        rhs = torch.randn((B, nrhs, n), generator=g, **kw)
        x = fc.fused_cholesky_solve(out[0], out[1], rhs)
        xr = fc.fused_cholesky_solve_ref(out[0], out[1], rhs)
        assert _rel(x, xr) <= tol, nrhs
    assert fc.launch_counts()["panel_solve"] == 2


def _unit_lower_batch(B, n, g, kw):
    """B well-conditioned unit lower-triangular factors and their Dinv
    (chip_smoke.unit_lower, one per instance)."""
    from chip_smoke import unit_lower
    pairs = [unit_lower(n, g, kw) for _ in range(B)]
    return (torch.stack([p[0] for p in pairs]),
            torch.stack([p[1] for p in pairs]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("n,pairs", [
    (512, [(1, 1), (33, 1), (1, 4), (8, 4)]),
    (1280, [(1, 1), (33, 1), (1, 4), (8, 4)]),
    (10240, [(1, 1), (1, 4)])])
def test_panel_solve_matches_plain_on_card(cuda_device, dtype, tol, n,
                                           pairs):
    """panel_solve against the plain version at (B, nrhs) with B nrhs up
    to 33, on well-conditioned unit lower factors: within 1e-5 / 1e-12,
    and two runs give equal bits."""
    kw = dict(dtype=dtype, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(n)
    for B, nrhs in pairs:
        assert _kernel_of("solve", B, n, nrhs, dtype, cuda_device) == \
            "panel_solve"
        L, D = _unit_lower_batch(B, n, g, kw)
        rhs = torch.randn((B, nrhs, n), generator=g, **kw)
        fc.reset_launch_counts()
        x = fc.fused_cholesky_solve(L, D, rhs)
        x2 = fc.fused_cholesky_solve(L, D, rhs)
        assert fc.launch_counts()["panel_solve"] == 2
        assert _rel(x, fc.fused_cholesky_solve_ref(L, D, rhs)) <= tol, \
            (B, nrhs)
        assert torch.equal(x, x2), (B, nrhs)
        del L, D


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_small_batch_non_pd_instance_between_pd_ones(cuda_device, dtype):
    """On the small-batch path the middle instance, not PD from its sixth
    panel on, comes back all NaN in L, Dinv and the solve; its neighbours
    agree with the plain version and equal, bit for bit, their factor
    without it."""
    B, n = 3, 1280
    kw = dict(dtype=dtype, device=cuda_device)
    P, Gt, d2 = _convex(B, n, 128, kw, seed=11, shift=n)
    P[1, 350, 350] = -1e6
    L, D = fc.fused_schur_cholesky(P, Gt, d2)
    Lr, Dr = fc.fused_schur_cholesky_ref(P, Gt, d2)
    tol = dict(TOLS)[dtype]
    assert bool(torch.isnan(L[1]).all() and torch.isnan(D[1]).all())
    for k in (0, 2):
        assert _rel(L[k], Lr[k]) <= tol and _rel(D[k], Dr[k]) <= tol
    two = [0, 2]
    L2, D2 = fc.fused_schur_cholesky(P[two].contiguous(),
                                     Gt[two].contiguous(), d2[two])
    assert torch.equal(L[two], L2) and torch.equal(D[two], D2)
    x = fc.fused_cholesky_solve(L, D, torch.ones((B, 1, n), **kw))
    assert bool(torch.isnan(x[1]).all())
    assert bool(torch.isfinite(x[0]).all() and torch.isfinite(x[2]).all())


# ---- the f64 factor on the FP64 tensor cores, with the lookahead ----------

@pytest.mark.gpu
@pytest.mark.parametrize("B,n,m,per_instance", [
    (1024, 320, 513, True), (1024, 320, 513, False),   # row 9 (cpl)
    (1, 192, 378, False), (1, 192, 378, True),         # row 12 (boeing2)
    (16, 64, 157, False), (16, 64, 157, True),         # row 14 (milp)
    (8, 1280, 1248, True), (8, 1280, 1248, False),     # row 16 (parallel)
    (1, 10240, 10240, False)])                         # row 19 (large_kkt)
def test_f64_assembly_matches_plain_on_card(cuda_device, B, n, m,
                                            per_instance):
    """The DMMA schur_assemble alone at PERF.md's f64 rows' shapes, Gt
    shared or per instance, m odd (rows not 16-byte aligned) or even: the
    lower triangle of S within 1e-12 of torch's."""
    kw = dict(dtype=torch.float64, device=cuda_device)
    P, Gtb, d2 = _convex(B if per_instance else 1, n, m, kw, seed=n + m,
                         shift=1.0)
    if not per_instance:
        P = P.expand(B, n, n).contiguous()
        d2 = torch.as_tensor(np.random.default_rng(m).uniform(
            0.5, 2.0, (B, m)), **kw)
    Gt = Gtb if per_instance else Gtb[0]
    L = torch.empty((B, n, n), **kw)
    fc._assemble(P, Gt, Gt.stride(0) if per_instance else 0, d2,
                 d2.stride(0), L)
    S = P + (Gt * d2.unsqueeze(-2)) @ Gt.transpose(-1, -2)
    low = torch.ones((n, n), dtype=torch.bool, device=cuda_device).tril()
    assert _rel(torch.where(low, L, 0.0), torch.where(low, S, 0.0)) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1280, 4096, 10240])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_lookahead_factor_matches_plain_on_card(cuda_device, B, n):
    """The f64 panel_factor with the lookahead (strip on the main stream,
    the rest of each trailing update on the side stream) on bench.py's
    large-KKT data (P = F F' + I): L and Dinv within 1e-12 of the plain
    version, L's strict upper triangle 0, the result the same on a
    second call."""
    kw = dict(dtype=torch.float64, device=cuda_device)
    P, Gt, d2 = _convex(B, n, 192, kw, seed=n + B, shift=1.0)
    plan = fc.launch_config("factor", B, n, 192, 8,
                            fc._smem_optin(cuda_device), fc._sms(cuda_device))
    assert {c.get("stream") for c in plan[1:]} == {"main", "side"}
    fc.reset_launch_counts()
    L, D = fc.fused_schur_cholesky(P, Gt, d2)
    assert fc.launch_counts()["panel_factor"] == 1
    Lr, Dr = fc.fused_schur_cholesky_ref(P, Gt, d2)
    assert _rel(L, Lr) <= 1e-12 and _rel(D, Dr) <= 1e-12
    assert bool((torch.triu(L, 1) == 0).all())
    del Lr, Dr
    L2, D2 = fc.fused_schur_cholesky(P, Gt, d2)
    assert torch.equal(L, L2) and torch.equal(D, D2)


@pytest.mark.gpu
def test_lookahead_non_pd_instance_between_pd_ones(cuda_device):
    """f64 at n = 4096: the middle instance is not PD from its 32nd panel
    on (the eighth outer panel, after seven split trailing updates): it
    alone comes back all NaN; its neighbours agree with the plain version
    and equal, bit for bit, their factor without it."""
    B, n = 3, 4096
    kw = dict(dtype=torch.float64, device=cuda_device)
    P, Gt, d2 = _convex(B, n, 128, kw, seed=12, shift=1.0)
    P[1, 2000, 2000] = -1e6
    L, D = fc.fused_schur_cholesky(P, Gt, d2)
    Lr, Dr = fc.fused_schur_cholesky_ref(P, Gt, d2)
    assert bool(torch.isnan(L[1]).all() and torch.isnan(D[1]).all())
    for k in (0, 2):
        assert _rel(L[k], Lr[k]) <= 1e-12 and _rel(D[k], Dr[k]) <= 1e-12
    two = [0, 2]
    L2, D2 = fc.fused_schur_cholesky(P[two].contiguous(),
                                     Gt[two].contiguous(), d2[two])
    assert torch.equal(L[two], L2) and torch.equal(D[two], D2)


def _panel_factor_with(L, D, codes, nlaunch):
    """panel_factor on L (assembled S) with the encoded plan `codes`."""
    bad = torch.zeros(L.shape[0], dtype=torch.int32, device=L.device)
    plan = (ctypes.c_int * len(codes))(*codes)
    fc._run("panel_factor", L, L.data_ptr(), D.data_ptr(), None,
            bad.data_ptr(), L.shape[0], L.shape[-1], plan, nlaunch)


@pytest.mark.gpu
def test_panel_factor_runs_only_the_plan_launch_config_lists(cuda_device):
    """f64 at n = 1280 (forked): the launcher runs the plan of
    launch_config, and refuses, before it launches anything, the same plan
    with one wait dropped, one record dropped, one launch moved to the
    other stream, one column range changed, or the last launch cut."""
    B, n = 1, 1280
    kw = dict(dtype=torch.float64, device=cuda_device)
    P, Gt, d2 = _convex(B, n, 192, kw, seed=3, shift=1.0)
    S = P + (Gt * d2.unsqueeze(-2)) @ Gt.transpose(-1, -2)
    plan = fc.launch_config("factor", B, n, 192, 8,
                            fc._smem_optin(cuda_device),
                            fc._sms(cuda_device))[1:]
    codes = fc.plan_codes(plan, n)
    D = torch.empty((B, n // fc.BP, fc.BP, fc.BP), **kw)
    L = S.clone()
    _panel_factor_with(L, D, codes, len(plan))
    Lr, Dr = fc.fused_schur_cholesky_ref(P, Gt, d2)
    assert _rel(L, Lr) <= 1e-12 and _rel(D, Dr) <= 1e-12

    strip = next(i for i, c in enumerate(plan) if c.get("waits") == ["rest"]
                 and c["kernel"] == "trail_update")
    rest = next(i for i, c in enumerate(plan) if c.get("part") == "rest")
    chain = rest - 2        # records "panel" before the strip and the rest
    assert plan[chain]["records"] == ["panel"]
    wrong = {"no wait": (strip, 4, 0), "no record": (chain, 5, 0),
             "rest on main": (rest, 3, fc.PLAN_STREAMS.index("main")),
             "col1": (rest, 10, n - fc.BP)}
    for name, (i, k, v) in wrong.items():
        bad = list(codes)
        bad[fc.PLAN_INTS * i + k] = v
        assert bad != codes, name
        L = S.clone()
        with pytest.raises(RuntimeError, match="disagrees"):
            _panel_factor_with(L, D, bad, len(plan))
        torch.cuda.synchronize()
        assert torch.equal(L, S), name
    with pytest.raises(RuntimeError, match="disagrees"):
        _panel_factor_with(S.clone(), D, codes[:-fc.PLAN_INTS],
                           len(plan) - 1)


@pytest.mark.gpu
def test_lookahead_factors_from_two_host_threads(cuda_device):
    """Two host threads, each on its own stream, factor at n = 1280 (f64,
    B = 1, forked) at the same time, eight times each: the calls share one
    device's lookahead streams and events, and every result equals the
    plain version within 1e-12."""
    n, reps = 1280, 8
    kw = dict(dtype=torch.float64, device=cuda_device)
    data = [_convex(1, n, 192, kw, seed=40 + t, shift=1.0) for t in (0, 1)]
    refs = [fc.fused_schur_cholesky_ref(*d) for d in data]
    torch.cuda.synchronize()
    start = threading.Barrier(2)
    outs = [[], []]

    def work(t):
        with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
            start.wait()
            for _ in range(reps):
                outs[t].append(fc.fused_schur_cholesky(*data[t]))
            torch.cuda.current_stream().synchronize()

    threads = [threading.Thread(target=work, args=(t,)) for t in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    for t in (0, 1):
        assert len(outs[t]) == reps
        for L, D in outs[t]:
            assert _rel(L, refs[t][0]) <= 1e-12
            assert _rel(D, refs[t][1]) <= 1e-12


def _interior(rng, d, B):
    v = np.zeros((B, d.cdim))
    v[:, :d.l] = rng.uniform(0.5, 2, (B, d.l))
    off = d.l
    for m in d.q:
        v[:, off] = 1.0 + rng.uniform(0, 1, B)
        v[:, off + 1:off + m] = \
            rng.standard_normal((B, m - 1)) * 0.3 / np.sqrt(m)
        off += m
    for m in d.s:
        X = rng.standard_normal((B, m, m))
        v[:, off:off + m * m] = \
            (X @ X.transpose(0, 2, 1) + np.eye(m)).reshape(B, -1)
        off += m * m
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("fd,tol", [(None, 1e-9), ("float32", 1e-4)])
@pytest.mark.parametrize("name", ["chol2", "chol2_inv"])
@pytest.mark.parametrize("n", [40, 64])
def test_kkt_chol2_qs_branch_on_kernels(cuda_device, n, name, fd, tol):
    """kkt_chol2 on 'q'/'s' cones factors S = H + Gs'Gs in the fused
    kernels (Gt = Gs', dinv2 = 1; n = 40 is padded to 64): the solve on
    the card against the same call on CPU tensors (the kernels' plain
    versions), with one W handed to both."""
    dims = ConeDims(l=3, q=(4, 4, 5), s=(3,))
    rng = np.random.default_rng(11)
    B, m = 5, dims.cdim
    F = rng.standard_normal((B, n, n)) / np.sqrt(n)
    P = torch.as_tensor(F @ F.transpose(0, 2, 1) + 0.1 * np.eye(n))
    G = torch.as_tensor(rng.standard_normal((B, m, n)))
    A = torch.as_tensor(rng.standard_normal((1, n)))
    s, z = (torch.as_tensor(_interior(rng, dims, B)) for _ in range(2))
    W, _ = tsc.compute_scaling(s, z, dims)
    rhs = [torch.as_tensor(rng.standard_normal((B, k))) for k in (n, 1, m)]
    ref = tk.get_kktsolver(name, G, dims, A, factor_dtype=fd)(W, P)(*rhs)

    def cu(t):
        return t.to(cuda_device)

    Wc = {k: ([cu(u) for u in v] if isinstance(v, list) else cu(v))
          for k, v in W.items()}
    fc.reset_launch_counts()
    out = tk.get_kktsolver(name, cu(G), dims, cu(A), factor_dtype=fd)(
        Wc, cu(P))(*map(cu, rhs))
    counts = fc.launch_counts()
    assert counts["fused_schur_cholesky"] == 1
    assert counts["fused_cholesky_solve"] >= 1
    for u, v in zip(out, ref):
        scale = max(1.0, float(v.abs().max()))
        assert float((u.cpu() - v).abs().max()) <= tol * scale


@pytest.mark.gpu
def test_small_socp_on_card_matches_cpu(cuda_device):
    """The SOC cascade (n = 16, 8 blocks of 4, B = 8) on the card against
    the CPU run: all solved at 1e-7, x within 1e-6."""
    rng = np.random.default_rng(12)
    nb, n, nq, mq = 8, 16, 8, 4
    m = nq * mq
    F = rng.standard_normal((nb, n, n // 4)) / np.sqrt(n)
    P = F @ F.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = -rng.uniform(0.0, 0.1, (nb, n))
    G = 0.3 * rng.standard_normal((nb, m, n))
    h = 0.1 * rng.standard_normal((nb, nq, mq))
    h[:, :, 0] = 1.0
    data = (P, q, G, h.reshape(nb, m), np.zeros((nb, 0, n)),
            np.zeros((nb, 0)))
    kw = dict(kktsolver="chol2_inv", maxiters=50, abstol=1e-7,
              reltol=1e-7, feastol=1e-7, shared_GhAb=False)
    dims = ConeDims(q=(mq,) * nq)
    ref = make_coneqp_cascade(dims, device="cpu", **kw)(*data)
    fc.reset_launch_counts()
    out = make_coneqp_cascade(dims, device=cuda_device, **kw)(*data)
    assert fc.launch_counts()["fused_schur_cholesky"] > 0
    assert (out["status"] == 0).all() and (ref["status"] == 0).all()
    assert max(float(out[k].max()) for k in ("gap", "pres", "dres")) <= 1e-7
    assert float((out["x"].cpu() - ref["x"]).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_small_lp_on_card_matches_cpu(cuda_device):
    """The cone-LP cascade on 'l' cones (n = 24, B = 8, shared G/h/A/b)
    on the card against the CPU run."""
    rng = np.random.default_rng(13)
    nb, n = 8, 24
    c = -rng.uniform(0.0, 0.1, (nb, n))
    eye = np.eye(n)
    data = (c, np.concatenate([-eye, eye]),
            np.concatenate([np.zeros(n), np.ones(n)]), np.ones((1, n)),
            np.ones(1))
    kw = dict(kktsolver="chol2", maxiters=50, abstol=1e-7, reltol=1e-7,
              feastol=1e-7)
    dims = ConeDims(l=2 * n)
    ref = make_conelp_cascade(dims, device="cpu", **kw)(*data)
    fc.reset_launch_counts()
    out = make_conelp_cascade(dims, device=cuda_device, **kw)(*data)
    assert fc.launch_counts()["fused_schur_cholesky_batched"] > 0
    assert (out["status"] == 0).all() and (ref["status"] == 0).all()
    assert max(float(out[k].max()) for k in ("gap", "pres", "dres")) <= 1e-7
    assert float((out["x"].cpu() - ref["x"]).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_adaptive_factor_on_card_matches_cpu(cuda_device):
    """factor_dtype='adaptive' takes its float32 factor from the fused
    kernels on the card: a well-conditioned and an ill-conditioned
    instance against the same call on CPU tensors."""
    n, m = 24, 8
    dims = ConeDims(l=m)
    rng = np.random.default_rng(14)
    G = torch.as_tensor(rng.standard_normal((m, n)))
    A = torch.as_tensor(rng.standard_normal((1, n)))
    P = torch.eye(n, dtype=torch.float64).expand(2, n, n)
    s, z = np.ones((2, m)), np.ones((2, m))
    s[1], z[1] = np.logspace(-7, 0, m), np.logspace(0, -7, m)
    W, _ = tsc.compute_scaling(torch.as_tensor(s), torch.as_tensor(z), dims)
    rhs = [torch.as_tensor(rng.standard_normal((2, k))) for k in (n, 1, m)]
    ref = tk.get_kktsolver("chol2", G, dims, A,
                           factor_dtype="adaptive")(W, P)(*rhs)

    def cu(t):
        return t.to(cuda_device)

    Wc = {k: ([cu(u) for u in v] if isinstance(v, list) else cu(v))
          for k, v in W.items()}
    fc.reset_launch_counts()
    out = tk.get_kktsolver("chol2", cu(G), dims, cu(A),
                           factor_dtype="adaptive")(Wc, cu(P))(*map(cu, rhs))
    assert fc.launch_counts()["fused_schur_cholesky"] == 1
    for u, v in zip(out, ref):
        scale = max(1.0, float(v.abs().max()))
        assert float((u.cpu() - v).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("nrhs", [1, 64])
def test_cpl_kernel_shapes_match_plain_on_card(cuda_device, nrhs):
    """The batched cpl path's f64 shapes (chip_smoke.py rows 9-11): the
    per-instance factor at n = 320 (257 padded), m = 513, and its solves
    at nrhs 1 and 64, B = 16 (on an H100 the small-batch kernels at nrhs
    1, solve_many at 64)."""
    rng = np.random.default_rng(15)
    B, n, m = 16, 320, 513
    kw = dict(dtype=torch.float64, device=cuda_device)
    P, _, Gtb, _ = _problem(rng, B, n, m, kw)
    ones = torch.ones((B, m), **kw)
    fc.reset_launch_counts()
    L, D = fc.fused_schur_cholesky(P, Gtb, ones)
    Lr, Dr = fc.fused_schur_cholesky_ref(P, Gtb, ones)
    assert _rel(L, Lr) <= 1e-12 and _rel(D, Dr) <= 1e-12
    rhs = torch.as_tensor(rng.standard_normal((B, nrhs, n)), **kw)
    x = fc.fused_cholesky_solve(L, D, rhs)
    assert _rel(x, fc.fused_cholesky_solve_ref(Lr, Dr, rhs)) <= 1e-12
    kernel = _kernel_of("solve", B, n, nrhs, torch.float64, cuda_device)
    assert fc.solve_kernel_counts()["fused_cholesky_solve"][kernel] == 1


@pytest.mark.gpu
def test_batched_cpl_on_card_matches_cpu(cuda_device):
    """make_cpl with 'chol2' on 16 acent2 problems (n = 64 plus the
    epigraph variable) on the card against the CPU run: statuses and
    iterations equal, x within 1e-6, the unbatched kernels launched."""
    from cvxopt_tpu_torch.cvxprog import make_cpl
    n, p, B = 64, 16, 16
    rng = np.random.default_rng(16)
    Au = rng.standard_normal((p, n))
    eye = np.eye(n)
    data = (np.eye(n + 1)[n], np.eye(n + 1)[n],
            np.concatenate([np.concatenate([eye, -eye]),
                            np.zeros((2 * n, 1))], axis=1),
            np.ones(2 * n), np.concatenate([Au, np.zeros((p, 1))], axis=1),
            rng.uniform(-0.5, 0.5, (B, n)) @ Au.T)

    def F(x):
        return (-torch.log(1.0 - x[:n] ** 2).sum() - x[n]).reshape(1)

    dims = ConeDims(l=2 * n, mnl=1)
    ref = make_cpl(dims, F, kktsolver="chol2", device="cpu")(*data)
    fc.reset_launch_counts()
    out = make_cpl(dims, F, kktsolver="chol2", device=cuda_device)(*data)
    assert fc.launch_counts()["fused_schur_cholesky"] > 0
    assert fc.solve_kernel_counts()["fused_cholesky_solve"]["solve_many"] > 0
    assert (out["status"] == 0).all() and (ref["status"] == 0).all()
    assert torch.equal(out["iterations"].cpu(), ref["iterations"])
    assert float((out["x"].cpu() - ref["x"]).abs().max()) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,m,nrhs", [(1, 192, 378, 4), (16, 64, 157, 1),
                                        (5, 64, 125, 1)])
def test_lp_milp_kernel_shapes_match_plain_on_card(cuda_device, B, n, m,
                                                   nrhs):
    """The lp_milp path's f64 shapes (chip_smoke.py): the batched pair
    with shared Gt and P = 0 at boeing2's (n = 143 padded to 192,
    m = 378, solves at nrhs 1 and 4) and at the ilp node batches'
    (n = 60 padded to 64, m = 157 with the cut pool, 125 without)."""
    rng = np.random.default_rng(17)
    kw = dict(dtype=torch.float64, device=cuda_device)
    _, Gt, _, d2 = _problem(rng, B, n, m, kw)
    P = torch.zeros((B, n, n), **kw)
    L, D = fc.fused_schur_cholesky_batched(P, Gt, d2, tb=1)
    Lr, Dr = fc.fused_schur_cholesky_ref(P, Gt, d2)
    assert _rel(L, Lr) <= 1e-12 and _rel(D, Dr) <= 1e-12
    for k in {1, nrhs}:
        rhs = torch.as_tensor(rng.standard_normal((B, k, n)), **kw)
        x = fc.fused_cholesky_solve_batched(L, D, rhs, tb=1)
        assert _rel(x, fc.fused_cholesky_solve_ref(Lr, Dr, rhs)) <= 1e-12


@pytest.mark.gpu
def test_simplex_on_card_matches_cpu(cuda_device):
    """make_simplex(batched=True) on 32 of bench.py's vertex LPs on the
    card against the CPU run: equal codes, x within 1e-9."""
    from chip_smoke import vertex_lps
    from cvxopt_tpu_torch.simplex import make_simplex
    (c, G, h, A, b), _ = vertex_lps(nb=32)
    args = (c, G, h, A, b)
    out = make_simplex(16, 40, 1, 400, batched=True,
                       device=cuda_device)(*args)
    ref = make_simplex(16, 40, 1, 400, batched=True, device="cpu")(*args)
    assert torch.equal(out[0].cpu(), ref[0]) and (ref[0] == 0).all()
    assert float((out[1].cpu() - ref[1]).abs().max()) <= 1e-9


@pytest.mark.gpu
def test_ilp_on_card_matches_cpu(cuda_device):
    """glpk.ilp on a 20-binary knapsack on the card against the CPU run:
    the same status and objective, the batched kernel pair launched."""
    from cvxopt_tpu_torch import glpk
    rng = np.random.default_rng(18)
    c = -rng.uniform(1, 10, 20)
    W = rng.uniform(1, 10, (3, 20))
    cap = 0.3 * W.sum(axis=1)
    kw = dict(B=list(range(20)), node_batch=8, max_nodes=2000)
    ref = glpk.ilp(c, W, cap, device="cpu", **kw)
    fc.reset_launch_counts()
    out = glpk.ilp(c, W, cap, device=cuda_device, **kw)
    assert fc.launch_counts()["fused_schur_cholesky_batched"] > 0
    assert out[0] == ref[0] == "optimal"
    assert abs(float(c @ out[1]) - float(c @ ref[1])) <= 1e-6


@pytest.mark.gpu
def test_lp_sparse_on_card_matches_cpu(cuda_device):
    """lp_sparse on the chain LP at n = 2000: the card's blocked factor
    against the port's CPU run ('auto': one row per step there), equal
    status and iterations, x within 1e-6."""
    from chip_smoke import chain_lp
    from cvxopt_tpu_torch.ops import sparse_kkt as sk
    c, G, h = chain_lp(2000, seed=3)
    out = sk.lp_sparse(c, G, h, options={"maxiters": 30},
                       device=cuda_device)
    ref = sk.lp_sparse(c, G, h, options={"maxiters": 30}, device="cpu")
    assert out["status"] == ref["status"] == "optimal"
    assert out["iterations"] == ref["iterations"]
    assert float((out["x"].cpu() - ref["x"]).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_auto_picks_blocked_on_card(cuda_device, monkeypatch):
    from chip_smoke import chain_lp
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.ops import banded, sparse_kkt as sk
    _, G, _ = chain_lp(300)
    calls = []
    orig = banded.pbtrf_blocked
    monkeypatch.setattr(banded, "pbtrf_blocked",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    monkeypatch.setattr(banded, "pbtrf", None)
    kkt = sk.kkt_chol2_banded(G, ConeDims(l=G.shape[0]), device=cuda_device)
    kkt({"di": torch.ones(G.shape[0], dtype=torch.float64,
                          device=cuda_device)})
    assert calls == [1]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["banded", "blocksparse"])
def test_cholmod_sys_codes_on_card(cuda_device, route):
    """The CHOLMOD sys table on the card's banded (block-panel factor
    in band storage) and blocksparse routes against the CPU's, 1e-12
    relative; sys 2-5 exist on the banded route only."""
    from chip_smoke import arrow_spd, banded_spd
    from cvxopt_tpu_torch import cholmod
    A = banded_spd(300, 3, 0) if route == "banded" else arrow_spd(512, 8, 1)
    symb = cholmod.symbolic(A)
    assert (symb.banded if route == "banded" else symb.bsp is not None)
    Fg = cholmod.numeric(A, symb, device=cuda_device)
    Fc = cholmod.numeric(A, symb, device="cpu")
    b = np.random.default_rng(42).standard_normal(A.shape[0])
    codes = range(9) if route == "banded" else (0, 1, 6, 7, 8)
    for sys in codes:
        x = cholmod.solve(Fg, b, sys=sys).cpu()
        want = cholmod.solve(Fc, b, sys=sys)
        assert _rel(x, want) <= 1e-12, sys
    x0 = cholmod.solve(Fg, b).cpu().numpy()
    assert np.linalg.norm(A @ x0 - b) <= 1e-10 * np.linalg.norm(b)


@pytest.mark.gpu
def test_umfpack_and_namespaces_on_card(cuda_device):
    from chip_smoke import unsym_arrow
    from cvxopt_tpu_torch import umfpack
    from cvxopt_tpu_torch.ops import lapack
    from cvxopt_tpu_torch.utils import fft
    A = unsym_arrow(600, head=12, seed=7)
    b = np.random.default_rng(4).standard_normal(600)
    F = umfpack.numeric(A, umfpack.symbolic(A), device=cuda_device)
    for trans, M in (("N", A), ("T", A.T)):
        x = umfpack.solve(F, b, trans=trans).cpu().numpy()
        assert np.linalg.norm(M @ x - b) <= 1e-12 * np.linalg.norm(b)
    M = torch.as_tensor(np.random.default_rng(5).standard_normal((64, 64)),
                        device=cuda_device)
    S, w, V = lapack.gees(M)
    assert S.device.type == "cuda"
    assert _rel(V @ S @ V.T, M) <= 1e-12
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(33),
                        device=cuda_device)
    for t in (1, 2, 3, 4):
        assert _rel(fft.idct(fft.dct(x, type=t), type=t), x) <= 1e-12


# ---- the parallel layer ---------------------------------------------------

@pytest.mark.gpu
def test_block_qp_local_factor_on_card(cuda_device):
    """The n = 10,240 block QP's local factor as the block kktsolver hands
    it to the kernels at W = 1.1 I (K = 8, nk = 1248 padded to 1280, m =
    1248), and its solves at nrhs 256 (D^-1 U) and 1, against the plain
    versions, 1e-12 relative."""
    from chip_smoke import BLOCK_QP, BLOCK_QP_D, block_factor_inputs
    from cvxopt_tpu_torch.parallel.schur import random_block_qp
    qp = random_block_qp(**BLOCK_QP, device=cuda_device)
    P, Gt, d2 = block_factor_inputs(qp, BLOCK_QP_D)
    L, D = fc.fused_schur_cholesky(P, Gt, d2)
    Lr, Dr = fc.fused_schur_cholesky_ref(P, Gt, d2)
    assert _rel(L, Lr) <= 1e-12 and _rel(D, Dr) <= 1e-12
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for nrhs in (256, 1):
        rhs = torch.randn((8, nrhs, P.shape[-1]), dtype=torch.float64,
                          device=cuda_device, generator=g)
        assert _rel(fc.fused_cholesky_solve(L, D, rhs),
                    fc.fused_cholesky_solve_ref(L, D, rhs)) <= 1e-12


@pytest.mark.gpu
def test_nccl_world_size_one_collectives(cuda_device, tmp_path):
    """An NCCL group of one rank (file rendezvous): every collective on
    the card against the single-device cone functions (chip_smoke.py's
    parallel_collectives), and the dryrun's sharded paths against their
    unsharded runs."""
    import datetime
    import torch.distributed as dist
    from chip_smoke import parallel_collectives, parallel_dryrun
    from cvxopt_tpu_torch.parallel import make_mesh
    torch.cuda.set_device(cuda_device if cuda_device.index is not None
                          else 0)
    dist.init_process_group(
        "nccl", init_method="file://" + str(tmp_path / "rdv"),
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        assert dist.get_backend() == "nccl"
        dev = torch.device("cuda", torch.cuda.current_device())
        errs = parallel_collectives(make_mesh(1, axis="shards"), dev)
        assert max(errs.values()) <= 1e-12
        rec = parallel_dryrun(make_mesh(1), make_mesh(1, axis="cone"), dev)
        assert rec["conesolve"]["status"] == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_block_kktsolver_on_card_matches_cpu(cuda_device):
    """A small block QP ('q' cones, local equalities) through coneqp with
    the block kktsolver on the card against the CPU run: the kernels
    launched, equal status and iterations, x within 1e-9."""
    from cvxopt_tpu_torch.coneqp import coneqp
    from cvxopt_tpu_torch.parallel.schur import (
        random_block_qp, make_block_kktsolver)
    kw = dict(K=4, nk=8, n0=4, l=5, q=(3,), pk=2, seed=2)
    out = {}
    for dev in (cuda_device, "cpu"):
        qp = random_block_qp(**kw, device=dev)
        fc.reset_launch_counts()
        out[str(dev)] = coneqp(
            qp.flat_P(), qp.flat_q(), qp.flat_G(), qp.flat_h(),
            dims=qp.dims, A=qp.flat_A(), b=qp.flat_b(),
            kktsolver=make_block_kktsolver(qp), device=dev)
        if dev == cuda_device:
            assert fc.launch_counts()["fused_schur_cholesky"] > 0
    gpu, cpu = out[str(cuda_device)], out["cpu"]
    assert gpu["status"] == cpu["status"] == "optimal"
    assert gpu["iterations"] == cpu["iterations"]
    assert float((gpu["x"].cpu() - cpu["x"]).abs().max()) <= 1e-9


@pytest.mark.gpu
def test_make_mesh_on_card_needs_a_process_group(cuda_device):
    """No process group, no mesh: make_mesh raises on the card as on the
    CPU (there is no one-rank mesh whose collectives do nothing)."""
    import torch.distributed as dist
    from cvxopt_tpu_torch.parallel import make_mesh, sharded_batch_solve
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device=cuda_device)
    with pytest.raises(RuntimeError, match="process group"):
        sharded_batch_solve(lambda u: {"x": u},
                            (torch.ones(2, device=cuda_device),))

"""The small-batch path of the fused-Cholesky kernels (panel_factor,
panel_solve in cvxopt_tpu_torch/csrc/fused_chol.cu), on the CPU: which
calls take it, and plain-torch walks of the launch plans that
`fused_chol.launch_config` returns, step by step as the kernels run
them, against the plain versions and the JAX package's Pallas kernels.

The kernels themselves run only on the card (tests/test_torch_gpu.py,
chip_smoke.py); these walks check the plans they follow: the panel and
update-rank schedule of the factor, and the ticket order of the solve,
in which every block's inputs come from blocks with lower tickets."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl

from cvxopt_tpu_torch.ops import fused_chol as fc

torch.set_num_threads(1)

H100_SMEM = 232448   # an H100's opt-in shared memory per block, bytes
H100_SMS = 132       # and its streaming multiprocessors


# ---- which calls take the small-batch kernels ---------------------------

# PERF.md's kernel rows: (kind, B, n, m or nrhs)
ROWS_ONE_BLOCK = {          # one block per instance (per right-hand side)
    "1": ("factor", 64, 256, 256), "2": ("solve", 64, 256, 1),
    "3": ("factor", 1024, 256, 512), "4": ("solve", 1024, 256, 256),
    "4'": ("solve", 1024, 256, 1), "5": ("factor", 1024, 64, 400),
    "6": ("solve", 1024, 64, 64), "6'": ("solve", 1024, 64, 1),
    "7": ("factor", 1024, 256, 512), "8": ("solve", 1024, 256, 1),
    "9": ("factor", 1024, 320, 513), "10": ("solve", 1024, 320, 1),
    "11": ("solve", 1024, 320, 64),
    # below the measured n thresholds
    "12": ("factor", 1, 192, 378), "13": ("solve", 1, 192, 1),
    "13/nrhs4": ("solve", 1, 192, 4), "14": ("factor", 16, 64, 157),
    "15": ("solve", 16, 64, 1),
    # 2048 (instance, right-hand side) pairs fill the card already
    "17": ("solve", 8, 1280, 256),
}
ROWS_SMALL_BATCH = {        # rows 16 and 18 and the n = 10,240 system
    "16": ("factor", 8, 1280, 1248), "18": ("solve", 8, 1280, 1),
    "18/nrhs4": ("solve", 8, 1280, 4),
    "large_kkt": ("factor", 1, 10240, 10240),
    "large_kkt/solve": ("solve", 1, 10240, 1),
}


@pytest.fixture()
def panel_everywhere(monkeypatch):
    """The small-batch kernels at any n (their thresholds set to one
    panel), so that the plans can be walked at small n."""
    monkeypatch.setattr(fc, "PANEL_FACTOR_MIN_N", fc.BP)
    monkeypatch.setattr(fc, "PANEL_SOLVE_MIN_N", fc.BP)


@pytest.mark.parametrize("row", sorted(ROWS_ONE_BLOCK))
def test_rows_keep_one_block_per_instance(row):
    """Rows 1-11 and 17, whose batches fill the card, and rows 12-15,
    whose n lies below the thresholds measured on the card, keep one
    block per instance, the layout launch_config gives without an SM
    count: the n = 64 factor rows (5 and 14) in one launch of
    schur_chol64, the other factor rows in schur_factor, the solves in
    solve_few or solve_many."""
    kind, B, n, k = ROWS_ONE_BLOCK[row]
    for esize in (4, 8):
        new = fc.launch_config(kind, B, n, k, esize, H100_SMEM, H100_SMS)
        assert new == fc.launch_config(kind, B, n, k, esize, H100_SMEM)
        if kind == "factor" and n == fc.BP:
            assert [c["kernel"] for c in new] == ["schur_chol64"]
            assert new[0]["grid"] == B
        else:
            assert new[-1]["kernel"] in ("schur_factor", "solve_few",
                                         "solve_many")


@pytest.mark.parametrize("row", sorted(ROWS_SMALL_BATCH))
def test_small_batch_rows_take_the_panel_kernels(row):
    kind, B, n, k = ROWS_SMALL_BATCH[row]
    for esize in (4, 8):
        got = fc.launch_config(kind, B, n, k, esize, H100_SMEM, H100_SMS)
        names = [c["kernel"] for c in got]
        assert all(c["smem"] <= H100_SMEM for c in got)
        if kind == "solve":
            assert names == ["panel_solve"]
            assert got[0]["grid"] == B * k * 2 * (n // fc.BP)
        else:
            assert names[0] == "schur_assemble"
            assert names[-1] == "panel_finalize"
            assert "schur_factor" not in names
            assert names.count("panel_diag") == n // fc.BP


def test_the_threshold_follows_the_sm_count():
    B = H100_SMS // fc.SMALL_B_SHARE
    assert fc.small_batch("factor", B, 1280, 1, H100_SMS)
    assert not fc.small_batch("factor", B + 1, 1280, 1, H100_SMS)
    assert not fc.small_batch("factor", 1, 1280, 1, 0)
    assert fc.small_batch("solve", B // 2, 1280, 2, H100_SMS)
    assert not fc.small_batch("solve", B // 2 + 1, 1280, 2, H100_SMS)
    assert fc.small_batch("factor", 1, fc.PANEL_FACTOR_MIN_N, 1, H100_SMS)
    assert not fc.small_batch("factor", 1, fc.PANEL_FACTOR_MIN_N - fc.BP,
                              1, H100_SMS)
    assert fc.small_batch("solve", 1, fc.PANEL_SOLVE_MIN_N, 1, H100_SMS)
    assert not fc.small_batch("solve", 1, fc.PANEL_SOLVE_MIN_N - fc.BP, 1,
                              H100_SMS)


@pytest.mark.parametrize("B,n,nrhs,esize,again", [
    (1024, 320, 1, 8, False),    # row 10: 0.33 MB of tiles an instance
    (1024, 320, 64, 8, False),   # row 11
    (8, 1248, 1, 8, False),      # row 18: 6.0 MB an instance, 48 MB in all
    (1, 10240, 1, 8, True),      # row 20 f64: 417 MB
    (1, 10240, 1, 4, True)])     # row 20 f32: 208 MB
def test_solve_bound_reads_again_only_what_l2_cannot_keep(B, n, nrhs,
                                                          esize, again):
    """chip_smoke._solve_bound's bytes: L's off-diagonal tiles once, and a
    second time for the backward sweep only the part of an instance's
    tiles beyond the L2."""
    import chip_smoke as cs
    tiles = n * (n - 64) / 2 * esize
    rest = (n * 64 + 2 * nrhs * n) * esize
    bound, by = cs._solve_bound(B, n, nrhs, False, esize)
    want = B * (tiles + rest + (tiles - cs.L2_BYTES if again else 0))
    assert by == "bytes"
    assert bound == pytest.approx(want / cs.PEAK_BYTES * 1e3, rel=1e-12)


def test_factor_plan_at_n_10240():
    """160 panels in 40 outer panels of 256 columns: 160 diagonal
    factors, 159 L21 launches, 3 panel updates in each outer panel and 39
    rank-256 trailing updates; in f32 the first covers the 9,984-wide
    trailing matrix in 78 x 79 / 2 tiles of 128.  In f64 each but the last
    is split into the next panel's strip (2 x 78 - 1 tiles, on the main
    stream) and the rest (76 x 77 / 2 tiles, on the side stream); the
    last (n - t0 = 256) is a strip alone."""
    for esize in (4, 8):
        plan = fc.launch_config("factor", 1, 10240, 10240, esize,
                                H100_SMEM, H100_SMS)
        names = [c["kernel"] for c in plan]
        assert names.count("panel_diag") == 160
        assert names.count("panel_l21") == 159
        assert names.count("panel_update") == 40 * 3
        trail = [c for c in plan if c["kernel"] == "trail_update"]
        assert all(c["rank"] == fc.PANEL_NB for c in trail)
        assert trail[0]["t0"] == 256
        if esize == 4:
            assert len(trail) == 39
            assert trail[0]["grid"] == 78 * 79 // 2
            assert len(plan) == 1 + 160 + 159 + 120 + 39 + 1
        else:
            nxt = [c for c in trail if c["part"] == "next"]
            rest = [c for c in trail if c["part"] == "rest"]
            assert len(nxt) == 39 and len(rest) == 38
            assert all(c["stream"] == "main" for c in nxt)
            assert all(c["stream"] == "side" for c in rest)
            assert nxt[0]["grid"] == 2 * 78 - 1
            assert rest[0]["t0"] == 512 and rest[0]["grid"] == 76 * 77 // 2
            assert len(plan) == 1 + 160 + 159 + 120 + 39 + 38 + 1
        eq = fc.launch_config("factor", 1, 10240, 10240, esize, H100_SMEM,
                              H100_SMS, equilibrate=True)
        assert [c["kernel"] for c in eq[1:3]] == ["panel_deq", "panel_scale"]
        strip = lambda c: {k: v for k, v in c.items() if k != "waits"}
        assert [strip(c) for c in eq[3:]] == [strip(c) for c in plan[1:]]


# ---- plain-torch walks of the plans --------------------------------------

def walk_factor(P, Gt, dinv2, plan):
    """Run the factor plan's launches in order on (B, n, n) tensors, each
    as its kernel computes it; returns (L, Dinv) or (L, Dinv, deq)."""
    BP = fc.BP
    S = P + (Gt * dinv2.unsqueeze(-2)) @ Gt.transpose(-1, -2)  # assembly
    L = torch.tril(S).clone()
    B, n, _ = L.shape
    npan = n // BP
    Dinv = torch.zeros((B, npan, BP, BP), dtype=L.dtype)
    bad = torch.zeros(B, dtype=torch.bool)
    deq = None
    eye = torch.eye(BP, dtype=L.dtype)
    assert plan[0]["kernel"] == "schur_assemble"
    for c in plan[1:]:
        k = c["kernel"]
        if k == "panel_deq":
            deq = torch.rsqrt(torch.clamp(torch.diagonal(L, dim1=1, dim2=2),
                                          min=1e-30))
        elif k == "panel_scale":
            L = L * deq[:, :, None] * deq[:, None, :]
        elif k == "panel_diag":
            o = c["panel"] * BP
            Lc, info = torch.linalg.cholesky_ex(L[:, o:o + BP, o:o + BP])
            bad |= (info != 0) | ~torch.isfinite(Lc).all(-1).all(-1)
            L[:, o:o + BP, o:o + BP] = torch.tril(Lc)
            Dinv[:, c["panel"]] = torch.linalg.solve_triangular(
                torch.tril(Lc), eye, upper=False)
        elif k == "panel_l21":
            o = c["panel"] * BP
            L[:, o + BP:, o:o + BP] = L[:, o + BP:, o:o + BP] @ \
                Dinv[:, c["panel"]].transpose(-1, -2)
        elif k == "panel_update":
            o = c["panel"] * BP
            for J in range(c["panel"] + 1, c["panel"] + 1 + c["cols"]):
                oj = J * BP
                L[:, oj:, oj:oj + BP] -= L[:, oj:, o:o + BP] @ \
                    L[:, oj:oj + BP, o:o + BP].transpose(-1, -2)
        elif k == "trail_update":
            # the lower part of columns col0 .. col1 - 1 (f32: t0 .. n - 1)
            c0, c1, k0 = c.get("col0", c["t0"]), c.get("col1", n), c["k0"]
            A = L[:, c0:, k0:k0 + c["rank"]]
            L[:, c0:, c0:c1] -= torch.tril(
                A @ A[:, :c1 - c0].transpose(-1, -2))
        elif k == "panel_finalize":
            L = torch.tril(L)
            L[bad] = float("nan")
            Dinv[bad] = float("nan")
        else:
            raise AssertionError(f"unknown launch {k}")
    return (L, Dinv) if deq is None else (L, Dinv, deq)


def walk_solve(L, Dinv, B_rows, plan):
    """Run panel_solve's blocks in ticket order, each as the kernel does
    it.  Forward block j: s = sum_{k < j-1} L[j, k] y_k, then the chain's
    step y_j = Dinv[j] ((b_j - s) - L[j, j-1] y_{j-1}); backward block j:
    s = sum_{k > j+1} L[k, j]' x_k, then x_j = Dinv[j]' ((y_j - s) -
    L[j+1, j]' x_{j+1}).  Every panel a block reads was published by a
    block with a lower ticket, which has started: the kernel waits for
    nothing else."""
    BP = fc.BP
    (c,) = plan
    assert c["kernel"] == "panel_solve"
    B, nrhs, n = B_rows.shape
    npan, chains = n // BP, B * nrhs
    X = torch.full_like(B_rows, float("nan"))
    pub = {}        # (chain, sweep, panel) -> (ticket, values)

    def take(t, chain, sweep, k):
        tk, v = pub[chain, sweep, k]
        assert tk < t
        return v

    for t in range(c["grid"]):
        chain, pos = t % chains, t // chains
        b, r = divmod(chain, nrhs)
        Lb, Db = L[b], Dinv[b]
        if pos < npan:
            j = pos
            o = j * BP
            s = torch.zeros(BP, dtype=L.dtype)
            for k in range(j - 1):
                s = s + Lb[o:o + BP, k * BP:(k + 1) * BP] @ take(t, chain,
                                                                 "y", k)
            v = B_rows[b, r, o:o + BP] - s
            if j > 0:
                v = v - Lb[o:o + BP, o - BP:o] @ take(t, chain, "y", j - 1)
            pub[chain, "y", j] = (t, Db[j] @ v)
        else:
            j = 2 * npan - 1 - pos
            o = j * BP
            s = torch.zeros(BP, dtype=L.dtype)
            for k in range(npan - 1, j + 1, -1):
                s = s + Lb[k * BP:(k + 1) * BP, o:o + BP].T @ take(
                    t, chain, "x", k)
            v = take(t, chain, "y", j) - s
            if j + 1 < npan:
                v = v - Lb[o + BP:o + 2 * BP, o:o + BP].T @ take(
                    t, chain, "x", j + 1)
            pub[chain, "x", j] = (t, Db[j].T @ v)
            X[b, r, o:o + BP] = Db[j].T @ v
    return X


def _data(B, n, m, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, n, n)) / np.sqrt(n)
    P = F @ F.transpose(0, 2, 1) + np.eye(n)
    Gt = rng.standard_normal((B, n, m)) / np.sqrt(n)
    d2 = rng.uniform(0.5, 2.0, (B, m))
    return tuple(torch.as_tensor(a, dtype=dtype) for a in (P, Gt, d2))


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("n", [256, 576])
@pytest.mark.parametrize("equilibrate", [False, True])
def test_factor_walk_matches_plain(panel_everywhere, B, n, equilibrate):
    """n = 576 spans three outer panels, so two rank-256 trailing
    updates run; n = 256 is one outer panel."""
    P, Gt, d2 = _data(B, n, 96, seed=n + B)
    plan = fc.launch_config("factor", B, n, 96, 8, H100_SMEM, H100_SMS,
                            equilibrate=equilibrate)
    got = walk_factor(P, Gt, d2, plan)
    ref = fc.fused_schur_cholesky_ref(P, Gt, d2, equilibrate)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= 1e-12


def test_factor_walk_poisons_only_the_bad_instance(panel_everywhere):
    P, Gt, d2 = _data(3, 576, 64, seed=5)
    P[1, 300, 300] = -1e3            # not PD from the fifth panel on
    plan = fc.launch_config("factor", 3, 576, 64, 8, H100_SMEM, H100_SMS)
    L, Dinv = walk_factor(P, Gt, d2, plan)
    Lr, Dr = fc.fused_schur_cholesky_ref(P, Gt, d2)
    assert torch.isnan(L[1]).all() and torch.isnan(Dinv[1]).all()
    assert torch.isnan(Lr[1]).all()
    for k in (0, 2):
        assert _rel(L[k], Lr[k]) <= 1e-12 and _rel(Dinv[k], Dr[k]) <= 1e-12


@pytest.mark.parametrize("B,nrhs", [(1, 1), (2, 3), (1, 8)])
@pytest.mark.parametrize("n", [256, 576])
def test_solve_walk_matches_plain(panel_everywhere, B, nrhs, n):
    P, Gt, d2 = _data(B, n, 64, seed=7)
    L, Dinv = fc.fused_schur_cholesky_ref(P, Gt, d2)
    rhs = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (B, nrhs, n)))
    plan = fc.launch_config("solve", B, n, nrhs, 8, H100_SMEM, H100_SMS)
    x = walk_solve(L, Dinv, rhs, plan)
    assert _rel(x, fc.fused_cholesky_solve_ref(L, Dinv, rhs)) <= 1e-12


@pytest.fixture()
def pallas_interpret():
    """Force interpret mode (CPU) for pallas_call, as
    tests/test_torch_fused_chol.py does."""
    import importlib
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", interp):
        import cvxopt_tpu.ops.pallas_chol as pc
        importlib.reload(pc)
        yield pc
    import cvxopt_tpu.ops.pallas_chol as pc
    importlib.reload(pc)


def test_walks_match_pallas_interpret(panel_everywhere, pallas_interpret):
    """n = 192, m = 128 in float32, tests/test_torch_fused_chol.py's case
    and tolerances: the factor plan and the solve plan's walk against the
    JAX package's Pallas kernels."""
    pc = pallas_interpret
    n, m = 192, 128
    rng = np.random.default_rng(1)
    F = rng.standard_normal((n, n)).astype(np.float32)
    P = (F @ F.T + n * np.eye(n)).astype(np.float32)
    Gt = rng.standard_normal((n, m)).astype(np.float32)
    dinv2 = rng.uniform(0.5, 2.0, m).astype(np.float32)
    rhs = rng.standard_normal((8, n)).astype(np.float32)
    Lk, Dk = pc.fused_schur_cholesky(jnp.asarray(P), jnp.asarray(Gt),
                                     jnp.asarray(dinv2))
    xk = pc.fused_cholesky_solve(Lk, Dk, jnp.asarray(rhs))
    plan = fc.launch_config("factor", 1, n, m, 4, H100_SMEM, H100_SMS)
    L, Dinv = walk_factor(torch.as_tensor(P)[None], torch.as_tensor(Gt)[None],
                          torch.as_tensor(dinv2)[None], plan)
    splan = fc.launch_config("solve", 1, n, 8, 4, H100_SMEM, H100_SMS)
    x = walk_solve(L, Dinv, torch.as_tensor(rhs)[None], splan)
    scale = float(jnp.max(jnp.abs(Lk)))
    np.testing.assert_allclose(L[0].numpy(), np.asarray(Lk),
                               atol=3e-6 * scale)
    np.testing.assert_allclose(Dinv[0].numpy(), np.asarray(Dk), atol=1e-5)
    np.testing.assert_allclose(x[0].numpy(), np.asarray(xk), atol=1e-5)


@pytest.mark.parametrize("B,nrhs", [(1, 1), (2, 4)])
def test_solve_walk_matches_jax_reference_f64(panel_everywhere, B, nrhs):
    """float64 at n = 640 (ten panels a sweep): the walk of panel_solve's
    reordered chain against the JAX package's solve reference
    (cvxopt_tpu.ops.pallas_chol.fused_cholesky_solve_ref, vmapped) on its
    own factor, at 1e-12 relative Frobenius.  (The Pallas kernel itself
    takes its dots in float32, so float64 is held to its reference.)"""
    import jax
    from cvxopt_tpu.ops import pallas_chol as pc
    n = 640
    P, Gt, d2 = _data(B, n, 64, seed=13)
    Lr, Dr = jax.vmap(pc.fused_schur_cholesky_ref)(
        jnp.asarray(P.numpy()), jnp.asarray(Gt.numpy()),
        jnp.asarray(d2.numpy()))
    rhs = np.random.default_rng(14).standard_normal((B, nrhs, n))
    xr = jax.vmap(pc.fused_cholesky_solve_ref)(Lr, Dr, jnp.asarray(rhs))
    plan = fc.launch_config("solve", B, n, nrhs, 8, H100_SMEM, H100_SMS)
    assert plan[0]["scratch"] == fc.psolve_scratch(B * nrhs, n, 8)
    x = walk_solve(torch.tensor(np.asarray(Lr)),
                   torch.tensor(np.asarray(Dr)), torch.as_tensor(rhs), plan)
    assert _rel(x, torch.tensor(np.asarray(xr))) <= 1e-12

"""The f64 fused factor's layouts on the CPU (cvxopt_tpu_torch/csrc/
fused_chol.cu): the DMMA assembly's tiling and panel_factor's lookahead
plan, walked in plain torch as the kernels run them, against the plain
version, the JAX package's Pallas kernel and the f32 layout the seed
kept.

The kernels run only on the card (tests/test_torch_gpu.py,
chip_smoke.py).  Here `launch_config` gives the layouts: the assembly's
output tiles and k-chunks, and the factor's launches with the stream each
runs on and the events it waits for and records.  The lookahead plan is
walked in plan order and in the two most adversarial orders its streams
and events allow, and every two launches that the events leave unordered
are checked not to touch the same part of L or Dinv."""

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
BP = fc.BP


@pytest.fixture()
def panel_everywhere(monkeypatch):
    """The small-batch kernels at any n, so that small plans are walked."""
    monkeypatch.setattr(fc, "PANEL_FACTOR_MIN_N", BP)
    monkeypatch.setattr(fc, "PANEL_SOLVE_MIN_N", BP)


def _data(B, n, m, seed, per_instance=True, dtype=torch.float64):
    """bench.py's large-KKT data at a small size: P = F F' + I,
    Gt ~ N(0, 1) / sqrt(n), dinv2 ~ U(0.5, 2), from seeded numpy."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, n, max(n // 4, 1)))
    P = F @ F.transpose(0, 2, 1) + np.eye(n)
    Gt = rng.standard_normal(((B,) if per_instance else ()) + (n, m))
    d2 = rng.uniform(0.5, 2.0, (B, m))
    return tuple(torch.as_tensor(a, dtype=dtype)
                 for a in (P, Gt / np.sqrt(n), d2))


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


# ---- the f64 assembly's tiling ------------------------------------------

def walk_assembly(P, Gt, d2, cfg):
    """schur_assemble in f64 as its blocks compute it: per lower tile of
    `tile` rows and columns, k-chunks of `kc` zero-padded past m, each
    mma's k-slice of the A side scaled by dinv2 in registers; the diagonal
    tile's quadrant above the diagonal is not written (its two warps are
    idle).  Returns L (NaN where nothing is written)."""
    T, KC = cfg["tile"], cfg["kc"]
    MK = int(cfg["mma"].split("k")[-1])
    B, n, _ = P.shape
    m = Gt.shape[-1]
    G = Gt if Gt.dim() == 3 else Gt.expand(B, n, m)
    t = -(-n // T)
    assert cfg["grid"] == B * t * (t + 1) // 2
    mp, npad = -(-m // KC) * KC, t * T
    Gp = torch.zeros((B, npad, mp), dtype=P.dtype)
    Gp[:, :n, :m] = G
    dp = torch.zeros((B, mp), dtype=P.dtype)
    dp[:, :m] = d2
    L = torch.full((B, n, n), float("nan"), dtype=P.dtype)
    for I in range(t):
        for J in range(I + 1):
            r0, c0 = I * T, J * T
            acc = torch.zeros((B, T, T), dtype=P.dtype)
            for k0 in range(0, mp, KC):
                for kk in range(k0, k0 + KC, MK):
                    a = Gp[:, r0:r0 + T, kk:kk + MK] * \
                        dp[:, None, kk:kk + MK]
                    b = Gp[:, c0:c0 + T, kk:kk + MK]
                    acc += a @ b.transpose(-1, -2)
            rows, cols = min(T, n - r0), min(T, n - c0)
            out = acc[:, :rows, :cols] + P[:, r0:r0 + rows, c0:c0 + cols]
            if I == J:
                out[:, :T // 2, T // 2:] = float("nan")
            L[:, r0:r0 + rows, c0:c0 + cols] = out
    return L


@pytest.mark.parametrize("per_instance", [False, True])
@pytest.mark.parametrize("m", [157, 513])
@pytest.mark.parametrize("n", [192, 320, 1280])
def test_assembly_walk_matches_plain(panel_everywhere, n, m, per_instance):
    """Ragged n (not a multiple of the 128-wide tile) and m (not a
    multiple of the 32-deep chunk; m = 513 odd, its rows not 16-byte
    aligned), Gt shared or per instance: the walk's S equals the plain
    version's on and below the diagonal, and the factor of it equals
    fused_schur_cholesky_ref."""
    B = 2
    P, Gt, d2 = _data(B, n, m, seed=n + m, per_instance=per_instance)
    cfg = fc.launch_config("factor", B, n, m, 8, H100_SMEM)[0]
    assert cfg["kernel"] == "schur_assemble"
    assert (cfg["tile"], cfg["kc"], cfg["mma"]) == (fc.ASM_TILE, fc.DMMA_KC,
                                                    fc.DMMA_SHAPE)
    L = walk_assembly(P, Gt, d2, cfg)
    S = P + (Gt * d2.unsqueeze(-2)) @ Gt.transpose(-1, -2)
    low = torch.ones((n, n), dtype=torch.bool).tril()
    assert not torch.isnan(L[:, low]).any()
    assert _rel(L[:, low], S[:, low]) <= 1e-12
    got = walk_factor(L, fc.launch_config("factor", B, n, m, 8, H100_SMEM,
                                          H100_SMS)[1:], "plan")
    ref = fc.fused_schur_cholesky_ref(P, Gt, d2)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= 1e-12


def test_f64_assembly_layout_fits_and_keeps_the_f32_one():
    """The DMMA ring fits an H100's shared memory at every n; the f32
    assembly keeps the seed's layout and bytes.  A factor call launches
    the assembly first at n > 64 (at n = 64 schur_chol64 alone)."""
    for n in (64, 320, 10240):
        f64 = fc.launch_config("factor", 1, n, 513, 8, H100_SMEM,
                               chol64=False)[0]
        f32 = fc.launch_config("factor", 1, n, 513, 4, H100_SMEM,
                               chol64=False)[0]
        assert f64["smem"] == fc._dmma_smem() <= H100_SMEM
        assert f32 == dict(kernel="schur_assemble", grid=f64["grid"],
                           tile=128, smem=78528)
        first = [fc.launch_config("factor", 1, n, 513, e, H100_SMEM)[0]
                 for e in (8, 4)]
        assert first == ([f64, f32] if n > 64 else
                         [dict(c, kernel="schur_chol64") for c in first])


# ---- the lookahead plan -------------------------------------------------

def _happens_before(plan):
    """Each launch's predecessors by stream order and by events: a wait is
    on the latest record of its event issued before it (CUDA's rule);
    "fork" is recorded on the caller's stream before the first launch.
    Returns the direct predecessors of each launch."""
    preds, last_on, last_rec = [], {}, {}
    for i, c in enumerate(plan):
        p = set()
        s = c.get("stream", "main")
        if s in last_on:
            p.add(last_on[s])
        for e in c.get("waits", []):
            if e in last_rec:
                p.add(last_rec[e])
            else:
                assert e == "fork", f"launch {i} waits on {e}, never recorded"
        for e in c.get("records", []):
            last_rec[e] = i
        last_on[s] = i
        preds.append(p)
    return preds


def schedule(plan, order):
    """The launches in one order the streams and events allow: "plan" (the
    host's order), "side_deferred" (a main-stream launch whenever one can
    run: each side launch as late as its joins allow) or "side_advanced"
    (a side launch whenever one can run: each as early as its waits
    allow)."""
    if order == "plan":
        return list(range(len(plan)))
    preds = _happens_before(plan)
    first = "side" if order == "side_advanced" else "main"
    done, out = set(), []
    while len(out) < len(plan):
        ready = [i for i in range(len(plan))
                 if i not in done and preds[i] <= done]
        pick = [i for i in ready if plan[i].get("stream") == first] or ready
        out.append(pick[0])
        done.add(pick[0])
    return out


def walk_factor(S, plan, order):
    """panel_factor's launches in `order` on the assembled (B, n, n) S
    (its lower triangle), each as its kernel computes it.  Returns (L,
    Dinv) or (L, Dinv, deq)."""
    L = torch.where(torch.ones_like(S[0], dtype=torch.bool).tril(), S,
                    torch.zeros_like(S))
    B, n, _ = L.shape
    Dinv = torch.zeros((B, n // BP, BP, BP), dtype=L.dtype)
    bad = torch.zeros(B, dtype=torch.bool)
    deq = None
    eye = torch.eye(BP, dtype=L.dtype)
    for i in schedule(plan, order):
        c = plan[i]
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
            c0, c1, k0 = c["col0"], c["col1"], c["k0"]
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


ORDERS = ["plan", "side_deferred", "side_advanced"]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("equilibrate", [False, True])
@pytest.mark.parametrize("n", [256, 576, 1280])
@pytest.mark.parametrize("B", [1, 2])
def test_lookahead_walk_matches_plain(panel_everywhere, B, n, equilibrate,
                                      order):
    """n = 256 is one outer panel (no trailing update); n = 576 has one
    split update and a last strip; n = 1280 four split updates."""
    P, Gt, d2 = _data(B, n, 96, seed=n + B)
    plan = fc.launch_config("factor", B, n, 96, 8, H100_SMEM, H100_SMS,
                            equilibrate=equilibrate)
    S = P + (Gt * d2.unsqueeze(-2)) @ Gt.transpose(-1, -2)
    got = walk_factor(S, plan[1:], order)
    ref = fc.fused_schur_cholesky_ref(P, Gt, d2, equilibrate)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize("n,forked", [(256, False), (512, False),
                                      (576, True), (10240, True)])
def test_lookahead_forks_only_with_a_rest(n, forked):
    """Up to n = 2 x 256 no trailing update has a rest to overlap, and the
    plan stays on the caller's stream, as the f32 plan does; above it the
    plan forks from the caller's stream first and joins it last."""
    plan = fc.launch_config("factor", 1, n, n, 8, H100_SMEM, H100_SMS)[1:]
    streams = {c["stream"] for c in plan}
    rest = [c for c in plan if c.get("part") == "rest"]
    assert bool(rest) == forked
    if forked:
        assert streams == {"main", "side"}
        assert plan[0]["waits"] == ["fork"] and plan[-1]["records"] == ["join"]
    else:
        assert streams == {"caller"}
        assert not any(c["waits"] or c["records"] for c in plan)


def _footprint(c, n):
    """(reads, writes) of one launch: rectangles (array, r0, r1, c0, c1) of
    L (element rows and columns), Dinv (panels) and deq.  The per-instance
    bad flags are left out: a flag raised while a later launch runs only
    makes it skip that instance, which panel_finalize fills with NaN."""
    k, full = c["kernel"], ("L", 0, n, 0, n)
    if k == "panel_deq":
        return [full], [("deq", 0, 1, 0, 1)]
    if k == "panel_scale":
        return [full, ("deq", 0, 1, 0, 1)], [full]
    if k == "panel_finalize":
        return [full], [full, ("D", 0, n // BP, 0, 1)]
    if k == "trail_update":
        c0, c1, k0 = c["col0"], c["col1"], c["k0"]
        own = ("L", c0, n, c0, c1)
        return [own, ("L", c0, n, k0, k0 + c["rank"])], [own]
    o, jp = c["panel"] * BP, c["panel"]
    if k == "panel_diag":
        own = ("L", o, o + BP, o, o + BP)
        return [own], [own, ("D", jp, jp + 1, 0, 1)]
    if k == "panel_l21":
        own = ("L", o + BP, n, o, o + BP)
        return [own, ("D", jp, jp + 1, 0, 1)], [own]
    if k == "panel_update":
        own = ("L", o + BP, n, o + BP, o + BP * (1 + c["cols"]))
        return [own, ("L", o + BP, n, o, o + BP)], [own]
    raise AssertionError(k)


def _meet(a, b):
    return a[0] == b[0] and a[1] < b[2] and b[1] < a[2] and \
        a[3] < b[4] and b[3] < a[4]


@pytest.mark.parametrize("equilibrate", [False, True])
@pytest.mark.parametrize("n", [576, 1280, 10240])
def test_lookahead_leaves_no_race(n, equilibrate):
    """Every two launches that neither stream order nor events order
    (ancestors by the transitive closure) write disjoint parts of L and
    Dinv and read nothing the other writes; panel_finalize comes after
    every launch, so the caller's stream, which waits for it, sees the
    whole factor.  n = 10,240 is the large_kkt plan."""
    plan = fc.launch_config("factor", 1, n, n, 8, H100_SMEM, H100_SMS,
                            equilibrate=equilibrate)[1:]
    assert {c["stream"] for c in plan} == {"main", "side"}
    preds = _happens_before(plan)
    anc = []
    for p in preds:
        a = 0
        for j in p:
            a |= anc[j] | (1 << j)
        anc.append(a)
    assert anc[-1] == (1 << (len(plan) - 1)) - 1
    assert plan[-1]["records"] == ["join"]
    fp = [_footprint(c, n) for c in plan]
    concurrent = 0
    for i in range(len(plan)):
        for j in range(i):
            if anc[i] >> j & 1:
                continue
            concurrent += 1
            (ri, wi), (rj, wj) = fp[i], fp[j]
            for w in wi:
                assert not any(_meet(w, x) for x in rj + wj), (plan[j],
                                                               plan[i])
            for w in wj:
                assert not any(_meet(w, x) for x in ri), (plan[j], plan[i])
    assert concurrent > 0      # the lookahead does overlap launches


def _decode(codes, n):
    """fc.plan_codes back into launch fields, as csrc/fused_chol.cu reads
    them."""
    out = []
    for r in range(0, len(codes), fc.PLAN_INTS):
        k, grid, smem, s, w, rec, *a = codes[r:r + fc.PLAN_INTS]
        c = dict(kernel=fc.PLAN_KERNELS[k], grid=grid, smem=smem,
                 stream=fc.PLAN_STREAMS[s],
                 waits=[e for i, e in enumerate(fc.PLAN_EVENTS) if w >> i & 1],
                 records=[e for i, e in enumerate(fc.PLAN_EVENTS)
                          if rec >> i & 1])
        if c["kernel"] in ("panel_diag", "panel_l21", "panel_update"):
            c.update(panel=a[0], cols=a[1])
        if c["kernel"] == "trail_update":
            c.update(k0=a[0], rank=a[1], t0=a[2], col0=a[3], col1=a[4],
                     part="next" if a[5] else "rest")
        out.append(c)
    return out


@pytest.mark.parametrize("esize,B,n,equilibrate", [
    (8, 1, 512, False), (8, 2, 576, True), (8, 1, 1280, False),
    (8, 1, 10240, True), (4, 1, 1280, True), (4, 2, 10240, False)])
def test_plan_codes_carry_what_the_walks_read(esize, B, n, equilibrate):
    """The C launcher runs a plan only where its own equals plan_codes of
    launch_config's, so every field of a launch that the walks and the
    race check read (all but its tile) must be in the codes: decoded, each
    launch gives back each of its fields."""
    plan = fc.launch_config("factor", B, n, 96, esize, H100_SMEM, H100_SMS,
                            equilibrate=equilibrate)[1:]
    codes = fc.plan_codes(plan, n)
    assert len(codes) == fc.PLAN_INTS * len(plan)
    arr, nlaunch = fc._panel_factor_codes(B, n, esize, equilibrate)
    assert list(arr) == codes and nlaunch == len(plan)   # what _factor passes
    assert all(isinstance(v, int) and 0 <= v < 2 ** 31 for v in codes)
    for c, d in zip(plan, _decode(codes, n)):
        assert set(c) - {"tile"} <= set(d), c
        assert {k: c[k] for k in c if k != "tile"} == \
            {k: d[k] for k in c if k != "tile"}, c
        if esize == 4:
            assert (d["stream"], d["waits"], d["records"]) == \
                ("caller", [], [])
            if d["kernel"] == "trail_update":
                assert (d["col0"], d["col1"]) == (c["t0"], n)


@pytest.mark.parametrize("order", ORDERS[1:])
def test_lookahead_poisons_only_the_bad_instance(panel_everywhere, order):
    """The middle instance is not PD from its eleventh panel on (in the
    third outer panel, after two split updates): it alone comes back all
    NaN, and its neighbours equal the plain version."""
    B, n = 3, 1280
    P, Gt, d2 = _data(B, n, 64, seed=5)
    P[1, 700, 700] = -1e3
    plan = fc.launch_config("factor", B, n, 64, 8, H100_SMEM, H100_SMS)
    S = P + (Gt * d2.unsqueeze(-2)) @ Gt.transpose(-1, -2)
    L, Dinv = walk_factor(S, plan[1:], order)
    Lr, Dr = fc.fused_schur_cholesky_ref(P, Gt, d2)
    assert torch.isnan(L[1]).all() and torch.isnan(Dinv[1]).all()
    assert torch.isnan(Lr[1]).all()
    for k in (0, 2):
        assert _rel(L[k], Lr[k]) <= 1e-12 and _rel(Dinv[k], Dr[k]) <= 1e-12


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


def test_f64_walks_match_pallas_interpret(panel_everywhere, pallas_interpret):
    """n = 192, m = 128, tests/test_torch_small_batch.py's case and
    tolerances (the Pallas kernel computes in float32): the f64 layouts,
    the DMMA assembly's tiling and then panel_factor's plan, walked on the
    same float32 inputs, against the JAX package's Pallas kernel."""
    pc = pallas_interpret
    n, m = 192, 128
    rng = np.random.default_rng(1)
    F = rng.standard_normal((n, n)).astype(np.float32)
    P = (F @ F.T + n * np.eye(n)).astype(np.float32)
    Gt = rng.standard_normal((n, m)).astype(np.float32)
    dinv2 = rng.uniform(0.5, 2.0, m).astype(np.float32)
    Lk, Dk = pc.fused_schur_cholesky(jnp.asarray(P), jnp.asarray(Gt),
                                     jnp.asarray(dinv2))
    plan = fc.launch_config("factor", 1, n, m, 8, H100_SMEM, H100_SMS)
    S = walk_assembly(torch.as_tensor(P)[None], torch.as_tensor(Gt),
                      torch.as_tensor(dinv2)[None], plan[0])
    L, Dinv = walk_factor(S, plan[1:], "side_advanced")
    scale = float(jnp.max(jnp.abs(Lk)))
    np.testing.assert_allclose(L[0].numpy(), np.asarray(Lk),
                               atol=3e-6 * scale)
    np.testing.assert_allclose(Dinv[0].numpy(), np.asarray(Dk), atol=1e-5)


# ---- the f32 layouts stay the seed's -------------------------------------

def _seed_f32_panel_plan(B, n, equilibrate):
    """panel_factor's f32 launches as the seed laid them out (one stream,
    rank-256 trailing updates over the whole trailing triangle)."""
    npan, pw = n // BP, 4
    tile_words = BP * (BP + 4)
    diag, tile = (3 * tile_words + BP) * 4, 2 * tile_words * 4
    trail = (2 * 2 * 16 * 132 + 128 * 132) * 4
    out = []
    if equilibrate:
        out += [dict(kernel="panel_deq", grid=B * -(-n // 256), tile=256,
                     smem=0),
                dict(kernel="panel_scale", grid=B * npan * (npan + 1) // 2,
                     tile=BP, smem=0)]
    for p0 in range(0, npan, pw):
        pend = min(p0 + pw, npan) - 1
        for jp in range(p0, pend + 1):
            rows, cols = npan - 1 - jp, pend - jp
            out.append(dict(kernel="panel_diag", grid=B, tile=BP,
                            smem=diag, panel=jp))
            if rows:
                out.append(dict(kernel="panel_l21", grid=B * rows, tile=BP,
                                smem=tile, panel=jp))
            if cols:
                out.append(dict(kernel="panel_update", grid=B * rows * cols,
                                tile=BP, smem=tile, panel=jp, cols=cols))
        if pend < npan - 1:
            t0 = (pend + 1) * BP
            tt = -(-(n - t0) // 128)
            out.append(dict(kernel="trail_update", grid=B * tt * (tt + 1) // 2,
                            tile=128, smem=trail, k0=p0 * BP,
                            rank=t0 - p0 * BP, t0=t0))
    out.append(dict(kernel="panel_finalize", grid=B * npan, tile=BP, smem=0))
    return out


def _seed_f32_solve(B, n, nrhs, sms):
    """The solve's f32 launch as the seed laid it out; panel_solve's as
    its redesign does: a ring of 4 dense 64x64 tiles, five panels of 64
    and 128 bytes of alignment, and the zeroed scratch (a ticket, then 8
    bytes a published value)."""
    if nrhs <= 8 and sms and 4 * B * nrhs <= sms and n >= 512:
        return [dict(kernel="panel_solve", grid=B * nrhs * 2 * (n // BP),
                     tile=BP, ring=4, smem=128 + (4 * BP * BP + 5 * BP) * 4,
                     scratch=128 + B * nrhs * 2 * n * 8)]
    if nrhs <= 8:
        return [dict(kernel="solve_few", grid=B * nrhs, tile=1,
                     smem=17 * BP * 4)]
    return [dict(kernel="solve_many", grid=B * -(-nrhs // BP), tile=BP,
                 smem=6 * BP * (BP + 4) * 4)]


# PERF.md's f32 rows 1-8 and the f32 side of rows 19-20, and row 16's
# shape: (kind, B, n, m or nrhs)
F32_ROWS = [("factor", 64, 256, 256), ("solve", 64, 256, 1),
            ("factor", 1024, 256, 512), ("solve", 1024, 256, 256),
            ("solve", 1024, 256, 1), ("factor", 1024, 64, 400),
            ("solve", 1024, 64, 64), ("solve", 1024, 64, 1),
            ("factor", 1, 10240, 10240), ("solve", 1, 10240, 1),
            ("factor", 8, 1280, 1248)]


@pytest.mark.parametrize("row", F32_ROWS, ids=str)
def test_f32_launch_config_is_the_seeds(row):
    kind, B, n, k = row
    t = -(-n // 128)
    for sms in (0, H100_SMS):
        for eq in (False, True):
            got = fc.launch_config(kind, B, n, k, 4, H100_SMEM, sms, eq)
            if kind == "solve":
                assert got == _seed_f32_solve(B, n, k, sms)
                continue
            if n == BP:   # one launch since the seed: schur_chol64
                assert got == [dict(kernel="schur_chol64", grid=B, tile=BP,
                                    smem=(3 * BP * (BP + 4) + BP) * 4,
                                    kc=32, stages=3)]
                continue
            assert got[0] == dict(kernel="schur_assemble",
                                  grid=B * t * (t + 1) // 2, tile=128,
                                  smem=78528)
            if fc.small_batch("factor", B, n, 1, sms):
                assert got[1:] == _seed_f32_panel_plan(B, n, eq)
            else:
                assert got[1:] == [dict(kernel="schur_factor", grid=B,
                                        tile=BP, smem=52480)]

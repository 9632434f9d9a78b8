"""Fused condensed-KKT factor and solve: wrappers of the Hopper kernels
in `csrc/fused_chol.cu`, and their plain PyTorch versions.

Twin of `cvxopt_tpu/ops/pallas_chol.py`.  The four TPU kernels there
map onto two CUDA kernels, each templated on float and double:

  fused_schur_cholesky          (pallas_chol.py:129)  -> schur_chol
  fused_schur_cholesky_batched  (pallas_chol.py:338)  -> schur_chol
  fused_cholesky_solve          (pallas_chol.py:194)  -> chol_solve
  fused_cholesky_solve_batched  (pallas_chol.py:404)  -> chol_solve

    S = P + Gt diag(dinv2) Gt' ;  S = L L' ;  Dinv[j] = inv(L_jj)
    x = (L L')^{-1} b            (right-hand sides stored as rows)

The unbatched pair takes one instance or a batch with a per-instance
Gt (the vmapped form); the batched pair takes a Gt shared across the
batch.  With ``equilibrate=True`` the factor also computes
``deq = 1/sqrt(max(diag(S), 1e-30))``, factors ``D S D`` instead of S
and returns deq; with it False the function is exactly the TPU
kernel's.  n must be a multiple of BP = 64 (ValueError otherwise); the
KKT layer pads.

A wrapper given CPU tensors (with ``device="cpu"``) computes the plain
version; given CUDA tensors it launches its kernel or raises.  Each
wrapper counts its calls that launch on the card in
``<wrapper>.launches``, and its calls per device kernel in
``<wrapper>.kernels`` (`factor_kernel_counts`, `solve_kernel_counts`).
A factor call at n = 64 is one launch, schur_chol64: one block per
instance assembles S, factors and inverts it in shared memory.  At larger
n it launches schur_assemble and then either schur_factor (one
block per instance) or, for a batch much smaller than the card's SM
count, panel_factor: the same factor as a host loop of launches that
each spread one panel step over the grid.  In f64 schur_assemble and
panel_factor's trailing updates run on the FP64 tensor cores, and
panel_factor overlaps the next panel's steps with the bulk of each
trailing update on a second stream (a lookahead; it joins the caller's
stream before the call returns).  A solve call launches
solve_few or solve_many by the number of right-hand sides, or, for few
(instance, right-hand side) pairs, panel_solve: one block per (pair,
panel, sweep).  `launch_counts` also counts the calls of schur_chol64
and of each of the two small-batch kernels.  `launch_config` gives each
call's launches, grids and shared memory.

A pivot <= 0 or not finite poisons the whole instance with NaN, in the
kernels and the plain versions alike; the solvers read NaN as a
singular KKT system.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cvxopt_tpu_torch._device import resolve_device, check_on

BP = 64          # panel width

_DTYPES = (torch.float32, torch.float64)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


# ---- plain PyTorch versions -------------------------------------------

def _diag_blocks(L):
    """The (npan, BP, BP) diagonal blocks of (..., n, n) L."""
    n = L.shape[-1]
    npan = n // BP
    Lr = L.reshape(L.shape[:-2] + (npan, BP, npan, BP))
    return torch.diagonal(Lr, dim1=-4, dim2=-2).movedim(-1, -3)


def fused_schur_cholesky_ref(P, Gt, dinv2, equilibrate=False):
    """Plain version of the factor: (L, Dinv) or (L, Dinv, deq)."""
    if P.dim() == 2:
        dinv2 = dinv2.reshape(-1)
    S = P + (Gt * dinv2.unsqueeze(-2)) @ Gt.transpose(-1, -2)
    deq = None
    if equilibrate:
        deq = torch.rsqrt(torch.clamp(
            torch.diagonal(S, dim1=-2, dim2=-1), min=1e-30))
        S = S * deq.unsqueeze(-1) * deq.unsqueeze(-2)
    L, info = torch.linalg.cholesky_ex(S)
    bad = (info != 0) | ~torch.isfinite(L).all(-1).all(-1)
    L = torch.where(bad[..., None, None],
                    torch.full_like(L, float("nan")), L)
    eye = torch.eye(BP, dtype=L.dtype, device=L.device)
    Dinv = torch.linalg.solve_triangular(_diag_blocks(L), eye,
                                         upper=False)
    return (L, Dinv) if deq is None else (L, Dinv, deq)


def fused_cholesky_solve_ref(L, Dinv, B_rows):
    """Plain version of the solve: (L L')^{-1} b for rows b."""
    y = torch.linalg.solve_triangular(L, B_rows.transpose(-1, -2),
                                      upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x.transpose(-1, -2)


def fused_schur_cholesky_batched_ref(P, Gt, dinv2, equilibrate=False):
    return fused_schur_cholesky_ref(P, Gt, dinv2, equilibrate)


def fused_cholesky_solve_batched_ref(L, Dinv, B_rows):
    return fused_cholesky_solve_ref(L, Dinv, B_rows)


# ---- kernel launches ---------------------------------------------------

ASM_TILE = 128    # schur_assemble output tile
ASM_KC = 16       # schur_assemble k-chunk
ASM_STAGES = 3    # schur_assemble cp.async ring depth
FEW_RHS = 8       # chol_solve: nrhs <= FEW_RHS takes the mat-vec kernel
_ERR_LAYOUT = -2  # a launcher's return: launch_config disagrees with it
_ERR_TMAP = -3    # panel_solve: the driver refused L's tensor map

# The small-batch path: a factor call takes panel_factor when
# SMALL_B_SHARE * B <= the device's SM count and n >= PANEL_FACTOR_MIN_N,
# and a solve call with nrhs <= FEW_RHS takes panel_solve when
# SMALL_B_SHARE * B * nrhs <= the SM count and n >= PANEL_SOLVE_MIN_N; a
# larger batch, or a smaller n, keeps one block per instance (per
# right-hand side).  The two n thresholds are measured on an H100 at B = 1
# (chip_smoke.py's large_kkt phase, `small_batch_sweep`): below them the
# one-block kernels were as fast or faster.
SMALL_B_SHARE = 4
PANEL_FACTOR_MIN_N = 256
PANEL_SOLVE_MIN_N = 512
PANEL_NB = 256    # panel_factor: outer panel width, the trailing updates' rank
TRAIL_TILE = 128  # panel_factor: trail_update's output tile
TRAIL_KC = 16     # panel_factor: trail_update's k-chunk (f32)
# f64: schur_assemble and trail_update run on the FP64 tensor cores
# (mma.sync m16n8k8) through one main loop: k-chunks of DMMA_KC copied by
# a DMMA_STAGES-deep cp.async ring, rows at a pitch of DMMA_KC + 4 (the
# layout csrc/fused_chol.cu fixes; launch_config reports it)
DMMA_KC = 32
DMMA_STAGES = 3
DMMA_SHAPE = "m16n8k8"
# n == BP: one launch, schur_chol64, assembles S by k-chunks of CHOL64_KC
# (a CHOL64_STAGES-deep cp.async ring) and factors it in shared memory
CHOL64_KC = 32
CHOL64_STAGES = 3
# panel_solve: L's tiles stream through a ring of PSOLVE_RING 64x64 slots
# of shared memory; its scratch holds a ticket counter and the published
# values, 8 bytes a value in f32 and 16 in f64 (csrc/fused_chol.cu's
# layout)
PSOLVE_RING = 4


def _dmma_smem():
    """Shared memory of the f64 DMMA kernels, in bytes: the ring of both
    operands' chunks and of dinv2's."""
    return (DMMA_STAGES * 2 * ASM_TILE * (DMMA_KC + 4)
            + DMMA_STAGES * DMMA_KC) * 8


def small_batch(kind, B, n, k, sms):
    """Whether a `kind` ("factor" or "solve") call of B instances at n with
    k right-hand sides (k = 1 for a factor) takes the small-batch kernels
    on a device with `sms` SMs (0: never, one block per instance)."""
    min_n = PANEL_FACTOR_MIN_N if kind == "factor" else PANEL_SOLVE_MIN_N
    return bool(sms) and SMALL_B_SHARE * B * k <= sms and n >= min_n


def _factor_smem(esize):
    """Shared memory of schur_factor, panel_diag and schur_chol64, in
    bytes: three 64x64 tiles with their row pad, and one column."""
    return (3 * BP * (BP + 16 // esize) + BP) * esize


def psolve_scratch(chains, n, esize):
    """Bytes of panel_solve's zeroed scratch for `chains` (instance,
    right-hand side) pairs at n."""
    return 128 + chains * 2 * n * 2 * esize


def _panel_smem(esize):
    """Shared memory of panel_factor's kernels that use it, in bytes."""
    tile_words = BP * (BP + 16 // esize)
    trail = _dmma_smem() if esize == 8 else \
        (2 * 2 * TRAIL_KC * (TRAIL_TILE + 4)
         + TRAIL_TILE * (TRAIL_TILE + 4)) * esize
    return dict(diag=_factor_smem(esize), tile=2 * tile_words * esize,
                trail=trail)


def _panel_factor_plan(B, n, esize, equilibrate):
    """panel_factor's launches after schur_assemble, in the order the C
    launcher makes them (see csrc/fused_chol.cu; it launches nothing
    unless its own plan equals this one in every field of `plan_codes`).

    In f64 each trailing update is split into the next outer panel's
    column strip (`part` "next", on stream "main") and the rest of the
    trailing matrix ("rest", on "side"), which runs beside the next
    panel's chain (a lookahead).  Each f64 launch then lists the events
    it waits for before it starts (`waits`) and records when it ends
    (`records`), in host order: a wait is on the latest record of that
    event issued before it, as in CUDA.  "fork" is recorded on the
    caller's stream after schur_assemble; the caller's stream waits for
    "join".  With n <= 2 PANEL_NB no update has a rest, so there is
    nothing to overlap: every launch runs on the caller's stream
    ("caller"), with no fork and no join.  An f64 trail_update updates
    the lower part of columns col0 .. col1 - 1, rows col0 .. n - 1, of L
    by the rank-`rank` product of columns k0 .. k0 + rank - 1; an f32 one
    the whole trailing triangle from row and column t0."""
    npan, pw = n // BP, PANEL_NB // BP
    sm = _panel_smem(esize)
    lookahead = esize == 8
    forked = lookahead and n > 2 * PANEL_NB
    out = []

    def launch(kernel, grid, tile, smem, stream="main", waits=(), **kw):
        c = dict(kernel=kernel, grid=grid, tile=tile, smem=smem)
        if lookahead:
            c.update(stream=stream if forked else "caller",
                     waits=list(waits), records=[])
        out.append(dict(c, **kw))

    fork = ["fork"] if forked else []
    if equilibrate:
        launch("panel_deq", B * -(-n // 256), 256, 0, waits=fork)
        launch("panel_scale", B * npan * (npan + 1) // 2, BP, 0)
        fork = []
    rest_pending = False
    for p0 in range(0, npan, pw):
        pend = min(p0 + pw, npan) - 1
        for jp in range(p0, pend + 1):
            rows, cols = npan - 1 - jp, pend - jp
            launch("panel_diag", B, BP, sm["diag"], waits=fork, panel=jp)
            fork = []
            if rows:
                launch("panel_l21", B * rows, BP, sm["tile"], panel=jp)
            if cols:
                launch("panel_update", B * rows * cols, BP, sm["tile"],
                       panel=jp, cols=cols)
        if pend == npan - 1:
            continue
        t0, k0 = (pend + 1) * BP, p0 * BP
        tt = -(-(n - t0) // TRAIL_TILE)
        if not lookahead:
            launch("trail_update", B * tt * (tt + 1) // 2, TRAIL_TILE,
                   sm["trail"], k0=k0, rank=t0 - k0, t0=t0)
            continue
        rest = t0 + PANEL_NB < n
        if rest:
            out[-1]["records"].append("panel")
        launch("trail_update",
               B * (2 * tt - 1 if min(PANEL_NB, n - t0) > TRAIL_TILE
                    else tt),
               TRAIL_TILE, sm["trail"], waits=["rest"] if rest_pending
               else [], part="next", k0=k0, rank=t0 - k0, t0=t0, col0=t0,
               col1=min(t0 + PANEL_NB, n))
        rest_pending = rest
        if rest:
            r0 = t0 + PANEL_NB
            tr = -(-(n - r0) // TRAIL_TILE)
            launch("trail_update", B * tr * (tr + 1) // 2, TRAIL_TILE,
                   sm["trail"], stream="side", waits=["panel"], part="rest",
                   k0=k0, rank=t0 - k0, t0=r0, col0=r0, col1=n)
            out[-1]["records"].append("rest")
    launch("panel_finalize", B * npan, BP, 0,
           waits=["rest"] if rest_pending else [])
    if forked:
        out[-1]["records"].append("join")
    return out


# plan_codes: panel_factor's kernels, streams and events by their index,
# as csrc/fused_chol.cu numbers them
PLAN_KERNELS = ("panel_deq", "panel_scale", "panel_diag", "panel_l21",
                "panel_update", "trail_update", "panel_finalize")
PLAN_STREAMS = ("caller", "main", "side")
PLAN_EVENTS = ("fork", "panel", "rest", "join")
PLAN_INTS = 12    # ints per launch


def plan_codes(plan, n):
    """panel_factor's launches (launch_config's entries after
    schur_assemble) as the C launcher compares them with its own plan
    before it launches anything: PLAN_INTS ints a launch, the kernel's
    index in PLAN_KERNELS, grid, shared memory, stream (PLAN_STREAMS;
    an f32 plan runs on the caller's), the events waited for and
    recorded (bit i: PLAN_EVENTS[i]), then the arguments, zero-padded:
    panel_diag and panel_l21 the panel; panel_update the panel and
    `cols`; trail_update k0, rank, t0, the columns col0 .. col1 it
    updates (an f32 one t0 .. n) and 1 for the next outer panel's strip
    (`part` "next")."""
    def mask(events):
        return sum(1 << PLAN_EVENTS.index(e) for e in events)

    out = []
    for c in plan:
        k = c["kernel"]
        if k in ("panel_diag", "panel_l21"):
            args = [c["panel"]]
        elif k == "panel_update":
            args = [c["panel"], c["cols"]]
        elif k == "trail_update":
            args = [c["k0"], c["rank"], c["t0"], c.get("col0", c["t0"]),
                    c.get("col1", n), int(c.get("part") == "next")]
        else:
            args = []
        out += [PLAN_KERNELS.index(k), c["grid"], c["smem"],
                PLAN_STREAMS.index(c.get("stream", "caller")),
                mask(c.get("waits", ())), mask(c.get("records", ())),
                *args] + [0] * (PLAN_INTS - 6 - len(args))
    return out


@functools.lru_cache(maxsize=64)
def _panel_factor_codes(B, n, esize, equilibrate):
    """plan_codes of panel_factor's plan as a C int array, and its number
    of launches; cached, since encoding the 517 launches at n = 10,240
    takes more host time per call than the panel chain's first steps."""
    plan = _panel_factor_plan(B, n, esize, equilibrate)
    codes = plan_codes(plan, n)
    return (ctypes.c_int * len(codes))(*codes), len(plan)


def launch_config(kind, B, n, m_or_nrhs, esize, smem, sms=0,
                  equilibrate=False, chol64=True):
    """The device launches of one wrapper call, as csrc/fused_chol.cu lays
    them out: a list of dicts with the kernel's name, its grid (blocks of
    256 threads), its output tile and its dynamic shared memory in bytes.

    kind "factor" (m_or_nrhs = m): at n == BP one launch, schur_chol64,
    one block per instance (`kc`, `stages`: its k-chunk and ring depth).
    It is bound by issue, not bytes: S is assembled in registers over
    k-chunks of Gt and factored in shared memory, so it never goes through
    device memory; on an H100 (700 W) row 5 (B = 1024, m = 400, f32) takes
    0.18-0.19 ms against a 0.044 ms bound and 0.40 ms for the two
    launches it replaces.  At larger n schur_assemble, one block per
    (instance, lower 128-wide tile of S), then schur_factor, one block per
    instance.  kind "solve" (m_or_nrhs = nrhs): solve_few, one block per
    (instance, right-hand side), for nrhs <= FEW_RHS; else solve_many, one
    block per (instance, 64 right-hand sides).  esize is the element size
    in bytes.  No block's shared memory depends on n: a block holds one
    panel, never a whole right-hand side.  `chol64=False` gives the
    two-launch layout at n == BP too, as `_assemble` and `_factor` launch
    it (a factor call at n == BP does not; chip_smoke.py times it there).

    In f64 the assembly runs on the FP64 tensor cores and its entry also
    gives its k-chunk (`kc`), ring depth (`stages`) and mma shape
    (`mma`).

    `sms` is the device's SM count (0, the default: one block per
    instance at any B).  Where `small_batch` holds, a factor is
    schur_assemble and then panel_factor's launches, each with its
    panel (`panel`), the column tiles left in its outer panel (`cols`),
    or the trailing update's first column (`k0`), rank and first
    trailing row (`t0`); with `equilibrate`, two launches first compute
    deq and scale S.  In f64 each launch also names its stream and the
    events it waits for and records, and each trailing update is split
    in two (`_panel_factor_plan`).  A solve is one panel_solve launch: one
    block per (instance, right-hand side, 64-row panel, sweep), with its
    ring of L's tiles (`ring` slots, each filled by one TMA copy) and the
    bytes of its zeroed scratch (`scratch`, `psolve_scratch`).  It is
    bound by its chain of 2 n/64 steps, each of which every running block
    must keep up with by reading one tile: values are handed on with
    their tags in one word, with no fence, and the tiles stream by TMA.
    On an H100 (700 W) at n = 10,240 it takes 0.57 / 0.40 ms (f64 / f32)
    against a 0.23 / 0.11 ms bound, and 1.64 / 1.03 ms before.

    Raises ValueError when n is not a multiple of BP, or a block needs
    more than `smem` bytes (the device's opt-in shared memory per
    block)."""
    _check_n(n)
    vw = 16 // esize                 # elements in a 16-byte copy
    tile_words = BP * (BP + vw)      # a 64x64 tile with its row pad
    if kind == "factor" and n == BP and chol64:
        out = [dict(kernel="schur_chol64", grid=B, tile=BP,
                    smem=_factor_smem(esize), kc=CHOL64_KC,
                    stages=CHOL64_STAGES)]
    elif kind == "factor":
        t = -(-n // ASM_TILE)
        if esize == 8:
            asm = dict(smem=_dmma_smem(), kc=DMMA_KC, stages=DMMA_STAGES,
                       mma=DMMA_SHAPE)
        else:
            asm = dict(smem=(ASM_STAGES * 2 * ASM_TILE * (ASM_KC + vw)
                             + 2 * ASM_KC * (ASM_TILE + vw)
                             + ASM_STAGES * ASM_KC) * esize)
        out = [dict(kernel="schur_assemble", grid=B * (t * (t + 1) // 2),
                    tile=ASM_TILE, **asm)]
        if small_batch(kind, B, n, 1, sms):
            out += _panel_factor_plan(B, n, esize, equilibrate)
        else:
            out.append(dict(kernel="schur_factor", grid=B, tile=BP,
                            smem=_factor_smem(esize)))
    elif kind == "solve":
        nrhs = m_or_nrhs
        if nrhs <= FEW_RHS and small_batch(kind, B, n, nrhs, sms):
            out = [dict(kernel="panel_solve", grid=B * nrhs * 2 * (n // BP),
                        tile=BP, ring=PSOLVE_RING,
                        smem=128 + (PSOLVE_RING * BP * BP + 5 * BP) * esize,
                        scratch=psolve_scratch(B * nrhs, n, esize))]
        elif nrhs <= FEW_RHS:
            out = [dict(kernel="solve_few", grid=B * nrhs, tile=1,
                        smem=17 * BP * esize)]
        else:
            out = [dict(kernel="solve_many", grid=B * -(-nrhs // BP),
                        tile=BP, smem=6 * tile_words * esize)]
    else:
        raise ValueError(f"unknown kind {kind!r}")
    for c in out:
        if c["smem"] > smem:
            raise ValueError(f"{c['kernel']} needs {c['smem']} bytes of "
                             f"shared memory; the device allows {smem}")
        if c["grid"] >= 2 ** 31:
            raise ValueError(f"{c['kernel']}: {c['grid']} blocks exceed "
                             f"the grid's limit")
    return out


_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from cvxopt_tpu_torch.ops._build import load
        lib = load("fused_chol")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for sfx in ("f32", "f64"):
            f = getattr(lib, "schur_assemble_" + sfx)
            f.argtypes = [vp, ll, vp, ll, vp, ll, vp, ci, ci, ci, ci, ci, vp]
            f.restype = ci
            f = getattr(lib, "schur_factor_" + sfx)
            f.argtypes = [vp, vp, vp, ci, ci, ci, vp]
            f.restype = ci
            f = getattr(lib, "schur_chol64_" + sfx)
            f.argtypes = [vp, vp, ll, vp, ll, vp, vp, vp, ci, ci, ci, ci, vp]
            f.restype = ci
            f = getattr(lib, "chol_solve_" + sfx)
            f.argtypes = [vp, vp, vp, ll, vp, ci, ci, ci, ci, vp]
            f.restype = ci
            f = getattr(lib, "panel_factor_" + sfx)
            f.argtypes = [vp, vp, vp, vp, ci, ci, ctypes.POINTER(ci), ci,
                          vp]
            f.restype = ci
            f = getattr(lib, "panel_solve_" + sfx)
            f.argtypes = [vp, vp, vp, ll, vp, ci, ci, ci, vp, ll, ci, vp]
            f.restype = ci
        for f in (lib.smem_optin, lib.sm_count):
            f.argtypes = [ci, ctypes.POINTER(ci)]
            f.restype = ci
        _lib = lib
    return _lib


def _check_dtype(*ts):
    dt = ts[0].dtype
    if dt not in _DTYPES:
        raise TypeError(f"dtype {dt} not supported (float32/float64)")
    for t in ts:
        if t.dtype != dt:
            raise TypeError("all operands must share one dtype")


def _inner_contig(t, name):
    """Raise unless the last two axes of t are row-major contiguous."""
    if t.shape[-1] > 1 and t.stride(-1) != 1 or \
            t.dim() >= 2 and t.shape[-2] > 1 and \
            t.stride(-2) != t.shape[-1]:
        raise ValueError(f"{name} must be contiguous in its last two axes")


_attrs = {}


def _device_attr(name, device):
    """A device attribute by its C query (`smem_optin`, `sm_count`)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if (name, idx) not in _attrs:
        out = ctypes.c_int(0)
        err = getattr(_kernels(), name)(idx, ctypes.byref(out))
        if err:
            raise RuntimeError(f"{name} failed: CUDA error {err}")
        _attrs[name, idx] = out.value
    return _attrs[name, idx]


def _smem_optin(device):
    """Shared memory one block of `device` may opt in to, in bytes."""
    return _device_attr("smem_optin", device)


def _sms(device):
    """The SM count the small-batch rule reads for `device`."""
    return _device_attr("sm_count", device)


def _run(name, t, *args):
    """Call launcher `name` (suffixed by t's dtype) on t's device and
    current stream; raise on a refused launch."""
    fn = getattr(_kernels(), name + "_" + _SUFFIX[t.dtype])
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(*args, stream)
    if err == _ERR_LAYOUT:
        raise RuntimeError(f"{name}: launch_config disagrees with "
                           f"csrc/fused_chol.cu")
    if err == _ERR_TMAP:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused L")
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _vec(Gt, gt_bs, d2, d_bs):
    """Whether Gt's rows and dinv2 can be copied in 16-byte pieces."""
    vw = 16 // Gt.element_size()
    return int(Gt.shape[-1] % vw == 0 and gt_bs % vw == 0 and d_bs % vw == 0
               and Gt.data_ptr() % 16 == 0 and d2.data_ptr() % 16 == 0)


def _assemble(P3, Gt, gt_bs, d2, d_bs, L):
    """schur_assemble: the lower tiles of S = P + Gt diag(dinv2) Gt' into
    L (the first of the factor's two launches)."""
    Bsz, n, _ = P3.shape
    m = Gt.shape[-1]
    cfg = launch_config("factor", Bsz, n, m, P3.element_size(),
                        _smem_optin(P3.device), chol64=False)[0]
    _run("schur_assemble", P3, P3.data_ptr(), n * n, Gt.data_ptr(), gt_bs,
         d2.data_ptr(), d_bs, L.data_ptr(), Bsz, n, m,
         _vec(Gt, gt_bs, d2, d_bs), cfg["smem"])


def _factor(L, Dinv, deq):
    """L := chol(S) in place, Dinv, and deq if given: schur_factor (one
    launch), or panel_factor's launches for a small batch.  Returns the
    kernel's name."""
    Bsz, n, _ = L.shape
    cfg = launch_config("factor", Bsz, n, 1, L.element_size(),
                        _smem_optin(L.device), _sms(L.device),
                        deq is not None, chol64=False)[1:]
    dq = deq.data_ptr() if deq is not None else None
    if cfg[0]["kernel"] == "schur_factor":
        _run("schur_factor", L, L.data_ptr(), Dinv.data_ptr(), dq, Bsz, n,
             cfg[0]["smem"])
        return "schur_factor"
    plan, nlaunch = _panel_factor_codes(Bsz, n, L.element_size(),
                                        deq is not None)
    bad = torch.zeros(Bsz, dtype=torch.int32, device=L.device)
    _run("panel_factor", L, L.data_ptr(), Dinv.data_ptr(), dq,
         bad.data_ptr(), Bsz, n, plan, nlaunch)
    return "panel_factor"


def _launch_schur(P3, Gt, gt_bs, d2, d_bs, equilibrate):
    if not P3.is_contiguous():
        raise ValueError("P must be contiguous")
    _inner_contig(Gt, "Gt")
    if d2.stride(-1) != 1:
        raise ValueError("dinv2 must be contiguous")
    Bsz, n, _ = P3.shape
    kw = dict(dtype=P3.dtype, device=P3.device)
    L = torch.empty((Bsz, n, n), **kw)
    Dinv = torch.empty((Bsz, n // BP, BP, BP), **kw)
    deq = torch.empty((Bsz, n), **kw) if equilibrate else None
    if n == BP:
        (cfg,) = launch_config("factor", Bsz, n, Gt.shape[-1],
                               P3.element_size(), _smem_optin(P3.device))
        _run("schur_chol64", P3, P3.data_ptr(), Gt.data_ptr(), gt_bs,
             d2.data_ptr(), d_bs, L.data_ptr(), Dinv.data_ptr(),
             deq.data_ptr() if equilibrate else None, Bsz, Gt.shape[-1],
             _vec(Gt, gt_bs, d2, d_bs), cfg["smem"])
        return L, Dinv, deq, "schur_chol64"
    _assemble(P3, Gt, gt_bs, d2, d_bs, L)
    return L, Dinv, deq, _factor(L, Dinv, deq)


def _launch_solve(L3, D4, Bm, b_bs, nrhs):
    Bsz, n, _ = L3.shape
    if not (L3.is_contiguous() and D4.is_contiguous()):
        raise ValueError("L and Dinv must be contiguous")
    _inner_contig(Bm, "B_rows")
    # the kernels copy L and Dinv in 16-byte pieces
    if L3.data_ptr() % 16:
        L3 = L3.clone()
    if D4.data_ptr() % 16:
        D4 = D4.clone()
    cfg = launch_config("solve", Bsz, n, nrhs, L3.element_size(),
                        _smem_optin(L3.device), _sms(L3.device))[0]
    X = torch.empty((Bsz, nrhs, n), dtype=L3.dtype, device=L3.device)
    if cfg["kernel"] == "panel_solve":
        scratch = torch.zeros(cfg["scratch"] // 8, dtype=torch.int64,
                              device=L3.device)
        _run("panel_solve", L3, L3.data_ptr(), D4.data_ptr(), Bm.data_ptr(),
             b_bs, X.data_ptr(), Bsz, n, nrhs, scratch.data_ptr(),
             cfg["scratch"], cfg["smem"])
    else:
        _run("chol_solve", L3, L3.data_ptr(), D4.data_ptr(), Bm.data_ptr(),
             b_bs, X.data_ptr(), Bsz, n, nrhs, cfg["smem"])
    return X, cfg["kernel"]


def _check_n(n):
    if n % BP:
        raise ValueError(f"n ({n}) must be a multiple of {BP}")


# ---- public wrappers ---------------------------------------------------

def fused_schur_cholesky(P, Gt, dinv2, *, equilibrate=False,
                         device="cuda"):
    """L, Dinv = chol(P + Gt diag(dinv2) Gt') with panel inverses.

    P (n, n) or (B, n, n); Gt (n, m) or per-instance (B, n, m); dinv2
    (m,), (1, m) or (B, m).  Returns L (..., n, n), Dinv (..., n/64,
    64, 64), and deq (..., n) when `equilibrate`."""
    dev = resolve_device(device)
    check_on(dev, P, Gt, dinv2)
    _check_dtype(P, Gt, dinv2)
    n = P.shape[-1]
    _check_n(n)
    if dev.type == "cpu":
        return fused_schur_cholesky_ref(P, Gt, dinv2, equilibrate)
    single = P.dim() == 2
    P3 = P.unsqueeze(0) if single else P
    Bsz = P3.shape[0]
    m = Gt.shape[-1]
    d2 = dinv2.reshape(-1, m)
    if d2.shape[0] not in (1, Bsz):
        raise ValueError("dinv2 batch does not match P")
    if Gt.dim() == 3 and Gt.shape[0] != Bsz:
        raise ValueError("Gt batch does not match P")
    gt_bs = Gt.stride(0) if Gt.dim() == 3 else 0
    d_bs = d2.stride(0) if d2.shape[0] == Bsz and Bsz > 1 else 0
    L, Dinv, deq, kname = _launch_schur(P3, Gt, gt_bs, d2, d_bs,
                                        equilibrate)
    fused_schur_cholesky.launches += 1
    fused_schur_cholesky.kernels[kname] += 1
    if single:
        L, Dinv = L[0], Dinv[0]
        deq = deq[0] if deq is not None else None
    return (L, Dinv) if deq is None else (L, Dinv, deq)


def fused_cholesky_solve(L, Dinv, B_rows, *, device="cuda"):
    """x = (L L')^{-1} b for right-hand sides stored as rows.

    L (n, n) or (B, n, n); Dinv (..., n/64, 64, 64); B_rows (nrhs, n)
    or (B, nrhs, n).  Returns B_rows' shape."""
    dev = resolve_device(device)
    check_on(dev, L, Dinv, B_rows)
    _check_dtype(L, Dinv, B_rows)
    n = L.shape[-1]
    _check_n(n)
    if dev.type == "cpu":
        return fused_cholesky_solve_ref(L, Dinv, B_rows)
    single = L.dim() == 2
    L3 = L.unsqueeze(0) if single else L
    D4 = Dinv.unsqueeze(0) if single else Dinv
    Bm = B_rows.unsqueeze(0) if B_rows.dim() == 2 else B_rows
    if Bm.shape[0] != L3.shape[0]:
        Bm = Bm.expand(L3.shape[0], -1, -1)
    X, kname = _launch_solve(L3, D4, Bm, Bm.stride(0), Bm.shape[1])
    fused_cholesky_solve.launches += 1
    fused_cholesky_solve.kernels[kname] += 1
    return X[0] if single and B_rows.dim() == 2 else X


def fused_schur_cholesky_batched(P, Gt, dinv2, tb: int = 8, *,
                                 equilibrate=False, device="cuda"):
    """Batched L, Dinv with a shared Gt: P (B, n, n), Gt (n, m), dinv2
    (B, m).  B must be a multiple of tb (kept from the TPU kernel's
    signature; the CUDA kernels otherwise ignore it) and n of BP."""
    dev = resolve_device(device)
    check_on(dev, P, Gt, dinv2)
    _check_dtype(P, Gt, dinv2)
    Bsz, n, _ = P.shape
    if Bsz % tb or n % BP:
        raise ValueError("B must be divisible by tb and n by BP")
    if Gt.dim() != 2 or dinv2.shape != (Bsz, Gt.shape[1]):
        raise ValueError("expected Gt (n, m) and dinv2 (B, m)")
    if dev.type == "cpu":
        return fused_schur_cholesky_batched_ref(P, Gt, dinv2, equilibrate)
    L, Dinv, deq, kname = _launch_schur(P, Gt, 0, dinv2, dinv2.stride(0),
                                        equilibrate)
    fused_schur_cholesky_batched.launches += 1
    fused_schur_cholesky_batched.kernels[kname] += 1
    return (L, Dinv) if deq is None else (L, Dinv, deq)


def fused_cholesky_solve_batched(L, Dinv, B_rows, tb: int = 8, *,
                                 device="cuda"):
    """Batched multi-RHS solve: L (B, n, n), Dinv (B, n/64, 64, 64),
    B_rows (B, nrhs, n); B_rows may be an expanded view with batch
    stride 0 (e.g. one identity for the whole batch)."""
    dev = resolve_device(device)
    check_on(dev, L, Dinv, B_rows)
    _check_dtype(L, Dinv, B_rows)
    Bsz, n, _ = L.shape
    if Bsz % tb or n % BP:
        raise ValueError("B must be divisible by tb and n by BP")
    if dev.type == "cpu":
        return fused_cholesky_solve_batched_ref(L, Dinv, B_rows)
    X, kname = _launch_solve(L, Dinv, B_rows, B_rows.stride(0),
                             B_rows.shape[1])
    fused_cholesky_solve_batched.launches += 1
    fused_cholesky_solve_batched.kernels[kname] += 1
    return X


WRAPPERS = (fused_schur_cholesky, fused_cholesky_solve,
            fused_schur_cholesky_batched, fused_cholesky_solve_batched)
FACTOR_WRAPPERS = (fused_schur_cholesky, fused_schur_cholesky_batched)
SOLVE_WRAPPERS = (fused_cholesky_solve, fused_cholesky_solve_batched)
FACTOR_KERNELS = ("schur_chol64", "schur_factor", "panel_factor")
SOLVE_KERNELS = ("solve_few", "solve_many", "panel_solve")
SMALL_BATCH_KERNELS = ("panel_factor", "panel_solve")
# kernels whose calls launch_counts reports over both wrappers of a kind
COUNTED_KERNELS = ("schur_chol64",) + SMALL_BATCH_KERNELS


def reset_launch_counts():
    for w in WRAPPERS:
        w.launches = 0
    for w in FACTOR_WRAPPERS:
        w.kernels = dict.fromkeys(FACTOR_KERNELS, 0)
    for w in SOLVE_WRAPPERS:
        w.kernels = dict.fromkeys(SOLVE_KERNELS, 0)


def launch_counts():
    """Calls of each wrapper that launched on the card, and calls of
    schur_chol64 and of each small-batch kernel (over both wrappers of
    its kind)."""
    out = {w.__name__: w.launches for w in WRAPPERS}
    for k in COUNTED_KERNELS:
        out[k] = sum(w.kernels.get(k, 0) for w in WRAPPERS)
    return out


def factor_kernel_counts():
    """Calls of each factor wrapper by the factor kernel they launched."""
    return {w.__name__: dict(w.kernels) for w in FACTOR_WRAPPERS}


def solve_kernel_counts():
    """Calls of each solve wrapper by the device kernel they launched."""
    return {w.__name__: dict(w.kernels) for w in SOLVE_WRAPPERS}


reset_launch_counts()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`cvxopt_tpu_torch`) on one GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line:

  env      nvidia-smi name and power limit, torch and CUDA versions
  build    nvcc builds csrc/fused_chol.cu (sm_90a); seconds, ptxas usage
  kernels  the four fused-Cholesky wrappers against their plain PyTorch
           versions on the card, at every solver phase's shapes (f32;
           f64 for cpl and lp_milp) and at B=64 in f64, plus a non-PD
           instance that must come back NaN;
           kernel, plain-version and library times, share of the bound
           (bound_ms / ms), and schur_chol's two launches (assembly,
           factor) timed apart; at n = 64 (the socp and ilp shapes) the
           factor is one launch, schur_chol64, timed in turns with its
           plain version, the library and the two-launch layout it
           replaces
  cascade  make_coneqp_cascade(l=512, 'chol2_inv', 1e-7) on 1024
           scenario QPs with n=256: every status 0, gap/pres/dres
           <= 1e-7, IPM iterations/s, the batched kernels launched
  entry    make_coneqp(l=256) on 64 QPs with per-instance G in f32 and
           f64: the unbatched kernels launched, 4 instances agree with
           the port's CPU run
  socp     make_coneqp_cascade(q=(4,)*100, 'chol2_inv', 1e-7, per-instance
           G/h) on 1024 SOC-constrained QPs with n=64: every status 0,
           gap/pres/dres <= 1e-7, the unbatched kernels launched, 4
           instances agree with the port's float64 CPU run
  conelp_lp  make_conelp_cascade(l=512, 'chol2', 1e-7) on 1024 scenario
           LPs with n=256 and shared G/h/A/b: same checks, the batched
           kernels launched
  sdp      make_conelp_cascade(s=(50,), 1e-7/1e-6/1e-7, per-instance
           G/h) on 128 max-cut SDP relaxations with m=50: same checks
           (no hand-written kernel on this path: the default 'qr')
  cpl      cvxprog.make_cpl(l=512, mnl=1, 'chol2') on 1024 analytic-
           centering problems (acent2, n=256 plus the epigraph variable)
           in f64: every status 0, pres/dres <= 1e-7, gap <= 1e-7 or
           relgap <= 1e-6, the unbatched kernels launched in f64 at
           n=320 (padded), m=513, nrhs 1 and 64, and the first 16
           instances equal to the port's CPU run of those 16 alone
           (status, iterations, x within 1e-6)
  nonlinear_front  one problem each through the front doors, on the
           card: gp floor planning against its closed form; cp acent
           (m=100, n=1000) against the CPU run; cpl with a Sherman-
           Morrison kktsolver, dense and matrix-free (n=4096), against
           the dense default path; kkt_structured.l1 (m=2000, n=500:
           operator G, callable kktsolver in conelp) against the CPU run;
           kkt_structured.l1regls (m=200, n=2000: operator P/G, Woodbury
           kktsolver in coneqp) against its optimality conditions and
           the CPU run
  lp_milp  the LP modeling and integer path: boeing2.mps (BASELINE.json
           config 1) through modeling.op().fromfile().solve() (conelp
           'chol2', the batched kernel pair at B=1 in f64) and through
           solvers.lp(solver='glpk') (the simplex: both optimal, objectives
           within 1e-3 of the NETLIB value and 1e-6 of each other, pivots,
           host syncs, and the library QR's share of device time in a
           profiled window of the pivot loop); bench.py's 256 batched vertex LPs (n=16, m=40,
           p=1) through make_simplex(batched=True) against scipy's HiGHS
           (objectives within 1e-9) and the CPU run; the 60-binary
           multi-knapsack of tests/test_ilp.py through glpk.ilp
           (node_batch=16) with and without cover cuts against
           scipy.optimize.milp (objective within 1e-6; cuts open at most
           0.85 x the nodes), the batched kernel pair launched in f64
  sparse   the sparse direct path: bench.py's chain LP at n = 100,000
           through lp_sparse against HiGHS, a profiled window, n = 20,000
           against the CPU run, and the cholmod/umfpack/blas/lapack/fft
           namespaces (no hand-written kernel)
  parallel the parallel layer in an NCCL process group of world size 1
           (one card, a file rendezvous): the collectives against the
           single-device cone functions; __graft_entry__.dryrun_multichip's
           sharded paths (batched QPs, arrow and block kktsolvers alone
           and through coneqp, cone reductions, the cone-sharded coneqp,
           the chol2_inv cascade) against their mesh=None runs; the
           cascade phase's 1024 x n=256 batch through sharded_batch_solve
           (every status 0 at 1e-7, x within 1e-12 of the unsharded run,
           the batched kernels launched); the n = 10,240 block QP of
           tests/test_block_kkt.py:90-130, unchanged and not convex: one
           factor + solve of the mesh kktsolver at W = 1.1 I, timed, whose
           outputs must be non-finite as the JAX package's are, and its
           local factor and solves (8 x 1280, f64) against their plain
           versions
  large_kkt  bench.py's large_kkt stage (:746) at n = 10,240, B = 1, in
           seeded numpy (S = F F' + I + Gt diag(d) Gt', F (n, 256)):
           panel_factor and panel_solve in f32 and f64 (the f64 factor
           within 1e-12 of its plain version; the f32 factor, S being
           conditioned at about 1.4e4, as close to the f64 factor as the
           plain version is, within twice its distance; the solve within
           1e-5 / 1e-12 of its plain version on a well-conditioned factor
           of this shape, and on S with a residual within 10 times the
           library's); kernel, plain and library times (torch.linalg.
           cholesky of torch's S, torch.cholesky_solve; the solve in turns
           with its plain version and the library's), the
           factor's two launches apart, one run of the one-block layout,
           a torch.profiler breakdown of one f64 factor (`factor_profile`:
           each kernel's device ms and launches, the DMMA kernels'
           TFLOP/s and share of the 67 TFLOP/s peak, and the device time
           the lookahead overlaps, `lookahead_overlap_ms`) and a sweep
           over n at B = 1 (small-batch against one-block kernels: the
           data behind fused_chol's n thresholds); then one QP at n = m =
           10,240 through solvers.qp (chol2, so the kernels at B = 1) held
           to gap, pres and dres <= 1e-7 and to x of the same QP through
           kktsolver='chol' within 1e-6, with its iterations, wall, kernel
           launches and each factor call's device ms
           (`factor_call_device_ms`)

Each solver phase sets the kernels' launch counts to 0 just before its
timed solve and reads them just after.  Then a line with each phase's
wall seconds (checks and CPU references included), a `{"kernels":
[...]}` line (one row per wrapper and shape, with the phases that
launched it), the nvidia-smi line, and last `{"ok": true, "device":
{...}}`.  Any failed check raises, and the
script exits non-zero; it also exits non-zero, printing no result,
when no CUDA device is present.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "build", "kernels", "cascade", "entry", "socp",
          "conelp_lp", "sdp", "cpl", "nonlinear_front", "lp_milp", "sparse",
          "parallel", "large_kkt")

# published peaks of one H100 SXM (NVIDIA data sheet): float32 outside
# the tensor cores, and HBM3 bandwidth.  67 TFLOP/s is also the FP64
# tensor-core (DMMA) peak, which the f64 rows' bounds use: the f64
# schur_assemble and trail_update run on DMMA, the other f64 kernels on
# FP64 FMAs (34 TFLOP/s)
PEAK_F32_FLOPS = 67e12
PEAK_DMMA_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FLOP_RATE = {4: "FP32 without tensor cores, 67 TFLOP/s",
             8: "FP64 tensor cores (DMMA), 67 TFLOP/s; schur_assemble and "
                "trail_update use DMMA, the other kernels FP64 FMA "
                "(34 TFLOP/s)"}

TOL = {"float32": 1e-5, "float64": 1e-12}


def emit(obj, log):
    log.append(obj)
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def rel_fro(a, b):
    import torch
    d = torch.linalg.vector_norm((a - b).double())
    return float(d / torch.linalg.vector_norm(b.double()))


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


# ---- data ----------------------------------------------------------------

def kernel_data(B, n, m, dtype, per_instance_gt, seed):
    """tests/test_pallas_chol.py's generator, scaled up and made on the
    card: P = F F' + n I, Gt ~ N(0, 1), dinv2 ~ U(0.5, 2)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", dtype=torch.float64, generator=g)
    F = torch.randn((B, n, n), **kw)
    P = F @ F.transpose(1, 2) + n * torch.eye(n, dtype=torch.float64,
                                              device="cuda")
    Gt = torch.randn(((B,) if per_instance_gt else ()) + (n, m), **kw)
    dinv2 = 0.5 + 1.5 * torch.rand((B, m), **kw)
    return P.to(dtype), Gt.to(dtype), dinv2.to(dtype)


def scenario_qps(nb, n, seed=0, dev="cuda"):
    """bench.py make_batch: min 1/2 x'Px + q'x, 0 <= x <= 1, sum x = 1,
    with P = F F' + 0.1 I, F (n, n/4) / sqrt(n); seeded numpy."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    F = torch.as_tensor(rng.standard_normal((nb, n, n // 4)) / np.sqrt(n),
                        device=dev)
    P = F @ F.transpose(1, 2) + 0.1 * torch.eye(n, dtype=torch.float64,
                                                device=dev)
    q = torch.as_tensor(-rng.uniform(0.0, 0.1, (nb, n)), device=dev)
    eye = np.eye(n)
    G = np.concatenate([-eye, eye], axis=0)
    h = np.concatenate([np.zeros(n), np.ones(n)])
    return (P, q) + tuple(torch.as_tensor(u, device=dev) for u in
                          (G, h, np.ones((1, n)), np.ones(1)))


def entry_qps(nb, n, dtype):
    """__graft_entry__._qp_batch: P = F F' + I, x >= 0, sum x = 1, with
    a per-instance G = -I; seeded numpy."""
    import numpy as np
    rng = np.random.default_rng(0)
    F = rng.standard_normal((nb, n, n)).astype(dtype)
    P = F @ F.transpose(0, 2, 1) + np.eye(n, dtype=dtype)
    q = rng.standard_normal((nb, n)).astype(dtype)
    G = np.broadcast_to(-np.eye(n, dtype=dtype), (nb, n, n)).copy()
    h = np.zeros((nb, n), dtype=dtype)
    A = np.broadcast_to(np.ones((1, n), dtype=dtype), (nb, 1, n)).copy()
    b = np.ones((nb, 1), dtype=dtype)
    return P, q, G, h, A, b


def soc_qps(nb, n=64, nq=100, mq=4, seed=0):
    """bench.py bench_socp's problem in seeded numpy: P = F F' + 0.1 I,
    and per block ||D_i x + f_i|| <= g_i'x + 1 (x = 0 strictly
    feasible), G rows [-g_i'; -D_i], h = [1; f_i]; per-instance G, h."""
    import numpy as np
    rng = np.random.default_rng(seed)
    m = nq * mq
    F = rng.standard_normal((nb, n, n // 4)) / np.sqrt(n)
    P = F @ F.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = -rng.uniform(0.0, 0.1, (nb, n))
    G = 0.3 * rng.standard_normal((nb, m, n))
    h = 0.1 * rng.standard_normal((nb, nq, mq))
    h[:, :, 0] = 1.0
    return (P, q, G, h.reshape(nb, m), np.zeros((nb, 0, n)),
            np.zeros((nb, 0)))


def scenario_lps(nb, n=256, seed=0):
    """The scenario problems without P: min q'x, 0 <= x <= 1,
    sum x = 1, shared G/h/A/b; seeded numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    c = -rng.uniform(0.0, 0.1, (nb, n))
    eye = np.eye(n)
    return (c, np.concatenate([-eye, eye]),
            np.concatenate([np.zeros(n), np.ones(n)]), np.ones((1, n)),
            np.ones(1))


def acent2_batch(nb, n=256, p=64, seed=0):
    """chap9/acent2.py's problem in the epigraph form `cp` builds, for
    `make_cpl`: x = [u; t], minimize t s.t. -sum log(1 - u_i^2) - t <= 0,
    -1 <= u <= 1 (a zero t column), A u = b with A ~ N(0, 1) (p, n) shared
    and b = A u_feas per instance, u_feas ~ U(-0.5, 0.5); x0 = [0; 1].
    Returns the data (c, x0, G, h, A, b) and F of one instance."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    Au = rng.standard_normal((p, n))
    b = rng.uniform(-0.5, 0.5, (nb, n)) @ Au.T
    eye = np.eye(n)
    G = np.concatenate([np.concatenate([eye, -eye]), np.zeros((2 * n, 1))],
                       axis=1)
    c = np.zeros(n + 1)
    c[n] = 1.0
    x0 = np.zeros(n + 1)
    x0[n] = 1.0

    def F(x):
        return (-torch.log(1.0 - x[:n] ** 2).sum() - x[n]).reshape(1)

    return (c, x0, G, np.ones(2 * n),
            np.concatenate([Au, np.zeros((p, 1))], axis=1), b), F


def mcsdp_batch(nb, m=50, seed=0):
    """bench.py's batched max-cut SDP relaxation: min 1'x subject to
    diag(x) + W PSD, with a seeded symmetric W per instance;
    per-instance G/h/A/b."""
    import numpy as np
    rng = np.random.default_rng(seed)
    G = np.zeros((m * m, m))
    G[np.arange(m) * (m + 1), np.arange(m)] = -1.0
    W = rng.standard_normal((nb, m, m))
    W = (W + W.transpose(0, 2, 1)) / np.sqrt(m)
    return (np.ones((nb, m)), np.broadcast_to(G, (nb,) + G.shape).copy(),
            W.reshape(nb, -1), np.zeros((nb, 0, m)), np.zeros((nb, 0)))


def boeing2_lp():
    """BASELINE.json's first configuration, the NETLIB LP boeing2
    (tests/data/boeing2.mps, 166 rows, 143 columns) as (c, G, h, A, b)."""
    from cvxopt_tpu_torch.mpsio import mps_load
    return mps_load(os.path.join(ROOT, "tests", "data",
                                 "boeing2.mps")).to_lp()


def vertex_lps(nb=256, n=16, mextra=8, seed=5):
    """bench.py bench_batched_lp's LPs (:1051-1104): min c'x, 0 <= x <= 1,
    `mextra` random rows Pn x <= Pn 0.5 + U(0.05, 0.5), sum x = n / 2;
    per-instance (c, G, h, A, b) and Pn."""
    import numpy as np
    rng = np.random.default_rng(seed)
    eye = np.eye(n)
    Pn = rng.standard_normal((nb, mextra, n)) / np.sqrt(n)
    G = np.concatenate([np.broadcast_to(np.vstack([eye, -eye]),
                                        (nb, 2 * n, n)), Pn], axis=1)
    h = np.concatenate(
        [np.ones((nb, n)), np.zeros((nb, n)),
         Pn @ np.full(n, 0.5) + rng.uniform(0.05, 0.5, (nb, mextra))],
        axis=1)
    c = rng.standard_normal((nb, n))
    A = np.ones((nb, 1, n))
    b = np.full((nb, 1), n / 2.0)
    return (c, G, h, A, b), Pn


def knapsack60(seed=11):
    """tests/test_ilp.py:99-120: 60 binaries, 5 knapsack rows with
    capacity 0.3 of each row's total weight; max value = min c'x."""
    import numpy as np
    rng = np.random.default_rng(seed)
    c = -rng.uniform(1, 10, 60)
    W = rng.uniform(1, 10, (5, 60))
    return c, W, 0.3 * W.sum(axis=1)


def chain_lp(n, seed=0):
    """bench.py's `_chain_lp` (tests/test_sparse_kkt.py's generator),
    vectorized: min c'x s.t. 0 <= x <= 1 (rows 2i, 2i+1) and
    |x_i - x_{i+1}| <= 0.5 (rows 2n+2i, 2n+2i+1), as scipy CSR."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(n) * 0.1
    i = np.arange(n)
    j = np.arange(n - 1)
    r0 = 2 * n + 2 * j
    rows = np.concatenate([2 * i, 2 * i + 1, r0, r0, r0 + 1, r0 + 1])
    cols = np.concatenate([i, i, j, j + 1, j, j + 1])
    vals = np.concatenate([-np.ones(n), np.ones(n), np.ones(n - 1),
                           -np.ones(n - 1), -np.ones(n - 1), np.ones(n - 1)])
    m = 2 * n + 2 * (n - 1)
    G = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    h = np.concatenate([np.tile([0.0, 1.0], n), np.full(2 * (n - 1), 0.5)])
    return c, G, h


def banded_spd(n=60, kd=3, seed=0):
    """tests/test_cholmod_sys.py's `_banded_spd` built sparse (the same
    draws): B B' + n I for a random band B of width kd, under a random
    symmetric permutation."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    B = sp.csr_matrix((n, n))
    for d in range(kd + 1):
        v = rng.standard_normal(n - d) * (0.3 if d else 1.0)
        B = B + sp.diags(v, -d) + (sp.diags(v, d) if d else 0)
    A = (B @ B.T + n * sp.eye(n)).tocsr()
    p = rng.permutation(n)
    return A[p][:, p].tocsr()


def arrow_spd(n=256, head=8, seed=1):
    """tests/test_cholmod_sys.py's `_arrow_spd`: a diagonal plus dense
    head rows and columns."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    A = sp.lil_matrix((n, n))
    A.setdiag(rng.uniform(1.0, 2.0, n) + n)
    C = 0.3 * rng.standard_normal((head, n - head))
    A[:head, head:] = C
    A[head:, :head] = C.T
    return sp.csr_matrix(A)


def unsym_arrow(n, head=10, seed=0):
    """tests/test_blocksparse.py's `_unsym_arrow`."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    A = sp.lil_matrix((n, n))
    A.setdiag(rng.uniform(5.0, 9.0, n))
    A[:head, head:] = 0.4 * rng.standard_normal((head, n - head))
    A[head:, :head] = 0.2 * rng.standard_normal((n - head, head))
    for d in (1, 2):
        A.setdiag(0.3 * rng.standard_normal(n - d), d)
        A.setdiag(0.2 * rng.standard_normal(n - d), -d)
    return sp.csr_matrix(A)


# ---- phases --------------------------------------------------------------

def phase_build(log):
    from cvxopt_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build("fused_chol")
    secs = time.perf_counter() - t0
    info = _build.build_log.get("fused_chol", {})
    usage = [ln.strip() for ln in info.get("ptxas", "").splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": secs, "library":
          os.path.relpath(path, ROOT), "ptxas": usage}, log)


def _factor_bound(B, n, m, shared, esize):
    """S's lower triangle (n (n+1) m FLOP) and its factor (n^3 / 3) per
    instance; bytes of P's lower triangle, Gt (once if shared), dinv2
    in and L, Dinv out."""
    flops = B * (n * (n + 1.0) * m + n ** 3 / 3.0)
    words = B * (n * (n + 1) / 2 + m + n * n + n * 64) + \
        (n * m if shared else B * n * m)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = words * esize / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


L2_BYTES = 50 * 2 ** 20    # the H100's L2 cache


def _solve_bound(B, n, nrhs, rhs_shared, esize):
    """Per right-hand side, forward and backward: the strictly lower
    off-diagonal tiles (n (n-64) / 2 words) and the lower halves of the
    Dinv blocks, 2 (n^2 + n) FLOP in all; bytes of the Dinv blocks and of
    the right-hand sides in (once if shared) and out, and of the tiles:
    both sweeps read every tile, and the backward sweep of an instance
    starts only when its forward sweep has ended, so the second sweep
    reads from memory what of an instance's tiles the L2 cannot keep
    (tiles once where they fit in it, as at every shape but n = 10,240).
    Shared memory and registers, which hold a chain's working set, are
    not counted as a cache."""
    flops = B * 2.0 * (n * n + n) * nrhs
    tiles = n * (n - 64) / 2
    again = max(0.0, tiles - L2_BYTES / esize)
    words = B * (tiles + again + n * 64 + nrhs * n) + \
        (nrhs * n if rhs_shared else B * nrhs * n)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = words * esize / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def schur_split_ms(P, Gt, d2, reps=10, warmup=2):
    """Device ms of schur_chol's two launches, schur_assemble and the
    factor (schur_factor, or panel_factor's launches), each between CUDA
    events recorded around it.  At n = 64, where a factor call is one
    launch of schur_chol64, this times the two-launch layout that calls
    took before it (schur_assemble + schur_factor)."""
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    B, n, _ = P.shape
    gt_bs = Gt.stride(0) if Gt.dim() == 3 else 0
    L = torch.empty((B, n, n), dtype=P.dtype, device=P.device)
    D = torch.empty((B, n // fc.BP, fc.BP, fc.BP), dtype=P.dtype,
                    device=P.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    asm = fac = 0.0
    for r in range(warmup + reps):
        ev[0].record()
        fc._assemble(P, Gt, gt_bs, d2, d2.stride(0), L)
        ev[1].record()
        fc._factor(L, D, None)
        ev[2].record()
        torch.cuda.synchronize()
        if r >= warmup:
            asm += ev[0].elapsed_time(ev[1])
            fac += ev[1].elapsed_time(ev[2])
    return asm / reps, fac / reps


def _check_factor(fn, P, Gt, d2, dtype_name, label, equilibrate):
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    out = fn(P, Gt, d2, equilibrate=equilibrate)
    ref = fc.fused_schur_cholesky_ref(P, Gt, d2, equilibrate)
    torch.cuda.synchronize()
    errs = {"L": rel_fro(out[0], ref[0]), "Dinv": rel_fro(out[1], ref[1])}
    if equilibrate:
        errs["deq"] = rel_fro(out[2], ref[2])
    tol = TOL[dtype_name]
    check(all(e <= tol for e in errs.values()),
          f"{label} {dtype_name} disagrees with its plain version: {errs}")
    return out, ref, errs


def _lib_factor(P, Gt, d2):
    """The library's factor of the same S: torch's S, then
    torch.linalg.cholesky (a yardstick; the port calls neither)."""
    import torch
    S = torch.baddbmm(P, Gt * d2.unsqueeze(-2), Gt.transpose(-1, -2)) \
        if Gt.dim() == 3 else P + (Gt * d2.unsqueeze(-2)) @ Gt.T
    return torch.linalg.cholesky(S)


def chol64_times(fac, P, Gt, d2):
    """The n = 64 factor's times: schur_chol64 through the wrapper (`ms`),
    its plain version, the library's S + Cholesky, and the two-launch
    layout it replaces (schur_assemble + schur_factor, `two_launch_*`,
    called below the wrapper: without its checks and allocations), timed
    in turns: kernel, plain, library, two-launch, then again."""
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    B, n, _ = P.shape
    L = torch.empty_like(P)
    D = torch.empty((B, 1, n, n), dtype=P.dtype, device=P.device)
    gt_bs = Gt.stride(0) if Gt.dim() == 3 else 0

    def two_launch():
        fc._assemble(P, Gt, gt_bs, d2, d2.stride(0), L)
        fc._factor(L, D, None)
    t = in_turns({"ms": fac,
                  "plain_ms": lambda: fc.fused_schur_cholesky_ref(P, Gt, d2),
                  "library_ms": lambda: _lib_factor(P, Gt, d2),
                  "two_launch_ms": two_launch})
    out = {k: min(v) for k, v in t.items()}
    out["turns"] = t
    out["two_launch_assemble_ms"], out["two_launch_factor_ms"] = \
        schur_split_ms(P, Gt, d2)
    return out


def phase_kernels(log, results):
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    f32, f64 = torch.float32, torch.float64
    rep = "cvxopt_tpu/ops/pallas_chol.py:"

    # -- kernel 3: batched factor, shared Gt (cascade phases A/B)
    B, n, m = 1024, 256, 512
    P, Gt, d2 = kernel_data(B, n, m, f32, False, seed=1)
    b3 = lambda P, Gt, d2, equilibrate=False: \
        fc.fused_schur_cholesky_batched(P, Gt, d2, tb=8,
                                        equilibrate=equilibrate)
    (L3, D3), ref3, e3 = _check_factor(b3, P, Gt, d2, "float32",
                                       "fused_schur_cholesky_batched", False)
    _, _, e3q = _check_factor(b3, P, Gt, d2, "float32",
                              "fused_schur_cholesky_batched(equilibrate)",
                              True)
    bound, by = _factor_bound(B, n, m, True, 4)
    results["fused_schur_cholesky_batched"] = dict(
        replaces=rep + "338", shape=[B, n, m], dtype="float32",
        rel_fro_err=e3, rel_fro_err_equilibrate=e3q,
        max_abs_err=max_abs(L3, ref3[0]),
        ms=time_ms(lambda: b3(P, Gt, d2)),
        ms_equilibrate=time_ms(lambda: b3(P, Gt, d2, True)),
        plain_ms=time_ms(lambda: fc.fused_schur_cholesky_ref(P, Gt, d2)),
        library_ms=time_ms(lambda: _lib_factor(P, Gt, d2)),
        bound_ms=bound, bound_by=by)
    r = results["fused_schur_cholesky_batched"]
    r["assemble_ms"], r["factor_ms"] = schur_split_ms(P, Gt, d2)

    # -- kernel 4: batched solve, nrhs = 256 (identity, as chol2_inv's
    # inverse) and nrhs = 1 (chol2 solves of the rescue phase)
    eye = torch.eye(n, dtype=f32, device="cuda").expand(B, n, n)
    g = torch.Generator(device="cuda").manual_seed(2)
    r1 = torch.randn((B, 1, n), device="cuda", dtype=f32, generator=g)
    s4 = lambda rhs: fc.fused_cholesky_solve_batched(L3, D3, rhs, tb=8)
    x256, x1 = s4(eye), s4(r1)
    x256r = fc.fused_cholesky_solve_ref(L3, D3, eye)
    x1r = fc.fused_cholesky_solve_ref(L3, D3, r1)
    e4 = {"nrhs256": rel_fro(x256, x256r), "nrhs1": rel_fro(x1, x1r)}
    check(all(v <= TOL["float32"] for v in e4.values()),
          f"fused_cholesky_solve_batched disagrees: {e4}")
    bound, by = _solve_bound(B, n, n, True, 4)
    bound1, by1 = _solve_bound(B, n, 1, False, 4)
    results["fused_cholesky_solve_batched"] = dict(
        replaces=rep + "404", shape=[B, n, n], dtype="float32",
        rel_fro_err=e4, max_abs_err=max_abs(x256, x256r),
        ms=time_ms(lambda: s4(eye)),
        plain_ms=time_ms(lambda: fc.fused_cholesky_solve_ref(L3, D3, eye)),
        library_ms=time_ms(lambda: torch.cholesky_solve(eye, L3)),
        bound_ms=bound, bound_by=by,
        nrhs1=dict(ms=time_ms(lambda: s4(r1)),
                   plain_ms=time_ms(
                       lambda: fc.fused_cholesky_solve_ref(L3, D3, r1)),
                   library_ms=time_ms(lambda: torch.cholesky_solve(
                       r1.transpose(1, 2), L3)),
                   bound_ms=bound1, bound_by=by1))
    del P, Gt, d2, L3, D3, ref3, eye, x256, x256r

    # -- kernel 1: factor with per-instance Gt (entry-shaped path)
    B1, m1 = 64, 256
    P, Gt, d2 = kernel_data(B1, n, m1, f32, True, seed=3)
    k1 = lambda P, Gt, d2, equilibrate=False: \
        fc.fused_schur_cholesky(P, Gt, d2, equilibrate=equilibrate)
    (L1, D1), ref1, e1 = _check_factor(k1, P, Gt, d2, "float32",
                                       "fused_schur_cholesky", False)
    bound, by = _factor_bound(B1, n, m1, False, 4)
    results["fused_schur_cholesky"] = dict(
        replaces=rep + "129", shape=[B1, n, m1], dtype="float32",
        rel_fro_err=e1, max_abs_err=max_abs(L1, ref1[0]),
        ms=time_ms(lambda: k1(P, Gt, d2)),
        plain_ms=time_ms(lambda: fc.fused_schur_cholesky_ref(P, Gt, d2)),
        library_ms=time_ms(lambda: _lib_factor(P, Gt, d2)),
        bound_ms=bound, bound_by=by)
    r = results["fused_schur_cholesky"]
    r["assemble_ms"], r["factor_ms"] = schur_split_ms(P, Gt, d2)

    # -- kernel 2: solve, nrhs = 1 (every chol2 KKT solve)
    r1 = torch.randn((B1, 1, n), device="cuda", dtype=f32, generator=g)
    x1 = fc.fused_cholesky_solve(L1, D1, r1)
    x1r = fc.fused_cholesky_solve_ref(L1, D1, r1)
    e2 = rel_fro(x1, x1r)
    check(e2 <= TOL["float32"], f"fused_cholesky_solve disagrees: {e2}")
    bound, by = _solve_bound(B1, n, 1, False, 4)
    results["fused_cholesky_solve"] = dict(
        replaces=rep + "194", shape=[B1, n, 1], dtype="float32",
        rel_fro_err=e2, max_abs_err=max_abs(x1, x1r),
        ms=time_ms(lambda: fc.fused_cholesky_solve(L1, D1, r1)),
        plain_ms=time_ms(lambda: fc.fused_cholesky_solve_ref(L1, D1, r1)),
        library_ms=time_ms(lambda: torch.cholesky_solve(
            r1.transpose(1, 2), L1)),
        bound_ms=bound, bound_by=by)

    del P, Gt, d2, L1, D1, ref1

    # -- the SOCP path's shapes: per-instance Gt = Gs' (1024, 64, 400),
    # the inverse by nrhs = 64 (phase A's chol2_inv), nrhs = 1 (phase C)
    Bq, nq_, mq_ = 1024, 64, 400
    P, Gt, d2 = kernel_data(Bq, nq_, mq_, f32, True, seed=5)
    d2 = torch.ones_like(d2)
    (L5, D5), ref5, e5 = _check_factor(k1, P, Gt, d2, "float32",
                                       "schur_chol64 (socp)", False)
    _, _, e5q = _check_factor(k1, P, Gt, d2, "float32",
                              "schur_chol64 (socp, equilibrate)", True)
    bound, by = _factor_bound(Bq, nq_, mq_, False, 4)
    results["schur_chol64/socp"] = dict(
        name="schur_chol64", replaces=rep + "129",
        shape=[Bq, nq_, mq_], dtype="float32", rel_fro_err=e5,
        rel_fro_err_equilibrate=e5q, max_abs_err=max_abs(L5, ref5[0]),
        bound_ms=bound, bound_by=by,
        **chol64_times(lambda: k1(P, Gt, d2), P, Gt, d2))
    eye = torch.eye(nq_, dtype=f32, device="cuda").expand(Bq, nq_, nq_)
    r1 = torch.randn((Bq, 1, nq_), device="cuda", dtype=f32, generator=g)
    s2 = lambda rhs: fc.fused_cholesky_solve(L5, D5, rhs)
    x64, x1 = s2(eye), s2(r1)
    x64r = fc.fused_cholesky_solve_ref(L5, D5, eye)
    x1r = fc.fused_cholesky_solve_ref(L5, D5, r1)
    e6 = {"nrhs64": rel_fro(x64, x64r), "nrhs1": rel_fro(x1, x1r)}
    check(all(v <= TOL["float32"] for v in e6.values()),
          f"fused_cholesky_solve (socp) disagrees: {e6}")
    bound, by = _solve_bound(Bq, nq_, nq_, True, 4)
    bound1, by1 = _solve_bound(Bq, nq_, 1, False, 4)
    results["fused_cholesky_solve/socp"] = dict(
        name="fused_cholesky_solve", replaces=rep + "194",
        shape=[Bq, nq_, nq_], dtype="float32", rel_fro_err=e6,
        max_abs_err=max_abs(x64, x64r),
        ms=time_ms(lambda: s2(eye)),
        plain_ms=time_ms(lambda: fc.fused_cholesky_solve_ref(L5, D5, eye)),
        library_ms=time_ms(lambda: torch.cholesky_solve(eye, L5)),
        bound_ms=bound, bound_by=by,
        nrhs1=dict(ms=time_ms(lambda: s2(r1)),
                   plain_ms=time_ms(
                       lambda: fc.fused_cholesky_solve_ref(L5, D5, r1)),
                   library_ms=time_ms(lambda: torch.cholesky_solve(
                       r1.transpose(1, 2), L5)),
                   bound_ms=bound1, bound_by=by1))
    del P, Gt, d2, L5, D5, ref5, eye, x64, x64r

    # -- the cone-LP path's shapes: shared Gt, P = 0 (1024, 256, 512),
    # solves at nrhs = 1 (S^{-1} A' with p = 1, and every KKT solve)
    P, Gt, d2 = kernel_data(B, n, m, f32, False, seed=6)
    P = torch.zeros_like(P)
    (L7, D7), ref7, e7 = _check_factor(
        b3, P, Gt, d2, "float32", "fused_schur_cholesky_batched (P = 0)",
        False)
    bound, by = _factor_bound(B, n, m, True, 4)
    results["fused_schur_cholesky_batched/lp"] = dict(
        name="fused_schur_cholesky_batched", replaces=rep + "338",
        shape=[B, n, m], dtype="float32", rel_fro_err=e7,
        max_abs_err=max_abs(L7, ref7[0]),
        ms=time_ms(lambda: b3(P, Gt, d2)),
        plain_ms=time_ms(lambda: fc.fused_schur_cholesky_ref(P, Gt, d2)),
        library_ms=time_ms(lambda: _lib_factor(P, Gt, d2)),
        bound_ms=bound, bound_by=by)
    r = results["fused_schur_cholesky_batched/lp"]
    r["assemble_ms"], r["factor_ms"] = schur_split_ms(P, Gt, d2)
    r1 = torch.randn((B, 1, n), device="cuda", dtype=f32, generator=g)
    s8 = lambda rhs: fc.fused_cholesky_solve_batched(L7, D7, rhs, tb=8)
    x1, x1r = s8(r1), fc.fused_cholesky_solve_ref(L7, D7, r1)
    e8 = rel_fro(x1, x1r)
    check(e8 <= TOL["float32"],
          f"fused_cholesky_solve_batched (lp) disagrees: {e8}")
    bound, by = _solve_bound(B, n, 1, False, 4)
    results["fused_cholesky_solve_batched/lp"] = dict(
        name="fused_cholesky_solve_batched", replaces=rep + "404",
        shape=[B, n, 1], dtype="float32", rel_fro_err=e8,
        max_abs_err=max_abs(x1, x1r),
        ms=time_ms(lambda: s8(r1)),
        plain_ms=time_ms(lambda: fc.fused_cholesky_solve_ref(L7, D7, r1)),
        library_ms=time_ms(lambda: torch.cholesky_solve(
            r1.transpose(1, 2), L7)),
        bound_ms=bound, bound_by=by)
    del P, Gt, d2, L7, D7, ref7

    # -- the cpl path's shapes, f64: per-instance Gt = Gs' of [Df; G]
    # (1024, 320, 513: n = 257 padded to 320, m = 1 + 512), P = H padded
    # with an identity, dinv2 = 1; solves at nrhs = 1 (every KKT solve)
    # and nrhs = 64 (S^{-1} A', once per factor)
    Bc, nc, mc = 1024, 320, 513
    P, Gt, d2 = kernel_data(Bc, nc, mc, f64, True, seed=7)
    d2 = torch.ones_like(d2)
    (L9, D9), ref9, e9 = _check_factor(k1, P, Gt, d2, "float64",
                                       "fused_schur_cholesky (cpl)", False)
    bound, by = _factor_bound(Bc, nc, mc, False, 8)
    results["fused_schur_cholesky/cpl"] = dict(
        name="fused_schur_cholesky", replaces=rep + "129",
        shape=[Bc, nc, mc], dtype="float64", rel_fro_err=e9,
        max_abs_err=max_abs(L9, ref9[0]),
        ms=time_ms(lambda: k1(P, Gt, d2)),
        plain_ms=time_ms(lambda: fc.fused_schur_cholesky_ref(P, Gt, d2)),
        library_ms=time_ms(lambda: _lib_factor(P, Gt, d2)),
        bound_ms=bound, bound_by=by, flop_rate=FLOP_RATE[8])
    r = results["fused_schur_cholesky/cpl"]
    r["assemble_ms"], r["factor_ms"] = schur_split_ms(P, Gt, d2)
    del P, Gt, d2, ref9
    for key, nrhs in (("fused_cholesky_solve/cpl", 1),
                      ("fused_cholesky_solve/cpl_nrhs64", 64)):
        rhs = torch.randn((Bc, nrhs, nc), device="cuda", dtype=f64,
                          generator=g)
        s9 = lambda: fc.fused_cholesky_solve(L9, D9, rhs)
        x, xr = s9(), fc.fused_cholesky_solve_ref(L9, D9, rhs)
        err = rel_fro(x, xr)
        check(err <= TOL["float64"], f"{key} disagrees: {err}")
        bound, by = _solve_bound(Bc, nc, nrhs, False, 8)
        results[key] = dict(
            name="fused_cholesky_solve", replaces=rep + "194",
            shape=[Bc, nc, nrhs], dtype="float64", rel_fro_err=err,
            max_abs_err=max_abs(x, xr), ms=time_ms(s9),
            plain_ms=time_ms(
                lambda: fc.fused_cholesky_solve_ref(L9, D9, rhs)),
            library_ms=time_ms(lambda: torch.cholesky_solve(
                rhs.transpose(1, 2), L9)),
            bound_ms=bound, bound_by=by, flop_rate=FLOP_RATE[8])
    del L9, D9, rhs, x, xr

    # -- the lp_milp path's shapes, f64, shared Gt, P = 0 (an LP): boeing2
    # through conelp (B = 1, n = 143 padded to 192, m = 378; solves at
    # nrhs 1, and 4 for S^{-1} A') and the ilp node batches (B = 16,
    # n = 60 padded to 64, m = 5 rows + 32 cut rows + 120 box rows)
    # (tb = 1, as kkt_chol2 calls the batched pair)
    b1 = lambda P, Gt, d2, equilibrate=False: \
        fc.fused_schur_cholesky_batched(P, Gt, d2, tb=1,
                                        equilibrate=equilibrate)
    for tag, (Bl, nl, ml), extra in (("boeing2", (1, 192, 378), 4),
                                     ("milp", (16, 64, 157), None)):
        P, Gt, d2 = kernel_data(Bl, nl, ml, f64, False, seed=8)
        P = torch.zeros_like(P)
        # n = 64 (the ilp node batches) is one launch of schur_chol64
        key = ("schur_chol64/" if nl == fc.BP else
               "fused_schur_cholesky_batched/") + tag
        (Ll, Dl), refl, el = _check_factor(
            b1, P, Gt, d2, "float64", f"{key.split('/')[0]} ({tag})", False)
        bound, by = _factor_bound(Bl, nl, ml, True, 8)
        results[key] = dict(
            name=key.split("/")[0], replaces=rep + "338",
            shape=[Bl, nl, ml], dtype="float64", rel_fro_err=el,
            max_abs_err=max_abs(Ll, refl[0]),
            bound_ms=bound, bound_by=by, flop_rate=FLOP_RATE[8])
        r = results[key]
        if nl == fc.BP:
            r.update(chol64_times(lambda: b1(P, Gt, d2), P, Gt, d2))
        else:
            r.update(ms=time_ms(lambda: b1(P, Gt, d2)),
                     plain_ms=time_ms(
                         lambda: fc.fused_schur_cholesky_ref(P, Gt, d2)),
                     library_ms=time_ms(lambda: _lib_factor(P, Gt, d2)),
                     one_block_ms=one_block_ms(lambda: b1(P, Gt, d2)))
            r["assemble_ms"], r["factor_ms"] = schur_split_ms(P, Gt, d2)
        sl = lambda rhs: fc.fused_cholesky_solve_batched(Ll, Dl, rhs, tb=1)
        errs = {}
        for k in (1, extra) if extra else (1,):
            rhs = torch.randn((Bl, k, nl), device="cuda", dtype=f64,
                              generator=g)
            x, xr = sl(rhs), fc.fused_cholesky_solve_ref(Ll, Dl, rhs)
            errs[f"nrhs{k}"] = rel_fro(x, xr)
            if k == 1:
                r1, x1, x1r = rhs, x, xr
        check(all(v <= TOL["float64"] for v in errs.values()),
              f"fused_cholesky_solve_batched ({tag}) disagrees: {errs}")
        bound, by = _solve_bound(Bl, nl, 1, False, 8)
        results["fused_cholesky_solve_batched/" + tag] = dict(
            name="fused_cholesky_solve_batched", replaces=rep + "404",
            shape=[Bl, nl, 1], dtype="float64", rel_fro_err=errs,
            max_abs_err=max_abs(x1, x1r),
            ms=time_ms(lambda: sl(r1)),
            plain_ms=time_ms(
                lambda: fc.fused_cholesky_solve_ref(Ll, Dl, r1)),
            library_ms=time_ms(lambda: torch.cholesky_solve(
                r1.transpose(1, 2), Ll)),
            one_block_ms=one_block_ms(lambda: sl(r1)),
            bound_ms=bound, bound_by=by, flop_rate=FLOP_RATE[8])
        del P, Gt, d2, Ll, Dl, refl

    # -- float64 at B = 64, with one non-PD instance (must be NaN)
    B64 = 64
    f64errs = {}
    for name, per_inst in (("fused_schur_cholesky", True),
                           ("fused_schur_cholesky_batched", False)):
        P, Gt, d2 = kernel_data(B64, n, 512, f64, per_inst, seed=4)
        P[0] = -1e6 * torch.eye(n, dtype=f64, device="cuda")
        fn = getattr(fc, name)
        L, D = fn(P, Gt, d2)
        Lr, Dr = fc.fused_schur_cholesky_ref(P, Gt, d2)
        torch.cuda.synchronize()
        check(bool(torch.isnan(L[0]).all() and torch.isnan(D[0]).all()),
              f"{name}: non-PD instance did not come back NaN")
        check(bool(torch.isfinite(L[1:]).all()),
              f"{name}: NaN leaked into PD instances")
        eL, eD = rel_fro(L[1:], Lr[1:]), rel_fro(D[1:], Dr[1:])
        rhs = torch.randn((B64, 8, n), device="cuda", dtype=f64,
                          generator=g)
        sname = name.replace("schur_cholesky", "cholesky_solve")
        x = getattr(fc, sname)(L, D, rhs)
        xr = fc.fused_cholesky_solve_ref(Lr, Dr, rhs)
        check(bool(torch.isnan(x[0]).all()),
              f"{sname}: non-PD instance did not come back NaN")
        ex = rel_fro(x[1:], xr[1:])
        f64errs[name] = {"L": eL, "Dinv": eD}
        f64errs[sname] = {"x": ex}
        check(max(eL, eD, ex) <= TOL["float64"],
              f"{name}/{sname} float64 disagree: {eL} {eD} {ex}")
    for k, v in f64errs.items():
        results[k]["rel_fro_err_float64_B64"] = v
    for k, r in results.items():
        r.setdefault("name", k)
    for r in results.values():
        r.setdefault("flop_rate", FLOP_RATE[4])
        for row in (r, r.get("nrhs1")):
            if row:
                row["bound_share"] = row["bound_ms"] / row["ms"]
    emit({"phase": "kernels", "ok": True, "results": results}, log)


def phase_cascade(log, results, carry):
    import torch
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.coneqp import make_coneqp_cascade, make_coneqp
    from cvxopt_tpu_torch.ops import fused_chol as fc
    nb, n = 1024, 256
    dims = ConeDims(l=2 * n)
    kw = dict(kktsolver="chol2_inv", maxiters=50, abstol=1e-7,
              reltol=1e-7, feastol=1e-7)
    solve = make_coneqp_cascade(dims, instrument=True, **kw)
    solve(*scenario_qps(64, n, seed=1))           # warm-up (handles)
    data = scenario_qps(nb, n, seed=0)
    torch.cuda.synchronize()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    out = solve(*data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fc.launch_counts()
    status = out["status"].cpu()
    iters = int(out["iterations"].sum())
    rec = {"phase": "cascade", "instances": nb, "n": n,
           "solved": int((status == 0).sum()),
           "max_gap": float(out["gap"].max()),
           "max_relgap": float(out["relgap"].max()),
           "max_pres": float(out["pres"].max()),
           "max_dres": float(out["dres"].max()),
           "iterations": iters, "wall_s": wall,
           "ipm_iters_per_s": iters / wall,
           "profile": out["profile"], "launches": counts}
    check(rec["solved"] == nb, f"cascade: {nb - rec['solved']} unsolved")
    check(rec["max_gap"] <= 1e-7, f"cascade gap {rec['max_gap']}")
    check(max(rec["max_pres"], rec["max_dres"]) <= 1e-7,
          f"cascade residuals {rec['max_pres']} {rec['max_dres']}")
    for k in ("fused_schur_cholesky_batched",
              "fused_cholesky_solve_batched"):
        check(counts[k] > 0, f"cascade did not launch {k}")
        if k in results:
            results[k]["launches"] = counts[k]
            results[k].setdefault("paths", []).append("cascade")
    # four instances against the port's float64 'chol2' solve on the CPU
    cpu = make_coneqp(dims, kktsolver="chol2", abstol=1e-7, reltol=1e-7,
                      feastol=1e-7, device="cpu")
    P, q, G, h, A, b = (u.cpu() for u in data)
    ref = cpu(P[:4], q[:4], G, h, A, b)
    dx = float((out["x"][:4].cpu() - ref["x"]).abs().max())
    rec["x_vs_cpu_f64_max_abs"] = dx
    check(dx <= 1e-6, f"cascade x differs from the CPU f64 solve: {dx}")
    carry["cascade_x"] = out["x"]
    rec["nvidia_smi"] = nvidia_smi()
    emit(rec, log)


def phase_entry(log, results):
    import numpy as np
    import torch
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.coneqp import make_coneqp
    from cvxopt_tpu_torch.ops import fused_chol as fc
    nb, n = 64, 256
    dims = ConeDims(l=n)
    for dtype, kw, xtol in (
            (np.float32, dict(maxiters=30, abstol=1e-4, reltol=1e-4,
                              feastol=1e-4), 1e-5),
            (np.float64, dict(), 1e-9)):
        data = entry_qps(nb, n, dtype)
        gpu = make_coneqp(dims, **kw)
        torch.cuda.synchronize()
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        out = gpu(*data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fc.launch_counts()
        status = out["status"].cpu().numpy()
        cpu = make_coneqp(dims, device="cpu", **kw)
        ref = cpu(*(u[:4] for u in data))
        dx = float((out["x"][:4].cpu() - ref["x"]).abs().max())
        rec = {"phase": "entry", "dtype": np.dtype(dtype).name,
               "instances": nb, "n": n,
               "solved": int((status == 0).sum()),
               "iterations": int(out["iterations"].sum()),
               "wall_s": wall, "launches": counts,
               "cpu_status": ref["status"].tolist(),
               "x_vs_cpu_max_abs": dx}
        check(rec["solved"] == nb, f"entry {rec['dtype']}: unsolved")
        check(np.array_equal(status[:4], ref["status"].numpy()),
              "entry: statuses differ from the CPU run")
        check(dx <= xtol, f"entry {rec['dtype']}: x differs by {dx}")
        for k in ("fused_schur_cholesky", "fused_cholesky_solve"):
            check(counts[k] > 0, f"entry path did not launch {k}")
            if dtype == np.float32 and k in results:
                results[k]["launches"] = counts[k]
                results[k].setdefault("paths", []).append("entry")
        emit(rec, log)


def _attribute(results, counts, phase, rows):
    """Write the wrappers' launch counts of one solver phase into the
    kernel rows at that phase's shapes."""
    for key in rows:
        name = key.split("/")[0]
        check(counts[name] > 0, f"{phase} did not launch {name}")
        if key in results:
            results[key]["launches"] = counts[name]
            results[key].setdefault("paths", []).append(phase)


def _solver_phase(log, results, phase, solve, data, warm, rows, cpu_ref,
                  reltol, xtol, extra=None):
    """One cascade on the card: a warm-up solve of a few instances
    (library handles, first-use allocations), the counts set to 0, the
    timed solve, the counts read; then the checks: every status 0,
    pres/dres <= 1e-7 and gap <= 1e-7 (or relgap <= reltol where the
    solver's reltol exit is looser), the kernels of `rows` launched, and
    4 instances against the port's float64 run on the CPU."""
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    solve(*warm)
    data = tuple(torch.as_tensor(u, device="cuda") for u in data)
    torch.cuda.synchronize()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    out = solve(*data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fc.launch_counts()
    nb = data[0].shape[0]
    iters = int(out["iterations"].sum())
    conv = (out["gap"] <= 1e-7) | (out["relgap"] <= reltol)
    rec = {"phase": phase, "instances": nb,
           "solved": int((out["status"] == 0).sum()),
           "max_gap": float(out["gap"].max()),
           "max_relgap": float(out["relgap"].max()),
           "max_pres": float(out["pres"].max()),
           "max_dres": float(out["dres"].max()),
           "iterations": iters, "wall_s": wall,
           "ipm_iters_per_s": iters / wall,
           "rescue_iterations": int(out["rescue_iterations"].sum()),
           "profile": out["profile"], "launches": counts}
    rec.update(extra or {})
    check(rec["solved"] == nb, f"{phase}: {nb - rec['solved']} unsolved")
    check(bool(conv.all()), f"{phase}: gap {rec['max_gap']} relgap "
          f"{rec['max_relgap']}")
    check(max(rec["max_pres"], rec["max_dres"]) <= 1e-7,
          f"{phase} residuals {rec['max_pres']} {rec['max_dres']}")
    if rows:
        _attribute(results, counts, phase, rows)
    else:
        check(not any(counts.values()),
              f"{phase}: unexpected kernel launches {counts}")
    ref = cpu_ref(*(u.cpu() for u in data))
    dx = float((out["x"][:4].cpu() - ref["x"]).abs().max())
    dp = float(((out["pcost"][:4].cpu() - ref["pcost"]).abs()
                / ref["pcost"].abs().clamp(min=1.0)).max())
    rec.update(x_vs_cpu_f64_max_abs=dx, pcost_vs_cpu_f64_max_rel=dp,
               x_tolerance=xtol, cpu_status=ref["status"].tolist(),
               nvidia_smi=nvidia_smi())
    check(all(v == 0 for v in rec["cpu_status"]), f"{phase}: CPU run")
    check(dx <= xtol, f"{phase}: x differs from the CPU f64 solve: {dx}")
    check(dp <= max(1e-6, 3 * reltol),
          f"{phase}: objective differs from the CPU's: {dp}")
    emit(rec, log)


def phase_socp(log, results):
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.coneqp import make_coneqp_cascade, make_coneqp
    dims = ConeDims(q=(4,) * 100)
    tol = dict(abstol=1e-7, reltol=1e-7, feastol=1e-7)
    solve = make_coneqp_cascade(dims, kktsolver="chol2_inv", maxiters=50,
                                shared_GhAb=False, instrument=True, **tol)
    cpu = make_coneqp(dims, kktsolver="chol2", device="cpu", **tol)
    _solver_phase(
        log, results, "socp", solve, soc_qps(1024, seed=0),
        soc_qps(64, seed=1),
        ("schur_chol64/socp", "fused_cholesky_solve/socp"),
        lambda *d: cpu(*(u[:4] for u in d)), 1e-7, 1e-6,
        extra={"n": 64, "cone": "q=(4,)*100"})


def phase_conelp_lp(log, results):
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.conelp import make_conelp_cascade, make_conelp
    dims = ConeDims(l=512)
    tol = dict(abstol=1e-7, reltol=1e-7, feastol=1e-7)
    solve = make_conelp_cascade(dims, kktsolver="chol2", maxiters=50,
                                instrument=True, **tol)
    cpu = make_conelp(dims, kktsolver="chol2", device="cpu", **tol)
    _solver_phase(
        log, results, "conelp_lp", solve, scenario_lps(1024, seed=0),
        scenario_lps(64, seed=1),
        ("fused_schur_cholesky_batched/lp",
         "fused_cholesky_solve_batched/lp"),
        lambda c, *shared: cpu(c[:4], *shared), 1e-7, 1e-6,
        extra={"n": 256, "cone": "l=512"})


def phase_sdp(log, results):
    """x of an SDP stopped at relgap <= 1e-6 is determined to about
    1e-4 only, so x is held to 1e-3 and the objective to 1e-6."""
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.conelp import make_conelp_cascade, make_conelp
    dims = ConeDims(s=(50,))
    tol = dict(abstol=1e-7, reltol=1e-6, feastol=1e-7)
    solve = make_conelp_cascade(dims, maxiters=40, shared_GhAb=False,
                                instrument=True, **tol)
    cpu = make_conelp(dims, maxiters=40, device="cpu", **tol)
    _solver_phase(
        log, results, "sdp", solve, mcsdp_batch(128, seed=0),
        mcsdp_batch(8, seed=1), (),
        lambda *d: cpu(*(u[:4] for u in d)), 1e-6, 1e-3,
        extra={"m": 50, "cone": "s=(50,)"})


def phase_cpl(log, results):
    """The batched nonlinear path: make_cpl with 'chol2' factors S = H +
    [Df; G]' W^-2 [Df; G] per instance in the unbatched kernel pair."""
    import numpy as np
    import torch
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.cvxprog import make_cpl
    from cvxopt_tpu_torch.ops import fused_chol as fc
    nb, n, ncheck = 1024, 256, 16
    dims = ConeDims(l=2 * n, mnl=1)
    data, F = acent2_batch(nb, n, seed=0)
    warm, _ = acent2_batch(8, n, seed=1)
    gpu = make_cpl(dims, F, kktsolver="chol2")
    gpu(*(torch.as_tensor(u, device="cuda") for u in warm))
    data = tuple(torch.as_tensor(u, device="cuda") for u in data)
    torch.cuda.synchronize()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    out = gpu(*data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, kcounts = fc.launch_counts(), fc.solve_kernel_counts()
    iters = int(out["iterations"].sum())
    conv = (out["gap"] <= 1e-7) | (out["relgap"] <= 1e-6)
    rec = {"phase": "cpl", "instances": nb, "n": n + 1, "mnl": 1,
           "cone": "l=512", "p": 64, "kktsolver": "chol2",
           "solved": int((out["status"] == 0).sum()),
           "max_gap": float(out["gap"].max()),
           "max_relgap": float(out["relgap"].max()),
           "max_pres": float(out["pres"].max()),
           "max_dres": float(out["dres"].max()),
           "iterations": iters,
           "max_iterations": int(out["iterations"].max()),
           "wall_s": wall, "ipm_iters_per_s": iters / wall,
           "passes": out["passes"], "host_syncs": out["host_syncs"],
           "host_syncs_per_pass": out["host_syncs"] / out["passes"],
           "launches": counts, "solve_kernels": kcounts}
    check(rec["solved"] == nb, f"cpl: {nb - rec['solved']} unsolved")
    check(bool(conv.all()), f"cpl: gap {rec['max_gap']} relgap "
          f"{rec['max_relgap']}")
    check(max(rec["max_pres"], rec["max_dres"]) <= 1e-7,
          f"cpl residuals {rec['max_pres']} {rec['max_dres']}")
    few = kcounts["fused_cholesky_solve"]
    for key, cnt in (("fused_schur_cholesky/cpl",
                      counts["fused_schur_cholesky"]),
                     ("fused_cholesky_solve/cpl", few["solve_few"]),
                     ("fused_cholesky_solve/cpl_nrhs64",
                      few["solve_many"])):
        check(cnt > 0, f"cpl did not launch {key}")
        if key in results:
            results[key]["launches"] = cnt
            results[key].setdefault("paths", []).append("cpl")
    # the first instances against the port's f64 run of them on the CPU
    cpu = make_cpl(dims, F, kktsolver="chol2", device="cpu")
    c, x0, G, h, A, b = (u.cpu() for u in data)
    t0 = time.perf_counter()
    ref = cpu(c, x0, G, h, A, b[:ncheck])
    dx = float((out["x"][:ncheck].cpu() - ref["x"]).abs().max())
    rec.update(cpu_instances=ncheck, cpu_s=time.perf_counter() - t0,
               x_vs_cpu_f64_max_abs=dx,
               cpu_status=ref["status"].tolist(),
               cpu_iterations=ref["iterations"].tolist(),
               nvidia_smi=nvidia_smi())
    check(np.array_equal(out["status"][:ncheck].cpu().numpy(),
                         ref["status"].numpy()), "cpl: CPU statuses differ")
    check(np.array_equal(out["iterations"][:ncheck].cpu().numpy(),
                         ref["iterations"].numpy()),
          "cpl: CPU iteration counts differ")
    check(dx <= 1e-6, f"cpl: x differs from the CPU f64 solve: {dx}")
    emit(rec, log)


def _front(name, run, rec):
    """Time one front-door solve on the card; returns its result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = run()
    torch.cuda.synchronize()
    rec[name] = {"status": sol["status"], "iterations": sol["iterations"],
                 "wall_s": time.perf_counter() - t0}
    check(sol["status"] == "optimal", f"{name}: {sol['status']}")
    return sol


def _vs_cpu(name, gpu, cpu, rec, key="x", tol=1e-6):
    dx = float((gpu[key].cpu() - cpu[key]).abs().max())
    rec[name].update(cpu_iterations=cpu["iterations"],
                     x_vs_cpu_max_abs=dx)
    check(cpu["status"] == "optimal", f"{name}: CPU run {cpu['status']}")
    check(gpu["iterations"] == cpu["iterations"],
          f"{name}: iterations differ from the CPU run")
    check(dx <= tol, f"{name}: x differs from the CPU run by {dx}")


def phase_nonlinear_front(log, results):
    """One problem each through cvxopt_tpu_torch.solvers / kkt_structured
    on the card (the tests' cases at larger sizes).  The GP is solved at
    1e-11 tolerances: its optimum is flat, and (h, w, d) reach 1e-5
    (relative) of the closed form only there."""
    import numpy as np
    import torch
    from cvxopt_tpu_torch import solvers, kkt_structured
    rec = {"phase": "nonlinear_front"}
    cpu = dict(device="cpu")

    # gp: floor planning (chap9/gp.py), closed form (5, 10, 20)/sqrt(3)
    K = [1, 2, 1, 1, 1, 1, 1]
    Fg = np.array([[-1., 1., 1., 0., -1., 1., 0., 0.],
                   [-1., 1., 0., 1., 1., -1., 1., -1.],
                   [-1., 0., 1., 1., 0., 0., -1., 1.]]).T
    g = np.log(np.array([1.0, 2 / 100.0, 2 / 100.0, 1 / 1000.0, 0.5,
                         1 / 2.0, 0.5, 1 / 2.0]))
    tight = dict(options=dict(abstol=1e-11, reltol=1e-11, feastol=1e-11))
    sol = _front("gp", lambda: solvers.gp(K, Fg, g, **tight), rec)
    hwd = np.exp(sol["x"].cpu().numpy())
    err = float(np.abs(hwd / (np.array([5., 10., 20.]) / np.sqrt(3)) - 1)
                .max())
    rec["gp"]["hwd_rel_err"] = err
    check(err <= 1e-5, f"gp: (h, w, d) {hwd} off the closed form by {err}")
    _vs_cpu("gp", sol, solvers.gp(K, Fg, g, **tight, **cpu), rec)

    # cp: analytic centering (chap9/acent.py) at m = 100, n = 1000
    rng = np.random.default_rng(0)
    m, n = 100, 1000
    y = rng.standard_normal(m)
    A = rng.standard_normal((m, n))
    A = A + np.outer(y, rng.uniform(0, 1, n) - A.T @ y) / (y @ y)
    b = A @ rng.uniform(0, 1, n)

    def Fa(x):
        return (-torch.log(x).sum()).reshape(1)

    sol = _front("cp_acent", lambda: solvers.cp(Fa, np.ones(n), A=A, b=b),
                 rec)
    _vs_cpu("cp_acent", sol, solvers.cp(Fa, np.ones(n), A=A, b=b, **cpu),
            rec)

    # cpl: min 1'x s.t. sum(exp(x)) <= n, x >= -2, with the Sherman-
    # Morrison kktsolver(x, znl, W) of tests/test_cvxprog.py, dense and
    # matrix-free, against the dense default path, n = 4096 (the test's
    # bound 10 becomes n: at this n no x >= -2 meets 10); the optimum is
    # the bound x = -2
    n = 4096
    c, G, h = np.ones(n), -np.eye(n), 2.0 * np.ones(n)

    def Fe(x):
        return (torch.exp(x).sum() - float(n)).reshape(1)

    def sm_kkt(x, znl, W):
        ex = torch.exp(x)
        dnli2 = W["dnli"][0] ** 2
        di2 = W["di"] ** 2
        Dinv = 1.0 / (znl[0] * ex + di2)
        u = torch.sqrt(dnli2) * ex
        denom = 1.0 + (u * Dinv * u).sum()

        def solve(bx, by, bz):
            t = Dinv * (bx + ex * (dnli2 * bz[0]) - di2 * bz[1:])
            ux = t - Dinv * u * ((u * t).sum() / denom)
            return ux, by, torch.cat([W["dnli"] * ((ex * ux).sum() - bz[:1]),
                                      W["di"] * (-ux - bz[1:])])

        return solve

    dense = _front("cpl_dense", lambda: solvers.cpl(c, Fe, np.zeros(n), G,
                                                    h), rec)
    err = float((dense["x"] + 2.0).abs().max())
    rec["cpl_dense"]["x_vs_closed_form_max_abs"] = err
    check(err <= 1e-5, f"cpl_dense: x off the bound -2 by {err}")
    for name, mf in (("cpl_sherman_morrison", False),
                     ("cpl_matrix_free", True)):
        sol = _front(name, lambda: solvers.cpl(
            c, Fe, np.zeros(n), G, h, kktsolver=sm_kkt, matrix_free=mf),
            rec)
        dx = float((sol["x"] - dense["x"]).abs().max())
        rec[name]["x_vs_dense_max_abs"] = dx
        check(dx <= 1e-6, f"{name}: x differs from the dense path by {dx}")

    # kkt_structured.l1: operator G, callable kktsolver in conelp
    P = rng.standard_normal((2000, 500))
    q = rng.standard_normal(2000)
    sol = _front("l1", lambda: kkt_structured.l1(P, q), rec)
    _vs_cpu("l1", sol, kkt_structured.l1(P, q, **cpu), rec, key="u")

    # kkt_structured.l1regls: operator P/G, Woodbury kktsolver in coneqp
    A = rng.standard_normal((200, 2000))
    y = rng.standard_normal(200)
    sol = _front("l1regls", lambda: kkt_structured.l1regls(A, y), rec)
    u = sol["u"].cpu().numpy()
    gr = 2 * A.T @ (A @ u - y)
    # away from the kink g = -sign(u); entries at the solver's
    # convergence scale only satisfy |g| <= 1 (tests/test_custom_kkt.py)
    on = np.abs(u) > 1e-3
    kkt_err = max(float(np.abs(gr[on] + np.sign(u[on])).max(initial=0.0)),
                  float(np.abs(gr[~on]).max(initial=0.0)) - 1.0)
    rec["l1regls"].update(nonzeros=int(on.sum()), optimality_err=kkt_err)
    check(kkt_err < 1e-4, f"l1regls: optimality conditions off by {kkt_err}")
    _vs_cpu("l1regls", sol, kkt_structured.l1regls(A, y, **cpu), rec,
            key="u")
    rec["nvidia_smi"] = nvidia_smi()
    emit(rec, log)


# device-kernel name fragments -> group of a profile's breakdown
GROUPS = (
    ("hand_written", ("schur_assemble", "schur_factor", "solve_few",
                      "solve_many", "panel_", "trail_update")),
    ("library_qr", ("geqr", "larf", "orgqr", "ormqr", "householder",
                    "geqr2", "larft")),
    ("library_eigh", ("syev", "sytr", "stedc", "steqr", "jacobi", "heev",
                      "sytd", "latrd", "laed", "ormtr", "stedx")),
    ("library_chol_lu_trsm", ("potr", "getr", "trsm", "trsv", "trmm",
                              "triangular", "lu_", "cholesky")),
    ("matmul", ("gemm", "gemv", "cutlass", "sgemm", "dgemm", "bmm")),
)


def kernel_group(name):
    low = name.lower()
    for grp, frags in GROUPS:
        if any(f in low for f in frags):
            return grp
    return "other"


def device_rows(prof):
    """(name, launches, device ms) of every device-side event of a
    torch.profiler run: a CPU op's device time repeats the kernels it
    launched, so only device events count."""
    rows = []
    for e in prof.key_averages():
        dt = next((getattr(e, k) for k in ("self_device_time_total",
                                           "self_cuda_time_total")
                   if hasattr(e, k)), 0.0)
        if "CUDA" in str(getattr(e, "device_type", "CUDA")) and dt > 0:
            rows.append({"name": e.key[:120], "count": e.count,
                         "device_ms": dt / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def _simplex_phases(data, maxiters):
    """The two simplex phases of a batch of LPs (c, G, h, A, b with a
    leading batch axis) through simplex._setup/_phase on the card:
    pivot-loop trips per phase (the most any instance took), pivots in
    all, host syncs and wall seconds."""
    import torch
    from cvxopt_tpu_torch import simplex as sx
    args = [torch.as_tensor(u, device="cuda") for u in data]
    syncs = [0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S = sx._setup(*args)
    basis, code1, it1, _ = sx._phase(
        S["W"], S["r"], S["c1"], ~S["is_art"], S["basis0"], maxiters,
        syncs=syncs)
    _, code2, it2, _ = sx._phase(
        S["W"], S["r"], S["c2"], ~S["is_art"], basis, maxiters - it1,
        cap_art=S["is_art"], syncs=syncs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(bool((code1 == 0).all() and (code2 == 0).all()),
          "simplex phases: a phase did not end optimal")
    return {"pivots_phase1": int(it1.max()), "pivots_phase2": int(it2.max()),
            "pivots_total": int((it1 + it2).sum()), "host_syncs": syncs[0],
            "phases_wall_s": wall}


def _profiled_pivots(data, pivots):
    """`pivots` trips of the phase-1 pivot loop from the crash basis
    under torch.profiler: a steady window, since every trip refactors a
    basis of the same size.  Device kernel ms and launches per trip, the
    device's idle share, and the share of device time in the library QR
    (cuSOLVER geqrf and its Householder helpers).  A window, not the
    whole solve: analysing a trace takes about 0.3 ms per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cvxopt_tpu_torch import simplex as sx
    S = sx._setup(*(torch.as_tensor(u, device="cuda") for u in data))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sx._phase(S["W"], S["r"], S["c1"], ~S["is_art"], S["basis0"],
                  pivots)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    dev_ms = sum(r["device_ms"] for r in rows)
    check(dev_ms > 0, "the profiler saw no device kernels")
    qr_ms = sum(r["device_ms"] for r in rows
                if kernel_group(r["name"]) == "library_qr")
    launches = sum(r["count"] for r in rows)
    return {"trips": pivots, "profiled_wall_s": wall,
            "device_kernel_ms": dev_ms, "device_ms_per_trip": dev_ms / pivots,
            "device_idle_share": 1.0 - dev_ms / 1e3 / wall,
            "launches_per_trip": launches / pivots,
            "qr_share_of_device": qr_ms / dev_ms, "top": rows[:4]}


def phase_lp_milp(log, results):
    """The LP modeling and integer path: boeing2 through the modeling
    layer (IPM, the batched kernel pair at B = 1 in f64) and through the
    simplex (solver='glpk'); bench.py's 256 batched vertex LPs; the
    60-binary multi-knapsack through glpk.ilp (node batches in the
    batched kernel pair, f64) with and without cover cuts."""
    import numpy as np
    import torch
    from scipy.optimize import Bounds, LinearConstraint, linprog, milp
    from cvxopt_tpu_torch import glpk, modeling, solvers
    from cvxopt_tpu_torch.ops import fused_chol as fc
    from cvxopt_tpu_torch.simplex import make_simplex
    rec = {"phase": "lp_milp", "elapsed_s": {}}
    t_phase = time.perf_counter()

    def mark(part):
        rec["elapsed_s"][part] = time.perf_counter() - t_phase

    boeing = os.path.join(ROOT, "tests", "data", "boeing2.mps")
    c, G, h, A, b = data = boeing2_lp()
    netlib = -315.0187280

    # warm-up: library handles and first-use allocations on small LPs
    x = modeling.variable(2)
    modeling.op(modeling.dot(np.array([-4., -5.]), x),
                np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]]) @ x
                <= np.array([3., 3., 0., 0.])).solve()
    glpk.lp(np.array([-4., -5.]), np.eye(2), np.ones(2))
    glpk.ilp(np.array([-4., -5.]), np.eye(2), np.ones(2), I={0, 1})
    mark("warm_up")

    # 1a. boeing2 through op().fromfile().solve(): lp -> conelp, chol2
    torch.cuda.synchronize()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    prob = modeling.op().fromfile(boeing)
    ipm = prob.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fc.launch_counts()
    rec["boeing2_ipm"] = {
        "status": ipm["status"], "iterations": ipm["iterations"],
        "primal_objective": ipm["primal objective"], "wall_s": wall,
        "launches": counts}
    check(ipm["status"] == "optimal", f"boeing2 IPM: {ipm['status']}")
    check(abs(ipm["primal objective"] - netlib) <= 1e-3,
          f"boeing2 IPM objective {ipm['primal objective']}")
    _attribute(results, counts, "lp_milp",
               ("fused_schur_cholesky_batched/boeing2",
                "fused_cholesky_solve_batched/boeing2"))

    # 1b. boeing2 through the simplex (solver='glpk')
    opts = {"glpk": {"it_lim": 20000}}
    torch.cuda.synchronize()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    spx = solvers.lp(c, G, h, A=A, b=b, solver="glpk", options=opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rel = abs(spx["primal objective"] - ipm["primal objective"]) / \
        abs(spx["primal objective"])
    rec["boeing2_simplex"] = {
        "status": spx["status"], "primal_objective": spx["primal objective"],
        "primal_infeasibility": spx["primal infeasibility"],
        "dual_infeasibility": spx["dual infeasibility"], "wall_s": wall,
        "objective_vs_ipm_rel": rel,
        "kernel_launches": sum(fc.launch_counts().values())}
    check(spx["status"] == "optimal", f"boeing2 simplex: {spx['status']}")
    check(abs(spx["primal objective"] - netlib) <= 1e-3,
          f"boeing2 simplex objective {spx['primal objective']}")
    check(max(spx["primal infeasibility"], spx["dual infeasibility"])
          <= 1e-7, "boeing2 simplex residuals")
    check(rel <= 1e-6, f"boeing2: simplex and IPM objectives differ {rel}")
    mark("boeing2")
    one = [u[None] for u in data]
    rec["boeing2_simplex"].update(_simplex_phases(one, 20000))
    rec["boeing2_simplex"]["profile"] = _profiled_pivots(one, 64)
    mark("boeing2_profile")

    # 2. bench.py's batched vertex LPs: 256 x (n = 16, m = 40, p = 1)
    (cb, Gb, hb, Ab, bb), Pn = vertex_lps()
    nb, n = cb.shape
    run = make_simplex(n, Gb.shape[1], 1, 400, batched=True)
    run(*(u[:8] for u in (cb, Gb, hb, Ab, bb)))
    dev = [torch.as_tensor(u, device="cuda") for u in (cb, Gb, hb, Ab, bb)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    code, xb, _, _ = run(*dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    code, xb = code.cpu().numpy(), xb.cpu().numpy()
    objs = np.einsum("bi,bi->b", xb, cb)
    t0 = time.perf_counter()
    sobjs = np.array([linprog(cb[i], A_ub=Pn[i], b_ub=hb[i, 2 * n:],
                              A_eq=Ab[i], b_eq=bb[i], bounds=(0.0, 1.0),
                              method="highs").fun for i in range(nb)])
    scipy_s = time.perf_counter() - t0
    cpu = make_simplex(n, Gb.shape[1], 1, 400, batched=True,
                       device="cpu")(*(u[:4] for u in (cb, Gb, hb, Ab, bb)))
    dobj = float(np.max(np.abs(objs - sobjs) / np.maximum(1, np.abs(sobjs))))
    dx = float(np.abs(xb[:4] - cpu[1].numpy()).max())
    rec["batched_simplex"] = {
        "instances": nb, "n": n, "m": int(Gb.shape[1]), "p": 1,
        "maxiters": 400, "solved": int((code == 0).sum()), "wall_s": wall,
        "lps_per_s": nb / wall, "scipy_highs_s": scipy_s,
        "objective_vs_highs_max_rel": dobj, "x_vs_cpu_max_abs": dx}
    check((code == 0).all(), f"batched simplex: codes {np.unique(code)}")
    check(dobj <= 1e-9, f"batched simplex objectives vs HiGHS: {dobj}")
    check(np.array_equal(code[:4], cpu[0].numpy()),
          "batched simplex: codes differ from the CPU run")
    check(dx <= 1e-9, f"batched simplex: x differs from the CPU run {dx}")
    mark("batched_simplex")
    batch = (cb, Gb, hb, Ab, bb)
    rec["batched_simplex"].update(_simplex_phases(batch, 400))
    rec["batched_simplex"]["profile"] = _profiled_pivots(batch, 8)
    mark("batched_profile")

    # 3. the 60-binary multi-knapsack, with and without cover cuts
    ck, W, cap = knapsack60()
    ref = milp(ck, constraints=LinearConstraint(W, -np.inf, cap),
               integrality=np.ones(60), bounds=Bounds(0, 1))
    check(ref.status == 0, f"scipy milp: {ref.message}")
    mark("highs_milp")
    total = {k: 0 for k in fc.launch_counts()}
    for cuts in (False, True):
        st = {}
        torch.cuda.synchronize()
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        status, xk = glpk.ilp(ck, W, cap, B=list(range(60)), cuts=cuts,
                              max_nodes=4000, node_batch=16,
                              options={"_stats": st})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fc.launch_counts()
        for k, v in counts.items():
            total[k] += v
        obj = float(ck @ xk) if xk is not None else None
        rec["milp_cuts" if cuts else "milp_no_cuts"] = {
            "status": status, "objective": obj, "highs_objective": ref.fun,
            "wall_s": wall, "launches": counts, **st}
        check(status == "optimal", f"milp (cuts={cuts}): {status}")
        check(abs(obj - ref.fun) <= 1e-6 * max(1.0, abs(ref.fun)),
              f"milp (cuts={cuts}) objective {obj} vs HiGHS {ref.fun}")
    check(rec["milp_cuts"]["nodes"] <= 0.85 * rec["milp_no_cuts"]["nodes"],
          "cover cuts did not prune the search")
    mark("milp")
    _attribute(results, total, "lp_milp",
               ("schur_chol64/milp",
                "fused_cholesky_solve_batched/milp"))
    rec["nvidia_smi"] = nvidia_smi()
    emit(rec, log)


# ---- the sparse direct path ------------------------------------------------

class _CountingKKT:
    """A kktsolver wrapper that counts factor and solve calls and runs
    torch.profiler over the IPM iterations whose factors are calls
    `window` (start, stop) - the loop calls the factor once at the start
    and once per iteration."""

    def __init__(self, kkt, window=None):
        self.kkt, self.window = kkt, window
        self.factors = self.solves = 0
        self.prof = None
        self.window_wall = None

    def __call__(self, W):
        import torch
        self.factors += 1
        if self.window and self.factors in self.window:
            torch.cuda.synchronize()
            if self.factors == self.window[0]:
                from torch.profiler import ProfilerActivity, profile
                # device activity only: the window holds ~10^5 launches,
                # and the trace's analysis costs per event
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
                self._t0 = time.perf_counter()
            else:
                self.window_wall = time.perf_counter() - self._t0
                self.prof.stop()
        solve = self.kkt(W)

        def counted(bx, by, bz):
            self.solves += 1
            return solve(bx, by, bz)

        return counted


def _sparse_lp_window(c, G, h, maxiters, dev):
    """lp_sparse's path (the pattern-routed kktsolver and ELL operator
    in conelp), instrumented: factor and solve calls, host syncs (CUDA
    sync debug mode), and a torch.profiler window over IPM iterations 2
    and 3."""
    import warnings
    import torch
    from cvxopt_tpu_torch import solvers
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.ops import sparse_kkt as sk
    dims = ConeDims(l=G.shape[0])
    kkt = _CountingKKT(sk._pick_sparse_kkt(G, dims, None, None,
                                           torch.float64, device=dev),
                       window=(3, 5))
    Gop = sk._as_ops(G, torch.float64, dev)
    t = [torch.as_tensor(u, device=dev) for u in (c, h)]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sol = solvers.conelp(t[0], Gop, t[1], dims=dims, kktsolver=kkt,
                                 options={"maxiters": maxiters}, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    check(kkt.prof is not None and kkt.window_wall is not None,
          "the profiled window did not close")
    t0 = time.perf_counter()
    rows = device_rows(kkt.prof)
    analysis_s = time.perf_counter() - t0
    dev_ms = sum(r["device_ms"] for r in rows)
    check(dev_ms > 0, "the profiler saw no device kernels")
    launches = sum(r["count"] for r in rows)
    return sol, {"trace_analysis_s": analysis_s,
        "factor_calls": kkt.factors, "solve_calls": kkt.solves,
        "host_syncs": syncs, "window_iterations": 2,
        "window_wall_s": kkt.window_wall, "window_device_ms": dev_ms,
        "device_ms_per_iteration": dev_ms / 2,
        "launches_per_iteration": launches / 2,
        "idle_share_profiled_window": 1.0 - dev_ms / 1e3 / kkt.window_wall,
        "top": rows[:6]}


def _rel_res(A, x, b):
    import numpy as np
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


def _blas_lapack_fft_sweep(n, dev):
    """One call of each listed blas/lapack/fft function on `dev` tensors
    at n x n against numpy/scipy; returns {name: (relative error,
    seconds)}."""
    import numpy as np
    import scipy.fft as sfft
    import scipy.linalg as sla
    import torch
    from cvxopt_tpu_torch.ops import blas, lapack
    from cvxopt_tpu_torch.utils import fft
    rng = np.random.default_rng(12)
    F = rng.standard_normal((n, n))
    A = F @ F.T / n + np.eye(n)
    M = rng.standard_normal((n, n)) + n ** 0.5 * np.eye(n)
    b = rng.standard_normal(n)
    x = rng.standard_normal((n, 4))
    T = lambda a: torch.as_tensor(a, device=dev)          # noqa: E731
    H = lambda t: t.cpu().numpy()                          # noqa: E731

    def err(got, want):
        return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))

    checks = {
        "blas.gemm": lambda: err(H(blas.gemm(T(M), T(x))), M @ x),
        "blas.trsm": lambda: err(H(blas.trsm(T(np.tril(A)), T(x))),
                                 sla.solve_triangular(np.tril(A), x,
                                                      lower=True)),
        "lapack.potrf": lambda: err(H(lapack.potrf(T(A))),
                                    np.linalg.cholesky(A)),
        "lapack.gesv": lambda: err(H(lapack.gesv(T(M), T(b))[1]),
                                   np.linalg.solve(M, b)),
        "lapack.sytrf/sytrs": lambda: err(
            H(lapack.sytrs(lapack.sytrf(T(np.tril(A - 2 * np.eye(n)))),
                           T(b))), np.linalg.solve(A - 2 * np.eye(n), b)),
        "lapack.geqrf/orgqr": lambda: max(
            err(H(lapack.orgqr(lapack.geqrf(T(M))) @ lapack.geqrf(T(M))[1]),
                M),
            err(H(lapack.orgqr(lapack.geqrf(T(M))).T
                  @ lapack.orgqr(lapack.geqrf(T(M)))), np.eye(n))),
        "lapack.geqp3": lambda: _geqp3_err(lapack.geqp3(T(M)), M, err),
        "lapack.syev": lambda: err(H(lapack.syev(T(A), jobz="N")),
                                   np.linalg.eigvalsh(A)),
        "lapack.gesvd": lambda: err(H(lapack.gesvd(T(M))[1]),
                                    np.linalg.svd(M, compute_uv=False)),
        "lapack.gees": lambda: _gees_err(lapack.gees(T(M)), M, err),
    }
    for t in (1, 2, 3, 4):
        checks[f"fft.dct{t}"] = (lambda t=t: err(H(fft.dct(T(x), type=t)),
                                                 sfft.dct(x, type=t, axis=0)))
        checks[f"fft.dst{t}"] = (lambda t=t: err(H(fft.dst(T(x), type=t)),
                                                 sfft.dst(x, type=t, axis=0)))
    out = {}
    for name, fn in checks.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = fn()
        out[name] = {"rel_err": e, "seconds": time.perf_counter() - t0}
    return out


def _geqp3_err(res, M, err):
    import numpy as np
    Q, R, piv = (u.cpu().numpy() for u in res)
    d = np.abs(np.diag(R))
    order = float(np.maximum(d[1:] - d[:-1], 0).max() / d.max())
    return max(err(Q @ R, M[:, piv]), err(Q.T @ Q, np.eye(M.shape[0])),
               order)


def _gees_err(res, M, err):
    S, _, V = (u.cpu().numpy() for u in res)
    return err(V @ S @ V.T, M)


def phase_sparse(log, results, dev="cuda", n=100_000, n_cmp=20_000,
                 n_band=10_000, n_arrow=4096, n_lu=3000, n_dense=512):
    """The sparse direct path: bench.py's chain LP (n = 100,000, m =
    399,998) through ops.sparse_kkt.lp_sparse on the card against
    scipy's HiGHS; the same path instrumented (factor and solve calls,
    host syncs, a profiled window of two IPM iterations); the chain LP
    at n = 20,000 on the card against the port's CPU run; then one call
    each of cholmod (banded and blocksparse routes), umfpack, and a
    blas/lapack/fft sweep on the card."""
    import numpy as np
    import torch
    from scipy.optimize import linprog
    from cvxopt_tpu_torch import cholmod, native, umfpack
    from cvxopt_tpu_torch.ops import fused_chol as fc
    from cvxopt_tpu_torch.ops import sparse_kkt as sk
    rec = {"phase": "sparse", "elapsed_s": {}}
    t_phase = time.perf_counter()

    def mark(part):
        rec["elapsed_s"][part] = time.perf_counter() - t_phase

    fc.reset_launch_counts()
    # warm-up: library handles and first-use allocations on a small LP
    sk.lp_sparse(*chain_lp(500), options={"maxiters": 30}, device=dev)
    mark("warm_up")

    # 1. the 100k LP through the user's entry point
    c, G, h = chain_lp(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = sk.lp_sparse(c, G, h, options={"maxiters": 30}, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plan = sk.make_band_plan(G, device="cpu")
    lp = {"n": n, "m": G.shape[0], "nnz": int(G.nnz),
          "ell_width": int(np.diff(G.indptr).max()), "kd": plan.kd,
          "cb": max(128, -(-plan.kd // 8) * 8),
          "panels": -(-n // max(128, -(-plan.kd // 8) * 8)),
          "status": sol["status"], "iterations": sol["iterations"],
          "gap": sol["gap"], "relgap": sol["relative gap"],
          "primal_objective": sol["primal objective"], "wall_s": wall,
          "iterations_per_s": sol["iterations"] / wall}
    check(sol["status"] == "optimal", f"sparse LP: {sol['status']}")
    x = sol["x"].cpu().numpy()
    check(np.isfinite(x).all() and x.shape == (n,), "sparse LP: x")
    mark("lp_100k")
    t0 = time.perf_counter()
    ref = linprog(c, A_ub=G, b_ub=h, bounds=(None, None), method="highs")
    lp["highs_s"] = time.perf_counter() - t0
    check(ref.status == 0, f"HiGHS: {ref.message}")
    lp["highs_objective"] = ref.fun
    lp["objective_vs_highs_rel"] = abs(sol["primal objective"] - ref.fun) \
        / abs(ref.fun)
    lp["max_constraint_violation"] = float(max((G @ x - h).max(), 0.0))
    check(lp["objective_vs_highs_rel"] <= 1e-6,
          f"sparse LP objective vs HiGHS {lp['objective_vs_highs_rel']}")
    mark("highs")
    sol2, inst = _sparse_lp_window(c, G, h, 30, dev)
    check(sol2["status"] == "optimal" and
          sol2["iterations"] == sol["iterations"],
          "instrumented sparse LP differs from the plain run")
    inst["idle_share_vs_plain_wall"] = 1.0 - \
        inst["device_ms_per_iteration"] / 1e3 / (wall / sol["iterations"])
    lp["instrumented"] = inst
    rec["lp_100k"] = lp
    mark("lp_100k_instrumented")

    # 2. n = 20,000: the card against the port's CPU run, both with the
    # blocked factor ('auto' takes it on the card)
    c2, G2, h2 = chain_lp(n_cmp)
    gpu = sk.lp_sparse(c2, G2, h2, options={"maxiters": 30}, device=dev)
    t0 = time.perf_counter()
    cpu = sk.lp_sparse(c2, G2, h2, options={"maxiters": 30},
                       method="blocked", device="cpu")
    dx = float(np.abs(gpu["x"].cpu().numpy() - cpu["x"].numpy()).max())
    rec["lp_20k_vs_cpu"] = {
        "n": n_cmp, "status": [gpu["status"], cpu["status"]],
        "iterations": [gpu["iterations"], cpu["iterations"]],
        "x_max_abs_diff": dx, "cpu_method": "blocked",
        "cpu_s": time.perf_counter() - t0}
    check(gpu["status"] == cpu["status"] == "optimal",
          "20k LP: a run is not optimal")
    check(gpu["iterations"] == cpu["iterations"],
          "20k LP: iterations differ from the CPU run")
    check(dx <= 1e-6, f"20k LP: x differs from the CPU run by {dx}")
    mark("lp_20k_vs_cpu")

    # 3. the namespaces, one call each on the card
    ns = {}
    for name, A, want in (("cholmod_banded", banded_spd(n_band, 3, 0),
                           "banded"),
                          ("cholmod_blocksparse", arrow_spd(n_arrow, 8, 1),
                           "blocksparse")):
        b = np.random.default_rng(5).standard_normal(A.shape[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        symb = cholmod.symbolic(A)
        xs = cholmod.solve(cholmod.numeric(A, symb, device=dev), b)
        torch.cuda.synchronize()
        route = "banded" if symb.banded else (
            "blocksparse" if symb.bsp is not None else "dense")
        ns[name] = {"n": A.shape[0], "route": route, "kd": symb.kd,
                    "wall_s": time.perf_counter() - t0,
                    "rel_residual": _rel_res(A, xs.cpu().numpy(), b)}
        check(route == want, f"{name}: took the {route} route")
        check(ns[name]["rel_residual"] <= 1e-10, f"{name}: residual")
    A = unsym_arrow(n_lu, head=12)
    b = np.random.default_rng(6).standard_normal(n_lu)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    symb = umfpack.symbolic(A)
    F = umfpack.numeric(A, symb, device=dev)
    xn = umfpack.solve(F, b).cpu().numpy()
    xt = umfpack.solve(F, b, trans="T").cpu().numpy()
    torch.cuda.synchronize()
    ns["umfpack_blocksparse"] = {
        "n": n_lu, "route": "blocksparse" if symb.bsp is not None else
        ("banded" if symb.banded else "dense"),
        "wall_s": time.perf_counter() - t0,
        "rel_residual_N": _rel_res(A, xn, b),
        "rel_residual_T": _rel_res(A.T, xt, b)}
    check(ns["umfpack_blocksparse"]["route"] == "blocksparse",
          "umfpack: not the blocksparse route")
    check(max(ns["umfpack_blocksparse"]["rel_residual_N"],
              ns["umfpack_blocksparse"]["rel_residual_T"]) <= 1e-12,
          "umfpack: residual")
    sweep = _blas_lapack_fft_sweep(n_dense, dev)
    bad = {k: v["rel_err"] for k, v in sweep.items() if v["rel_err"] > 1e-10}
    check(not bad, f"blas/lapack/fft sweep: {bad}")
    ns["dense_sweep"] = {"n": n_dense, **sweep}
    ns["native"] = native.built()
    rec["namespaces"] = ns
    mark("namespaces")
    counts = fc.launch_counts()
    check(not any(counts.values()),
          f"the sparse phase launched fused-Cholesky kernels {counts}")
    rec["nvidia_smi"] = nvidia_smi()
    emit(rec, log)


# ---- the parallel layer (torch.distributed) ---------------------------------

# tests/test_block_kkt.py:90-130, the sharded path's n = 10,240 row, as
# the JAX test draws it: K = 8 scenarios of nk = 1248 coupled through
# n0 = 256 variables, local equalities (pk = 4); n = 10,240, m = 9984,
# p = 32.  Its P is indefinite (the generator scales the coupling blocks
# by 0.1 whatever nk is), so it is not a convex QP: the phase runs one
# KKT factor + solve of it, as the JAX test does, and no coneqp.
BLOCK_QP = dict(K=8, nk=1248, n0=256, l=1248, q=(), pk=4, seed=0)
BLOCK_QP_D = 1.1          # W = 1.1 I, the JAX test's timed scaling


def _on_device(dev, *ts):
    check(all(t.device == dev for t in ts),
          f"a result left the mesh's device {dev}")


def _xdiff(a, b):
    return float((a["x"] - b["x"]).abs().max())


def parallel_collectives(mesh, dev):
    """tests/test_collectives.py's reductions (and the plain collectives)
    on one shard of (l=4, q=(3, 3), s=(2,)) against the single-device
    cone functions on the same vectors; returns the largest differences
    (relative to the value)."""
    import numpy as np
    import torch
    from cvxopt_tpu_torch import cones
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.parallel import collectives as coll
    ld = ConeDims(l=4, q=(3, 3), s=(2,))
    rng = np.random.default_rng(0)
    e = cones.cone_identity(ld, device=dev)

    def interior():
        x = torch.as_tensor(rng.standard_normal(ld.cdim) * 0.1, device=dev)
        return cones.symmetrize(x + (cones.max_step(x, ld) + 1.0) * e, ld)

    x, y = interior(), interior()
    t = torch.clamp(torch.maximum(cones.max_step(-x, ld),
                                  cones.max_step(-y, ld)), min=0.0)
    step = torch.where(t == 0, torch.ones_like(t),
                       torch.clamp(0.99 / t, max=1.0))
    pairs = {
        "psdot": (coll.psdot(x, y, ld, mesh), cones.sdot(x, y, ld)),
        "psnrm2": (coll.psnrm2(x, ld, mesh), cones.snrm2(x, ld)),
        "pmax_step": (coll.pmax_step(-x, ld, mesh), cones.max_step(-x, ld)),
        "pstep_length": (coll.pstep_length(-x, -y, ld, mesh), step),
        "psum": (coll.psum(x, mesh), x), "pmax": (coll.pmax(x, mesh), x),
        "pmin": (coll.pmin(x, mesh), x),
        "pnorm2": (coll.pnorm2(x, mesh), torch.linalg.vector_norm(x)),
        "pdot": (coll.pdot(x, y, mesh), x @ y),
        "all_gather": (coll.all_gather(x, mesh), x[None]),
        "all_gather_tiled": (coll.all_gather(x, mesh, tiled=True), x),
        "ppermute_ring": (coll.ppermute_ring(x, mesh, 1), x)}
    _on_device(dev, *(a for a, _ in pairs.values()))
    errs = {k: float((a - b).abs().max() / b.abs().max().clamp(min=1.0))
            for k, (a, b) in pairs.items()}
    check(max(errs.values()) <= 1e-12, f"collectives: {errs}")
    return errs


def _kkt_pair(name, make, W, rhs, dev):
    """A kktsolver's (ux, uy, W uz) on the mesh against its mesh=None
    run at one scaling; returns the largest difference."""
    import torch
    u = make(True)(W)(*rhs)
    u1 = make(False)(W)(*rhs)
    _on_device(dev, *u)
    err = float(torch.cat([(a - b).reshape(-1) for a, b in zip(u, u1)])
                .abs().max())
    check(err <= 1e-12, f"dryrun {name} kktsolver differs from mesh=None "
          f"by {err}")
    return err


def parallel_dryrun(mesh, cmesh, dev):
    """__graft_entry__.py:55-251 (dryrun_multichip) at its sizes for the
    mesh's ranks: each sharded path against its mesh=None (unsharded)
    run on the same device, and the function's own asserts."""
    import numpy as np
    import torch
    from cvxopt_tpu_torch import cones, solvers
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.coneqp import make_coneqp, make_coneqp_cascade
    from cvxopt_tpu_torch.parallel import sharded_batch_solve
    from cvxopt_tpu_torch.parallel import collectives as coll
    from cvxopt_tpu_torch.parallel.schur import (
        random_arrow_qp, make_arrow_kktsolver, random_block_qp,
        make_block_kktsolver)
    from cvxopt_tpu_torch.parallel.conesolve import make_coneqp_sharded
    from cvxopt_tpu_torch.scaling import compute_scaling
    nd = mesh.size
    rec = {}
    loose = {"abstol": 1e-4, "reltol": 1e-4, "feastol": 1e-4,
             "maxiters": 30}
    T = lambda a: torch.as_tensor(a, device=dev)

    # batched QPs, the batch axis sharded (:84-110)
    core = make_coneqp(ConeDims(l=4), device=dev, **loose)
    data = tuple(T(u) for u in entry_qps(2 * nd, 4, np.float64))
    out = sharded_batch_solve(core, data, mesh=mesh)
    ref = core(*data)
    _on_device(dev, out["x"])
    rec["batch"] = {"status": out["status"].tolist(),
                    "iterations": out["iterations"].tolist(),
                    "x_vs_unsharded": _xdiff(out, ref)}
    check(bool((out["status"] == 0).all()), f"dryrun batch: {rec['batch']}")
    check(torch.equal(out["iterations"], ref["iterations"])
          and rec["batch"]["x_vs_unsharded"] <= 1e-12,
          f"dryrun batch differs from the unsharded solve: {rec['batch']}")

    # the arrow and block kktsolvers on the mesh (:112-147): at one
    # scaling, and through coneqp
    qp = random_arrow_qp(K=2 * nd, nk=4, n0=3, mk=4, seed=1, device=dev)
    bqp = random_block_qp(K=2 * nd, nk=6, n0=4, l=4, q=(3,), pk=2, seed=2,
                          device=dev)
    rng = np.random.default_rng(4)
    for name, q_, make, args, kw in (
            ("arrow", qp, lambda m: make_arrow_kktsolver(qp, mesh=m),
             (qp.flat_P(), qp.flat_q(), qp.flat_G(), qp.flat_h()), {}),
            ("block", bqp, lambda m: make_block_kktsolver(bqp, mesh=m),
             (bqp.flat_P(), bqp.flat_q(), bqp.flat_G(), bqp.flat_h()),
             dict(dims=bqp.dims, A=bqp.flat_A(), b=bqp.flat_b()))):
        dims = bqp.dims if name == "block" else ConeDims(l=q_.K * q_.mk)
        e = cones.cone_identity(dims, device=dev)
        s, z = (e + 0.1 * T(rng.uniform(0, 1, dims.cdim)) for _ in range(2))
        W, _ = compute_scaling(s, z, dims)
        n = args[0].shape[0]
        p = kw["A"].shape[0] if kw else 0
        rhs = (T(rng.standard_normal(n)), T(rng.standard_normal(p)),
               T(rng.standard_normal(dims.cdim)))
        kerr = _kkt_pair(name, lambda on: make(mesh if on else None), W,
                         rhs, dev)
        sol = solvers.coneqp(*args, kktsolver=make(mesh), options=loose,
                             device=dev, **kw)
        one = solvers.coneqp(*args, kktsolver=make(None), options=loose,
                             device=dev, **kw)
        _on_device(dev, sol["x"])
        rec[name] = {"status": sol["status"],
                     "iterations": sol["iterations"],
                     "kkt_vs_unsharded": kerr,
                     "x_vs_unsharded": _xdiff(sol, one)}
        check(sol["status"] == "optimal", f"dryrun {name}: {sol['status']}")
        check(sol["iterations"] == one["iterations"]
              and rec[name]["x_vs_unsharded"] <= 1e-12,
              f"dryrun {name} differs from mesh=None: {rec[name]}")

    # the cone reductions of a block-sharded vector (:149-185)
    ld = ConeDims(l=2, q=(3,))
    v = T(np.random.default_rng(3).standard_normal(ld.cdim) * 0.1)
    x = v + (cones.max_step(v, ld) + 1.0) * cones.cone_identity(ld,
                                                                 device=dev)
    gap = coll.psdot(x, x, ld, cmesh)
    ts_ = coll.pmax_step(-x, ld, cmesh)
    _on_device(dev, gap, ts_)
    rec["reductions"] = {
        "gap": float(gap), "max_step": float(ts_),
        "gap_err": abs(float(gap) - float(cones.sdot(x, x, ld))),
        "max_step_err": abs(float(ts_) - float(cones.max_step(-x, ld)))}
    check(rec["reductions"]["gap_err"] <= 1e-6 * max(1.0, float(gap))
          and rec["reductions"]["max_step_err"] <= 1e-6 * max(1.0,
                                                               abs(float(ts_))),
          f"dryrun reductions: {rec['reductions']}")

    # the cone-sharded coneqp with equalities, 1e-7 (:187-220), against
    # the single-device coneqp on the same problem in grouped row order
    sd = ConeDims(l=2, q=(3,))
    mk_, n_ = sd.cdim, 6
    m = nd * mk_
    rng2 = np.random.default_rng(5)
    F2 = rng2.standard_normal((n_, n_)) / np.sqrt(n_)
    P2 = F2 @ F2.T + np.eye(n_)
    q2 = 0.1 * rng2.standard_normal(n_)
    G2 = 0.3 * rng2.standard_normal((m, n_))
    h2 = 0.1 * rng2.standard_normal(m)
    for k in range(nd):
        h2[k * mk_:k * mk_ + 3] = 1.0
    A2 = rng2.standard_normal((1, n_))
    b2 = A2 @ (0.01 * rng2.standard_normal(n_))
    sout = make_coneqp_sharded(sd, cmesh, axis="cone", abstol=1e-7,
                               reltol=1e-6, feastol=1e-7)(
        T(P2), T(q2), T(G2), T(h2), T(A2), T(b2))
    _on_device(dev, sout["x"], sout["s"])
    perm = np.concatenate([np.arange(k * mk_, k * mk_ + 2) for k in range(nd)]
                          + [np.arange(k * mk_ + 2, (k + 1) * mk_)
                             for k in range(nd)])
    single = make_coneqp(ConeDims(l=2 * nd, q=(3,) * nd), device=dev,
                         abstol=1e-7, reltol=1e-6, feastol=1e-7)(
        T(P2)[None], T(q2)[None], T(G2[perm]), T(h2[perm]), T(A2), T(b2))
    rec["conesolve"] = {
        "status": int(sout["status"]), "iterations": int(sout["iterations"]),
        "single_device_iterations": int(single["iterations"][0]),
        "pres": float(sout["pres"]), "dres": float(sout["dres"]),
        "Ax_minus_b": float((T(A2) @ sout["x"] - T(b2)).abs().max()),
        "x_vs_single_device": float((sout["x"] - single["x"][0])
                                    .abs().max())}
    c = rec["conesolve"]
    check(c["status"] == 0 and max(c["pres"], c["dres"]) <= 1e-7
          and c["Ax_minus_b"] <= 1e-7, f"dryrun conesolve: {c}")
    check(int(single["status"][0]) == 0 and c["x_vs_single_device"] <= 5e-6,
          f"dryrun conesolve differs from the single-device coneqp: {c}")

    # the chol2_inv cascade, its batch axis on the mesh (:222-251)
    nb2, n2 = 2 * nd, 16
    csolve = make_coneqp_cascade(ConeDims(l=2 * n2), kktsolver="chol2_inv",
                                 maxiters=40, abstol=1e-7, reltol=1e-7,
                                 feastol=1e-7, device=dev)
    rng3 = np.random.default_rng(7)
    Fc = rng3.standard_normal((nb2, n2, n2 // 4)) / np.sqrt(n2)
    Pc = T(Fc @ Fc.transpose(0, 2, 1) + 0.1 * np.eye(n2))
    qc = T(-rng3.uniform(0.0, 0.1, (nb2, n2)))
    Gc = T(np.concatenate([-np.eye(n2), np.eye(n2)]))
    hc = T(np.concatenate([np.zeros(n2), np.ones(n2)]))
    Ac, bc = T(np.ones((1, n2))), T(np.ones(1))
    cout = sharded_batch_solve(lambda P, q: csolve(P, q, Gc, hc, Ac, bc),
                               (Pc, qc), mesh=mesh)
    cref = csolve(Pc, qc, Gc, hc, Ac, bc)
    rec["cascade"] = {"status": cout["status"].tolist(),
                      "max_gap": float(cout["gap"].max()),
                      "x_vs_unsharded": _xdiff(cout, cref)}
    check(bool((cout["status"] == 0).all())
          and rec["cascade"]["max_gap"] <= 1e-6, f"dryrun cascade: "
          f"{rec['cascade']}")
    check(rec["cascade"]["x_vs_unsharded"] <= 1e-12,
          f"dryrun cascade differs from the unsharded solve: "
          f"{rec['cascade']}")
    return rec


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parallel_cascade(mesh, dev, results, x_unsharded, nb=1024, n=256):
    """The main path's headline batch through the mesh: scenario_qps(1024,
    256, seed=0) through make_coneqp_cascade('chol2_inv', 1e-7) under
    sharded_batch_solve, bracketed by the kernels' launch counts; every
    status 0, x within 1e-12 of the unsharded run (the cascade phase's
    when it ran, else one made here)."""
    import torch
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.coneqp import make_coneqp_cascade
    from cvxopt_tpu_torch.ops import fused_chol as fc
    from cvxopt_tpu_torch.parallel import sharded_batch_solve
    solve = make_coneqp_cascade(ConeDims(l=2 * n), kktsolver="chol2_inv",
                                maxiters=50, abstol=1e-7, reltol=1e-7,
                                feastol=1e-7, instrument=True, device=dev)
    P, q, G, h, A, b = scenario_qps(nb, n, seed=0, dev=dev)
    run = lambda P, q: solve(P, q, G, h, A, b)
    rec = {"instances": nb, "n": n, "world_size": mesh.size,
           "x_reference": "cascade phase" if x_unsharded is not None
           else "unsharded run in this phase"}
    warm = scenario_qps(64, n, seed=1, dev=dev)[:2]
    if x_unsharded is None:
        run(*warm)                                # warm-up (handles)
        x_unsharded = run(P, q)["x"]
    sharded_batch_solve(run, warm, mesh=mesh)
    _sync(dev)
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    out = sharded_batch_solve(run, (P, q), mesh=mesh)
    _sync(dev)
    rec["wall_s"] = time.perf_counter() - t0
    counts = fc.launch_counts()
    _on_device(dev, out["x"])
    iters = int(out["iterations"].sum())
    rec.update(solved=int((out["status"] == 0).sum()),
               max_gap=float(out["gap"].max()),
               max_pres=float(out["pres"].max()),
               max_dres=float(out["dres"].max()), iterations=iters,
               ipm_iters_per_s=iters / rec["wall_s"],
               profile=out["profile"], launches=counts,
               x_vs_unsharded_max_abs=float((out["x"] - x_unsharded)
                                            .abs().max()))
    check(rec["solved"] == nb, f"parallel cascade: {nb - rec['solved']} "
          f"unsolved")
    check(max(rec["max_gap"], rec["max_pres"], rec["max_dres"]) <= 1e-7,
          f"parallel cascade outside the 1e-7 contract: {rec}")
    check(tuple(out["x"].shape) == (nb, n)
          and bool(torch.isfinite(out["x"]).all()), "parallel cascade: x")
    check(rec["x_vs_unsharded_max_abs"] <= 1e-12,
          f"parallel cascade differs from the unsharded run: "
          f"{rec['x_vs_unsharded_max_abs']}")
    for k in ("fused_schur_cholesky_batched", "fused_cholesky_solve_batched"):
        check(counts[k] > 0, f"the sharded cascade did not launch {k}")
        if k in results:
            results[k].setdefault("launches", counts[k])
            results[k].setdefault("paths", []).append("parallel")
    return rec


def _reduced_matrix(qp, d):
    """The reduced (n0, n0) matrix of the block kktsolver at W = d I,
    formed apart from the kktsolver with the library's Cholesky: S0 =
    P0 + sum_k Es_k'Es_k - V_k' H_k^-1 V_k, H_k = [[D_k, A_k'], [A_k, 0]]
    and V_k = [U_k; C_k], where V' H^-1 V = U'D^-1 U - R' M^-1 R with
    M = A D^-1 A' and R = A D^-1 U - C."""
    import torch
    T = lambda M: M.transpose(-1, -2)
    Gs, Es = qp.Gk / d, qp.Ek / d
    L = torch.linalg.cholesky(qp.Pk + T(Gs) @ Gs)
    U = qp.Pc + T(Gs) @ Es
    DiU = torch.cholesky_solve(U, L)
    DiAt = torch.cholesky_solve(T(qp.Ak), L)
    R = qp.Ak @ DiU - qp.Ck
    MiR = torch.cholesky_solve(R, torch.linalg.cholesky(qp.Ak @ DiAt))
    return qp.P0 + (T(Es) @ Es).sum(0) - (T(U) @ DiU - T(R) @ MiR).sum(0)


def parallel_block_qp(mesh, dev, spec=BLOCK_QP):
    """tests/test_block_kkt.py:90-130 on the card, as the JAX test runs
    it: the n = 10,240 block QP (BLOCK_QP, the generator's data
    unchanged), one factor + solve of the mesh kktsolver at W = 1.1 I
    timed after a warm-up at W = I, bracketed by the kernels' launch
    counts.  The QP is not convex, so the outputs must be non-finite, as
    JAX's are; the local factors D_k are positive definite, and the
    kernel rows at this shape are checked and timed."""
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    from cvxopt_tpu_torch.parallel.schur import (
        random_block_qp, make_block_kktsolver)
    from cvxopt_tpu_torch.scaling import identity_scaling
    rec = {"spec": dict(spec), "world_size": mesh.size,
           "W": f"{BLOCK_QP_D} I"}
    t0 = time.perf_counter()
    qp = random_block_qp(**spec, device=dev)
    n, p, m = qp.K * qp.nk + qp.n0, qp.K * qp.pk + qp.p0, qp.dims.cdim
    rec.update(n=n, m=m, p=p, data_s=time.perf_counter() - t0)
    # P is positive definite iff its Schur complement on x0 is (the P_k
    # are); the reduced factor of the kktsolver fails where its matrix
    # is not
    X = torch.cholesky_solve(qp.Pc, torch.linalg.cholesky(qp.Pk))
    S = qp.P0 - torch.einsum("kia,kib->ab", qp.Pc, X)
    rec["P_schur_min_eig"] = float(torch.linalg.eigvalsh(S)[0])
    S0 = _reduced_matrix(qp, BLOCK_QP_D)
    rec["reduced_min_eig"] = float(torch.linalg.eigvalsh(S0)[0])
    rec["reduced_cholesky_info"] = int(torch.linalg.cholesky_ex(S0).info)
    kkt = make_block_kktsolver(qp, mesh=mesh)
    W = identity_scaling(qp.dims, device=dev)
    ones = lambda k: torch.ones(k, dtype=torch.float64, device=dev)

    def factor_solve(d):
        return kkt(dict(W, d=W["d"] * d, di=W["di"] / d))(
            ones(n), 0.0 * ones(p), ones(m))

    factor_solve(1.0)                                 # warm-up
    _sync(dev)
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    u = factor_solve(BLOCK_QP_D)
    _sync(dev)
    rec["factor_solve_ms"] = (time.perf_counter() - t0) * 1e3
    rec["launches"] = fc.launch_counts()
    rec["solve_kernels"] = fc.solve_kernel_counts()
    _on_device(dev, *u)
    check(tuple(v.shape[0] for v in u) == (n, p, m), "block QP: shapes")
    rec["finite"] = {k: int(torch.isfinite(v).sum())
                     for k, v in zip(("ux", "uy", "Wuz"), u)}
    check(rec["P_schur_min_eig"] < 0 and rec["reduced_cholesky_info"] > 0,
          f"block QP: the data is no longer the JAX test's: {rec}")
    check(not any(rec["finite"].values()),
          f"block QP: finite outputs where JAX's are not: {rec['finite']}")
    return rec, qp


def block_factor_inputs(qp, d):
    """The block kktsolver's local factor as it hands it to the kernels
    at W = d I on an orthant: P_k padded with an identity to a multiple
    of 64, Gt = Gs_k' = G_k' / d with zero pad rows, dinv2 = 1."""
    import torch
    from cvxopt_tpu_torch.kkt import _pad_to
    K, nk, mk = qp.K, qp.nk, qp.mk
    n = _pad_to(nk)
    kw = dict(dtype=qp.Pk.dtype, device=qp.Pk.device)
    P = torch.zeros((K, n, n), **kw)
    P[:, :nk, :nk] = qp.Pk
    idx = torch.arange(nk, n, device=qp.Pk.device)
    P[:, idx, idx] = 1.0
    Gt = torch.zeros((K, n, mk), **kw)
    Gt[:, :nk] = qp.Gk.transpose(1, 2) / d
    return P, Gt, torch.ones((K, mk), **kw)


def _block_qp_kernel_rows(qp, results, launches, kcounts):
    """The block QP's local factor and its solves at the full shape, as
    the mesh kktsolver hands them to the kernels at W = 1.1 I (P_k padded
    with an identity to n = 1280, Gt = Gs_k' with zero pad rows, dinv2 =
    1): each against its plain version (1e-12), with kernel, plain and
    library times; the bound counts the nk = 1248 the data needs."""
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    f64 = torch.float64
    K, nk, mk = qp.K, qp.nk, qp.mk
    P, Gt, d2 = block_factor_inputs(qp, BLOCK_QP_D)
    n = P.shape[-1]
    rep = "cvxopt_tpu/ops/pallas_chol.py:"
    (L, D), ref, err = _check_factor(fc.fused_schur_cholesky, P, Gt, d2,
                                     "float64", "fused_schur_cholesky "
                                     "(block_qp)", False)
    bound, by = _factor_bound(K, nk, mk, False, 8)
    row = results["fused_schur_cholesky/block_qp"] = dict(
        name="fused_schur_cholesky", replaces=rep + "129",
        shape=[K, n, mk], dtype="float64", rel_fro_err=err,
        max_abs_err=max_abs(L, ref[0]),
        ms=time_ms(lambda: fc.fused_schur_cholesky(P, Gt, d2), reps=5),
        plain_ms=time_ms(lambda: fc.fused_schur_cholesky_ref(P, Gt, d2),
                         reps=5),
        library_ms=time_ms(lambda: _lib_factor(P, Gt, d2), reps=5),
        one_block_ms=one_block_ms(
            lambda: fc.fused_schur_cholesky(P, Gt, d2), reps=5),
        bound_ms=bound, bound_by=by, flop_rate=FLOP_RATE[8],
        launches=launches["fused_schur_cholesky"], paths=["parallel"])
    row["assemble_ms"], row["factor_ms"] = schur_split_ms(P, Gt, d2, reps=5)
    g = torch.Generator(device="cuda").manual_seed(9)
    few = kcounts["fused_cholesky_solve"]
    # D^-1 U (nrhs = n0, solve_many) and D^-1 r (nrhs = 1, panel_solve
    # on an H100; its count also holds the nrhs = pk = 4 launch for
    # D^-1 A', the same kernel there)
    for key, nrhs, cnt in (("block_qp_nrhs256", qp.n0, few["solve_many"]),
                           ("block_qp_nrhs1", 1,
                            few[solve_kernel(K, n, 1, 8)])):
        rhs = torch.randn((K, nrhs, n), dtype=f64, device="cuda",
                          generator=g)
        x = fc.fused_cholesky_solve(L, D, rhs)
        xr = fc.fused_cholesky_solve_ref(L, D, rhs)
        e = rel_fro(x, xr)
        check(e <= TOL["float64"], f"fused_cholesky_solve ({key}): {e}")
        check(cnt > 0, f"the block QP's solve did not launch {key}")
        bound, by = _solve_bound(K, nk, nrhs, False, 8)
        results["fused_cholesky_solve/" + key] = dict(
            name="fused_cholesky_solve", replaces=rep + "194",
            shape=[K, n, nrhs], dtype="float64", rel_fro_err=e,
            max_abs_err=max_abs(x, xr),
            ms=time_ms(lambda: fc.fused_cholesky_solve(L, D, rhs)),
            plain_ms=time_ms(lambda: fc.fused_cholesky_solve_ref(L, D, rhs)),
            library_ms=time_ms(lambda: torch.cholesky_solve(
                rhs.transpose(1, 2), L)),
            one_block_ms=one_block_ms(
                lambda: fc.fused_cholesky_solve(L, D, rhs)),
            kernel=solve_kernel(K, n, nrhs, 8),
            bound_ms=bound, bound_by=by, flop_rate=FLOP_RATE[8],
            launches=cnt, paths=["parallel"])
    for key in ("fused_schur_cholesky/block_qp",
                "fused_cholesky_solve/block_qp_nrhs256",
                "fused_cholesky_solve/block_qp_nrhs1"):
        results[key]["bound_share"] = results[key]["bound_ms"] / \
            results[key]["ms"]


def phase_parallel(log, results, carry):
    """The parallel layer on the card in an NCCL process group of world
    size 1 (a file rendezvous in a temporary directory): the collectives
    against the single-device cone functions; dryrun_multichip's sharded
    paths against their mesh=None runs; the headline cascade batch
    through sharded_batch_solve; the n = 10,240 block QP's factor + solve
    through the mesh kktsolver, with its kernel rows."""
    import datetime
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from cvxopt_tpu_torch.parallel import make_mesh
    rec = {"phase": "parallel", "elapsed_s": {}}
    t_phase = time.perf_counter()

    def mark(part):
        rec["elapsed_s"][part] = time.perf_counter() - t_phase

    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(tmpdir, "rdv"),
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        rec.update(backend=str(dist.get_backend()),
                   world_size=dist.get_world_size())
        check(rec["backend"] == "nccl", f"backend {rec['backend']}")
        dev = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(1)
        check(mesh.device == dev, "the mesh is not on the card")
        mark("init")
        rec["collectives_max_err"] = parallel_collectives(
            make_mesh(1, axis="shards"), dev)
        mark("collectives")
        rec["dryrun"] = parallel_dryrun(mesh, make_mesh(1, axis="cone"),
                                        dev)
        mark("dryrun")
        rec["cascade"] = parallel_cascade(mesh, dev, results,
                                          carry.get("cascade_x"))
        mark("cascade")
        rec["block_qp"], qp = parallel_block_qp(mesh, dev)
        mark("block_qp")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmpdir, ignore_errors=True)
    b = rec["block_qp"]
    _block_qp_kernel_rows(qp, results, b["launches"], b["solve_kernels"])
    rec["kernel_rows"] = {k: v for k, v in results.items()
                          if k.endswith(("/block_qp", "/block_qp_nrhs256",
                                         "/block_qp_nrhs1"))}
    mark("kernel_rows")
    rec["nvidia_smi"] = nvidia_smi()
    emit(rec, log)


# ---- large_kkt: one n = 10,240 KKT system at B = 1 -------------------------

LARGE_KKT_N = 10240
LARGE_KKT_K = 256         # columns of F: P = F F' + I (bench.py:770)
# the QP's stopping rule: gap <= abstol (reltol 0), so that gap, pres and
# dres all end at or below 1e-7
LARGE_KKT_OPTS = {"abstol": 1e-7, "reltol": 0.0, "feastol": 1e-7}


def large_kkt_data(n=LARGE_KKT_N, k=LARGE_KKT_K, seed=0):
    """bench.py:746-800 (bench_large_kkt) in seeded numpy: F (n, k) ~
    N(0, 1), Gt (n, n) ~ N(0, 1) / sqrt(n), d ~ U(0.5, 2), so that
    S = F F' + I + Gt diag(d) Gt' is positive definite by construction;
    and the QP's q ~ N(0, 1), x0 ~ N(0, 1), s0 ~ U(0.5, 2).  bench.py
    draws from jax.random: the values differ from its."""
    import numpy as np
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, k))
    Gt = rng.standard_normal((n, n)) / np.sqrt(n)
    d = rng.uniform(0.5, 2.0, n)
    q = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    s0 = rng.uniform(0.5, 2.0, n)
    return F, Gt, d, q, x0, s0


def _panel_min_n(factor_n, solve_n, fn):
    """fn() with fused_chol's small-batch n thresholds set as given."""
    from cvxopt_tpu_torch.ops import fused_chol as fc
    keep = fc.PANEL_FACTOR_MIN_N, fc.PANEL_SOLVE_MIN_N
    fc.PANEL_FACTOR_MIN_N, fc.PANEL_SOLVE_MIN_N = factor_n, solve_n
    try:
        return fn()
    finally:
        fc.PANEL_FACTOR_MIN_N, fc.PANEL_SOLVE_MIN_N = keep


def one_block(fn):
    """fn() with the small-batch kernels off: one block per instance (per
    right-hand side), the layout every batch took before them."""
    never = 1 << 62
    return _panel_min_n(never, never, fn)


def one_block_ms(fn, **kw):
    """fn's device ms on one block per instance (`one_block`)."""
    return one_block(lambda: time_ms(fn, **kw))


def solve_kernel(B, n, nrhs, esize):
    """The solve kernel launch_config picks on this card."""
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    dev = torch.device("cuda")
    return fc.launch_config("solve", B, n, nrhs, esize, fc._smem_optin(dev),
                            fc._sms(dev))[0]["kernel"]


def in_turns(fns, rounds=2, **kw):
    """Device ms of each of `fns` (a dict), timed in turns: every round
    times each once, in order; returns {name: [ms per round]}."""
    out = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            out[k].append(time_ms(fn, **kw))
    return out


def unit_lower(n, g, kw):
    """A well-conditioned unit lower-triangular L (I plus N(0, 1) / n
    below the diagonal) and its Dinv blocks (tests/test_torch_gpu.py's
    n = 25,600 solve test uses them too)."""
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    L = torch.randn((n, n), generator=g, **kw).tril_(-1).div_(n)
    L.diagonal().add_(1.0)
    eye = torch.eye(fc.BP, **kw)
    D = torch.linalg.solve_triangular(fc._diag_blocks(L), eye,
                                      upper=False).contiguous()
    return L, D


def _large_kkt_rows(F, Gt_np, d_np, dtype, g, fails):
    """The kernel pair at B = 1, n = 10,240 in one dtype, checked, with
    kernel, plain and library times in turns, the factor's two launches
    apart and one timed run of the one-block layout.  Checks (a failed
    one is appended to `fails`):
      factor, f64: L and Dinv within 1e-12 relative Frobenius of the
        plain version's; f32: S's condition number is about 1.4e4, so
        two f32 factors differ by more than 1e-5 however each sums, and
        the f32 factor is held to the f64 one as closely as the plain
        version is, within twice its distance;
      solve: on a well-conditioned unit lower-triangular L of this shape,
        within 1e-5 / 1e-12 of the plain version on the same inputs; on
        the factor of S, a residual |S x - b| / |b| within 10 times the
        library's (torch.cholesky_solve on torch.linalg.cholesky)."""
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    name = str(dtype).split(".")[-1]
    kw = dict(dtype=dtype, device="cuda")
    Fd = torch.as_tensor(F, **kw)
    P = Fd @ Fd.T
    P.diagonal().add_(1.0)
    del Fd
    Gt = torch.as_tensor(Gt_np, **kw)
    d = torch.as_tensor(d_np, **kw)
    n, m = Gt.shape
    fac = lambda: fc.fused_schur_cholesky(P, Gt, d)
    L, D = fac()
    Lr, Dr = fc.fused_schur_cholesky_ref(P, Gt, d)
    err = {"L": rel_fro(L, Lr), "Dinv": rel_fro(D, Dr)}
    fac_err = max_abs(L, Lr)
    rec = dict(factor_rel_fro_err=err)
    if dtype == torch.float32:
        L64, D64 = fc.fused_schur_cholesky_ref(P.double(), Gt.double(),
                                               d.double())
        dist = {"L": (rel_fro(L, L64), rel_fro(Lr, L64)),
                "Dinv": (rel_fro(D, D64), rel_fro(Dr, D64))}
        rec["vs_float64"] = {k: {"kernel": a, "plain": p}
                             for k, (a, p) in dist.items()}
        del L64, D64
        if not all(a <= 2 * p for a, p in dist.values()):
            fails.append(f"panel_factor (large_kkt, float32) farther from "
                         f"the float64 factor than twice the plain "
                         f"version: {rec['vs_float64']}")
    elif not all(e <= TOL[name] for e in err.values()):
        fails.append(f"panel_factor (large_kkt, {name}) disagrees with "
                     f"its plain version: {err}")
    del Lr, Dr
    # the solve on a well-conditioned factor of this shape
    Lu, Du = unit_lower(n, g, kw)
    bu = torch.randn((1, n), generator=g, **kw)
    xu = fc.fused_cholesky_solve(Lu, Du, bu)
    xur = fc.fused_cholesky_solve_ref(Lu, Du, bu)
    rec["solve_rel_fro_err"] = rel_fro(xu, xur)
    if rec["solve_rel_fro_err"] > TOL[name]:
        fails.append(f"panel_solve (large_kkt, {name}) disagrees with its "
                     f"plain version: {rec['solve_rel_fro_err']}")
    solve_err = max_abs(xu, xur)
    del Lu, Du
    # and on the factor of S
    b = torch.randn((1, n), generator=g, **kw)
    x = fc.fused_cholesky_solve(L, D, b)
    xr = fc.fused_cholesky_solve_ref(L, D, b)
    rec["solve_on_S_rel_fro_err"] = rel_fro(x, xr)
    S = P + (Gt * d) @ Gt.T
    Llib = torch.linalg.cholesky(S)
    xl = torch.cholesky_solve(b.T, Llib).T
    res = lambda v: float(torch.linalg.vector_norm((S @ v.T).T - b)
                          / torch.linalg.vector_norm(b))
    rec.update(residual=res(x), library_residual=res(xl),
               plain_residual=res(xr))
    if rec["residual"] > 10 * rec["library_residual"]:
        fails.append(f"panel_solve (large_kkt, {name}): residual "
                     f"{rec['residual']} against the library's "
                     f"{rec['library_residual']}")
    t = in_turns({
        "ms": fac,
        "library_ms": lambda: torch.linalg.cholesky(
            P + (Gt * d) @ Gt.T),
        "library_factor_ms": lambda: torch.linalg.cholesky(S)},
        reps=3, warmup=1)
    rec.update(t)
    # the solve in turns with its plain version and the library's
    rec.update(in_turns({
        "solve_ms": lambda: fc.fused_cholesky_solve(L, D, b),
        "solve_plain_ms": lambda: fc.fused_cholesky_solve_ref(L, D, b),
        "solve_library_ms": lambda: torch.cholesky_solve(b.T, Llib)},
        rounds=3, reps=10, warmup=2))
    rec["plain_ms"] = time_ms(lambda: fc.fused_schur_cholesky_ref(P, Gt, d),
                              reps=2, warmup=1)
    rec["assemble_ms"], rec["factor_ms"] = schur_split_ms(
        P[None], Gt, d[None], reps=3, warmup=1)
    rec["one_block_ms"] = one_block_ms(fac, reps=1, warmup=0)
    rec["solve_one_block_ms"] = one_block_ms(
        lambda: fc.fused_cholesky_solve(L, D, b), reps=2, warmup=1)
    esize = P.element_size()
    rec["bound_ms"], rec["bound_by"] = _factor_bound(1, n, m, False, esize)
    rec["factor_only_bound_ms"] = max(
        n ** 3 / 3.0 / PEAK_F32_FLOPS * 1e3,
        (n * (n + 1) / 2 + n * n + n * 64) * esize / PEAK_BYTES * 1e3)
    rec["solve_bound_ms"], rec["solve_bound_by"] = _solve_bound(
        1, n, 1, False, esize)
    rec["factor_max_abs_err"] = fac_err
    rec["solve_max_abs_err"] = solve_err
    return rec


def small_batch_sweep(ns=(128, 192, 256, 384, 512, 1024), dtype=None):
    """B = 1, f64: the factor and a one-right-hand-side solve at each n
    on the small-batch kernels (their n thresholds set to one panel for
    the sweep) and on one block, device ms of each: the data that sets
    fused_chol.PANEL_FACTOR_MIN_N and PANEL_SOLVE_MIN_N."""
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    return _panel_min_n(fc.BP, fc.BP, lambda: {
        n: _sweep_point(n, dtype or torch.float64) for n in ns})


def _sweep_point(n, dtype):
    """One n of `small_batch_sweep`."""
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    P, Gt, d2 = kernel_data(1, n, n, dtype, False, seed=n)
    L, D = fc.fused_schur_cholesky_batched(P, Gt, d2, tb=1)
    b = torch.ones((1, 1, n), dtype=P.dtype, device="cuda")
    sol = lambda: fc.fused_cholesky_solve_batched(L, D, b, tb=1)
    return {"factor_ms": schur_split_ms(P, Gt, d2)[1],
            "factor_one_block_ms": one_block(
                lambda: schur_split_ms(P, Gt, d2))[1],
            "solve_ms": time_ms(sol),
            "solve_one_block_ms": one_block_ms(sol)}


def trail_flops(plan, n):
    """FLOPs the trailing updates of a panel_factor plan need: 2 x rank
    per element of L's lower triangle that each updates."""
    total = 0.0
    for c in plan:
        if c["kernel"] != "trail_update":
            continue
        c0, c1 = c.get("col0", c["t0"]), c.get("col1", n)
        total += 2.0 * c["rank"] * sum(n - j for j in range(c0, c1))
    return total


def large_kkt_profile(F, Gt_np, d_np):
    """torch.profiler over one f64 factor call at n = 10,240: device ms and
    launches of each kernel (the assembly, panel_factor's six); the DMMA
    kernels' (schur_assemble, trail_update) achieved TFLOP/s and share of
    the 67 TFLOP/s DMMA peak, for the FLOPs the call needs; and the device
    time the lookahead overlaps: the sum of panel_factor's kernel times
    minus its elapsed time (CUDA events around it, outside the
    profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cvxopt_tpu_torch.ops import fused_chol as fc
    kw = dict(dtype=torch.float64, device="cuda")
    Fd = torch.as_tensor(F, **kw)
    P = Fd @ Fd.T
    P.diagonal().add_(1.0)
    del Fd
    Gt = torch.as_tensor(Gt_np, **kw)
    d = torch.as_tensor(d_np, **kw)
    n, m = Gt.shape
    fc.fused_schur_cholesky(P, Gt, d)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fc.fused_schur_cholesky(P, Gt, d)
        torch.cuda.synchronize()
    out = {}
    for r in device_rows(prof):
        mm = re.search(r"(\w+_kernel)", r["name"])
        k = out.setdefault(mm.group(1) if mm else r["name"][:40],
                           {"launches": 0, "device_ms": 0.0})
        k["launches"] += r["count"]
        k["device_ms"] += r["device_ms"]
    plan = fc.launch_config("factor", 1, n, m, 8,
                            fc._smem_optin(P.device), fc._sms(P.device))
    flops = {"schur_assemble": n * (n + 1.0) * m,
             "trail_update": trail_flops(plan, n)}
    for name, k in out.items():
        base = next((f for f in flops if name.startswith(f)), None)
        if base and k["device_ms"] > 0:
            k["flops"] = flops[base]
            k["tflops"] = flops[base] / k["device_ms"] / 1e9
            k["share_of_dmma_peak"] = k["tflops"] * 1e12 / PEAK_DMMA_FLOPS
    asm_ms, fac_ms = schur_split_ms(P[None], Gt, d[None], reps=3, warmup=1)
    kernels_ms = sum(k["device_ms"] for name, k in out.items()
                     if name.startswith(("panel_", "trail_update")))
    return {"kernels": out, "assemble_elapsed_ms": asm_ms,
            "panel_factor_elapsed_ms": fac_ms,
            "panel_factor_kernels_ms": kernels_ms,
            "lookahead_overlap_ms": kernels_ms - fac_ms}


class factor_call_events:
    """Within the block, each factor call's launches (schur_assemble and
    the factor) between two CUDA events: a list of (start, end) events,
    read after a synchronize.  Records on the stream only; adds no host
    synchronization."""

    def __enter__(self):
        import torch
        from cvxopt_tpu_torch.ops import fused_chol as fc
        self.fc, self.calls = fc, []
        self.orig = orig = fc._launch_schur

        def timed(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = orig(*a, **k)
            ev[1].record()
            self.calls.append(ev)
            return out

        fc._launch_schur = timed
        return self.calls

    def __exit__(self, *exc):
        self.fc._launch_schur = self.orig
        return False


def phase_large_kkt(log, results):
    """bench.py's large_kkt stage (:746) on the card at n = 10,240, B = 1:
    the small-batch kernel pair in f32 and f64 against the plain versions
    and the library; then one QP (P = F F' + I, G = Gt', h = G x0 + s0,
    m = 10,240) through solvers.qp, which resolves to chol2 and so to the
    kernels at B = 1, held to gap, pres, dres <= 1e-7 and to x of the same
    QP through kktsolver='chol' (no hand-written kernel) within 1e-6."""
    import torch
    from cvxopt_tpu_torch import solvers
    from cvxopt_tpu_torch.coneqp import coneqp
    from cvxopt_tpu_torch.ops import fused_chol as fc
    rec = {"phase": "large_kkt", "n": LARGE_KKT_N, "m": LARGE_KKT_N,
           "data": "seeded numpy; bench.py draws from jax.random, so the "
                   "values differ from its"}
    t0 = time.perf_counter()
    F, Gt, d, q, x0, s0 = large_kkt_data()
    rec["data_s"] = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(12)
    rows, fails = {}, []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        rows[name] = _large_kkt_rows(F, Gt, d, dtype, g, fails)
        torch.cuda.empty_cache()
    rec["kernel_rows"] = rows
    rec["small_batch_sweep"] = small_batch_sweep()
    rec["factor_profile"] = large_kkt_profile(F, Gt, d)

    # one QP end to end, f64, through the front door
    kw = dict(dtype=torch.float64, device="cuda")
    Fd = torch.as_tensor(F, **kw)
    P = Fd @ Fd.T
    P.diagonal().add_(1.0)
    del Fd
    G = torch.as_tensor(Gt, **kw).T.contiguous()
    qd = torch.as_tensor(q, **kw)
    h = G @ torch.as_tensor(x0, **kw) + torch.as_tensor(s0, **kw)
    torch.cuda.synchronize()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    with factor_call_events() as calls:
        sol = solvers.qp(P, qd, G, h, options=LARGE_KKT_OPTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fc.launch_counts()
    qp = {"status": sol["status"], "iterations": sol["iterations"],
          "wall_s": wall, "gap": sol["gap"],
          "relative_gap": sol["relative gap"],
          "pres": sol["primal infeasibility"],
          "dres": sol["dual infeasibility"],
          "primal_objective": sol["primal objective"],
          "launches": counts, "factor_kernels": fc.factor_kernel_counts(),
          "solve_kernels": fc.solve_kernel_counts(),
          "factor_call_device_ms": [a.elapsed_time(b) for a, b in calls],
          "options": LARGE_KKT_OPTS}
    if sol["status"] != "optimal" or any(
            v is None or v > 1e-7 for v in (qp["gap"], qp["pres"],
                                            qp["dres"])):
        fails.append(f"large_kkt QP: {sol['status']}, gap {qp['gap']} "
                     f"pres {qp['pres']} dres {qp['dres']}")
    for k in fc.SMALL_BATCH_KERNELS:
        if not counts[k]:
            fails.append(f"large_kkt QP did not launch {k}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = coneqp(P, qd, G, h, kktsolver="chol", options=LARGE_KKT_OPTS)
    torch.cuda.synchronize()
    qp["chol_wall_s"] = time.perf_counter() - t0
    qp["chol_status"] = ref["status"]
    qp["chol_iterations"] = ref["iterations"]
    qp["x_vs_chol_max_abs"] = float((sol["x"] - ref["x"]).abs().max())
    if ref["status"] != "optimal" or not qp["x_vs_chol_max_abs"] <= 1e-6:
        fails.append(f"large_kkt QP through kktsolver='chol': "
                     f"{ref['status']}, x differs by "
                     f"{qp['x_vs_chol_max_abs']}")
    rec["qp"] = qp
    del P, G, h, sol, ref
    torch.cuda.empty_cache()

    rep = "cvxopt_tpu/ops/pallas_chol.py:"
    for key, kname, line, pre in (("panel_factor/large_kkt", "panel_factor",
                                   "129", ""),
                                  ("panel_solve/large_kkt", "panel_solve",
                                   "194", "solve_")):
        r64, r32 = rows["float64"], rows["float32"]

        def pick(r):
            plain = r[pre + "plain_ms"]
            return dict(ms=min(r[pre + "ms"]),
                        plain_ms=min(plain) if isinstance(plain, list)
                        else plain,
                        library_ms=min(r[pre + "library_ms"]),
                        bound_ms=r[pre + "bound_ms"],
                        bound_by=r[pre + "bound_by"],
                        one_block_ms=r[pre + "one_block_ms"],
                        max_abs_err=r[("solve_" if pre else "factor_")
                                      + "max_abs_err"])
        row = dict(name=kname, replaces=rep + line, dtype="float64",
                   shape=[1, LARGE_KKT_N, LARGE_KKT_N if not pre else 1],
                   launches=counts[kname], paths=["large_kkt"],
                   flop_rate=FLOP_RATE[8], **pick(r64))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["float32"] = pick(r32)
        results[key] = row
    rec["nvidia_smi"] = nvidia_smi()
    rec["failed_checks"] = fails
    emit(rec, log)
    check(not fails, f"large_kkt: {fails}")


KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "bound_share", "shape", "paths")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import cvxopt_tpu_torch  # noqa: F401  (sets TF32 off)

    log, results = [], {}
    smi = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "tf32": torch.backends.cuda.matmul.allow_tf32}, log)
    if "build" in phases or "kernels" in phases:
        phase_build(log)
    seconds = {}
    carry = {}          # the cascade phase's x, for the parallel phase
    for name, run in (("kernels", phase_kernels),
                      ("cascade", lambda log, res:
                       phase_cascade(log, res, carry)),
                      ("entry", phase_entry),
                      ("socp", phase_socp), ("conelp_lp", phase_conelp_lp),
                      ("sdp", phase_sdp), ("cpl", phase_cpl),
                      ("nonlinear_front", phase_nonlinear_front),
                      ("lp_milp", phase_lp_milp),
                      ("sparse", phase_sparse),
                      ("parallel", lambda log, res:
                       phase_parallel(log, res, carry)),
                      ("large_kkt", phase_large_kkt)):
        if name in phases:
            t0 = time.perf_counter()
            run(log, results)
            seconds[name] = time.perf_counter() - t0
    emit({"phase": "seconds", "seconds": seconds}, log)

    kernels = []
    for r in results.values():
        row = dict(r, route="cuda",
                   source="cvxopt_tpu_torch/csrc/fused_chol.cu")
        row.setdefault("launches", 0)
        row.setdefault("paths", [])
        kernels.append({k: row[k] for k in KEYS})
    if all(ph in phases for ph in PHASES):
        idle = [r["name"] + str(r["shape"]) for r in kernels
                if not r["launches"]]
        check(not idle, f"no solver phase launched {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

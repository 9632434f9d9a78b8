#!/usr/bin/env python3
"""The f64 fused factor of cvxopt_tpu_torch on one GPU: schur_assemble and
panel_factor checked against the plain version and timed, at n = 10,240,
B = 1 (chip_smoke.py's large_kkt data) and at the kernel rows' smaller
shapes.

    python3 scripts/torch_f64_factor.py                  # this checkout
    python3 scripts/torch_f64_factor.py --root OTHER     # another checkout

`--root` imports cvxopt_tpu_torch from another checkout (an older
commit, to compare in one run).  Prints one JSON line: relative
Frobenius errors, device ms (CUDA events) of the assembly at the kernel
rows' shapes, of the factor at small n on the small-batch and the
one-block kernels (also queued, the host running ahead), of the
assembly, of panel_factor and of the whole call at n = 10,240 beside
torch's S and torch.linalg.cholesky, the assembly's TFLOP/s against the
67 TFLOP/s FP64 tensor-core peak, a torch.profiler breakdown of one
factor call, the ptxas lines of the build and the card's name and power
limit.  Exits non-zero if a check fails.
"""

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_DMMA = 67e12


def rel_fro(a, b):
    import torch
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def events_ms(fn, reps, setup=None):
    """Mean device ms of fn() between CUDA events, setup() (untimed)
    before each."""
    import torch
    out = []
    for r in range(reps + 1):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        if r:
            out.append(a.elapsed_time(b))
    return sum(out) / len(out)


def convex(B, n, m, per_instance, seed, kw):
    """bench.py's large-KKT data at (B, n, m): P = F F' + I, F (n, 256),
    Gt ~ N(0, 1) / sqrt(n), d ~ U(0.5, 2), from seeded numpy."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    F = torch.as_tensor(rng.standard_normal((B, n, min(256, n))), **kw)
    P = F @ F.transpose(1, 2)
    P.diagonal(dim1=1, dim2=2).add_(1.0)
    Gt = torch.as_tensor(rng.standard_normal(
        ((B,) if per_instance else ()) + (n, m)) / np.sqrt(n), **kw)
    d = torch.as_tensor(rng.uniform(0.5, 2.0, (B, m)), **kw)
    return P, Gt, d


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--n", type=int, default=10240)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_f64_factor: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from cvxopt_tpu_torch.ops import _build
    from cvxopt_tpu_torch.ops import fused_chol as fc
    lib = _build.build("fused_chol")
    # ptxas's lines for the f64 DMMA kernels: registers and spills
    ptxas, keep = [], False
    for ln in _build.build_log.get("fused_chol", {}).get("ptxas",
                                                         "").splitlines():
        if "Compiling entry" in ln:
            keep = "f64_kernel" in ln
        if keep:
            ptxas.append(ln.strip())
    kw = dict(dtype=torch.float64, device="cuda")
    rec = {"root": os.path.relpath(os.path.abspath(args.root), HERE),
           "library": os.path.basename(lib), "ptxas": ptxas[:40]}
    fails = []

    # the assembly alone (the lower tiles of L) at the kernel rows' shapes
    asm = {}
    for B, n, m, per in ((1024, 320, 513, True), (1, 192, 378, False),
                         (16, 64, 157, False), (8, 1280, 1248, True),
                         (2, 320, 157, False), (3, 1280, 513, False)):
        P, Gt, d = convex(B, n, m, per, n + m, kw)
        L = torch.empty((B, n, n), **kw)
        gt_bs = Gt.stride(0) if per else 0
        fc._assemble(P, Gt, gt_bs, d, d.stride(0), L)
        S = P + (Gt * d.unsqueeze(-2)) @ Gt.transpose(-1, -2)
        err = rel_fro(torch.tril(L), torch.tril(S))
        asm[f"{B}x{n}x{m}{'/per' if per else ''}"] = {
            "rel_fro": err, "ms": events_ms(
                lambda: fc._assemble(P, Gt, gt_bs, d, d.stride(0), L),
                args.reps)}
        if not err <= 1e-12:
            fails.append(f"assembly {B}x{n}x{m}: {err}")
        del P, Gt, d, L, S
    rec["assembly_rows"] = asm

    # panel_factor at smaller n, against the plain factor
    fac = {}
    for B, n, eq in ((1, 1280, False), (2, 4096, True), (8, 1280, False)):
        P, Gt, d = convex(B, n, 192, True, n + B, kw)
        out = fc.fused_schur_cholesky(P, Gt, d, equilibrate=eq)
        ref = fc.fused_schur_cholesky_ref(P, Gt, d, eq)
        errs = [rel_fro(a, b) for a, b in zip(out, ref)]
        fac[f"{B}x{n}{'/eq' if eq else ''}"] = errs
        if not max(errs) <= 1e-12:
            fails.append(f"factor {B}x{n}: {errs}")
    rec["factor_rows"] = fac

    # small n, B = 1: panel_factor against one block per instance, each
    # call between CUDA events (what chip_smoke.py's sweep times), and ten
    # calls (on ten copies of S) queued behind a sleep so that the host
    # runs ahead: the device's own time, without the host's launch latency
    small = {}
    keep = fc.PANEL_FACTOR_MIN_N
    for n in (128, 256, 512, 1024):
        P, Gt, d = convex(1, n, n, False, n, kw)
        L = torch.empty((1, n, n), **kw)
        D = torch.empty((1, n // fc.BP, fc.BP, fc.BP), **kw)
        fc._assemble(P, Gt, 0, d, d.stride(0), L)
        S0 = L.clone()
        row = {}
        for mode, min_n in (("panel", fc.BP), ("one_block", 1 << 40)):
            fc.PANEL_FACTOR_MIN_N = min_n
            row[mode + "_ms"] = events_ms(lambda: fc._factor(L, D, None),
                                          20, setup=lambda: L.copy_(S0))
            Ls = [S0.clone() for _ in range(10)]
            torch.cuda._sleep(200_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for Lc in Ls:
                fc._factor(Lc, D, None)
            b.record()
            torch.cuda.synchronize()
            row[mode + "_queued_ms"] = a.elapsed_time(b) / 10
        small[n] = row
    fc.PANEL_FACTOR_MIN_N = keep
    rec["small_n"] = small

    # n = 10,240, B = 1
    n = args.n
    P, Gt, d = convex(1, n, n, False, 0, kw)
    L = torch.empty((1, n, n), **kw)
    D = torch.empty((1, n // fc.BP, fc.BP, fc.BP), **kw)
    fc._assemble(P, Gt, 0, d, d.stride(0), L)
    S0 = L.clone()
    Lk, Dk = fc.fused_schur_cholesky(P, Gt, d)
    Lr, Dr = fc.fused_schur_cholesky_ref(P, Gt, d)
    rec["large"] = big = {"n": n, "L_rel_fro": rel_fro(Lk, Lr),
                          "Dinv_rel_fro": rel_fro(Dk, Dr)}
    if not max(big["L_rel_fro"], big["Dinv_rel_fro"]) <= 1e-12:
        fails.append(f"factor at n = {n}: {big}")
    del Lk, Dk, Lr, Dr
    flops = n * (n + 1.0) * n
    for rnd in range(2):
        big.setdefault("assemble_ms", []).append(events_ms(
            lambda: fc._assemble(P, Gt, 0, d, d.stride(0), L), args.reps))
        big.setdefault("panel_factor_ms", []).append(events_ms(
            lambda: fc._factor(L, D, None), args.reps,
            setup=lambda: L.copy_(S0)))
        big.setdefault("call_ms", []).append(events_ms(
            lambda: fc.fused_schur_cholesky(P, Gt, d), args.reps))
        big.setdefault("library_ms", []).append(events_ms(
            lambda: torch.linalg.cholesky(P + (Gt * d) @ Gt.T), args.reps))
        big.setdefault("library_S_ms", []).append(events_ms(
            lambda: P + (Gt * d) @ Gt.T, args.reps))
        big.setdefault("library_cholesky_ms", []).append(events_ms(
            lambda: torch.linalg.cholesky(S0), args.reps))
    big["assemble_tflops"] = flops / min(big["assemble_ms"]) / 1e9
    big["assemble_share_of_dmma_peak"] = big["assemble_tflops"] * 1e12 \
        / PEAK_DMMA

    from torch.profiler import ProfilerActivity, profile
    L.copy_(S0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fc.fused_schur_cholesky(P, Gt, d)
        torch.cuda.synchronize()
    kern = {}
    for e in prof.key_averages():
        dt = next((getattr(e, k) for k in ("self_device_time_total",
                                           "self_cuda_time_total")
                   if hasattr(e, k)), 0.0)
        if "CUDA" in str(getattr(e, "device_type", "CUDA")) and dt > 0:
            mm = re.search(r"(\w+_kernel)", e.key)
            k = kern.setdefault(mm.group(1) if mm else e.key[:40],
                                {"launches": 0, "device_ms": 0.0})
            k["launches"] += e.count
            k["device_ms"] += dt / 1e3
    big["profile"] = kern
    rec["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rec["failed_checks"] = fails
    print(json.dumps(rec), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())

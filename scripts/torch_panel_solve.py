#!/usr/bin/env python3
"""panel_solve and schur_chol64 of cvxopt_tpu_torch on one GPU: checked
against their plain versions and timed, the solve at the shapes of
PERF.md's rows 20 (B = 1, n = 10,240, one right-hand side, f64 and f32)
and 18 (B = 8, n = 1280, f64) in turns with the plain version and
torch.cholesky_solve, the factor at n = 64 at rows 5 and 14 in turns with
its plain version and the two-launch layout (schur_assemble +
schur_factor), the order reversed each round.  Timing and data helpers
are chip_smoke.py's.

    python3 scripts/torch_panel_solve.py                  # this checkout
    python3 scripts/torch_panel_solve.py --root OTHER     # another checkout

`--root` imports cvxopt_tpu_torch from another checkout (an older commit,
to compare in one call).  Prints one JSON line: per shape, the wrapper's,
the plain version's and (solve) the library's or (factor) the two
launches' ms per round (CUDA events over `--reps` calls; host-bound
calls read the host's time per call), the kernels alone (device ms per
call, torch.profiler), the relative Frobenius error against the plain
version and, for the solve, whether two calls gave equal bits; the
ptxas lines of panel_solve, the card's name and power limit.  Exits
non-zero if a check fails.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402  (timing and data helpers)

# (tag, B, n, dtype): the solve's rows
SHAPES = (("row20_f64", 1, 10240, "float64"),
          ("row20_f32", 1, 10240, "float32"),
          ("row18_f64", 8, 1280, "float64"))
# (tag, B, m, dtype, per-instance Gt): the n = 64 factor's rows
FACTOR_SHAPES = (("row5_f32", 1024, 400, "float32", True),
                 ("row14_f64", 16, 157, "float64", False))


def kernel_ms(fn, reps, names=("panel_solve",)):
    """Device ms a call of fn spends in the kernels whose names contain
    one of `names`, over `reps` calls (torch.profiler; the wrapper's
    other launches excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot = 0
    for e in prof.key_averages():
        if any(k in e.key for k in names):
            tot += getattr(e, "device_time_total", None) or e.cuda_time_total
    return tot / 1e3 / reps if tot else None


def ptxas_lines(log):
    lines = log.splitlines()
    keep = []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and "panel_solve" in ln:
            keep += [s.strip() for s in lines[i:i + 3]]
    return keep


def solve_row(fc, B, n, dt, args, fails, tag):
    import torch
    kw = dict(dtype=getattr(torch, dt), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(n + B)
    pairs = [cs.unit_lower(n, g, kw) for _ in range(B)]
    L = torch.stack([p[0] for p in pairs])
    D = torch.stack([p[1] for p in pairs])
    b = torch.randn((B, 1, n), generator=g, **kw)
    xr = fc.fused_cholesky_solve_ref(L, D, b)
    fc.reset_launch_counts()
    x = fc.fused_cholesky_solve(L, D, b)
    x2 = fc.fused_cholesky_solve(L, D, b)
    torch.cuda.synchronize()
    rec = {"B": B, "n": n, "dtype": dt, "error": cs.rel_fro(x, xr),
           "equal_bits": bool(torch.equal(x, x2)),
           "kernels": fc.solve_kernel_counts()}
    if rec["error"] > cs.TOL[dt] or not rec["equal_bits"]:
        fails.append(f"{tag}: {rec['error']}, equal bits "
                     f"{rec['equal_bits']}")
    solve = lambda: fc.fused_cholesky_solve(L, D, b)
    bt = b.transpose(1, 2)
    rec["ms"] = cs.in_turns({
        "kernel": solve,
        "plain": lambda: fc.fused_cholesky_solve_ref(L, D, b),
        "library": lambda: torch.cholesky_solve(bt, L)},
        args.rounds, reps=args.reps)
    rec["kernel_only_ms"] = kernel_ms(solve, args.reps)
    return rec


def factor_row(fc, B, m, dt, per_inst, args, fails, tag):
    import torch
    P, Gt, d2 = cs.kernel_data(B, 64, m, getattr(torch, dt), per_inst,
                               seed=B + m)
    if per_inst:
        fac = lambda: fc.fused_schur_cholesky(P, Gt, d2)
    else:
        fac = lambda: fc.fused_schur_cholesky_batched(P, Gt, d2, tb=1)
    L = torch.empty_like(P)
    D = torch.empty((B, 1, 64, 64), dtype=P.dtype, device="cuda")
    gt_bs = Gt.stride(0) if per_inst else 0

    def two_launch():
        # schur_assemble + schur_factor, called below the wrapper: without
        # its checks and allocations
        fc._assemble(P, Gt, gt_bs, d2, d2.stride(0), L)
        fc._factor(L, D, None)
    ref = fc.fused_schur_cholesky_ref(P, Gt, d2)
    Lk, Dk = fac()
    torch.cuda.synchronize()
    rec = {"B": B, "m": m, "dtype": dt, "per_instance_gt": per_inst,
           "error": max(cs.rel_fro(Lk, ref[0]), cs.rel_fro(Dk, ref[1]))}
    if rec["error"] > cs.TOL[dt]:
        fails.append(f"{tag}: {rec['error']}")
    fns = {"kernel": fac, "two_launch": two_launch,
           "plain": lambda: fc.fused_schur_cholesky_ref(P, Gt, d2)}
    rec["ms"] = {k: [] for k in fns}
    for r in range(args.factor_rounds):      # the order reversed each round
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            rec["ms"][k].append(cs.time_ms(fns[k], reps=args.reps))
    kernels = ("schur_chol64", "schur_assemble", "schur_factor")
    rec["device_ms"] = {k: kernel_ms(fns[k], args.reps, kernels)
                        for k in ("kernel", "two_launch")}
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--factor-rounds", type=int, default=12)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_panel_solve: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from cvxopt_tpu_torch.ops import fused_chol as fc
    from cvxopt_tpu_torch.ops import _build

    _build.build("fused_chol")
    out = {"root": os.path.abspath(args.root),
           "ptxas": ptxas_lines(_build.build_log.get(
               "fused_chol", {}).get("ptxas", "")), "shapes": {}}
    fails = []
    for tag, B, n, dt in SHAPES:
        out["shapes"][tag] = solve_row(fc, B, n, dt, args, fails, tag)
        torch.cuda.empty_cache()
    for tag, B, m, dt, per_inst in FACTOR_SHAPES:
        out["shapes"][tag] = factor_row(fc, B, m, dt, per_inst, args, fails,
                                        tag)
    out["nvidia_smi"] = cs.nvidia_smi()
    out["failed_checks"] = fails
    print(json.dumps(out), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())

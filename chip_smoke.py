#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`cvxopt_tpu_torch`) on one GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line:

  env      nvidia-smi name and power limit, torch and CUDA versions
  build    nvcc builds csrc/fused_chol.cu (sm_90a); seconds, ptxas usage
  kernels  the four fused-Cholesky wrappers against their plain PyTorch
           versions on the card, at the main-path shapes in f32 and at
           B=64 in f64, plus a non-PD instance that must come back NaN;
           kernel, plain-version and library times
  cascade  make_coneqp_cascade(l=512, 'chol2_inv', 1e-7) on 1024
           scenario QPs with n=256: every status 0, gap/pres/dres
           <= 1e-7, IPM iterations/s, the batched kernels launched
  entry    make_coneqp(l=256) on 64 QPs with per-instance G in f32 and
           f64: the unbatched kernels launched, 4 instances agree with
           the port's CPU run

Then a `{"kernels": [...]}` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.  Any failed check raises, and the
script exits non-zero; it also exits non-zero, printing no result,
when no CUDA device is present.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "build", "kernels", "cascade", "entry")

# published peaks of one H100 SXM (NVIDIA data sheet): float32 outside
# the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

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


def scenario_qps(nb, n, seed=0):
    """bench.py make_batch: min 1/2 x'Px + q'x, 0 <= x <= 1, sum x = 1,
    with P = F F' + 0.1 I, F (n, n/4) / sqrt(n); seeded numpy."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    F = torch.as_tensor(rng.standard_normal((nb, n, n // 4)) / np.sqrt(n),
                        device="cuda")
    P = F @ F.transpose(1, 2) + 0.1 * torch.eye(n, dtype=torch.float64,
                                                device="cuda")
    q = torch.as_tensor(-rng.uniform(0.0, 0.1, (nb, n)), device="cuda")
    eye = np.eye(n)
    G = np.concatenate([-eye, eye], axis=0)
    h = np.concatenate([np.zeros(n), np.ones(n)])
    return (P, q) + tuple(torch.as_tensor(u, device="cuda") for u in
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


def _solve_bound(B, n, nrhs, rhs_shared, esize):
    """Per right-hand side, forward and backward: the strictly lower
    off-diagonal tiles (n (n-64) / 2 words) and the lower halves of the
    Dinv blocks, 2 (n^2 + n) FLOP in all; bytes of those tiles, Dinv
    and the right-hand sides in (once if shared) and out."""
    flops = B * 2.0 * (n * n + n) * nrhs
    words = B * (n * (n - 64) / 2 + n * 64 + nrhs * n) + \
        (nrhs * n if rhs_shared else B * nrhs * n)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = words * esize / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


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


def phase_kernels(log, results):
    import torch
    from cvxopt_tpu_torch.ops import fused_chol as fc
    f32, f64 = torch.float32, torch.float64
    rep = "cvxopt_tpu/ops/pallas_chol.py:"

    def lib_factor(P, Gt, d2):
        S = torch.baddbmm(P, Gt * d2.unsqueeze(-2), Gt.transpose(-1, -2)) \
            if Gt.dim() == 3 else P + (Gt * d2.unsqueeze(-2)) @ Gt.T
        return torch.linalg.cholesky(S)

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
        library_ms=time_ms(lambda: lib_factor(P, Gt, d2)),
        bound_ms=bound, bound_by=by)

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
        library_ms=time_ms(lambda: lib_factor(P, Gt, d2)),
        bound_ms=bound, bound_by=by)

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
    emit({"phase": "kernels", "ok": True, "results": results}, log)


def phase_cascade(log, results):
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
        results[k]["launches"] = counts[k]
    # four instances against the port's float64 'chol2' solve on the CPU
    cpu = make_coneqp(dims, kktsolver="chol2", abstol=1e-7, reltol=1e-7,
                      feastol=1e-7, device="cpu")
    P, q, G, h, A, b = (u.cpu() for u in data)
    ref = cpu(P[:4], q[:4], G, h, A, b)
    dx = float((out["x"][:4].cpu() - ref["x"]).abs().max())
    rec["x_vs_cpu_f64_max_abs"] = dx
    check(dx <= 1e-6, f"cascade x differs from the CPU f64 solve: {dx}")
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
            if dtype == np.float32:
                results[k]["launches"] = counts[k]
        emit(rec, log)


KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


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
    if "kernels" in phases:
        phase_kernels(log, results)
    if "cascade" in phases:
        phase_cascade(log, results)
    if "entry" in phases:
        phase_entry(log, results)

    kernels = []
    for name, r in results.items():
        row = dict(r, name=name, route="cuda",
                   source="cvxopt_tpu_torch/csrc/fused_chol.cu")
        row.setdefault("launches", 0)
        kernels.append({k: row[k] for k in KEYS})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the port's cascades goes, on one GPU.

    python3 scripts/torch_cascade_profile.py [--path cascade]
                                             [--kktsolver chol2_inv]

Paths (the configurations and data of chip_smoke.py's phases):

  cascade    make_coneqp_cascade(l=512, kktsolver, maxiters=50, 1e-7) on
             1024 scenario QPs, n=256 (the default path)
  socp       make_coneqp_cascade(q=(4,)*100, 'chol2_inv', 1e-7,
             per-instance G/h) on 1024 SOC-constrained QPs, n=64
  conelp_lp  make_conelp_cascade(l=512, 'chol2', 1e-7) on 1024 scenario
             LPs, n=256
  sdp        make_conelp_cascade(s=(50,), 1e-7/1e-6/1e-7) on 128 max-cut
             SDP relaxations, m=50
  cpl        cvxprog.make_cpl(l=512, mnl=1, 'chol2') on 1024 acent2
             problems, n=256 plus the epigraph variable, f64; also the
             main loop's passes, the host syncs and the device launches
             per pass
  library    no solve: CUDA-event times of the library calls that the
             socp and sdp paths make once per loop pass, at their shapes
             (batched torch.linalg.qr, eigh, eigvalsh, solve_triangular)

One warm-up solve of the same batch (so the timed solves pay no
first-use costs: allocations, lazily loaded kernels and library
handles), three timed solves (wall seconds and aggregate IPM
iterations/s each), then one solve under torch.profiler.  Prints one
JSON line: the card (nvidia-smi name and power limit), the timed runs
with their per-phase iterations and host syncs, device kernel time
against the profiled wall time (the idle share), kernel launches, the
kernels that take the most device time, and the device time by group:
the hand-written kernels, the library's QR, eigh and Cholesky/LU/
triangular kernels, matmuls, everything else.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 3

def _setup(path, kktsolver):
    """(solve, data on the card, description) for one path."""
    import torch
    import chip_smoke as cs
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.coneqp import make_coneqp_cascade
    from cvxopt_tpu_torch.conelp import make_conelp_cascade
    from cvxopt_tpu_torch.cvxprog import make_cpl
    tol = dict(abstol=1e-7, reltol=1e-7, feastol=1e-7)
    if path == "cascade":
        solve = make_coneqp_cascade(
            ConeDims(l=512), kktsolver=kktsolver, maxiters=50,
            instrument=True, **tol)
        return solve, cs.scenario_qps(1024, 256, seed=0), \
            {"nb": 1024, "n": 256, "kktsolver": kktsolver}
    if path == "socp":
        solve = make_coneqp_cascade(
            ConeDims(q=(4,) * 100), kktsolver="chol2_inv", maxiters=50,
            shared_GhAb=False, instrument=True, **tol)
        data, desc = cs.soc_qps(1024, seed=0), {"nb": 1024, "n": 64}
    elif path == "cpl":
        data, F = cs.acent2_batch(1024, 256, seed=0)
        solve = make_cpl(ConeDims(l=512, mnl=1), F, kktsolver="chol2")
        desc = {"nb": 1024, "n": 257, "kktsolver": "chol2"}
    elif path == "conelp_lp":
        solve = make_conelp_cascade(
            ConeDims(l=512), kktsolver="chol2", maxiters=50,
            instrument=True, **tol)
        data, desc = cs.scenario_lps(1024, seed=0), {"nb": 1024, "n": 256}
    else:
        solve = make_conelp_cascade(
            ConeDims(s=(50,)), maxiters=40, abstol=1e-7, reltol=1e-6,
            feastol=1e-7, shared_GhAb=False, instrument=True)
        data, desc = cs.mcsdp_batch(128, seed=0), {"nb": 128, "m": 50}
    return solve, tuple(torch.as_tensor(u, device="cuda") for u in data), \
        desc


def _library_times():
    """ms per call of the batched library calls on the socp and sdp
    paths, on seeded normal data of the paths' shapes."""
    import torch
    from chip_smoke import time_ms
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape, dtype):
        return torch.randn(shape, device="cuda", dtype=torch.float64,
                           generator=g).to(dtype)

    f32, f64 = torch.float32, torch.float64
    out = {}
    # socp phase B: kkt_cholqr's QR of [Gs; Rp] Q2, R only
    M = rnd((1024, 464, 64), f32)
    out["qr_r_1024x464x64_f32"] = time_ms(
        lambda: torch.linalg.qr(M, mode="r"))
    R = torch.linalg.qr(M, mode="r")[1]
    eye = torch.eye(64, dtype=f32, device="cuda").expand(1024, 64, 64)
    out["solve_triangular_eye_1024x64_f32"] = time_ms(
        lambda: torch.linalg.solve_triangular(R, eye, upper=True))
    # sdp: kkt_qr's reduced QR of the packed Gs (1275 x 50), phases A/B
    for dt, tag in ((f32, "f32"), (f64, "f64")):
        Gp = rnd((128, 1275, 50), dt)
        out[f"qr_reduced_128x1275x50_{tag}"] = time_ms(
            lambda: torch.linalg.qr(Gp, mode="reduced"), reps=5)
    # sdp: the NT scaling's and max_step's symmetric eigenproblems
    X = rnd((128, 50, 50), f64)
    S = X @ X.transpose(1, 2) + torch.eye(50, dtype=f64, device="cuda")
    out["eigh_128x50x50_f64"] = time_ms(
        lambda: torch.linalg.eigh(S), reps=5)
    out["eigvalsh_128x50x50_f64"] = time_ms(
        lambda: torch.linalg.eigvalsh(S), reps=5)
    out["cholesky_128x50x50_f64"] = time_ms(
        lambda: torch.linalg.cholesky_ex(S), reps=5)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default="cascade",
                    choices=("cascade", "socp", "conelp_lp", "sdp", "cpl",
                             "library"))
    ap.add_argument("--kktsolver", default="chol2_inv",
                    help="the cascade path's strategy")
    ap.add_argument("--reps", type=int, default=REPS,
                    help="timed solves before the profiled one")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import device_rows, kernel_group, nvidia_smi
    import cvxopt_tpu_torch  # noqa: F401  (sets TF32 off)
    from torch.profiler import ProfilerActivity, profile

    if args.path == "library":
        print(json.dumps({"nvidia_smi": nvidia_smi(), "path": "library",
                          "ms_per_call": _library_times()}), flush=True)
        return 0

    solve, data, desc = _setup(args.path, args.kktsolver)
    solve(*data)

    runs = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve(*data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        iters = int(out["iterations"].sum())
        runs.append({"wall_s": wall, "iterations": iters,
                     "ipm_iters_per_s": iters / wall,
                     "solved": int((out["status"] == 0).sum()),
                     **{k: out[k] for k in ("profile", "passes",
                                            "host_syncs") if k in out}})

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(*data)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    rows = device_rows(prof)
    dev_ms = sum(r["device_ms"] for r in rows)
    launches = sum(r["count"] for r in rows)
    groups = {}
    for r in rows:
        g = groups.setdefault(kernel_group(r["name"]),
                              {"device_ms": 0.0, "launches": 0})
        g["device_ms"] += r["device_ms"]
        g["launches"] += r["count"]
    summary = {
        "nvidia_smi": nvidia_smi(), "path": args.path, **desc,
        "runs": runs, "groups": groups,
        "profiled_wall_s": pwall, "device_kernel_ms": dev_ms,
        "device_idle_share": 1.0 - dev_ms / 1e3 / pwall,
        "device_launches": launches,
        "top": rows[:12],
    }
    if "passes" in runs[-1]:
        passes = runs[-1]["passes"]
        summary.update(
            host_syncs_per_pass=runs[-1]["host_syncs"] / passes,
            device_launches_per_pass=launches / passes,
            device_ms_per_pass=dev_ms / passes)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

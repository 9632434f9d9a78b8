#!/usr/bin/env python3
"""Where the time of the port's headline solve goes, on one GPU.

    python3 scripts/torch_cascade_profile.py [--kktsolver chol2_inv]

Runs cvxopt_tpu_torch's make_coneqp_cascade(l=512, kktsolver,
maxiters=50, 1e-7) on bench.py's scenario QPs (1024 instances, n=256,
seeded numpy): one warm-up, three timed solves (wall seconds and aggregate IPM
iterations/s each), then one solve under torch.profiler.  Prints one
JSON line: the card (nvidia-smi name and power limit), the timed runs,
device kernel time against the profiled wall time (the idle share),
kernel launches, and the kernels that take the most device time.  The
data is chip_smoke.py's, from its generator.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB, N, REPS = 1024, 256, 3


def _dev_time(evt):
    for k in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, k):
            return getattr(evt, k)
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kktsolver", default="chol2_inv")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import scenario_qps, nvidia_smi
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.coneqp import make_coneqp_cascade
    from torch.profiler import ProfilerActivity, profile

    solve = make_coneqp_cascade(
        ConeDims(l=2 * N), kktsolver=args.kktsolver, maxiters=50,
        abstol=1e-7, reltol=1e-7, feastol=1e-7, instrument=True)
    solve(*scenario_qps(64, N, seed=1))
    data = scenario_qps(NB, N, seed=0)

    runs = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve(*data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        iters = int(out["iterations"].sum())
        runs.append({"wall_s": wall, "iterations": iters,
                     "ipm_iters_per_s": iters / wall,
                     "solved": int((out["status"] == 0).sum()),
                     "profile": out["profile"]})

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(*data)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only: a CPU op's device time repeats the
        # kernels it launched
        on_device = "CUDA" in str(getattr(e, "device_type", "CUDA"))
        dt = _dev_time(e)
        if on_device and dt > 0:
            rows.append({"name": e.key[:120], "count": e.count,
                         "device_ms": dt / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    dev_ms = sum(r["device_ms"] for r in rows)
    launches = sum(r["count"] for r in rows)
    summary = {
        "nvidia_smi": nvidia_smi(), "nb": NB, "n": N,
        "kktsolver": args.kktsolver,
        "runs": runs,
        "profiled_wall_s": pwall, "device_kernel_ms": dev_ms,
        "device_idle_share": 1.0 - dev_ms / 1e3 / pwall,
        "device_launches": launches,
        "top": rows[:12],
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

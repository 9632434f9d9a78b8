"""Captures and replays of the IPM tapes (`cvxopt_tpu_torch.ipm_graph`)
in a benchmark cell's window, on the card.

    python3 scripts/torch_ipm_graph_counts.py --workload scenario_qp.b16 \
        --seed 7 --seconds 20

Makes the cell's data and its instrumented solver as `benchmark/run.py`
does, makes the traffic's warm-up calls, then calls the solver for
``--seconds`` and prints one JSON line: `ipm_graph.counts()` over the
warm-up and over the window, and for a cascade the window's sums of its
profile: phase A and B passes (each phase's host syncs less one), the
passes of each replayed from a tape, and captures.  It imports the
package of its own checkout: to compare two commits, run it in each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    from benchmark import harness
    from cvxopt_tpu_torch import ipm_graph

    spec = harness.load_spec(HERE)
    _, cfg, traffic = harness.cell_parts(spec, args.workload, HERE)
    family = harness.load_module(
        os.path.join(HERE, "benchmark", "problems", cfg["problem"] + ".py"),
        "benchmark_problem_" + cfg["problem"])
    pool = family.make_pool(cfg, traffic, args.seed, "cuda")
    solver = family.make_solver(cfg, traffic, "cuda", instrument=True)
    ipm_graph.reset_counts()
    for k in range(traffic["warmup_calls"]):
        solver(pool[k % len(pool)])
    torch.cuda.synchronize()
    warm = ipm_graph.counts()
    ipm_graph.reset_counts()
    keys = ("a_host_syncs", "b_host_syncs", "a_replays", "b_replays",
            "captures")
    sums = dict.fromkeys(keys, 0)
    calls, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        out = solver(pool[(traffic["warmup_calls"] + calls) % len(pool)])
        torch.cuda.synchronize()
        calls += 1
        prof = out.get("profile") if isinstance(out, dict) else None
        for k in keys if prof else ():
            sums[k] += prof[k]
    res = dict(workload=args.workload, seed=args.seed, calls=calls,
               warmup=warm, window=ipm_graph.counts(),
               device=torch.cuda.get_device_name(0))
    if sums["a_host_syncs"]:
        res.update(a_passes=sums["a_host_syncs"] - calls,
                   b_passes=sums["b_host_syncs"] - calls,
                   a_replays=sums["a_replays"], b_replays=sums["b_replays"],
                   captures=sums["captures"])
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""A benchmark cell's traced run with the program's spans read: the
idle time of the traced calls put down to the innermost `cvx.*` span
open on the host (`benchmark/program_spans.py`), the per-layer
quantities read from that, and the traced calls' mean length.

    python3 scripts/torch_trace_split.py --workload scenario_qp.b16 \
        --seed 7 --seconds 5

Runs the cell as `benchmark/run.py --trace 1` does (`harness.run_cell`,
this checkout's BENCHMARK.json and benchmark/), with
`tracing.reduce_trace` replaced by `program_spans.reduce_trace` for the
run.  It imports cvxopt_tpu_torch from its own checkout; to compare two
commits, run the script in each.  Prints one JSON line: the harness's
result (`correct`, the per-layer metrics, `breakdown` with the split
`idle_gaps`), `program` (count and idle seconds of each span name),
`program_metrics`, `call_ms` (the mean `bench.call` span of the traced
calls), the card's name and power limit.  Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

T_START = time.time()
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(workload, seed, seconds, device, overrides=None):
    """The harness's traced run of `workload`, with the program's spans
    read; returns the dict that main prints (less the card)."""
    from benchmark import harness, program_spans, tracing
    seen = {}

    def reduce(events):
        calls = [float(e["dur"]) for e in events
                 if e.get("ph") == "X" and e.get("name") == tracing.CALL]
        seen["call_ms"] = sum(calls) / len(calls) / 1e3 if calls else None
        seen["reduced"] = program_spans.reduce_trace(events)
        return seen["reduced"]

    parent = tracing.reduce_trace
    tracing.reduce_trace = reduce
    try:
        result = harness.run_cell(workload, seed, seconds, 1, device=device,
                                  t_start=T_START, root=HERE,
                                  overrides=overrides)
    finally:
        tracing.reduce_trace = parent
    reduced = seen.get("reduced") or {}
    if result is not None:
        result["breakdown"]["idle_gaps"] = reduced.get("idle_gaps")
    return dict(workload=workload, seed=seed, result=result,
                program=reduced.get("program"),
                program_metrics=program_spans.program_metrics(reduced),
                call_ms=seen.get("call_ms"), ncalls=reduced.get("ncalls"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from benchmark import harness
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, "cuda")
    out.update(card=harness.power_limit())
    print(json.dumps(out), flush=True)
    return 0 if out["result"] and out["result"]["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())

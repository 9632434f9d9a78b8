"""Benchmark of cvxopt_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload scenario_qp.b1024 --seed 7 \
        --seconds 30 --trace 0

Runs one cell of BENCHMARK.json from the root of a checkout and prints
one JSON line as the last line of standard output: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device, with --trace 1 breakdown, and
last the numbers the judge compared beside their limits, which are also
the last lines of standard error.  Exits non-zero without a result when
no card (or too few) is found, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness
    spec = harness.load_spec(ROOT)
    cell, _, _ = harness.cell_parts(spec, args.workload, ROOT)

    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"no result: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)} x{have} used "
          f"{cell['chips']}; nvidia-smi name, power limit: "
          f"{harness.power_limit()}", file=sys.stderr, flush=True)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              args.trace, device="cuda", t_start=T_START,
                              root=ROOT)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    harness.print_checks(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of the judge, on the card: a cell run with the problem
family's control in the program's place (`make_control`: in the
scenario cells the cascade's own float32 path, in the dense cell the
plain reference in float32 with TF32 off), judged by the same
comparison as the program.  It has to come out not correct.  The
benchmark's runs never run this.

    python3 benchmark/control.py --workload scenario_qp.b1024 \
        --seeds 11,12,13 --seconds 10

Prints one JSON line a seed: the run's `correct` and checks, and the
worst of each number over the answers that came back optimal alone,
which is what a float32 path that never stalls would read.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(name, seed, seconds, *, device, overrides=None):
    """One control run: (result, worst numbers over optimal answers)."""
    from benchmark import harness
    judged = []
    r = harness.run_cell(name, seed, seconds, 0, device=device,
                         t_start=time.time(), overrides=overrides,
                         control=True, judged=judged)
    ok = [nums for flag, nums in judged if flag]
    worst_ok = {k: max((v[k] for v in ok), default=math.nan)
                for k in r["checks"]}
    return r, dict(answers=len(judged), optimal=len(ok), worst=worst_ok)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r, ok = readings(args.workload, seed, args.seconds, device="cuda")
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              correct=r["correct"], checks=r["checks"],
                              optimal_answers=ok,
                              attempted=r["attempted"],
                              failed=r["failed"])), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

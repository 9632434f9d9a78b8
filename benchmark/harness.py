"""One run of one cell: data from the seed, warm-up, a closed-loop window
of back-to-back solver calls, the judge of what the window returned,
and the metrics, each read by its own module under `metrics/`.

Everything particular to a cell is found by name: the cell in
`BENCHMARK.json`, its configuration file, its traffic file under
`traffic/`, its problem family under `problems/` (named by the
configuration's "problem" key) and each metric's reader under
`metrics/`.  Adding one needs no edit here.

A problem family is a module with `make_pool`, `make_solver`,
`make_control`, `record`, `keep` and `judge`.  Its `record(out)` gives
a call's batch, optimal flags, iterations and host syncs, and may give
`counters`, {name: number}, which the readers find with the harness's
own per-call counters (`fused_chol.<wrapper>` launches and
`ipm_graph.<count>`, reset before each call) in `Context.counters` (the
window's calls) and `Context.trace_counters` (the profiled calls).  It
may declare `KERNEL_SPANS`, more functions to put benchmark spans
around in the traced slice (see `tracing`); a reader finds their calls
by `Context.kernel_calls(kind)`.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from benchmark import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
BANNED = ("jax", "jaxlib", "flax", "cvxopt_tpu")


def load_spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(spec, name, root=ROOT):
    """(cell entry, configuration dict, traffic dict) of a cell."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         + ", ".join(sorted(cells)))
    cell = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                     cell["traffic"] + ".json"))
    return cell, cfg, traffic


def cell_metrics(spec, name, trace):
    """The metric entries a cell reports: end-to-end ones with --trace 0,
    per-layer ones with --trace 1."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def banned_modules():
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = out.stdout.strip().splitlines()[:1]
    return line[0] if line else None


class Context:
    """What the metric readers read.  Times in seconds."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def kernel_calls(self, kind):
        """[(record, device seconds)] of the traced slice's calls of a
        kernel span's kind (`factor`, `solve` or one a problem family
        declares) whose kernels the trace shows."""
        if not self.trace:
            return []
        dev = self.trace["span_device_s"]
        return [(rec, dev[(kind, i)]) for i, rec in enumerate(self.spans)
                if rec["kind"] == kind and dev.get((kind, i), 0.0) > 0.0]


def _worst(worst, nums):
    for k in worst:
        v = float(nums[k])
        v = math.inf if math.isnan(v) else v
        worst[k] = max(worst[k], v)


def run_cell(name, seed, seconds, trace, *, device, t_start, root=ROOT,
             overrides=None, control=False, judged=None, log=sys.stderr):
    """Run one cell; returns its result dict, or None where it may not
    report (JAX or the JAX package was loaded).

    With ``control`` the problem family's control (the program's own
    lower-precision path, or the plain reference in a lower precision)
    takes the program's place in the window and is judged as the program
    is; it has to come out not correct.  A list passed as ``judged``
    receives (returned optimal, numbers) of every judged answer."""
    import torch
    spec = load_spec(root)
    cell, cfg, traffic = cell_parts(spec, name, root)
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    family = load_module(os.path.join(root, "benchmark", "problems",
                                      cfg["problem"] + ".py"),
                         "benchmark_problem_" + cfg["problem"])
    from cvxopt_tpu_torch import ipm_graph
    from cvxopt_tpu_torch.ops import fused_chol as fc
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    marks = [("imports and context", time.time())]
    pool = family.make_pool(cfg, traffic, seed, device)
    sync()
    marks.append(("data", time.time()))
    if control and trace:
        raise ValueError("the control is not traced")
    if control:
        solver = family.make_control(cfg, traffic, device)
    else:
        solver = family.make_solver(cfg, traffic, device,
                                    instrument=bool(trace))
    # A traced run's window runs the instrumented solver (its profile
    # counts host syncs); the profiled slice runs one that is not, as the
    # untraced window does, so that the trace sees no extra syncs.
    plain = (family.make_solver(cfg, traffic, device, instrument=False)
             if trace else solver)
    for fn in dict.fromkeys((solver, plain)):
        for k in range(traffic["warmup_calls"]):
            fn(pool[k % len(pool)])
            sync()
    marks.append(("warm-up", time.time()))
    setup_s = marks[-1][1] - t_start
    edges = [t_start] + [t for _, t in marks]
    print("setup_s by part: " + ", ".join(
        f"{part} {b - a:.3f}" for (part, _), a, b in
        zip(marks, edges, edges[1:])), file=log)

    pick = np.random.default_rng([seed, 1])
    calls, kept = [], []

    def one(k, span=False):
        batch = pool[k % len(pool)]
        fc.reset_launch_counts()
        ipm_graph.reset_counts()
        t0 = time.perf_counter()
        if span:
            with torch.profiler.record_function(tracing.CALL):
                out = plain(batch)
                sync()
        else:
            out = solver(batch)
            sync()
        t1 = time.perf_counter()
        lc = fc.launch_counts()
        rec = family.record(out)
        counters = {f"fused_chol.{w}": v for w, v in lc.items()}
        counters.update((f"ipm_graph.{c}", v)
                        for c, v in ipm_graph.counts().items())
        counters.update(rec.get("counters", {}))
        rec.update(s=t1 - t0, t_end=t1, counters=counters,
                   factor_calls=sum(lc[w] for w in tracing.FACTOR))
        i = int(pick.integers(rec["batch"]))
        kept.append((k % len(pool), i, bool(rec["ok"][i]),
                     family.keep(out, i)))
        calls.append(rec)

    t_win = time.perf_counter()
    while not calls or calls[-1]["t_end"] - t_win < seconds:
        one(len(calls))
    window_s = calls[-1]["t_end"] - t_win
    nwin = len(calls)
    spans, reduced = [], None
    if trace:
        spans, reduced = tracing.profile_calls(
            lambda k: one(nwin + k, span=True), traffic["trace_calls"],
            getattr(family, "KERNEL_SPANS", ()))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del solver, plain
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    limits = cfg["checks"]
    worst = dict.fromkeys(limits, 0.0)
    for j, i, ok, ans in kept:
        nums = family.judge(pool[j], i, ans)
        _worst(worst, nums)
        if judged is not None:
            judged.append((ok, nums))
    correct = all(worst[k] <= limits[k] for k in limits)

    win = calls[:nwin]
    attempted = sum(c["batch"] for c in win)
    solved = sum(int(c["ok"].sum()) for c in win)
    ctx = Context(
        setup_s=setup_s, window_s=window_s, call_s=[c["s"] for c in win],
        solved=solved, attempted=attempted,
        iterations=np.concatenate([np.asarray(c["iters"].cpu(), float)
                                   .reshape(-1) for c in win]),
        host_syncs=[c["host_syncs"] for c in win],
        factor_calls=[c["factor_calls"] for c in win],
        counters=[c["counters"] for c in win],
        # the profiled calls the trace holds: the profiler's warm-up call
        # comes first and is not recorded
        trace_counters=[c["counters"] for c in calls[nwin + 1:]],
        trace=reduced, spans=spans, n_problem=cfg.get("n"))
    metrics = {}
    for m in cell_metrics(spec, name, trace):
        reader = load_module(os.path.join(root, "benchmark", "metrics",
                                          m["name"] + ".py"),
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    found = banned_modules()
    if found:
        print("refusing to report: loaded " + ", ".join(found), file=log)
        return None
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"] if cuda else 0,
           "memory_peak_bytes": int(peak)}
    if reduced:
        dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(attempted - solved), "metrics": metrics,
              "device": dev}
    if reduced:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_split"][:10]}
    result["checks"] = {k: {"value": worst[k], "limit": limits[k]}
                        for k in limits}
    return result


def print_checks(result, log=sys.stderr):
    """The compared numbers beside their limits, as the last lines."""
    print(f"judged answers: correct={result['correct']}", file=log)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=log)

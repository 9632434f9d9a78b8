"""The traced slice of a run: the benchmark's own spans around the calls
into the KKT layer's kernels, a torch.profiler trace of a few calls, and
its reduction to device busy time, idle gaps by host span, the kernels
that took most time, and each factor or solve call's device time.

Spans are recorded from the benchmark's side only: `KernelSpans`
replaces the four wrappers of `cvxopt_tpu_torch.ops.fused_chol` by
module attribute while the slice runs (the KKT layer calls them through
the module), notes each call's shapes, opens a `record_function` span
around it and restores the wrappers afterwards.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

FACTOR = ("fused_schur_cholesky", "fused_schur_cholesky_batched")
SOLVE = ("fused_cholesky_solve", "fused_cholesky_solve_batched")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CALL = "bench.call"
NAME_CHARS = 120    # a kernel's name in the breakdown, cut after summing


def factor_shape(P, Gt):
    """(B, n, m, shared) of a factor wrapper's arguments."""
    B = P.shape[0] if P.dim() == 3 else 1
    return B, P.shape[-1], Gt.shape[-1], Gt.dim() == 2


def solve_shape(L, B_rows):
    """(B, n, nrhs, rhs_shared) of a solve wrapper's arguments."""
    B = L.shape[0] if L.dim() == 3 else 1
    shared = B_rows.dim() == 2 or (B > 1 and B_rows.stride(0) == 0)
    return B, L.shape[-1], B_rows.shape[-2], shared


class _Wrapped:
    """Calls `fn` inside a span and notes its shapes; reads and writes
    of other attributes (the program's launch counters) go to `fn`."""

    def __init__(self, fn, kind, calls):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_kind", kind)
        object.__setattr__(self, "_calls", calls)

    def __call__(self, *args, **kwargs):
        import torch
        if self._kind == "factor":
            shape = factor_shape(args[0], args[1])
        else:
            shape = solve_shape(args[0], args[2])
        rec = dict(kind=self._kind, shape=shape,
                   esize=args[0].element_size())
        self._calls.append(rec)
        with torch.profiler.record_function(
                f"bench.{self._kind}.{len(self._calls) - 1}"):
            return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


class KernelSpans:
    """Context manager: spans around the factor and solve wrappers."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from cvxopt_tpu_torch.ops import fused_chol as fc
        self._fc = fc
        self._orig = {name: getattr(fc, name) for name in FACTOR + SOLVE}
        for name, fn in self._orig.items():
            kind = "factor" if name in FACTOR else "solve"
            setattr(fc, name, _Wrapped(fn, kind, self.calls))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self._fc, name, fn)
        return False


def profile_calls(run_call, ncalls):
    """Run `run_call(k)` for k <= ncalls under torch.profiler with the
    kernel spans on (`run_call` opens the `bench.call` span itself, so
    that it covers the solver call alone).  The first call is the
    profiler's warm-up and is not recorded, so that the tracer's own
    start-up lands in no traced call.  Returns (the wrapper calls'
    records, the reduced trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    plan = schedule(wait=0, warmup=1, active=ncalls, repeat=1)
    with KernelSpans() as spans, profile(activities=acts,
                                         schedule=plan) as prof:
        for k in range(ncalls + 1):
            run_call(k)
            prof.step()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return spans.calls, reduce_trace(events)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(merged):
    return sum(b - a for a, b in merged)


def _clip(merged, lo, hi):
    return [[max(a, lo), min(b, hi)] for a, b in merged
            if b > lo and a < hi]


class _Spans:
    """Non-overlapping host spans of one kind, for lookups by time."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return self.spans[i]
        return None


def reduce_trace(events):
    """Reduce a chrome trace to what the metrics read (seconds):
    window_s (first call's start to last call's end, host clock),
    busy_s (device activity within it), device_ops (time by kernel
    name), idle_gaps (idle time by the host span open during it) and
    per-span device time of each factor and solve call."""
    dev, launch, calls, kspans = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append((t0, t1, e.get("name", "?"), args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = t0
        elif cat == "user_annotation" and e.get("name") == CALL:
            calls.append((t0, t1))
        elif cat == "user_annotation" and e.get("name", "").startswith(
                ("bench.factor.", "bench.solve.")):
            _, kind, idx = e["name"].split(".")
            kspans.append((t0, t1, kind, int(idx)))
    if not calls:
        return None
    lo, hi = min(c[0] for c in calls), max(c[1] for c in calls)
    busy = _clip(_union([(a, b) for a, b, _, _ in dev]), lo, hi)
    by_name = {}
    for a, b, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    call_idx, kernel_idx = _Spans(calls), _Spans(kspans)

    def host(t):
        span = kernel_idx.at(t)
        return (span[2] if span else
                "call" if call_idx.at(t) else "between_calls")

    # idle time split at every span boundary, by what the host was in
    cuts = sorted({t for s in calls + kspans for t in s[:2]})
    gaps = {}
    prev = lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            i, j = bisect.bisect_right(cuts, prev), bisect.bisect_left(cuts, a)
            edges = [prev] + cuts[i:j] + [a]
            for u, v in zip(edges, edges[1:]):
                name = host(0.5 * (u + v))
                gaps[name] = gaps.get(name, 0.0) + (v - u) / 1e6
        prev = max(prev, b)
    per_span = {}
    for a, b, _, corr in dev:
        t = launch.get(corr)
        span = kernel_idx.at(t) if t is not None else None
        if span is not None:
            per_span.setdefault((span[2], span[3]), []).append((a, b))
    span_device_s = {key: _length(_union(iv)) / 1e6
                     for key, iv in per_span.items()}
    return dict(window_s=(hi - lo) / 1e6, busy_s=_length(busy) / 1e6,
                device_ops=[[k[:NAME_CHARS], v] for k, v in top],
                idle_gaps=sorted(([k, v] for k, v in gaps.items()),
                                 key=lambda kv: -kv[1]),
                span_device_s=span_device_s, ncalls=len(calls))

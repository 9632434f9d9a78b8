"""The traced slice of a run: a torch.profiler trace of a few calls, and
its one reduction to what the per-layer metrics read.

Two kinds of host span are read from the trace.

- The benchmark's own `bench.<kind>.<i>` spans, put around calls into
  the program by `KernelSpans` while the slice runs: it replaces each
  entry's function by module attribute (the program calls it through the
  module), notes each call's shapes, opens the span around it and
  restores the functions afterwards.  The four wrappers of
  `cvxopt_tpu_torch.ops.fused_chol` (kinds `factor` and `solve`) are
  always wrapped.  A problem family may declare more in a module-level
  `KERNEL_SPANS`: (module, attribute, kind, shape) entries, where
  `shape(*args, **kwargs)` gives the call's shape tuple that a reader
  reads, and the first argument is a tensor whose element size is kept.
  A reader finds the calls of a kind by `harness.Context.kernel_calls`.
- The program's own `cvx.<layer>.<what>` spans (`cvxopt_tpu_torch.trace`,
  opened at each layer boundary while a profiler records; `cvx.*.sync`
  spans wrap its host reads of device values).

`reduce_trace(events)` gives (seconds):

- `window_s`: the first traced call's start to the last one's end (host
  clock); `busy_s`: device activity within it; `device_ops`: device time
  by kernel name; `ncalls`: the traced calls;
- `idle_split`: idle time by what the host was in: a kernel span's
  kind, else (in a call) the innermost `cvx.*` span open or `call`
  where none is, else `between_calls`.  It is the run's breakdown;
- `idle_gaps`: `idle_split` with the `cvx.*` names folded back into
  `call`, the form that readers of the benchmark's own spans alone
  compare with (`tests/test_torch_trace.py`).  Both sum to the window's
  idle time;
- `span_device_s`: {(kind, i): device time of the kernels launched
  inside that kernel span}, by the launch's correlation id;
- `program`: {`cvx.*` span name: count (spans that start in a traced
  call), idle_s (its idle time in `idle_split`), device_s (device time of
  the kernels launched while it was the innermost `cvx.*` span)}.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import tempfile


def factor_shape(P, Gt, *args, **kwargs):
    """(B, n, m, shared) of a factor wrapper's arguments."""
    B = P.shape[0] if P.dim() == 3 else 1
    return B, P.shape[-1], Gt.shape[-1], Gt.dim() == 2


def solve_shape(L, Dinv, B_rows, *args, **kwargs):
    """(B, n, nrhs, rhs_shared) of a solve wrapper's arguments."""
    B = L.shape[0] if L.dim() == 3 else 1
    shared = B_rows.dim() == 2 or (B > 1 and B_rows.stride(0) == 0)
    return B, L.shape[-1], B_rows.shape[-2], shared


FUSED_CHOL = "cvxopt_tpu_torch.ops.fused_chol"
FACTOR = ("fused_schur_cholesky", "fused_schur_cholesky_batched")
SOLVE = ("fused_cholesky_solve", "fused_cholesky_solve_batched")
KERNELS = tuple((FUSED_CHOL, name, "factor", factor_shape)
                for name in FACTOR) \
    + tuple((FUSED_CHOL, name, "solve", solve_shape) for name in SOLVE)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CALL = "bench.call"
PROGRAM = "cvx."
NAME_CHARS = 120    # a kernel's name in the breakdown, cut after summing


class _Wrapped:
    """Calls `fn` inside a span and notes its shapes; reads and writes
    of other attributes (the program's launch counters) go to `fn`."""

    def __init__(self, fn, kind, shape, calls):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_kind", kind)
        object.__setattr__(self, "_shape", shape)
        object.__setattr__(self, "_calls", calls)

    def __call__(self, *args, **kwargs):
        import torch
        rec = dict(kind=self._kind, shape=self._shape(*args, **kwargs),
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
    """Context manager: spans around the functions of `entries`
    ((module, attribute, kind, shape), see the module's docstring)."""

    def __init__(self, entries=KERNELS):
        self.entries = tuple(entries)
        self.calls = []
        for _, _, kind, _ in self.entries:
            # `reduce_trace` reads the kind back from `bench.<kind>.<i>`
            if not kind.isidentifier():
                raise ValueError(f"kernel span kind {kind!r} is no name")

    def __enter__(self):
        self._orig = []
        for mod, attr, kind, shape in self.entries:
            module = importlib.import_module(mod)
            fn = getattr(module, attr)
            self._orig.append((module, attr, fn))
            setattr(module, attr, _Wrapped(fn, kind, shape, self.calls))
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self._orig):
            setattr(module, attr, fn)
        return False


def profile_calls(run_call, ncalls, kernels=()):
    """Run `run_call(k)` for k <= ncalls under torch.profiler with spans
    around the `fused_chol` wrappers and the entries of `kernels`
    (`run_call` opens the `bench.call` span itself, so that it covers
    the solver call alone).  The first call is the profiler's warm-up
    and is not recorded, so that the tracer's own start-up lands in no
    traced call.  Returns (the wrapped calls' records, the reduced
    trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    plan = schedule(wait=0, warmup=1, active=ncalls, repeat=1)
    with KernelSpans(KERNELS + tuple(kernels)) as spans, \
            profile(activities=acts, schedule=plan) as prof:
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


class _Nested:
    """Host spans (start, end, ...) of one thread, nested or disjoint:
    the innermost one open at a moment, the one that started last among
    those that contain it."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent, open_ = [], []
        for i, span in enumerate(self.spans):
            while open_ and self.spans[open_[-1]][1] <= span[0]:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return self.spans[i] if i >= 0 else None


def _kernel_span(name):
    """(kind, i) of a `bench.<kind>.<i>` span's name, else None."""
    parts = name.split(".")
    if len(parts) == 3 and parts[0] == "bench" and parts[2].isdigit():
        return parts[1], int(parts[2])
    return None


def _ranked(gaps):
    return sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])


def reduce_trace(events):
    """Reduce a chrome trace's events (see the module's docstring);
    None where it holds no traced call."""
    dev, launch, calls, kspans, prog = [], {}, [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "?")
        args = e.get("args") or {}
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append((t0, t1, name, args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = t0
        elif cat != "user_annotation":
            continue
        elif name == CALL:
            calls.append((t0, t1))
        elif name.startswith(PROGRAM):
            prog.append((t0, t1, name))
        elif key := _kernel_span(name):
            kspans.append((t0, t1) + key)
    if not calls:
        return None
    lo, hi = min(c[0] for c in calls), max(c[1] for c in calls)
    busy = _clip(_union([(a, b) for a, b, _, _ in dev]), lo, hi)
    by_name = {}
    for a, b, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    call_idx, kernel_idx, prog_idx = (_Nested(calls), _Nested(kspans),
                                      _Nested(prog))

    def host(t):
        """A kernel span's kind, else the innermost program span, `call`
        or `between_calls`."""
        span = kernel_idx.at(t)
        if span:
            return span[2]
        if not call_idx.at(t):
            return "between_calls"
        span = prog_idx.at(t)
        return span[2] if span else "call"

    # idle time split at every span boundary, by what the host was in
    cuts = sorted({t for s in calls + kspans + prog for t in s[:2]})
    split = {}
    prev = lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            i, j = bisect.bisect_right(cuts, prev), bisect.bisect_left(cuts, a)
            edges = [prev] + cuts[i:j] + [a]
            for u, v in zip(edges, edges[1:]):
                name = host(0.5 * (u + v))
                split[name] = split.get(name, 0.0) + (v - u) / 1e6
        prev = max(prev, b)
    gaps = {}
    for name, idle in split.items():
        name = "call" if name.startswith(PROGRAM) else name
        gaps[name] = gaps.get(name, 0.0) + idle

    program = {}

    def entry(name):
        return program.setdefault(name, {"count": 0, "idle_s": 0.0,
                                         "device_s": 0.0})

    for a, _, name in prog:
        if call_idx.at(a):
            entry(name)["count"] += 1
    for name, idle in split.items():
        if name.startswith(PROGRAM):
            entry(name)["idle_s"] = idle
    per_span, per_prog = {}, {}
    for a, b, _, corr in dev:
        t = launch.get(corr)
        if t is None:
            continue
        span = kernel_idx.at(t)
        if span is not None:
            per_span.setdefault(span[2:4], []).append((a, b))
        span = prog_idx.at(t) if call_idx.at(t) else None
        if span is not None:
            per_prog.setdefault(span[2], []).append((a, b))
    for name, iv in per_prog.items():
        entry(name)["device_s"] = _length(_union(iv)) / 1e6
    return dict(window_s=(hi - lo) / 1e6, busy_s=_length(busy) / 1e6,
                device_ops=[[k[:NAME_CHARS], v] for k, v in top],
                idle_gaps=_ranked(gaps), idle_split=_ranked(split),
                span_device_s={key: _length(_union(iv)) / 1e6
                               for key, iv in per_span.items()},
                ncalls=len(calls), program=program)


def idle_pct(reduced, layer):
    """Idle time put down to the `cvx.<layer>.*` spans, as a share of the
    traced window (%); None where the trace holds none of them."""
    prog = (reduced or {}).get("program") or {}
    mine = [v["idle_s"] for k, v in prog.items()
            if k.startswith(f"{PROGRAM}{layer}.")]
    return 100.0 * sum(mine) / reduced["window_s"] if mine else None


def syncs_per_call(reduced):
    """`cvx.*.sync` spans per traced call; None where the trace holds no
    `cvx.*` span."""
    prog = (reduced or {}).get("program")
    if not prog:
        return None
    return sum(v["count"] for k, v in prog.items()
               if k.endswith(".sync")) / reduced["ncalls"]

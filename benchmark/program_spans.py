"""The program's own spans in a traced slice.

cvxopt_tpu_torch opens a `cvx.<layer>.<what>` span (`trace.span`) at
each layer boundary of a solver call while a profiler session records;
`cvx.<layer>.sync` spans wrap its host reads of device values.
`reduce_trace(events)` is `tracing.reduce_trace(events)` with two
additions:

- idle time that `tracing.reduce_trace` names `call` (in a call, outside
  the factor and solve wrapper spans) is named instead by the innermost
  `cvx.*` span open on the host at that moment, where one is; the rest
  stays `call`.  `factor`, `solve` and `between_calls` keep their
  values, and `idle_gaps` still sums to the window's idle time;
- `program`: for each `cvx.*` span name, the number of its spans that
  start inside the traced calls and the idle seconds put down to it.

Every other key is `tracing.reduce_trace`'s.  A program that opens no
`cvx.*` span gets the same reduction with an empty `program`.
`program_metrics(reduced)` gives the per-layer quantities read from it.
"""

from __future__ import annotations

import bisect

from benchmark import tracing

PREFIX = "cvx."
LAYERS = ("cascade", "ipm", "kkt")
# bound once, so that this reduction may stand in for it as
# tracing.reduce_trace
_base_reduce = tracing.reduce_trace


class _Nested:
    """Host spans of one thread, nested or disjoint: the innermost one
    open at a moment, the one that started last among those that
    contain it."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent, open_ = [], []
        for i, (a, _, _) in enumerate(self.spans):
            while open_ and self.spans[open_[-1]][1] <= a:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return self.spans[i] if i >= 0 else None


def _host_spans(events):
    """(bench.call spans, wrapper spans, cvx.* spans, device intervals)."""
    calls, kspans, prog, dev = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat in tracing.DEVICE_CATS:
            dev.append((t0, t1))
        elif cat != "user_annotation":
            continue
        elif name == tracing.CALL:
            calls.append((t0, t1))
        elif name.startswith(("bench.factor.", "bench.solve.")):
            kspans.append((t0, t1, name.split(".")[1]))
        elif name.startswith(PREFIX):
            prog.append((t0, t1, name))
    return calls, kspans, prog, dev


def reduce_trace(events):
    """`tracing.reduce_trace(events)` with `call` split by the program's
    spans and the key `program` (see the module's docstring)."""
    base = _base_reduce(events)
    if base is None:
        return None
    calls, kspans, prog, dev = _host_spans(events)
    lo, hi = min(c[0] for c in calls), max(c[1] for c in calls)
    busy = tracing._clip(tracing._union(dev), lo, hi)
    call_idx, kernel_idx = tracing._Spans(calls), tracing._Spans(kspans)
    prog_idx = _Nested(prog)

    def in_call(t):
        span = prog_idx.at(t)
        return span[2] if span else "call"

    # idle time in a call outside the wrappers, split at every span
    # boundary, by the innermost program span open during it
    cuts = sorted({t for s in calls + kspans + prog for t in s[:2]})
    split = {}
    prev = lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            i, j = bisect.bisect_right(cuts, prev), bisect.bisect_left(cuts, a)
            edges = [prev] + cuts[i:j] + [a]
            for u, v in zip(edges, edges[1:]):
                t = 0.5 * (u + v)
                if kernel_idx.at(t) is None and call_idx.at(t):
                    name = in_call(t)
                    split[name] = split.get(name, 0.0) + (v - u) / 1e6
        prev = max(prev, b)
    gaps = {k: v for k, v in base["idle_gaps"] if k != "call"}
    gaps.update((k, v) for k, v in split.items() if v > 0.0)
    program = {}
    for a, _, name in prog:
        if call_idx.at(a):
            entry = program.setdefault(name, {"count": 0, "idle_s": 0.0})
            entry["count"] += 1
    for name, entry in program.items():
        entry["idle_s"] = split.get(name, 0.0)
    return dict(base, idle_gaps=sorted(([k, v] for k, v in gaps.items()),
                                       key=lambda kv: -kv[1]),
                program=program)


def program_metrics(reduced):
    """host_syncs_per_call (`cvx.*.sync` spans per traced call) and,
    for each layer of LAYERS, idle_<layer>_pct (the idle time put down
    to its spans, as a share of the traced window).  None where the
    trace holds no `cvx.*` span, or none of that layer."""
    prog = (reduced or {}).get("program")
    out = {"host_syncs_per_call": None}
    out.update((f"idle_{layer}_pct", None) for layer in LAYERS)
    if not prog:
        return out
    out["host_syncs_per_call"] = sum(
        v["count"] for k, v in prog.items()
        if k.endswith(".sync")) / reduced["ncalls"]
    for layer in LAYERS:
        mine = [v["idle_s"] for k, v in prog.items()
                if k.startswith(f"{PREFIX}{layer}.")]
        if mine:
            out[f"idle_{layer}_pct"] = (100.0 * sum(mine)
                                        / reduced["window_s"])
    return out

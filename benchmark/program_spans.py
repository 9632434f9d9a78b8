"""The program's spans as `tracing.reduce_trace` reads them, in the form
of its first reader: no reduction of its own.

`reduce_trace(events)` is `tracing.reduce_trace(events)` with `idle_gaps`
replaced by its `idle_split` (idle time in a call put down to the
innermost `cvx.*` span) and each `program` entry cut to its count and
idle_s.  `program_metrics(reduced)` gives host_syncs_per_call and
idle_<layer>_pct for each layer of LAYERS, as the metric readers of the
same names read them (None where the trace holds no such span).
"""

from __future__ import annotations

from benchmark import tracing

LAYERS = ("cascade", "ipm", "kkt")
# bound once, so that this view may stand in for tracing.reduce_trace
_reduce = tracing.reduce_trace


def reduce_trace(events):
    reduced = _reduce(events)
    if reduced is None:
        return None
    return dict(reduced, idle_gaps=reduced["idle_split"],
                program={k: {"count": v["count"], "idle_s": v["idle_s"]}
                         for k, v in reduced["program"].items()})


def program_metrics(reduced):
    out = {"host_syncs_per_call": tracing.syncs_per_call(reduced)}
    out.update((f"idle_{layer}_pct", tracing.idle_pct(reduced, layer))
               for layer in LAYERS)
    return out

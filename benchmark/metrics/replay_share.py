"""Share of the IPM passes of the profiled calls (the uninstrumented
solver an untraced window runs) that were replayed from a CUDA-graph
tape: replays / (replays + eager passes), from the program's own
`ipm_graph.counts()`, reset before each call."""


def read(ctx):
    replays = sum(c["ipm_graph.replays"] for c in ctx.trace_counters)
    eager = sum(c["ipm_graph.eager_passes"] for c in ctx.trace_counters)
    return 100.0 * replays / (replays + eager) if replays + eager else None

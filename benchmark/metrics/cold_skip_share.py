"""Share of the warm-started IPM loops of the profiled calls that built
no cold start point, because every warm start was valid: skips / (skips
+ builds), from the program's own `ipm_graph.counts()` (`cold_skips`,
`cold_starts`), reset before each call.  Nothing where no profiled call
gave a warm start, or where the program has no such counter."""


def read(ctx):
    skips = sum(c.get("ipm_graph.cold_skips", 0) for c in ctx.trace_counters)
    builds = sum(c.get("ipm_graph.cold_starts", 0)
                 for c in ctx.trace_counters)
    return 100.0 * skips / (skips + builds) if skips + builds else None

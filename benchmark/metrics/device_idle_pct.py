"""Share of the traced slice's wall time (host clock, first call's
start to last call's end) in which no kernel, copy or memset ran on the
card (the union of their intervals in the profiler's trace)."""


def read(ctx):
    t = ctx.trace
    if not t or t["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

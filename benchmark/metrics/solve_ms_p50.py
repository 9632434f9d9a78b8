"""Median wall time of all calls in the window, from the solver being
called to its results synchronised (host clock), in ms."""

from benchmark import stats


def read(ctx):
    return 1e3 * stats.percentile(ctx.call_s, 50)

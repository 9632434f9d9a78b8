"""95th percentile of the wall times of all calls in the window, in ms."""

from benchmark import stats


def read(ctx):
    return 1e3 * stats.percentile(ctx.call_s, 95)

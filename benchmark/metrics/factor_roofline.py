"""Share of the roofline in the traced factor calls: the least time
their work needs on the card (benchmark/roofline.py, at the problem's
unpadded n) over the device time of the kernels launched inside them
(the union of their intervals, so that streams running side by side
count once)."""

from benchmark import roofline


def read(ctx):
    pairs = ctx.kernel_calls("factor")
    if not pairs:
        return None
    least = 0.0
    for rec, _ in pairs:
        B, n, m, shared = rec["shape"]
        e = rec["esize"]
        flops, nbytes = roofline.factor_work(
            B, roofline.true_n(n, ctx.n_problem), m, shared, e)
        least += roofline.least_seconds(flops, nbytes, e)
    return 100.0 * least / sum(dev for _, dev in pairs)

"""Share of the roofline in the traced solve calls (see
factor_roofline)."""

from benchmark import roofline


def read(ctx):
    pairs = ctx.kernel_calls("solve")
    if not pairs:
        return None
    least = 0.0
    for rec, _ in pairs:
        B, n, nrhs, shared = rec["shape"]
        e = rec["esize"]
        flops, nbytes = roofline.solve_work(
            B, roofline.true_n(n, ctx.n_problem), nrhs, shared, e)
        least += roofline.least_seconds(flops, nbytes, e)
    return 100.0 * least / sum(dev for _, dev in pairs)

"""Share of the roofline in the traced QR calls (`bench.qr.<i>` spans
around `torch.linalg.qr`; on 'q' cones, phase B's 'cholqr_inv' factor):
the least time their work needs on the card over the device time of the
kernels launched inside them, as factor_roofline reads its calls.

The work is that of an R-only Householder QR of a rows x cols matrix
(rows >= cols): 2 cols^2 (rows - cols/3) FLOPs, the matrix read once
and R's upper triangle written once, at the float32 peak
(`roofline.least_seconds`)."""

from benchmark import roofline


def qr_work(B, rows, cols, esize):
    """(FLOPs, bytes) of R = qr(M, mode='r') for B matrices M."""
    flops = B * 2.0 * cols * cols * (rows - cols / 3.0)
    words = B * (rows * cols + cols * (cols + 1) / 2.0)
    return flops, words * esize


def read(ctx):
    pairs = ctx.kernel_calls("qr")
    if not pairs:
        return None
    least = sum(roofline.least_seconds(*qr_work(*rec["shape"], rec["esize"]),
                                       4) for rec, _ in pairs)
    return 100.0 * least / sum(dev for _, dev in pairs)

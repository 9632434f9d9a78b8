"""Process start to the first timed call: imports, CUDA context, the
kernels' library (built on a checkout's first run), data made on the
device, and warm-up calls of the cell's own shapes."""


def read(ctx):
    return ctx.setup_s

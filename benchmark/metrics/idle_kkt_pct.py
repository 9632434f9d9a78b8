"""Share of the traced slice's wall time in which the card was idle
while the innermost program span open on the host was one of the KKT
layer's (`cvx.kkt.factor`, `.solve`; a replayed pass opens none, so
only the eager start points count), outside the benchmark's kernel
spans (`tracing.reduce_trace`'s `program`)."""

from benchmark import tracing


def read(ctx):
    return tracing.idle_pct(ctx.trace, "kkt")

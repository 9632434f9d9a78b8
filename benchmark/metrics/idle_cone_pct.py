"""Share of the traced slice's wall time in which the card was idle
while the innermost program span open on the host was one of the cone
layer's (`cvx.cone.scaling`: the NT scaling's computation and update;
`cvx.cone.step`: the steps to the cones' boundary), outside the
benchmark's kernel spans (`tracing.reduce_trace`'s `program`).  The
program opens them on dims with a 'q' or 's' part only."""

from benchmark import tracing


def read(ctx):
    return tracing.idle_pct(ctx.trace, "cone")

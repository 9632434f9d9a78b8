"""Share of the traced slice's wall time that the card spent on kernels
launched while the innermost program span open on the host was one of
the cone layer's (`cvx.cone.scaling`, `cvx.cone.step`): the summed
`device_s` of their `tracing.reduce_trace` `program` entries over the
traced window."""

PREFIX = "cvx.cone."


def read(ctx):
    prog = (ctx.trace or {}).get("program") or {}
    mine = [v["device_s"] for k, v in prog.items() if k.startswith(PREFIX)]
    return 100.0 * sum(mine) / ctx.trace["window_s"] if mine else None

"""Mean over the window's instances of the IPM iterations the solver
reports (all phases of a cascade)."""


def read(ctx):
    return float(ctx.iterations.mean()) if ctx.iterations.size else None

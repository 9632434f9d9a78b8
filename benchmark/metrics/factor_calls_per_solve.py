"""Calls into the fused Cholesky factor wrappers per solver call, from
the program's own counters (fused_chol.launch_counts(), reset before
each call); they count only calls that launched on the card."""


def read(ctx):
    total = sum(ctx.factor_calls)
    return total / len(ctx.factor_calls) if total else None

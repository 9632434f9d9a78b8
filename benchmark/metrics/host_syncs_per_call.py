"""Host reads of device values per traced call: the program's
`cvx.*.sync` spans (the IPM loop's status checks, the cascade's phase C
reads, the front end's result reads) that start inside the traced
calls, over the number of calls."""

from benchmark import tracing


def read(ctx):
    return tracing.syncs_per_call(ctx.trace)

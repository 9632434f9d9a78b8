"""Host synchronisations of a cascade's phases A and B per call, from
make_coneqp_cascade(instrument=True)'s profile; phase C's are not
counted by the program."""


def read(ctx):
    syncs = [s for s in ctx.host_syncs if s is not None]
    return sum(syncs) / len(syncs) if syncs else None

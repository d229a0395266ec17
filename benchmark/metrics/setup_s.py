"""Seconds from the process's start to the first timed request: imports,
the card's start, loading (or building) the kernels, making the victims,
the entry's own set-up and the warm-up requests (host clock)."""


def read(ctx):
    return ctx.setup_s

"""Launches of the program's hand-written kernels per request: the sum of
``ops/_cuda.LAUNCHES`` over the traced requests over their number."""


def read(ctx):
    if not ctx.requests or ctx.launches is None:
        return None
    return sum(ctx.launches.values()) / len(ctx.requests)

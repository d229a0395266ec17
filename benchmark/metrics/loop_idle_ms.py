"""Idle time of the card inside the elimination per request, in ms: the
stretches of the program's ``rref+origin`` span (the mode-0 elimination up
to the origin's readback) in which no device operation ran, over the
traced requests."""

from benchmark.harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    evs = spans.events(ctx.trace, ("rref+origin",))
    reqs = spans.requests(ctx.trace)
    if not evs or not reqs:
        return None
    return sum(spans.idle_within(ctx.trace, evs)) / 1000 / len(reqs)

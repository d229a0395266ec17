"""Idle time of the card inside mode 1's full elimination per request, in
ms: the stretches of the program's ``rref`` span (the phase around
``gauss_blocked.rref_full_blocked`` in ``solve_on_device``) in which no
device operation ran, over the traced requests."""

from benchmark.harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    evs = spans.events(ctx.trace, ("rref",))
    reqs = spans.requests(ctx.trace)
    if not evs or not reqs:
        return None
    return sum(spans.idle_within(ctx.trace, evs)) / 1000 / len(reqs)

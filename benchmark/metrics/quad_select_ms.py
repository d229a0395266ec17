"""Host time per request of the row selection, in ms: the program's span
``quad.select`` (a victim's kept row indices made and uploaded, the rows
gathered and padded to the row bucket on the card), from the trace's
``gf2bv.*`` host events, over the traced requests."""

from benchmark.harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    evs = spans.events(ctx.trace, ("quad.select",))
    reqs = spans.requests(ctx.trace)
    if not evs or not reqs:
        return None
    return sum(iv.end - iv.start for iv in evs) / 1000 / len(reqs)

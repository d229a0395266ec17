"""Host time per request of the entry's preparation before the elimination,
in ms: the program's spans ``mt.build`` (the MT19937 system built on the
card from the outputs) and ``lazy.bind`` (a victim's leaks bound to the
captured model and XORed into a copy of the cached matrix), from the
trace's ``gf2bv.*`` host events, over the traced requests."""

from benchmark.harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    evs = spans.events(ctx.trace, ("mt.build", "lazy.bind"))
    reqs = spans.requests(ctx.trace)
    if not evs or not reqs:
        return None
    return sum(iv.end - iv.start for iv in evs) / 1000 / len(reqs)

"""Host time of one panel of the elimination, in µs: the mean duration of
the program's ``panel`` span (a panel's scan, rebuild and rank-K update as
the host issues them) over the traced requests' panels."""

from benchmark.harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    evs = spans.events(ctx.trace, ("panel",))
    if not evs:
        return None
    return sum(iv.end - iv.start for iv in evs) / len(evs)

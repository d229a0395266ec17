"""Device time per request, in ms: every kernel, copy and memset of the
traced stretch (the profiler's device rows, no CPU-side operator rows) over
the traced requests."""


def read(ctx):
    if ctx.trace is None or not ctx.requests:
        return None
    total_us = sum(us for us, _, _ in ctx.trace.rows)
    if total_us <= 0:
        return None
    return total_us / 1000 / len(ctx.requests)

"""Share of the traced stretch in which no operation ran on the device, in
%: 1 - (union of the device's busy intervals) / (the stretch's wall), from
the profiler's timeline."""

from benchmark.harness import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    w = ctx.trace.window
    return 100 * (1 - trace.busy_us(ctx.trace.device, w) / (w.end - w.start))

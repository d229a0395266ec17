"""PyTorch calls per panel of the elimination: for each of the program's
``panel`` spans, the ``aten::`` host events inside it that lie inside no
other ``aten::`` event (the calls the program itself made, not those they
made in turn); the mean over the traced requests' panels."""

from benchmark.harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    panels = spans.events(ctx.trace, ("panel",))
    if not panels:
        return None
    calls = spans.top_level([iv for iv in ctx.trace.host if iv.name.startswith("aten::")])
    return sum(spans.counts_within(calls, panels)) / len(panels)

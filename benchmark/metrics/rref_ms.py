"""The panel loop's time per solve, in ms: ``utils.profiling``'s
``rref+origin`` phase (host clock around the mode-0 elimination, ending on
the origin's readback) over the traced requests, total over count."""


def read(ctx):
    spans = [r.phases["rref+origin"] for r in ctx.requests if "rref+origin" in r.phases]
    if not spans:
        return None
    return 1000 * sum(spans) / len(spans)

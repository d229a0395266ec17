"""Share of its roofline that the elimination's kernels reach, in %.

The least time is the bytes the elimination must move, computed from the
cell's shapes (harness/roofline.py: each panel's slice read once, the
rank-K update's live words under the mode-0 trailing rule read and written
once), over the card's published HBM rate.  It is divided by the device
time per request of the program's own kernels: the profiler's device rows
less copies, memsets and library kernels (harness/trace.is_library)."""

from benchmark.harness import roofline, trace


def read(ctx):
    if ctx.trace is None or not ctx.requests:
        return None
    peak = roofline.peak_for(ctx.kind)
    own_us = sum(us for us, name, _ in ctx.trace.rows if not trace.is_library(name))
    if peak is None or own_us <= 0:
        return None
    moved = roofline.elimination_bytes(ctx.shape["rows"], ctx.shape["cols"])
    bound_s = moved / peak["hbm_bytes_per_s"]
    return 100 * bound_s / (own_us / 1e6 / len(ctx.requests))

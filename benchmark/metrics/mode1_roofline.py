"""Share of its roofline that the full-width (mode 1) elimination's kernels
reach, in %.

The least time is the bytes a full RREF of the cell's nominal system must
move, over the card's published HBM rate.  Per panel of ``K`` columns: each
row's ``K``-column slice read once, and every word of every row read and
written once by the rank-K update (mode 1 keeps every column up to date,
so no word is dead), with the update's selector and the panel's pivot rows
read once.  Rows and words are the system's own, not padded: it counts the
work, not what any kernel moves, and it is a lower bound.  It is divided by
the device time per request of the program's own kernels: the profiler's
device rows less copies, memsets and library kernels
(harness/trace.is_library)."""

from benchmark.harness import roofline, trace

K_PANEL = 256  # panel width in columns the count is made for


def full_rref_bytes(rows: int, cols: int, k_panel: int = K_PANEL) -> int:
    """Bytes a full RREF of ``rows`` equations over ``cols`` unknowns (and
    the affine bit) must move."""
    kw = k_panel // 32
    words = -(-(1 + cols) // 32)
    panels = -(-(1 + cols) // k_panel)
    per_panel = 4 * rows * kw + 4 * (2 * rows * words + rows * kw + 32 * kw * words)
    return panels * per_panel


def read(ctx):
    if ctx.trace is None or not ctx.requests:
        return None
    peak = roofline.peak_for(ctx.kind)
    own_us = sum(us for us, name, _ in ctx.trace.rows if not trace.is_library(name))
    if peak is None or own_us <= 0:
        return None
    moved = full_rref_bytes(ctx.shape["rows"], ctx.shape["cols"])
    bound_s = moved / peak["hbm_bytes_per_s"]
    return 100 * bound_s / (own_us / 1e6 / len(ctx.requests))

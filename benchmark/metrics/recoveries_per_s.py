"""Recoveries completed and returned to the caller in the window, over the
window's seconds (host clock)."""

from benchmark.harness import stats


def read(ctx):
    if not ctx.window_s:
        return None
    return stats.rate(ctx.answered, ctx.window_s)

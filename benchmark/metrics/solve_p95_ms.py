"""The 95th percentile of every request's latency in the window, in ms: from
the call with the victim's observed outputs to the returned state words
(host clock)."""

from benchmark.harness import stats


def read(ctx):
    if not ctx.latencies_s:
        return None
    return 1000 * stats.percentile(ctx.latencies_s, 95)

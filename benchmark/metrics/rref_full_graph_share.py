"""The share of mode 1's full eliminations replayed from a CUDA graph: the
program's counter ``rref_full_graph_replays`` over its counter
``rref_full_calls`` (one each call of ``gauss_blocked.rref_full_blocked``),
each summed over the traced requests' span records.  None where the program
counts no such calls."""

from benchmark.harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    log = spans.program_log()
    if not log:
        return None
    calls = spans.counter_by_request(ctx.trace, log, "rref_full_calls")
    if not calls or not sum(calls):
        return None
    return sum(spans.counter_by_request(ctx.trace, log, "rref_full_graph_replays")) / sum(calls)

"""Host-to-device copies per request: the program's counter
``h2d_copies`` (each copy of a host tensor to the card) summed over the
span records of a request, from the program's span log; the mean over the
traced requests."""

from benchmark.harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    log = spans.program_log()
    if not log:
        return None
    per = spans.counter_by_request(ctx.trace, log, "h2d_copies")
    if not per:
        return None
    return sum(per) / len(per)

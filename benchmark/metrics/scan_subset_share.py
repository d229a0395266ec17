"""The share of the panels whose pivots the subset-first scan elected: the
program's counter ``scan_subset_panels`` over its counter ``scan_panels``
(both counted per elimination by ``gauss_blocked``, the first read back from
the card only while a profiler runs), each summed over the traced requests'
span records.  None where the program counts no scanned panels, as a program
without the subset-first scan does."""

from benchmark.harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    log = spans.program_log()
    if not log:
        return None
    panels = spans.counter_by_request(ctx.trace, log, "scan_panels")
    if not panels or not sum(panels):
        return None
    return sum(spans.counter_by_request(ctx.trace, log, "scan_subset_panels")) / sum(panels)

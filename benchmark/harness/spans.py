"""The program's own spans and counters in a traced stretch, by request.

The program (``gf2bv_tpu_torch/utils/profiling.py``) opens a
``gf2bv.<name>`` range on the profiler's timeline for each span and keeps a
log of the spans with their counters, stamped on the clock of the
profiler's host events.  A span or a record belongs to the request whose
``bench.request`` interval holds its start; the rest (set-up, the
profiler's start-up request) is left out.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right

from .trace import Interval, TraceData, busy_intervals

REQUEST_SPAN = "bench.request"
PREFIX = "gf2bv."


def requests(data: TraceData) -> list[Interval]:
    """The traced requests' intervals, in order."""
    return sorted((iv for iv in data.host if iv.name == REQUEST_SPAN), key=lambda iv: iv.start)


def request_of(reqs: list[Interval], start_us: float) -> int | None:
    """The index of the request whose interval holds ``start_us``."""
    i = bisect_right([r.start for r in reqs], start_us) - 1
    return i if i >= 0 and start_us <= reqs[i].end else None


def events(data: TraceData, names) -> list[Interval]:
    """The host events of the program's spans ``names`` (without the
    ``gf2bv.`` prefix) that start inside a request."""
    want = {PREFIX + n for n in names}
    reqs = requests(data)
    return [iv for iv in data.host
            if iv.name in want and request_of(reqs, iv.start) is not None]


def top_level(ivs: list[Interval]) -> list[Interval]:
    """The intervals that lie inside no other of the list, by start."""
    out: list[Interval] = []
    for iv in sorted(ivs, key=lambda iv: (iv.start, -iv.end)):
        if not out or iv.start >= out[-1].end:
            out.append(iv)
    return out


def counts_within(ivs: list[Interval], outer: list[Interval]) -> list[int]:
    """For each interval of ``outer``, how many of ``ivs`` lie inside it."""
    ivs = sorted(ivs, key=lambda iv: iv.start)
    starts = [iv.start for iv in ivs]
    return [sum(1 for iv in ivs[bisect_left(starts, o.start):bisect_right(starts, o.end)]
                if iv.end <= o.end) for o in outer]


def idle_within(data: TraceData, outer: list[Interval]) -> list[float]:
    """For each interval of ``outer``, the µs of it in which no device
    operation ran."""
    merged = busy_intervals(data.device, data.window)
    ends = [e for _, e in merged]
    out = []
    for o in outer:
        busy = 0.0
        for s, e in merged[bisect_right(ends, o.start):]:
            if s >= o.end:
                break
            busy += min(e, o.end) - max(s, o.start)
        out.append((o.end - o.start) - busy)
    return out


def counter_by_request(data: TraceData, records: list[dict], name: str) -> list[int] | None:
    """The counter ``name`` summed over each request's span records (a
    record's start in ns on the profiler's clock); None when no record of
    the log starts inside a request."""
    reqs = requests(data)
    out = [0] * len(reqs)
    seen = False
    for rec in records:
        i = request_of(reqs, rec["start_ns"] / 1e3)
        if i is not None:
            seen = True
            out[i] += rec["counters"].get(name, 0)
    return out if seen else None


def program_log() -> list[dict] | None:
    """The program's span log, or None where the program keeps none."""
    try:
        from gf2bv_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if callable(read) else None

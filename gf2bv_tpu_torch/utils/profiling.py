"""Observability: phase timers, spans and counters, ``torch.profiler`` traces.

Port of ``gf2bv_tpu/utils/profiling.py``.  The reference has no in-library
tracing (SURVEY.md §5), only the examples' wall-clock prints.  Here the
solver's phases are recorded on a module-level collector for tooling
(``ops/solver.solve``: ``solve[{backend}]``; ``ops/gauss_blocked.
solve_blocked``: ``pad``, ``h2d``, then ``solve_on_device``'s
``rref+origin`` / ``rref`` and ``extract``), and any region can be traced
with :func:`device_trace`.

Spans and counters.  Tracing is on exactly while a ``torch.profiler``
profile is active (the benchmark's traced run, :func:`device_trace`).
Then :func:`span` opens a profiler range ``gf2bv.<name>`` (the record
function behind ``torch.profiler.record_function``), so the span lies on
the profiler's timeline, and on exit appends a record to an
in-memory log (:func:`spans`): the name, start and end in
``time.time_ns()`` (the clock of the profiler's host events), its own id,
its parent's id, the request id (the id of the outermost span open when it
started: the spans of one call share it) and its counters.  :func:`count`
adds to the innermost open span's counters (a count with no span open is
not kept).  Off, a span is one flag read and a shared no-op context
manager, and a count one flag read.  Every :func:`phase` is also a span.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from array import array
from collections import defaultdict

import torch.autograd.profiler as _autograd_profiler

try:  # the profiler's range without record_function's Python wrapper: ~1 µs, not ~10
    from torch._C._profiler import _RecordFunctionFast as record_function
except ImportError:
    from torch.autograd.profiler import record_function

_phase_totals: dict[str, float] = defaultdict(float)
_phase_counts: dict[str, int] = defaultdict(int)

LOG_RECORDS = 65536  # the span log keeps the newest records
_FIELDS = ("start_ns", "end_ns", "id", "parent", "request")


class _Ring:
    """The span log: the newest ``size`` records in plain columns, so that a
    record keeps no object that the garbage collector tracks (one dict a
    record set off a collection every request or so, each of tens of ms in
    a process holding a captured model).  Only a span that counted keeps a
    dict of its counters."""

    def __init__(self, size: int):
        self.size = size
        self.names: list = [None] * size
        self.cols = array("q", bytes(8 * len(_FIELDS) * size))
        self.counters: dict[int, dict[str, int]] = {}  # slot -> counters
        self.written = 0

    def append(self, name, start_ns, end_ns, sid, parent, request, counters) -> None:
        slot = self.written % self.size
        self.written += 1
        self.names[slot] = name
        at = len(_FIELDS) * slot
        cols = self.cols
        cols[at], cols[at + 1], cols[at + 2], cols[at + 3], cols[at + 4] = (
            start_ns, end_ns, sid, parent, request)
        if counters:
            self.counters[slot] = counters
        else:
            self.counters.pop(slot, None)

    def records(self) -> list[dict]:
        first = max(0, self.written - self.size)
        out = []
        for k in range(first, self.written):
            slot = k % self.size
            rec = dict(zip(_FIELDS, self.cols[len(_FIELDS) * slot: len(_FIELDS) * (slot + 1)]))
            rec["name"] = self.names[slot]
            rec["parent"] = rec["parent"] or None
            rec["counters"] = dict(self.counters.get(slot, {}))
            out.append(rec)
        return out

    def dropped(self) -> int:
        return max(0, self.written - self.size)


_log = _Ring(LOG_RECORDS)
_next_id = 0
_stack: list = []  # the open spans, innermost last
_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "start_ns", "counters", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _next_id
        _next_id += 1
        self.id = _next_id
        outer = _stack[-1] if _stack else None
        self.parent = outer.id if outer else 0
        self.request = outer.request if outer else self.id
        self.counters = None
        self._rf = record_function(f"gf2bv.{self.name}")
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        _stack.append(self)
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _stack.pop()
        self._rf.__exit__(*exc)
        _log.append(self.name, self.start_ns, end_ns, self.id, self.parent, self.request,
                    self.counters)
        return False


def span(name: str):
    """A context manager around a stage of the program: a ``gf2bv.<name>``
    range on the profiler's timeline and a record in :func:`spans` while a
    profiler runs, a shared no-op otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span, while a
    profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    if _stack:
        inner = _stack[-1]
        if inner.counters is None:
            inner.counters = {}
        inner.counters[name] = inner.counters.get(name, 0) + n


def spans() -> list[dict]:
    """The span log, oldest first: at most :data:`LOG_RECORDS` records, each
    ``{"name", "start_ns", "end_ns", "id", "parent", "request", "counters"}``
    (``parent`` None for an outermost span)."""
    return _log.records()


def spans_dropped() -> int:
    """Records the log dropped, the oldest first, to keep its bound."""
    return _log.dropped()


@contextlib.contextmanager
def phase(name: str):
    """Record wall-clock for a named phase (cumulative); also a span."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        _phase_totals[name] += dt
        _phase_counts[name] += 1


def phase_report() -> dict[str, dict[str, float]]:
    return {
        k: {"total_s": _phase_totals[k], "count": _phase_counts[k]}
        for k in sorted(_phase_totals)
    }


def reset():
    """Clear the phases, the span log and its count of dropped records."""
    global _log
    _phase_totals.clear()
    _phase_counts.clear()
    _log = _Ring(_log.size)


def _append_spans(path: str, records: list[dict], dropped: int) -> None:
    """Add ``{"gf2bv_spans": {"records", "dropped"}}`` as a top-level key of
    the Chrome trace at ``path`` (a JSON object), in place."""
    extra = json.dumps({"records": records, "dropped": dropped})
    with open(path, "rb+") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(max(0, size - 4096))
        tail = f.read()
        at = tail.rfind(b"}")
        if at < 0:
            raise ValueError(f"{path} does not end in a JSON object")
        f.seek(size - len(tail) + at)
        f.truncate()
        f.write(f', "gf2bv_spans": {extra}}}'.encode())


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None):
    """``torch.profiler`` trace around a region: set ``GF2BV_TPU_TRACE_DIR``
    or pass ``trace_dir`` to enable, no-op otherwise.  The host's activity
    is always recorded, the card's when CUDA is present (the region is
    synchronised before the profiler stops); the Chrome trace is written
    into the directory as ``gf2bv_trace_<pid>_<ns>.json``, with the region's
    span records (:func:`spans`, counters included) under its top-level key
    ``gf2bv_spans``."""
    trace_dir = trace_dir or os.environ.get("GF2BV_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    first_id, dropped = _next_id, spans_dropped()
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(trace_dir, f"gf2bv_trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _append_spans(path, [r for r in spans() if r["id"] > first_id], spans_dropped() - dropped)

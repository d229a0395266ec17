"""Observability: phase timers and optional ``torch.profiler`` traces.

Port of ``gf2bv_tpu/utils/profiling.py``.  The reference has no in-library
tracing (SURVEY.md §5), only the examples' wall-clock prints.  Here the
solver's phases are recorded on a module-level collector for tooling
(``ops/solver.solve``: ``solve[{backend}]``; ``ops/gauss_blocked.
solve_blocked``: ``pad``, ``h2d``, then ``solve_on_device``'s
``rref+origin`` / ``rref`` and ``extract``), and any region can be traced
with :func:`device_trace`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

_phase_totals: dict[str, float] = defaultdict(float)
_phase_counts: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def phase(name: str):
    """Record wall-clock for a named phase (cumulative)."""
    t0 = time.perf_counter()
    try:
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
    _phase_totals.clear()
    _phase_counts.clear()


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None):
    """``torch.profiler`` trace around a region: set ``GF2BV_TPU_TRACE_DIR``
    or pass ``trace_dir`` to enable, no-op otherwise.  The host's activity
    is always recorded, the card's when CUDA is present (the region is
    synchronised before the profiler stops); the Chrome trace is written
    into the directory as ``gf2bv_trace_<pid>_<ns>.json``."""
    trace_dir = trace_dir or os.environ.get("GF2BV_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"gf2bv_trace_{os.getpid()}_{time.time_ns()}.json")
    )

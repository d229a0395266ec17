"""The reader of ``scan_subset_share`` (metrics/scan_subset_share.py) on a
synthetic trace and span log: the subset's panels over the panels scanned,
summed over the traced requests, records outside them left out, and no
value where the program counts no scanned panels."""

import pytest

from benchmark.harness import cells, spans
from benchmark.harness.core import RunContext
from benchmark.harness.trace import Interval, TraceData


def _read(ctx):
    return cells.load_module("metrics", "scan_subset_share").read(ctx)


def _ctx():
    host = [Interval("bench.request", 100.0, 400.0), Interval("bench.request", 500.0, 800.0)]
    return RunContext(setup_s=1.0, kind="cpu", shape={},
                      trace=TraceData(Interval("bench.window", 0.0, 1000.0), [], host))


def _log(subset):
    """Two requests of two eliminations of 79 panels each, ``subset`` of each
    elimination's panels decided by the subset; a first call in set-up, all
    79 decided, is left out."""
    log = [{"name": "rref+origin", "start_ns": 50_000,
            "counters": {"rref_calls": 1, "scan_panels": 79, "scan_subset_panels": 79}}]
    for req in (100, 500):
        for k in range(2):
            log.append({"name": "rref+origin", "start_ns": (req + 10 + 50 * k) * 1000,
                        "counters": {"rref_calls": 1, "rref_graph_replays": 1,
                                     "scan_panels": 79, "scan_subset_panels": subset}})
    return log


@pytest.mark.parametrize("subset,share", [(79, 1.0), (78, 78 / 79), (1, 1 / 79), (0, 0.0)])
def test_scan_subset_share_is_subset_panels_over_panels(monkeypatch, subset, share):
    monkeypatch.setattr(spans, "program_log", lambda: _log(subset))
    assert _read(_ctx()) == pytest.approx(share)


def test_mode1_eliminations_count_alike(monkeypatch):
    log = [{"name": "rref", "start_ns": (req + 10) * 1000,
            "counters": {"rref_full_calls": 1, "scan_panels": 33, "scan_subset_panels": n}}
           for req, n in ((100, 33), (500, 32))]
    monkeypatch.setattr(spans, "program_log", lambda: log)
    assert _read(_ctx()) == pytest.approx(65 / 66)


@pytest.mark.parametrize("log", [
    None,  # a program that keeps no span log
    [],
    [{"name": "rref+origin", "start_ns": 110_000, "counters": {"rref_calls": 1}}],  # the parent
    [{"name": "rref+origin", "start_ns": 50_000,
      "counters": {"scan_panels": 79, "scan_subset_panels": 78}}],  # set-up only
])
def test_no_scanned_panels_read_none(monkeypatch, log):
    monkeypatch.setattr(spans, "program_log", lambda: log)
    assert _read(_ctx()) is None
    assert _read(RunContext(setup_s=1.0, kind="cpu", shape={})) is None

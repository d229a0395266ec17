"""The reader of ``rref_graph_share`` (metrics/rref_graph_share.py) on a
synthetic trace and span log: replays over calls summed over the traced
requests, records outside them left out, and no value where the program
counts no calls."""

import pytest

from benchmark.harness import cells, spans
from benchmark.harness.core import RunContext
from benchmark.harness.trace import Interval, TraceData


def _read(ctx):
    return cells.load_module("metrics", "rref_graph_share").read(ctx)


def _ctx():
    host = [Interval("bench.request", 100.0, 400.0), Interval("bench.request", 500.0, 800.0)]
    return RunContext(setup_s=1.0, kind="cpu", shape={},
                      trace=TraceData(Interval("bench.window", 0.0, 1000.0), [], host))


def _log(replayed):
    """Two requests of four eliminations each, the first ``replayed`` of
    each replayed from a graph; a capture before the requests (set-up) is
    left out."""
    log = [{"name": "rref+origin", "start_ns": 50_000,
            "counters": {"rref_calls": 1, "rref_graph_captures": 1, "rref_graph_replays": 1}}]
    for req in (100, 500):
        for k in range(4):
            counters = {"rref_calls": 1}
            if k < replayed:
                counters["rref_graph_replays"] = 1
            log.append({"name": "rref+origin", "start_ns": (req + 10 + 50 * k) * 1000,
                        "counters": counters})
    return log


@pytest.mark.parametrize("replayed,share", [(4, 1.0), (2, 0.5), (0, 0.0)])
def test_rref_graph_share_is_replays_over_calls(monkeypatch, replayed, share):
    monkeypatch.setattr(spans, "program_log", lambda: _log(replayed))
    assert _read(_ctx()) == pytest.approx(share)


@pytest.mark.parametrize("log", [
    None,  # a program that keeps no span log
    [],
    [{"name": "rref+origin", "start_ns": 110_000, "counters": {}}],  # no counters: the parent
    [{"name": "rref+origin", "start_ns": 50_000, "counters": {"rref_calls": 1}}],  # set-up only
])
def test_no_calls_read_none(monkeypatch, log):
    monkeypatch.setattr(spans, "program_log", lambda: log)
    assert _read(_ctx()) is None
    assert _read(RunContext(setup_s=1.0, kind="cpu", shape={})) is None

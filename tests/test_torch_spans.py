"""The port's spans and counters (gf2bv_tpu_torch/utils/profiling.py) on the
CPU: off without a profiler (a shared no-op, no ``record_function``, no
record), on under ``torch.profiler`` (a record per span with its parent,
request and counters, each on the profiler's timeline as ``gf2bv.<name>``),
the panel loop's spans, the log's bound, and ``device_trace``'s copy of the
records."""

import gc
import json

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gf2bv_tpu_torch import LinearSystem
from gf2bv_tpu_torch.core import words
from gf2bv_tpu_torch.ops import solver
from gf2bv_tpu_torch.utils import profiling

from test_solver import random_system

torch.set_num_threads(2)

COLS = 600  # three panels of 256 columns


def _profiled(fn):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.spans(), prof.profiler.kineto_results.events()


def _solve_blocked(seed=1):
    eqs, _ = random_system(np.random.default_rng(seed), 700, COLS)
    return solver.solve(eqs, COLS, 0, "blocked", device="cpu")


def test_off_is_a_shared_noop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    profiling.reset()
    assert profiling.span("x") is profiling.span("y") is profiling._NOOP
    with profiling.span("x"):
        profiling.count("c", 3)
    with profiling.phase("p"):
        profiling.count("c")
    assert _solve_blocked() is not None
    assert profiling.spans() == [] and profiling.spans_dropped() == 0
    assert profiling.phase_report()["p"]["count"] == 1


def test_phases_are_spans_and_the_report_is_unchanged():
    _, recs, events = _profiled(lambda: (_solve_blocked(), _solve_blocked(2)))
    names = [r["name"] for r in recs]
    for phase in ("solve[blocked]", "pad", "h2d", "rref+origin"):
        assert names.count(phase) == 2
        assert profiling.phase_report()[phase]["count"] == 2
    assert {e.name() for e in events} >= {"gf2bv.solve[blocked]", "gf2bv.rref+origin"}


def test_panels_requests_and_the_profilers_events():
    _, recs, events = _profiled(lambda: (_solve_blocked(), _solve_blocked(2)))
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["solve[blocked]"] * 2
    # one request id per call, another for the next call
    assert {r["request"] for r in recs} == {r["id"] for r in roots}
    for r in recs:
        assert by_id[r["request"]]["parent"] is None
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["request"] == r["request"]
            assert p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"]
    panels = [r for r in recs if r["name"] == "panel"]
    assert len(panels) == 2 * 3
    for p in panels:
        assert by_id[p["parent"]]["name"] == "rref+origin"
        kids = sorted(r["name"] for r in recs if r["parent"] == p["id"])
        assert kids == ["panel.rebuild", "panel.scan", "panel.update"]
    # every record on the profiler's timeline under its gf2bv. name, its
    # start on the same clock
    starts: dict[str, list[int]] = {}
    for e in events:
        if e.name().startswith("gf2bv.") and e.device_type() == DeviceType.CPU:
            starts.setdefault(e.name(), []).append(e.start_ns())
    for name, got in starts.items():
        logged = sorted(r["start_ns"] for r in recs if "gf2bv." + r["name"] == name)
        assert len(logged) == len(got), name
        for a, b in zip(logged, sorted(got)):
            assert abs(a - b) < 2_000_000, name
    assert set(starts) == {"gf2bv." + r["name"] for r in recs}


def test_counters_go_to_the_innermost_span():
    def work():
        profiling.count("c")  # no span open: not kept
        with profiling.span("outer"):
            profiling.count("c")
            with profiling.span("inner"):
                profiling.count("c", 2)
                profiling.count("d")
            profiling.count("c", 4)

    _, recs, _ = _profiled(work)
    got = {r["name"]: r["counters"] for r in recs}
    assert got == {"inner": {"c": 2, "d": 1}, "outer": {"c": 5}}


def test_h2d_copies_count_copies_to_a_cuda_device_only(monkeypatch):
    moved = []
    monkeypatch.setattr(torch.Tensor, "to", lambda self, dev: moved.append(dev) or self)

    def work():
        with profiling.span("copy"):
            words.to_device(torch.zeros(3), "cpu")
            words.to_device(torch.zeros(3), torch.device("cuda", 0))
            words.to_device(torch.zeros(3), "cuda")

    _, recs, _ = _profiled(work)
    assert recs[0]["counters"] == {"h2d_copies": 2}
    assert len(moved) == 3


def test_captured_solve_binds_inside_its_root():
    lin = LinearSystem([16, 16], device="cpu")
    tmpl = lin.capture(lambda w, p: [(w[0] ^ w[1]) ^ p[0], w[1] ^ p[1]])
    sol, recs, _ = _profiled(lambda: tmpl.solve_one([0x1234, 0x00FF]))
    assert sol is not None and sol[1] == 0x00FF and sol[0] ^ sol[1] == 0x1234
    root = next(r for r in recs if r["parent"] is None)
    assert root["name"] == "capture.solve"
    bind = next(r for r in recs if r["name"] == "lazy.bind")
    assert bind["parent"] == root["id"] and bind["request"] == root["id"]


def test_the_log_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(profiling, "_log", profiling._Ring(4))

    def work():
        for i in range(6):
            with profiling.span(f"s{i}"):
                pass

    _, recs, _ = _profiled(work)
    assert [r["name"] for r in recs] == ["s2", "s3", "s4", "s5"]
    assert profiling.spans_dropped() == 2
    profiling.reset()
    assert profiling.spans() == [] and profiling.spans_dropped() == 0


def test_records_keep_no_object_the_collector_tracks():
    """A record of the log allocates no object that counts toward the
    garbage collector's next collection (a span that counted keeps one
    dict)."""
    def work():
        gc.disable()
        try:
            before = gc.get_count()[0]
            for _ in range(3000):
                with profiling.span("a"):
                    with profiling.span("b"):
                        pass
            return gc.get_count()[0] - before
        finally:
            gc.enable()

    grown, recs, _ = _profiled(work)
    assert len(recs) == 6000 and grown < 100


def test_device_trace_writes_the_records_into_its_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        _solve_blocked()
    (trace,) = tmp_path.iterdir()
    data = json.loads(trace.read_text())
    assert data["traceEvents"]
    log = data["gf2bv_spans"]
    assert log["dropped"] == 0
    names = [r["name"] for r in log["records"]]
    assert names.count("panel") == 3 and names.count("solve[blocked]") == 1
    assert {e.get("name") for e in data["traceEvents"]} >= {"gf2bv.panel", "gf2bv.rref+origin"}


def test_nothing_is_kept_outside_a_profile():
    """A span opened before a profile stays a no-op once it starts, a span
    open when it stops is still logged, and a span after it is a no-op."""
    profiling.reset()
    with profiling.span("before"):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("inside"):
                pass
            straddles = profiling.span("straddles")
            straddles.__enter__()
        straddles.__exit__(None, None, None)
    with profiling.span("after"):
        pass
    assert [r["name"] for r in profiling.spans()] == ["inside", "straddles"]

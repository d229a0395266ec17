"""The readers of the program's spans and counters (metrics/prepare_ms,
panel_host_us, loop_idle_ms, torch_calls_per_panel, h2d_copies_per_solve)
on a synthetic trace and span log: each definition, spans outside the
traced requests left out, and None where the program left no spans."""

import pytest

from benchmark.harness import cells, spans
from benchmark.harness.core import RunContext
from benchmark.harness.trace import Interval, TraceData

READERS = ("prepare_ms", "panel_host_us", "loop_idle_ms", "torch_calls_per_panel",
           "h2d_copies_per_solve")


def _read(name, ctx):
    return cells.load_module("metrics", name).read(ctx)


def _ctx(host, device=()):
    data = TraceData(Interval("bench.window", 0.0, 1000.0), device=list(device), host=host)
    return RunContext(setup_s=1.0, kind="cpu", shape={}, trace=data)


def _iv(name, s, e):
    return Interval(name, float(s), float(e))


# two requests; the spans at 10-90 µs belong to none (the profiler's start-up)
HOST = [
    _iv("bench.request", 100, 400), _iv("bench.request", 500, 800),
    _iv("gf2bv.mt.build", 10, 40), _iv("gf2bv.panel", 50, 90), _iv("aten::empty", 55, 60),
    _iv("gf2bv.mt.solve", 105, 398), _iv("gf2bv.mt.build", 110, 150),
    _iv("gf2bv.rref+origin", 160, 390),
    _iv("gf2bv.panel", 170, 250), _iv("gf2bv.panel.scan", 171, 205),
    _iv("aten::clone", 175, 200), _iv("aten::empty_like", 180, 190), _iv("aten::copy_", 191, 199),
    _iv("aten::transpose", 210, 220),
    _iv("gf2bv.panel", 260, 380), _iv("aten::where", 270, 280), _iv("aten::slice", 385, 388),
    _iv("gf2bv.capture.solve", 505, 795), _iv("gf2bv.lazy.bind", 510, 530),
    _iv("gf2bv.rref+origin", 540, 790), _iv("gf2bv.panel", 550, 700),
]
DEVICE = [_iv("scan", 20, 30), _iv("scan", 170, 200), _iv("update", 190, 210),
          _iv("scan", 300, 350), _iv("scan", 560, 600), _iv("Memcpy HtoD", 395, 410)]


def test_prepare_ms_sums_build_and_bind_per_request():
    assert _read("prepare_ms", _ctx(HOST, DEVICE)) == pytest.approx((40 + 20) / 1000 / 2)


def test_panel_host_us_is_the_mean_panel():
    assert _read("panel_host_us", _ctx(HOST, DEVICE)) == pytest.approx((80 + 120 + 150) / 3)


def test_loop_idle_ms_is_the_idle_time_inside_the_elimination():
    # first elimination 160-390: busy 170-210 and 300-350; second 540-790: 560-600
    idle = (230 - 40 - 50) + (250 - 40)
    assert _read("loop_idle_ms", _ctx(HOST, DEVICE)) == pytest.approx(idle / 1000 / 2)


def test_torch_calls_per_panel_counts_outermost_calls_inside_panels():
    # panel 1: clone (its empty_like and copy_ inside it) and transpose;
    # panel 2: where (the slice ends past it); panel 3: none
    assert _read("torch_calls_per_panel", _ctx(HOST, DEVICE)) == pytest.approx((2 + 1 + 0) / 3)


def test_h2d_copies_per_solve_sums_a_requests_records(monkeypatch):
    log = [
        {"name": "mt.build", "start_ns": 12_000, "counters": {"h2d_copies": 100}},
        {"name": "mt.build", "start_ns": 111_000, "counters": {"h2d_copies": 3}},
        {"name": "mt.solve", "start_ns": 106_000, "counters": {"h2d_copies": 2}},
        {"name": "lazy.bind", "start_ns": 511_000, "counters": {}},
        {"name": "capture.solve", "start_ns": 506_000, "counters": {}},
    ]
    monkeypatch.setattr(spans, "program_log", lambda: log)
    assert _read("h2d_copies_per_solve", _ctx(HOST, DEVICE)) == pytest.approx((5 + 0) / 2)
    monkeypatch.setattr(spans, "program_log", lambda: log[:1])  # none inside a request
    assert _read("h2d_copies_per_solve", _ctx(HOST, DEVICE)) is None


@pytest.mark.parametrize("name", READERS)
def test_no_spans_read_none(name, monkeypatch):
    monkeypatch.setattr(spans, "program_log", lambda: None)
    plain = [iv for iv in HOST if not iv.name.startswith("gf2bv.")]
    assert _read(name, _ctx(plain, DEVICE)) is None
    assert _read(name, RunContext(setup_s=1.0, kind="cpu", shape={})) is None


def test_program_log_reads_the_programs_spans():
    from gf2bv_tpu_torch.utils import profiling

    assert spans.program_log() == profiling.spans()

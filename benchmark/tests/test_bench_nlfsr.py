"""The ``nlfsr128`` configuration's pieces: the plain reference's victims
replay their keystreams, its judge counts every wrong state, a run of the
cell at 24 bits on the CPU comes out correct and its control does not, and
the four readers of the cell's per-layer metrics (rref_full_graph_share,
rref_full_idle_ms, quad_select_ms, mode1_roofline) on synthetic traces."""

import time

import pytest

from benchmark.harness import cells, core, spans, traffic
from benchmark.harness.trace import Interval, TraceData

REF = cells.load_module("reference", "nlfsr128")
ENTRY = cells.load_module("entries", "nlfsr_selected_solve_one")
CFG = cells.load_json(cells.BENCH_DIR / "configs" / "nlfsr128.json")
MIX = cells.load_json(cells.BENCH_DIR / "traffic" / "attack.json")
SEED = 2**31 + 1234567


def _plain_keystream(cfg, secret, steps):
    """The register and the combiner on Python integers."""
    width, taps = cfg["width"], int(cfg["taps"], 16)
    s, out = secret, []
    for _ in range(steps):
        s = (s >> 1) ^ (taps if s & 1 else 0)
        s &= (1 << width) - 1
        x = [(s >> p) & 1 for p in cfg["select"]]
        bit = 0
        for mono in cfg["combiner"]:
            term = 1
            for i in mono:
                term &= x[i]
            bit ^= term
        out.append(bit)
    return out


def test_victims_replay_their_keystreams():
    seeds = traffic.victim_seeds(SEED, 0, 5)
    vs = REF.make_victims(CFG, {"outputs": 600}, seeds)
    assert len({v.secret for v in vs}) == 5
    for v in vs:
        assert 0 < v.secret < 2**128 and v.secret.bit_length() > 64
        assert v.observed.tolist() == _plain_keystream(CFG, v.secret, 600)
    one = REF.make_victims(CFG, {"outputs": 600}, seeds[2:3])[0]
    assert one.secret == vs[2].secret and (one.observed == vs[2].observed).all()
    full = REF.make_victims(CFG, MIX, seeds[:1])[0]
    assert full.observed.shape == (17384,) and abs(int(full.observed.sum()) - 8692) < 400


def test_judge_counts_every_wrong_state():
    vs = REF.make_victims(CFG, {"outputs": 64}, traffic.victim_seeds(SEED, 0, 4))
    right = [v.secret for v in vs]
    assert REF.judge(CFG, MIX, vs, right) == {"wrong_states": 0}
    assert REF.judge(CFG, MIX, vs, [right[0] ^ 1 << 100] + right[1:]) == {"wrong_states": 1}
    assert REF.judge(CFG, MIX, vs, [None, None] + right[2:]) == {"wrong_states": 2}
    assert REF.LIMITS == {"wrong_states": 0}


def test_shape_and_the_common_buckets():
    assert REF.shape(CFG, MIX) == {"rows": 8692, "cols": 8256}
    assert CFG["unknowns"] == 8256 and CFG["outputs"] == MIX["outputs"] == 17384
    assert ENTRY._common_buckets(17384, 256) == [8704, 8960]
    assert ENTRY._common_buckets(CFG["control"]["keep_outputs"], 256) == [8192, 8448]


def _small_cell():
    """The cell at 24 bits and 2^12 outputs, so the CPU runs it."""
    cell = cells.resolve(cells.load_benchmark(), "nlfsr128.attack")
    cell.config = {**cell.config, "width": 24, "taps": "0xE10000",
                   "select": [3, 7, 11, 15, 19], "control": {"keep_outputs": 400}}
    cell.traffic = {**cell.traffic, "outputs": 2**12, "warmup": 1, "trace_requests": 2}
    return cell


@pytest.mark.parametrize("control", [False, True])
def test_a_small_run_on_the_cpu_is_judged(control):
    result, numbers = core.run_cell(_small_cell(), SEED, 0.5, False, "cpu", time.perf_counter(),
                                    control=control)
    assert result["attempted"] >= 1
    assert result["failed"] == 0
    if control:  # too few equations: the space's origin, which is not always the secret
        assert not result["correct"] and numbers["wrong_states"][0] > 0
    else:
        assert result["correct"]
        assert numbers["wrong_states"] == (0, 0)


# -- the readers --------------------------------------------------------------------------


def _read(name, ctx):
    return cells.load_module("metrics", name).read(ctx)


def _iv(name, s, e):
    return Interval(name, float(s), float(e))


HOST = [
    _iv("bench.request", 100, 400), _iv("bench.request", 500, 800),
    _iv("gf2bv.quad.select", 10, 40), _iv("gf2bv.rref", 45, 90),  # set-up: left out
    _iv("gf2bv.quad.select", 105, 125), _iv("gf2bv.rref", 130, 200),
    _iv("gf2bv.extract", 200, 300), _iv("gf2bv.quad.filter", 310, 320),
    _iv("gf2bv.quad.select", 505, 535), _iv("gf2bv.rref", 540, 640),
]
DEVICE = [_iv("scan", 20, 60), _iv("scan", 150, 190), _iv("update", 560, 600),
          _iv("at::native::copy", 600, 630), _iv("Memcpy HtoD", 110, 120)]


def _ctx(host=HOST, device=DEVICE, rows=8692, cols=8256, kind="NVIDIA H100 80GB HBM3"):
    data = TraceData(_iv("bench.window", 0, 1000), device=list(device), host=list(host))
    data.rows = sorted(((iv.end - iv.start, iv.name, 1) for iv in device), reverse=True)
    ctx = core.RunContext(setup_s=1.0, kind=kind, shape={"rows": rows, "cols": cols},
                          trace=data)
    ctx.requests = [core.Request(0.3, {}), core.Request(0.3, {})]
    return ctx


def test_quad_select_ms_is_the_selection_per_request():
    assert _read("quad_select_ms", _ctx()) == pytest.approx((20 + 30) / 1000 / 2)


def test_rref_full_idle_ms_is_the_idle_time_inside_the_full_elimination():
    # 130-200: busy 150-190; 540-640: busy 560-630
    assert _read("rref_full_idle_ms", _ctx()) == pytest.approx((30 + 30) / 1000 / 2)


def test_mode1_roofline_counts_the_full_width_work():
    m = cells.load_module("metrics", "mode1_roofline")
    rows, kw, words, panels = 8692, 8, 259, 33
    per_panel = 4 * rows * kw + 4 * (2 * rows * words + rows * kw + 32 * kw * words)
    assert m.full_rref_bytes(8692, 8256) == panels * per_panel
    own_s = (40 + 40 + 40) / 1e6 / 2  # the program's kernels; copies and at:: left out
    want = 100 * (panels * per_panel / 3.35e12) / own_s
    assert _read("mode1_roofline", _ctx()) == pytest.approx(want)
    assert _read("mode1_roofline", _ctx(kind="cpu")) is None


def _log(replayed):
    """Two requests of one full elimination each, the first ``replayed``
    replayed; a capture in set-up is left out."""
    log = [{"name": "rref", "start_ns": 50_000,
            "counters": {"rref_full_calls": 1, "rref_full_graph_captures": 1}}]
    for k, req in enumerate((100, 500)):
        counters = {"rref_full_calls": 1}
        if k < replayed:
            counters["rref_full_graph_replays"] = 1
        log.append({"name": "rref", "start_ns": (req + 30) * 1000, "counters": counters})
    return log


@pytest.mark.parametrize("replayed,share", [(2, 1.0), (1, 0.5), (0, 0.0)])
def test_rref_full_graph_share_is_replays_over_calls(monkeypatch, replayed, share):
    monkeypatch.setattr(spans, "program_log", lambda: _log(replayed))
    assert _read("rref_full_graph_share", _ctx()) == pytest.approx(share)


@pytest.mark.parametrize("name", ["quad_select_ms", "rref_full_idle_ms", "mode1_roofline",
                                  "rref_full_graph_share"])
def test_a_program_without_the_spans_reads_none(monkeypatch, name):
    """What the parent shows: no spans, no counters, or no trace at all."""
    monkeypatch.setattr(spans, "program_log", lambda: [
        {"name": "rref+origin", "start_ns": 110_000, "counters": {"rref_calls": 1}}])
    plain = [iv for iv in HOST if not iv.name.startswith("gf2bv.")]
    if name == "mode1_roofline":
        assert _read(name, _ctx(device=[_iv("at::native::copy", 600, 630)])) is None
    else:
        assert _read(name, _ctx(host=plain)) is None
    assert _read(name, core.RunContext(setup_s=1.0, kind="cpu", shape={})) is None


def test_entry_refuses_a_program_without_the_selection(monkeypatch):
    from gf2bv_tpu_torch import QuadraticSystem

    monkeypatch.delattr(QuadraticSystem, "select_rows")
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="select_rows"):
        ENTRY.setup(CFG, MIX, "cpu")
    assert time.perf_counter() - t < 5  # before the register's trace

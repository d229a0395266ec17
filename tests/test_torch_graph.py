"""The eliminations replayed from a CUDA graph: mode 0's
(``gauss_blocked.rref_origin_blocked``) and mode 1's full RREF
(``gauss_blocked.rref_full_blocked``).  The routing on the CPU, and on the
card the replay against the eager body, results held across replays, the
launch accounting, and what the profiler sees.  Also, on the card, the
subset-first scan (``phase1.scan_subset``) that both bodies run: its kernels
against their twins, the eliminations against the full scan on every panel
(the plan the graph takes from a shape's first call), and its test on the
card inside a replay.

The card tests are marked ``cuda`` and skip without a CUDA device.  This
file imports neither JAX nor the JAX package, so it runs on a machine
without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graph.py
"""

import random
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.core import packing
from gf2bv_tpu_torch.ops import _cuda, gauss_blocked, gauss_ref
from gf2bv_tpu_torch.utils import profiling

torch.set_num_threads(2)

COUNTERS = ("rref_calls", "rref_graph_replays", "rref_graph_captures")
FULL_COUNTERS = ("rref_full_calls", "rref_full_graph_replays", "rref_full_graph_captures")


@pytest.fixture(autouse=True)
def _no_graphs():
    gauss_blocked.clear_graphs()
    yield
    gauss_blocked.clear_graphs()


def _counted(fn, counters=COUNTERS):
    """``fn()`` under a profiler; (its result, the ``counters`` summed over
    the span log)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    profiling.reset()
    with profile(activities=acts), profiling.span("request"):
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    recs = profiling.spans()
    return out, {c: sum(r["counters"].get(c, 0) for r in recs) for c in counters}


# -- the routing, on the CPU -----------------------------------------------------------


def _stand_in(device="cuda:0", shape=(20224, 640)):
    """What the gate reads of a matrix: its device and shape."""
    return SimpleNamespace(device=torch.device(device), shape=torch.Size(shape))


@pytest.mark.parametrize("case,a,p1,p2", [
    ("cpu tensor", _stand_in("cpu"), "pallas_scan", "mxu"),
    ("pallas_sub", _stand_in(), "pallas_sub", "mxu"),
    ("jnp", _stand_in(), "jnp", "mxu"),
    ("jnp interpret", _stand_in(), "jnp_interpret", "jnp"),
    ("not the current device", _stand_in("cuda:1"), "pallas_scan", "mxu"),
])
def test_the_gate_sends_these_to_the_eager_body(monkeypatch, case, a, p1, p2):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert gauss_blocked._graph_key(a, 19968, 256, p1, p2) is None, case


@pytest.mark.parametrize("p1,p2", [
    ("pallas_scan", "mxu"), ("pallas_scan_interpret", "mxu_interpret"),
    ("pallas_scan2", "mxu"), ("pallas_scanm", "mxu_noseg"), ("pallas", "mxu_la"),
    ("pallas_scan", "mxu4"), ("pallas_scan", "jnp"),
])
def test_the_gate_keys_a_cuda_matrix_by_shape_and_engines(monkeypatch, p1, p2):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    key = gauss_blocked._graph_key(_stand_in(), 19968, 256, p1, p2)
    base = lambda name: name.removesuffix("_interpret")  # noqa: E731
    assert key == (torch.device("cuda:0"), 20224, 640, 19968, 256, base(p1), base(p2), "rref")
    other = gauss_blocked._graph_key(_stand_in(shape=(67328, 640)), 19968, 256, p1, p2)
    assert other != key


@pytest.mark.parametrize("case,a,p1", [
    ("cpu tensor", _stand_in("cpu", (8960, 384)), "pallas_scan"),
    ("pallas_sub", _stand_in(shape=(8960, 384)), "pallas_sub"),
    ("jnp", _stand_in(shape=(8960, 384)), "jnp"),
])
def test_mode1_keys_by_the_same_gate_apart_from_mode0(monkeypatch, case, a, p1):
    """The full RREF's key is mode 0's with its own kind, and a matrix the
    gate sends to the eager body in mode 0 goes there in mode 1 too."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert gauss_blocked._graph_key(a, 8256, 256, p1, "mxu", "rref_full") is None, case
    a = _stand_in(shape=(8960, 384))
    full = gauss_blocked._graph_key(a, 8256, 256, "pallas_scan", "mxu", "rref_full")
    zero = gauss_blocked._graph_key(a, 8256, 256, "pallas_scan", "mxu")
    assert full[:-1] == zero[:-1] and (zero[-1], full[-1]) == ("rref", "rref_full")
    for key in (zero, full):
        gauss_blocked._record_seen(key)
    entries = [gauss_blocked._graph_for(key) for key in (zero, full)]
    assert entries[0] is not entries[1] and [e.kind for e in entries] == ["rref", "rref_full"]


def test_the_gate_refuses_an_unknown_engine_as_the_body_does(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="unknown phase1 engine"):
        gauss_blocked._graph_key(_stand_in(), 19968, 256, "nope", "mxu")


def test_a_keys_first_call_is_eager_its_second_captures():
    key = ("cuda:0", 20224, 640, 19968, 256, "pallas_scan", "mxu")
    assert gauss_blocked._graph_for(key) is None  # first call: eager
    gauss_blocked._record_seen(key)
    entry = gauss_blocked._graph_for(key)  # second: an entry to capture
    assert entry is not None and entry.graph is None
    assert gauss_blocked._graph_for(key) is entry
    assert key not in gauss_blocked._seen


def test_the_cache_keeps_the_most_recently_used_keys():
    keys = [("cuda:0", 256 * (k + 1), 640, 100, 256, "pallas_scan", "mxu")
            for k in range(gauss_blocked.GRAPH_KEYS + 2)]
    for key in keys:
        gauss_blocked._record_seen(key)
        gauss_blocked._graph_for(key)
    gauss_blocked._graph_for(keys[2])  # used again: kept
    gauss_blocked._record_seen(keys[0])
    gauss_blocked._graph_for(keys[0])
    assert list(gauss_blocked._graphs) == [keys[4], keys[5], keys[2], keys[0]]
    for k in range(2 * gauss_blocked._SEEN_KEYS):
        gauss_blocked._record_seen(("cuda:0", k))
    assert len(gauss_blocked._seen) == gauss_blocked._SEEN_KEYS
    gauss_blocked.clear_graphs()
    assert not gauss_blocked._graphs and not gauss_blocked._seen


def test_threads_get_one_entry_a_key():
    """Many threads calling the same shapes at once: each key's first calls
    run eager, and every later call of the key gets the one entry made."""
    keys = [("cuda:0", 256 * k) for k in range(gauss_blocked.GRAPH_KEYS)]
    got = {key: set() for key in keys}

    def worker():
        for _ in range(300):
            for key in keys:
                entry = gauss_blocked._graph_for(key)
                if entry is None:
                    gauss_blocked._record_seen(key)
                else:
                    got[key].add(entry)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert all(len(entries) == 1 for entries in got.values())


def _system(seed, rows, cols, unsat=False):
    """A padded (rows', wp) uint32 matrix of a random consistent system;
    ``unsat`` turns a padding row into 0 = 1.  Also the packed equations."""
    rng = np.random.default_rng(seed)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    bits = np.concatenate([((coeff @ secret) % 2)[:, None], coeff], axis=1)
    eqs = packing.pack_bits(bits, 1 + cols)
    a32 = gauss_blocked._pad(eqs, 256, word_align=128)
    if unsat:
        a32[-1, :] = 0
        a32[-1, 0] = 1
    return eqs, a32


@pytest.mark.parametrize("seed,rows,cols,unsat", [
    (1, 700, 600, False), (2, 320, 700, False), (3, 400, 300, True), (4, 900, 1100, False),
])
def test_cpu_runs_the_eager_body_and_keeps_no_graph(seed, rows, cols, unsat):
    eqs, a32 = _system(seed, rows, cols, unsat)
    a = u32_to_torch(a32, "cpu")
    want = gauss_blocked._rref_origin_eager(a, cols)
    for _ in range(3):  # a repeated shape stays eager on the CPU
        (origin, bad), counts = _counted(lambda: gauss_blocked.rref_origin_blocked(a, cols))
        assert torch.equal(origin, want[0]) and bool(bad) == bool(want[1]) == unsat
        assert counts == {"rref_calls": 1, "rref_graph_replays": 0, "rref_graph_captures": 0}
    assert np.array_equal(torch_to_u32(a), a32)  # the input is not modified
    assert not gauss_blocked._graphs and not gauss_blocked._seen
    if not unsat:
        ref = gauss_ref.solve_oracle(eqs, cols, mode=0)
        got = packing.from_u32(torch_to_u32(origin)[None, :])[0]
        assert np.array_equal(got, ref.origin)


# -- on the card -------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _mt_matrix(seed, samples, dev, unsat=False):
    """The padded MT19937 recovery matrix of a ``random.Random(seed)``
    victim's first ``samples`` outputs (``unsat``: a padding row set to
    0 = 1), and the victim's state words."""
    from gf2bv_tpu_torch.crypto import mt_torch

    rng = random.Random(seed)
    state = list(rng.getstate()[1][:624])
    outs = np.array([[rng.getrandbits(32)] for _ in range(samples)], dtype=np.uint32)
    a = mt_torch._padded_system(u32_to_torch(outs, dev), 32, samples)
    if unsat:
        a[-1].zero_()
        a[-1, 0] = 1
    return a, state


_SFMT_TEMPLATE = []


def _sfmt_matrix(seed, dev, unsat=False):
    """The matrix that a captured SFMT19937 model's ``solve_one`` hands to
    the elimination for a victim seeded with ``seed`` (2496 low-16 leaks
    after 3 x 624 draws)."""
    from gf2bv_tpu_torch import LinearSystem
    from gf2bv_tpu_torch.crypto.sfmt import SFMT19937
    from gf2bv_tpu_torch.ops import lazy_solve

    if not _SFMT_TEMPLATE:
        def model(words, p):
            sym = SFMT19937(list(words), index=624)
            return [(sym() & 0xFFFF) ^ p[k] for k in range(2496)]

        _SFMT_TEMPLATE.append(LinearSystem([32] * 624, device=dev).capture(model))
    victim = SFMT19937.from_seed(seed)
    for _ in range(3 * 624):
        victim()
    observed = [victim() & 0xFFFF for _ in range(2496)]
    seen = []
    real = lazy_solve.solve_on_device
    try:
        lazy_solve.solve_on_device = lambda a, *args, **kw: seen.append(a.clone())
        _SFMT_TEMPLATE[0].solve_one(observed)
    finally:
        lazy_solve.solve_on_device = real
    a = seen[0]
    if unsat:
        a[-1].zero_()
        a[-1, 0] = 1
    return a


def _matrix(system, seed, dev, unsat=False):
    if system == "sfmt2496":
        return _sfmt_matrix(seed, dev, unsat)
    return _mt_matrix(seed, int(system[2:]), dev, unsat)[0]


SYSTEMS = ["mt624", "sfmt2496", "mt2100"]
COLS = 19968


@pytest.mark.cuda
@pytest.mark.parametrize("system", SYSTEMS)
def test_replay_equals_the_eager_body_bit_for_bit(dev, system):
    """Three victims a system, the last unsatisfiable: each solved three
    times (the shape's first call runs eager, the second captures, then
    replays) against ``_rref_origin_eager`` on the same matrix."""
    calls = []
    for seed, unsat in ((11, False), (12, False), (13, True)):
        a = _matrix(system, seed, dev, unsat)
        keep = a.clone()
        want = gauss_blocked._rref_origin_eager(a, COLS)
        for _ in range(3):
            (origin, bad), counts = _counted(lambda: gauss_blocked.rref_origin_blocked(a, COLS))
            calls.append(counts)
            assert torch.equal(origin, want[0]) and bool(bad) == bool(want[1]) == unsat
        assert torch.equal(a, keep)  # the input is not modified
    assert [c["rref_graph_captures"] for c in calls] == [0, 1] + [0] * 7
    assert [c["rref_graph_replays"] for c in calls] == [0] + [1] * 8
    assert all(c["rref_calls"] == 1 for c in calls)
    assert len(gauss_blocked._graphs) == 1


@pytest.mark.cuda
def test_results_held_across_replays_keep_their_values(dev):
    from gf2bv_tpu_torch.crypto import mt_torch

    mats = [_mt_matrix(seed, 624, dev) for seed in (21, 22, 23)]
    for a, _ in mats[:2]:  # eager, then the capture
        gauss_blocked.rref_origin_blocked(a, COLS)
    first = gauss_blocked.rref_origin_blocked(mats[0][0], COLS)
    held = [t.clone() for t in first]
    second = gauss_blocked.rref_origin_blocked(mats[1][0], COLS)
    torch.cuda.synchronize()
    assert all(torch.equal(t, h) for t, h in zip(first, held))
    assert not torch.equal(first[0], second[0])
    rngs = [random.Random(seed) for seed in (31, 32, 33)]
    states = [list(r.getstate()[1][:624]) for r in rngs]
    outs = [[r.getrandbits(32) for _ in range(624)] for r in rngs]
    (got), counts = _counted(lambda: mt_torch.solve_mt19937_batch(outs, 32))
    assert [list(s) for s in got] == states
    assert counts == {"rref_calls": 3, "rref_graph_replays": 3, "rref_graph_captures": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("samples,launches", [(624, 393), (2100, 472)])
def test_a_replay_counts_one_solves_launches_and_a_capture_none(dev, samples, launches):
    """The eager call scans every panel subset-first; the graph scans panel 0,
    where the first call's subset missed, by the full scan alone: one subset
    kernel and one test fewer, and the same gated full scans."""
    a, _ = _mt_matrix(41, samples, dev)
    per_call = []
    for _ in range(3):  # eager, capture and replay, replay
        _cuda.reset_launches()
        gauss_blocked.rref_origin_blocked(a, COLS)
        per_call.append({k: n for k, n in _cuda.LAUNCHES.items() if n})
    print(f"{samples} outputs: {per_call[0]}")
    assert per_call[1] == per_call[2]
    assert {k: n - per_call[1].get(k, 0) for k, n in per_call[0].items()
            if n != per_call[1].get(k, 0)} == {"scan_subset": 1, "scan_subset_test": 1}
    assert per_call[1]["scan_subset"] == per_call[1]["scan_subset_test"] == 78
    assert sum(per_call[1].values()) == launches
    assert gauss_blocked._graphs[gauss_blocked._graph_key(a, COLS, 256, "pallas_scan", "mxu")
                                 ].launches == per_call[1]


@pytest.mark.cuda
def test_the_profiler_sees_every_kernel_of_a_replay(dev):
    """A replayed elimination under the profiler shows the same device rows,
    by name and count, as the eager body under it, and its own copies
    (the caller's matrix into the graph's input, the two outputs out of its
    pool, the subset's flags): ``device_ms`` and ``elimination_roofline``
    read the graph's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a, _ = _mt_matrix(51, 624, dev)
    for _ in range(2):
        gauss_blocked.rref_origin_blocked(a, COLS)
    torch.cuda.synchronize()

    def rows(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA:
                out[ev.name()] = out.get(ev.name(), 0) + 1
        return out

    _cuda.reset_launches()
    replayed = rows(lambda: gauss_blocked.rref_origin_blocked(a, COLS))
    assert sum(_cuda.LAUNCHES.values()) == 393
    plan = gauss_blocked._graphs[gauss_blocked._graph_key(a, COLS, 256, "pallas_scan", "mxu")].plan
    eager = rows(lambda: gauss_blocked._rref_origin_body(a, plan, COLS, 256, "pallas_scan",
                                                         "mxu")[0])
    # the body's own copy of the matrix is a Memcpy row of the eager body; in
    # the graph its copy node runs as CUDA's own memcpy128 kernel or leaves
    # no row (both seen on the H100)
    node = replayed.pop("memcpy128", 0)
    assert node in (0, 1) and "memcpy128" not in eager
    ours = lambda r: {k: n for k, n in r.items()  # noqa: E731
                      if not k.startswith(("Memcpy", "Memset")) and "at::" not in k}
    print(f"replay: {sum(replayed.values())} device rows, {sum(ours(replayed).values())} "
          f"of the port's kernels, memcpy128 {node}; eager: {sum(eager.values())}")
    assert ours(replayed) == ours(eager) and sum(ours(eager).values()) >= 393
    extra = {k: replayed.get(k, 0) - eager.get(k, 0) for k in set(replayed) | set(eager)}
    # the replay's four copies: the matrix into the graph's input, the two
    # outputs out of its pool, and under the profiler the subset's flags
    # (scan_subset_panels, summed when the log is read)
    assert sum(n for k, n in replayed.items() if k.startswith("Memcpy")) == 4
    assert {k: n for k, n in extra.items() if n} == {"Memcpy DtoD (Device -> Device)": 3}


@pytest.mark.cuda
def test_paths_that_never_capture(dev):
    """A shape's first call, ``pallas_sub`` and ``jnp`` capture no graph;
    mode 1 leaves mode 0's counters alone."""
    from gf2bv_tpu_torch.crypto import mt_torch

    a, state = _mt_matrix(61, 624, dev)
    _, counts = _counted(lambda: gauss_blocked.rref_origin_blocked(a, COLS))
    assert counts["rref_graph_captures"] == 0 and not gauss_blocked._graphs
    gauss_blocked.clear_graphs()
    rng = random.Random(62)
    outs = [rng.getrandbits(32) for _ in range(624)]
    for _ in range(3):
        _, counts = _counted(lambda: mt_torch.solve_mt19937(outs, 32, mode=1))
        assert counts["rref_calls"] == 0
    gauss_blocked.clear_graphs()
    for p1, (seed, rows, cols) in (("pallas_sub", (1, 700, 600)), ("jnp", (2, 300, 200))):
        _, a32 = _system(seed, rows, cols)
        m = u32_to_torch(a32, dev)
        want = gauss_blocked._rref_origin_eager(m, cols, phase1=p1)
        for _ in range(3):
            (origin, _), counts = _counted(
                lambda: gauss_blocked.rref_origin_blocked(m, cols, phase1=p1))
            assert torch.equal(origin, want[0])
            assert counts == {"rref_calls": 1, "rref_graph_replays": 0, "rref_graph_captures": 0}
    assert not gauss_blocked._graphs and not gauss_blocked._seen


@pytest.mark.cuda
def test_threads_on_their_own_streams_share_one_graph(dev):
    """Four threads, each on a stream of its own, replay one shape's graph
    in turn with different victims: every result is the eager body's."""
    mats = [_mt_matrix(70 + k, 624, dev)[0] for k in range(6)]
    for a in mats[:2]:  # eager, then the capture
        gauss_blocked.rref_origin_blocked(a, COLS)
    want = [gauss_blocked._rref_origin_eager(a, COLS)[0].cpu() for a in mats]
    torch.cuda.synchronize()
    got, errors = [], []

    def worker(t):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for r in range(4):
                    k = (t + r) % len(mats)
                    origin, bad = gauss_blocked.rref_origin_blocked(mats[k], COLS)
                    got.append((k, origin.cpu(), bool(bad)))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(got) == 16
    for k, origin, bad in got:
        assert torch.equal(origin, want[k]) and not bad
    assert len(gauss_blocked._graphs) == 1


# -- mode 1 on the card: the NLFSR annihilator system ------------------------------------

NLFSR_TAPS = 0xD670201BAC7515352A273372B2A95B23
NLFSR_SELECT = (13, 24, 35, 46, 57)
NLFSR_STEPS = 2**14 + 1000
NLFSR_COLS = 128 + 128 * 127 // 2
_NLFSR = []


def _nlfsr_rows(dev):
    """Every step's annihilator row of the 128-bit filtered LFSR of
    upstream's examples/nlfsr.py, on the card, as a row selection."""
    if not _NLFSR:
        from gf2bv_tpu_torch import BitVec, LinearSystem, QuadraticSystem
        from gf2bv_tpu_torch.crypto.lfsr import GaloisLFSR
        from gf2bv_tpu_torch.ops import quad_device

        gens = BitVec.stack(LinearSystem([128], device=dev).gens(lazy=False))
        reg = GaloisLFSR(128, NLFSR_TAPS, gens)
        taps = ([], [], [])
        for _ in range(NLFSR_STEPS):
            reg()
            for bits, p in zip(taps, NLFSR_SELECT):
                bits.append(reg.state[p])
        f = [BitVec.stack(b) for b in taps]
        q = QuadraticSystem([128], device=dev)
        eqs = quad_device.quad_rows(q, [(f[0], f[1]), (f[1], f[2])], f, (1 << NLFSR_STEPS) - 1)
        _NLFSR.append(q.select_rows(eqs))
    return _NLFSR[0]


def _nlfsr_victim(seed):
    """A secret and its keystream (bool, one a step)."""
    from gf2bv_tpu_torch.crypto.lfsr import GaloisLFSR

    secret = random.Random(seed).getrandbits(128) | 1
    reg = GaloisLFSR(128, NLFSR_TAPS, secret)
    out = []
    for _ in range(NLFSR_STEPS):
        reg()
        x = [(reg.state >> p) & 1 for p in NLFSR_SELECT]
        out.append((x[0] & x[1]) ^ (x[0] & x[1] & x[3] & x[4]) ^ x[0] ^ x[1] ^ x[2])
    return secret, np.array(out, dtype=bool)


def _nlfsr_matrix(dev, bucket, seed):
    """A victim's selected matrix in the row bucket ``bucket``: the first
    ``bucket - 100`` rows of its keystream's ones, topped up with rows of
    its zeros where it has fewer ones (whose equations the secret need not
    meet: the system is then unsatisfiable).  Also whether it was topped
    up."""
    _, ks = _nlfsr_victim(seed)
    ones, zeros = np.flatnonzero(ks), np.flatnonzero(~ks)
    want = bucket - 100
    rows = ones[:want] if ones.size >= want else np.concatenate([ones, zeros[: want - ones.size]])
    keep = np.zeros(NLFSR_STEPS, dtype=bool)
    keep[rows] = True
    a = _nlfsr_rows(dev).select(keep)
    assert a.shape[0] == bucket
    return a, ones.size < want


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [8704, 8960])
def test_mode1_replay_equals_the_eager_body_bit_for_bit(dev, bucket):
    """Three victims a bucket (topped up with wrong rows where they have too
    few ones: unsatisfiable), the first solved three times (eager, capture, replay),
    against ``rref_blocked(trailing=False)`` on the same matrix: the RREF,
    the pivot map and the verdict."""
    calls, verdicts, topped = [], [], []
    for seed, times in ((81, 3), (82, 1), (83, 1)):
        a, wrong_rows = _nlfsr_matrix(dev, bucket, seed)
        topped.append(wrong_rows)
        keep = a.clone()
        want = gauss_blocked.rref_blocked(a, NLFSR_COLS, trailing=False)
        for _ in range(times):
            got, counts = _counted(lambda: gauss_blocked.rref_full_blocked(a, NLFSR_COLS),
                                   FULL_COUNTERS)
            calls.append(counts)
            assert len(got) == 3 and all(torch.equal(g, w) for g, w in zip(got, want))
        verdicts.append(bool(want[2]))
        assert torch.equal(a, keep)
    assert [c["rref_full_graph_captures"] for c in calls] == [0, 1, 0, 0, 0]
    assert [c["rref_full_graph_replays"] for c in calls] == [0, 1, 1, 1, 1]
    assert all(c["rref_full_calls"] == 1 for c in calls)
    assert verdicts == topped and any(verdicts)
    assert len(gauss_blocked._graphs) == 1


@pytest.mark.cuda
def test_mode1_results_held_across_replays_keep_their_values(dev):
    mats = [_nlfsr_matrix(dev, 8704, seed)[0] for seed in (91, 92)]
    for a in mats:  # eager, then the capture
        gauss_blocked.rref_full_blocked(a, NLFSR_COLS)
    first = gauss_blocked.rref_full_blocked(mats[0], NLFSR_COLS)
    held = [t.clone() for t in first]
    second = gauss_blocked.rref_full_blocked(mats[1], NLFSR_COLS)
    torch.cuda.synchronize()
    assert all(torch.equal(t, h) for t, h in zip(first, held))
    assert not torch.equal(first[0], second[0])


@pytest.mark.cuda
def test_a_mode1_replay_counts_one_eager_calls_launches(dev):
    a = _nlfsr_matrix(dev, 8704, 93)[0]
    _cuda.reset_launches()
    gauss_blocked.rref_blocked(a, NLFSR_COLS, trailing=False)
    eager = {k: n for k, n in _cuda.LAUNCHES.items() if n}
    per_call = []
    for _ in range(3):  # eager, capture and replay, replay
        _cuda.reset_launches()
        gauss_blocked.rref_full_blocked(a, NLFSR_COLS)
        per_call.append({k: n for k, n in _cuda.LAUNCHES.items() if n})
    print(f"mode 1, 8704 rows: {eager}")
    assert per_call == [eager] * 3 and sum(eager.values()) > 0


@pytest.mark.cuda
def test_mode1_and_mode0_keys_of_one_shape_are_distinct_entries(dev):
    a, _ = _mt_matrix(111, 624, dev)
    want0 = gauss_blocked._rref_origin_eager(a, COLS)
    want1 = gauss_blocked.rref_blocked(a, COLS, trailing=False)
    for _ in range(3):  # eager, capture, replay: each body its own entry
        got0 = gauss_blocked.rref_origin_blocked(a, COLS)
        got1 = gauss_blocked.rref_full_blocked(a, COLS)
        assert all(torch.equal(g, w) for g, w in zip(got0, want0))
        assert all(torch.equal(g, w) for g, w in zip(got1, want1))
    kinds = sorted(entry.kind for entry in gauss_blocked._graphs.values())
    assert kinds == ["rref", "rref_full"]
    assert len({key[:-1] for key in gauss_blocked._graphs}) == 1


@pytest.mark.cuda
def test_nlfsr_selected_solve_one_recovers_the_secret(dev):
    """The benchmark's request: the keystream's ones kept, solved in mode 1
    from the graph once the bucket is warm, the secret the first consistent
    point; the kept indices are one upload."""
    sel = _nlfsr_rows(dev)
    for seed in (121, 122, 123, 124):
        secret, ks = _nlfsr_victim(seed)
        got, counts = _counted(lambda: sel.solve_one(ks),
                               FULL_COUNTERS + ("h2d_copies",))
        print(f"seed {seed}: {counts}")
        assert got == (secret,)
        assert counts["rref_full_calls"] == 1 and counts["h2d_copies"] >= 1


# -- the subset-first scan on the card ------------------------------------------------------


def _panels(a, cols, K, trailing, p1, p2, subset_first=None):
    """``rref_blocked``'s three outputs with its panels scanned subset-first
    as ``subset_first`` says, and its panels' ``decided`` flags."""
    decided = torch.zeros((gauss_blocked._panel_count(a.shape[1], cols, K),),
                          dtype=torch.int32, device=a.device)
    out = gauss_blocked.rref_blocked(a, cols, K, trailing, phase1=p1, phase2=p2,
                                     subset_first=subset_first, decided=decided)
    return (*out, decided)


def _rand_slice(seed, kw, rows, density, used_frac, dev):
    rng = np.random.default_rng(seed)
    bits = rng.random((kw, rows, 32)) < density
    words = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
    used = (rng.random((1, rows)) < used_frac).astype(np.uint32)
    return u32_to_torch(words, dev), u32_to_torch(used, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,kw,density,used_frac,w0,cols", [
    (512, 8, 0.5, 0.0, 0, 10**6),  # S rows, all unused: the subset is every row
    (512, 8, 0.02, 0.3, 2, 10**6),
    (300, 3, 0.3, 0.1, 0, 10**6),  # fewer rows than S
    (3000, 8, 0.5, 0.2, 1, 10**6),  # rows above the subset, no miss
    (3000, 8, 0.01, 0.2, 0, 10**6),  # a miss: the cluster scan runs
    (3000, 2, 0.3, 0.5, 4, 32 * 4 + 40),  # valid columns end inside the panel
    (67328, 8, 0.003, 0.1, 0, 10**6),  # a miss past 65536 rows: the chained scan runs
])
def test_the_subset_kernel_against_its_twin(dev, rows, kw, density, used_frac, w0, cols):
    """The subset kernel's prow, used', scratch (record and header) and its
    rows' coefficient words against ``scan_subset_steps_plain``; the test's
    verdict against ``scan_subset_test_plain``; every output at the pivot
    rows against ``scan_plain``; one launch of each kernel."""
    from gf2bv_tpu_torch.ops import phase1

    bT, used = _rand_slice(rows + kw + w0, kw, rows, density, used_frac, dev)
    K = 32 * kw
    decided = torch.full((1,), 7, dtype=torch.int32, device=dev)
    _cuda.reset_launches()
    prow, used_o, cT, scratch = phase1.launch_scan_subset(bT, used, w0, K, cols, decided)
    route = phase1.scan_route(rows, kw)
    chained = route.kernel == "scan_chunked"
    assert {k: n for k, n in _cuda.LAUNCHES.items() if n} == {
        "scan_subset": 1, "scan_subset_test": 1, route.kernel: route.chunks if chained else 1}
    bc, uc = bT.cpu(), used.cpu()
    sp, su, sc, sscr = phase1.scan_subset_steps_plain(bc, uc, w0, K, cols)
    miss = phase1.scan_subset_test_plain(bc, uc, sscr, w0, K, cols)
    assert int(decided) == int(not miss)
    if not chained or not miss:  # a chained fallback reuses the record as its own
        assert torch.equal(scratch.cpu(), sscr)
    if not miss:
        assert torch.equal(prow.cpu(), sp) and torch.equal(used_o.cpu(), su)
        subset = sscr[8 * K : 9 * K]
        subset = subset[subset >= 0].long()
        assert torch.equal(cT.cpu()[:, subset], sc[:, subset])
    want = phase1.scan_plain(bT, used, w0, K, cols)
    assert torch.equal(prow, want[0]) and torch.equal(used_o, want[1])
    piv = want[0].clamp(min=0).long()[want[0] >= 0]
    assert torch.equal(cT[:, piv], want[2][:, piv])
    print(f"{rows} rows: {'miss' if miss else 'decided'}, header {sscr[-3:].tolist()}")


def _nlfsr_bucket(dev):
    return _nlfsr_matrix(dev, 8704, 131)[0], NLFSR_COLS


@pytest.mark.cuda
@pytest.mark.parametrize("system", SYSTEMS + ["nlfsr8704"])
def test_subset_first_eliminations_equal_the_full_scans(dev, system):
    """Mode 0 on the three MT19937 / SFMT shapes, mode 1 on an NLFSR bucket:
    the eager body (every panel subset-first), the capture and a replay (the
    plan from the first call) against the same body with the full scan on
    every panel, bit for bit: the RREF and the pivot map of the panel loop,
    then the origin and the verdict (mode 0) or the full RREF (mode 1)."""
    if system == "nlfsr8704":
        a, cols = _nlfsr_bucket(dev)
    else:
        a, cols = _matrix(system, 151, dev), COLS
    mode0 = system != "nlfsr8704"
    panels = -(-(1 + cols) // 256)
    old = _panels(a, cols, 256, mode0, "pallas_scan", "mxu", (False,) * panels)
    new = _panels(a, cols, 256, mode0, "pallas_scan", "mxu")
    assert all(torch.equal(g, w) for g, w in zip(new[:3], old[:3]))
    assert not old[3].any()
    decided = new[3].tolist()
    print(f"{system}: the subset decided {sum(decided)} of {panels} panels; missed at "
          f"{[t for t, d in enumerate(decided) if not d]}")
    if mode0:
        want = gauss_blocked._rref_origin_body(a, (False,) * panels, cols, 256, "pallas_scan",
                                               "mxu")[0]
        for _ in range(3):  # eager, capture, replay
            got = gauss_blocked.rref_origin_blocked(a, cols)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        for _ in range(3):
            got = gauss_blocked.rref_full_blocked(a, cols)
            assert all(torch.equal(g, w) for g, w in zip(got, old[:3]))
    entry = next(iter(gauss_blocked._graphs.values()))
    assert entry.plan == tuple(bool(d) for d in decided)
    assert torch.equal(entry.decided, new[3])


def _subset_shape_system(seed, miss):
    """A 1300-row system over 300 columns (two panels of 256 columns),
    padded to 1536 x 128 words: dense rows (no panel misses), or sparse rows
    with column 270 in the last row alone, beyond the first 512 unused rows
    of panel 1 (the subset misses there)."""
    rng = np.random.default_rng(seed)
    rows, cols = 1300, 300
    coeff = (rng.random((rows, cols)) < (0.05 if miss else 0.5)).astype(np.uint8)
    if miss:
        coeff[:, 269] = 0
        coeff[-1, 269] = 1
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    bits = np.concatenate([((coeff @ secret) % 2)[:, None], coeff], axis=1)
    eqs = packing.pack_bits(bits, 1 + cols)
    return eqs, gauss_blocked._pad(eqs, 256, word_align=128)


@pytest.mark.cuda
def test_a_replay_whose_plan_scans_subset_first_still_solves_a_miss(dev):
    """The shape's first two calls do not miss, so the graph scans both
    panels subset-first; a system of the same shape that misses in panel 1 is
    then solved by that replay exactly: the test and the gated full scan run
    on the card inside the graph."""
    dense = [u32_to_torch(_subset_shape_system(s, False)[1], dev) for s in (161, 162)]
    eqs, a32 = _subset_shape_system(163, True)
    sparse = u32_to_torch(a32, dev)
    for a in dense:  # eager, capture
        gauss_blocked.rref_origin_blocked(a, 300)
    entry = next(iter(gauss_blocked._graphs.values()))
    assert entry.plan == (True, True)
    (origin, bad), counts = _counted(lambda: gauss_blocked.rref_origin_blocked(sparse, 300),
                                     COUNTERS + ("scan_panels", "scan_subset_panels"))
    assert counts["rref_graph_replays"] == 1
    assert counts["scan_panels"] == 2 and counts["scan_subset_panels"] == 1
    assert entry.decided.tolist() == [1, 0]
    want = gauss_blocked._rref_origin_body(sparse, (False, False), 300, 256, "pallas_scan",
                                           "mxu")[0]
    assert torch.equal(origin, want[0]) and not bool(bad) and not bool(want[1])
    ref = gauss_ref.solve_oracle(eqs, 300, mode=0)
    assert np.array_equal(packing.from_u32(torch_to_u32(origin)[None, :])[0], ref.origin)


@pytest.mark.cuda
def test_the_captured_sfmt_model_is_decided_subset_first_on_every_panel(dev):
    """SFMT19937 captured over the benchmark cell's 2496 low-16 leaks on the
    card: the cached matrix is in pivot order (ops/lazy_solve), so the
    shape's eager first call, the capture and a replay decide all 79 panels
    subset-first and the graph's plan scans every panel so; the state
    replays the leaks and equals the CPU's answer (the traced row order)."""
    from gf2bv_tpu_torch import LinearSystem
    from gf2bv_tpu_torch.crypto.sfmt import SFMT19937

    def model(words, p):
        sym = SFMT19937(list(words), index=624)
        return [(sym() & 0xFFFF) ^ p[k] for k in range(2496)]

    victim = SFMT19937.from_seed(2024)
    for _ in range(3 * 624):
        victim()
    observed = [victim() & 0xFFFF for _ in range(2496)]
    tmpl = LinearSystem([32] * 624, device=dev).capture(model)
    counters = COUNTERS + ("scan_panels", "scan_subset_panels")
    states = []
    for _ in range(3):  # eager, capture, replay
        state, counts = _counted(lambda: tmpl.solve_one(observed), counters)
        assert counts["scan_panels"] == counts["scan_subset_panels"] == 79
        states.append(state)
    assert counts["rref_graph_replays"] == 1 and states[0] == states[1] == states[2]
    (entry,) = gauss_blocked._graphs.values()
    assert entry.plan == (True,) * 79 and entry.decided.tolist() == [1] * 79
    clone = SFMT19937(list(states[0]), index=624)
    assert [clone() & 0xFFFF for _ in range(2496)] == observed
    assert all(clone() == victim() for _ in range(1000))
    assert LinearSystem([32] * 624, device="cpu").capture(model).solve_one(observed) == states[0]

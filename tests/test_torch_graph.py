"""The mode-0 elimination replayed from a CUDA graph
(``gauss_blocked.rref_origin_blocked``): the routing on the CPU, and on the
card the replay against the eager body, results held across replays, the
launch accounting, and what the profiler sees.

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


@pytest.fixture(autouse=True)
def _no_graphs():
    gauss_blocked.clear_graphs()
    yield
    gauss_blocked.clear_graphs()


def _counted(fn):
    """``fn()`` under a profiler; (its result, the three counters summed
    over the span log)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    profiling.reset()
    with profile(activities=acts), profiling.span("request"):
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    recs = profiling.spans()
    return out, {c: sum(r["counters"].get(c, 0) for r in recs) for c in COUNTERS}


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
    assert key == (torch.device("cuda:0"), 20224, 640, 19968, 256, base(p1), base(p2))
    other = gauss_blocked._graph_key(_stand_in(shape=(67328, 640)), 19968, 256, p1, p2)
    assert other != key


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
@pytest.mark.parametrize("samples,launches", [(624, 237), (2100, 316)])
def test_a_replay_counts_one_solves_launches_and_a_capture_none(dev, samples, launches):
    a, _ = _mt_matrix(41, samples, dev)
    per_call = []
    for _ in range(3):  # eager, capture and replay, replay
        _cuda.reset_launches()
        gauss_blocked.rref_origin_blocked(a, COLS)
        per_call.append({k: n for k, n in _cuda.LAUNCHES.items() if n})
    print(f"{samples} outputs: {per_call[0]}")
    assert per_call[0] == per_call[1] == per_call[2]
    assert sum(per_call[0].values()) == launches
    assert gauss_blocked._graphs[gauss_blocked._graph_key(a, COLS, 256, "pallas_scan", "mxu")
                                 ].launches == per_call[0]


@pytest.mark.cuda
def test_the_profiler_sees_every_kernel_of_a_replay(dev):
    """A replayed elimination under the profiler shows the same device rows,
    by name and count, as the eager body under it, and three more copies
    (the caller's matrix into the graph's input, the two outputs out of its
    pool): ``device_ms`` and ``elimination_roofline`` read the graph's
    kernels."""
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
    assert sum(_cuda.LAUNCHES.values()) == 237
    eager = rows(lambda: gauss_blocked._rref_origin_eager(a, COLS))
    ours = lambda r: {k: n for k, n in r.items()  # noqa: E731
                      if not k.startswith(("Memcpy", "Memset")) and "at::" not in k}
    print(f"replay: {sum(replayed.values())} device rows, {sum(ours(replayed).values())} "
          f"of the port's kernels; eager: {sum(eager.values())}")
    assert ours(replayed) == ours(eager) and sum(ours(eager).values()) >= 237
    extra = {k: replayed.get(k, 0) - eager.get(k, 0) for k in set(replayed) | set(eager)}
    assert {k: n for k, n in extra.items() if n} == {"Memcpy DtoD (Device -> Device)": 3}


@pytest.mark.cuda
def test_paths_that_never_capture(dev):
    """A shape's first call, mode 1, ``pallas_sub`` and ``jnp`` capture no
    graph."""
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

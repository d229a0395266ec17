"""The subset-first scan (``phase1.scan_subset``), as far as the CPU can hold
it.

The kernels (``gf2_scan_subset`` in ``csrc/scan_subset.cu``: the subset
kernel, the miss test, the gated fallback) run only on the card
(``tests/test_torch_graph.py``).  Here:

* the twin of the subset kernel in its own order
  (``scan_subset_steps_plain``: a word of 32 columns at a time, the later
  words brought up to date from the recorded coefficients), the miss test's
  twin and their composition (``scan_subset_plain``) bit for bit against
  ``scan_plain`` (prow, used' and the pivot rows' coefficient words) on
  random slices, the flagship MT19937 panel 0 (where the subset misses), a
  system whose subset misses in a middle panel, free columns that no row can
  fill, fewer unused rows than S, and the chained scan's twin at a small
  chunk as the fallback;
* the record the kernel leaves for its test against a direct scan that
  records each pivot's words at its election;
* the panel loop: which panels are scanned subset-first under a plan, the
  plan a graph takes from its key's first call, the counters;
* the constants and the C signature mirrored from ``csrc/``.

Seeded inputs; tolerance 0: integer GF(2) arithmetic.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.core import packing
from gf2bv_tpu_torch.ops import _cuda, gauss_blocked, gauss_ref, phase1
from gf2bv_tpu_torch.utils import profiling

torch.set_num_threads(2)

CSRC = Path(phase1.__file__).resolve().parent.parent / "csrc"
S = phase1.SCAN_SUBSET_ROWS


def _slice(seed, kw, rows, density, used_frac):
    rng = np.random.default_rng(seed)
    bits = rng.random((kw, rows, 32)) < density
    words = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
    used = (rng.random((1, rows)) < used_frac).astype(np.uint32)
    return u32_to_torch(words, "cpu"), u32_to_torch(used, "cpu")


def _assert_as_full_scan(got, want):
    """prow, used' and the pivot rows' coefficient words equal the full scan's."""
    prow, used_o, cT = got[:3]
    assert torch.equal(prow, want[0]) and torch.equal(used_o, want[1])
    piv = want[0] >= 0
    rows = want[0].clamp(min=0).long()[piv]
    assert torch.equal(cT[:, rows], want[2][:, rows])


def _subset_differs(bT, used, w0, K, cols, s=S):
    """Whether the subset's own scan (the steps twin) differs from the full scan."""
    sub = phase1.scan_subset_steps_plain(bT, used, w0, K, cols, s)
    want = phase1.scan_plain(bT, used, w0, K, cols)
    return not (torch.equal(sub[0], want[0]) and torch.equal(sub[1], want[1]))


@pytest.mark.parametrize("seed,kw,rows,density,used_frac,w0,cols,s", [
    (1, 8, 1500, 0.5, 0.2, 0, 10**6, S),
    (2, 8, 1500, 0.02, 0.3, 1, 10**6, S),
    (3, 3, 3000, 0.02, 0.0, 0, 10**6, 256),
    (4, 2, 900, 0.1, 0.5, 5, 32 * 5 + 40, 64),
    (5, 1, 700, 0.01, 0.1, 0, 10**6, 64),
    (6, 8, 2000, 0.005, 0.4, 2, 10**6, S),
    (7, 4, 1200, 0.3, 0.9, 0, 10**6, 128),
    (8, 8, 800, 0.05, 0.0, 0, 5, S),  # five valid columns
])
def test_random_slices_give_the_full_scans_pivots(seed, kw, rows, density, used_frac, w0,
                                                  cols, s):
    bT, used = _slice(seed, kw, rows, density, used_frac)
    K = 32 * kw
    want = phase1.scan_plain(bT, used, w0, K, cols)
    got = phase1.scan_subset_plain(bT, used, w0, K, cols, S=s)
    _assert_as_full_scan(got, want)
    # the test misses exactly where the subset's own scan would be wrong, and
    # where the full scan elects a row above the subset
    assert got[3] == (not _subset_differs(bT, used, w0, K, cols, s))
    assert got[3] == phase1.subset_decides(want[0], used, s)


def test_random_slices_exercise_both_outcomes():
    outcomes = set()
    for seed in range(8):
        bT, used = _slice(100 + seed, 2, 600, 0.5 if seed % 2 else 0.01, 0.1)
        got = phase1.scan_subset_plain(bT, used, 0, 64, 10**6, S=64)
        want = phase1.scan_plain(bT, used, 0, 64, 10**6)
        _assert_as_full_scan(got, want)
        assert got[3] == phase1.subset_decides(want[0], used, 64)
        outcomes.add(got[3])
    assert outcomes == {True, False}


def _direct_record(bT, used, w0, K, cols):
    """A scan that records each pivot's slice words at its election."""
    kw, rows = bT.shape
    b = torch_to_u32(bT).astype(np.uint64)
    live = torch_to_u32(used)[0] == 0
    rec = np.zeros((K, 8), dtype=np.uint64)
    for jj in range(*phase1._valid_steps(w0, K, cols)):
        sw, sh = jj >> 5, jj & 31
        cand = np.nonzero(((b[sw] >> sh) & 1).astype(bool) & live)[0]
        if not cand.size:
            continue
        p = cand[0]
        rec[jj, sw:kw] = b[sw:, p]
        for r in cand[1:]:
            b[sw:, r] ^= b[sw:, p]
        live[p] = False
    return rec.astype(np.uint32)


@pytest.mark.parametrize("seed,kw,rows,density", [(11, 8, 500, 0.5), (12, 3, 520, 0.05),
                                                  (13, 8, 300, 0.02)])
def test_the_record_holds_each_pivots_words_at_its_election(seed, kw, rows, density):
    bT, used = _slice(seed, kw, rows, density, 0.1)
    K = 32 * kw
    prow, _, _, scratch = phase1.scan_subset_steps_plain(bT, used, 0, K, 10**6)
    assert scratch.shape == (phase1.subset_scratch_words(K),)
    words = torch_to_u32(scratch[: 8 * K]).reshape(K, 8)
    want = _direct_record(bT, used, 0, K, 10**6)
    assert np.array_equal(words, want)
    assert torch.equal(scratch[8 * K : 9 * K], prow)


def _flagship_panel0():
    import random

    from gf2bv_tpu_torch.crypto import mt_torch

    rng = random.Random(3)
    outs = np.array([[rng.getrandbits(32)] for _ in range(624)], dtype=np.uint32)
    a = mt_torch._padded_system(u32_to_torch(outs, "cpu"), 32, 624)
    return a[:, :8].T.contiguous(), torch.zeros((1, a.shape[0]), dtype=torch.int32)


def test_flagship_panel0_misses_and_falls_back_to_the_full_scan():
    """The low 31 bits of mt[0] appear only in the pin rows at the bottom:
    the first 512 rows leave their columns free, and the test sees it."""
    bT, used = _flagship_panel0()
    _, _, _, scratch = phase1.scan_subset_steps_plain(bT, used, 0, 256, 19968)
    flag, sub_end, n = scratch[-3:].tolist()
    assert flag == 1 and n == S and sub_end == S
    assert phase1.scan_subset_test_plain(bT, used, scratch, 0, 256, 19968)
    got = phase1.scan_subset_plain(bT, used, 0, 256, 19968)
    assert got[3] is False
    want = phase1.scan_plain(bT, used, 0, 256, 19968)
    _assert_as_full_scan(got, want)
    assert not phase1.subset_decides(want[0], used)


def test_free_columns_no_row_can_fill_are_no_miss():
    """A rank-deficient slice: columns zero in every row stay free, the
    header is flagged, and the test finds no row to pivot them."""
    bT, used = _slice(21, 4, 1500, 0.3, 0.2)
    bT[1] &= 0x0F0F0F0F  # word 1: half its columns zero everywhere
    bT[3] = 0
    got = phase1.scan_subset_plain(bT, used, 0, 128, 10**6)
    _, _, _, scratch = phase1.scan_subset_steps_plain(bT, used, 0, 128, 10**6)
    assert scratch[-3].item() == 1  # flagged: free valid columns, rows above the subset
    assert got[3] is True
    want = phase1.scan_plain(bT, used, 0, 128, 10**6)
    _assert_as_full_scan(got, want)
    assert phase1.subset_decides(want[0], used)
    assert (got[0][32:] < 0).sum() >= 16 + 32


@pytest.mark.parametrize("rows,used_frac", [(300, 0.0), (2000, 0.9), (S, 0.0)])
def test_fewer_unused_rows_than_s_take_them_all_and_cannot_miss(rows, used_frac):
    bT, used = _slice(31 + rows, 8, rows, 0.01, used_frac)
    n_unused = int((used == 0).sum())
    assert n_unused <= S
    prow, used_o, cT, scratch = phase1.scan_subset_steps_plain(bT, used, 0, 256, 10**6)
    flag, sub_end, n = scratch[-3:].tolist()
    assert (flag, sub_end, n) == (0, rows, n_unused)
    assert not phase1.scan_subset_test_plain(bT, used, scratch, 0, 256, 10**6)
    _assert_as_full_scan((prow, used_o, cT), phase1.scan_plain(bT, used, 0, 256, 10**6))


@pytest.mark.parametrize("chunk_rows", [100, 333, 1000])
def test_the_chained_scans_twin_as_the_fallback(chunk_rows):
    bT, used = _slice(41, 2, 1000, 0.01, 0.1)
    got = phase1.scan_subset_plain(bT, used, 0, 64, 10**6, chunk_rows=chunk_rows, S=64)
    assert got[3] is False  # this slice misses: the fallback ran
    want = phase1.scan_chunked_plain(bT, used, 0, 64, 10**6, chunk_rows)
    for g, w in zip(got[:3], want):
        assert torch.equal(g, w)
    _assert_as_full_scan(got, phase1.scan_plain(bT, used, 0, 64, 10**6))


def test_the_subset_takes_the_first_unused_rows_wherever_they_lie():
    rows = 12000
    bT, used = _slice(51, 1, rows, 0.01, 0.0)
    used[0, :8100] = 1  # the kernel's gather reads 8192 rows a pass: the subset spans two
    used[0, 8300:8350] = 1
    prow, used_o, _, scratch = phase1.scan_subset_steps_plain(bT, used, 0, 32, 10**6)
    flag, sub_end, n = scratch[-3:].tolist()
    assert n == S and sub_end == 8100 + S + 50
    assert ((prow < 0) | (prow >= 8100)).all() and (prow < sub_end).all()
    assert torch.equal(used_o[0, :8100], used[0, :8100])


def test_scan_subset_on_cpu_tensors_runs_the_twin_and_sets_decided():
    """On the CPU the full scan runs and ``subset_decides`` gives the flag:
    the twin's verdict."""
    bT, used = _flagship_panel0()
    decided = torch.full((3,), 7, dtype=torch.int32)
    _cuda.reset_launches()
    got = phase1.scan_subset(bT, used, 0, 256, 19968, decided[1:2])
    assert decided.tolist() == [7, 0, 7] and not any(_cuda.LAUNCHES.values())
    _assert_as_full_scan(got, phase1.scan_plain(bT, used, 0, 256, 19968))
    bT, used = _slice(61, 8, 400, 0.3, 0.0)
    got = phase1.scan_subset(bT, used, 0, 256, 10**6, decided[2:3])
    assert decided.tolist() == [7, 0, 1]
    for g, w in zip(got, phase1.scan_plain(bT, used, 0, 256, 10**6)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="K=64"):
        phase1.scan_subset(bT, used, 0, 64, 10**6, decided[:1])


# -- the panel loop ------------------------------------------------------------------


def _panels(a, cols, K, trailing, p1, p2, subset_first=None):
    """``rref_blocked``'s three outputs with its panels scanned subset-first
    as ``subset_first`` says, and its panels' ``decided`` flags."""
    decided = torch.zeros((gauss_blocked._panel_count(a.shape[1], cols, K),),
                          dtype=torch.int32, device=a.device)
    out = gauss_blocked.rref_blocked(a, cols, K, trailing, phase1=p1, phase2=p2,
                                     subset_first=subset_first, decided=decided)
    return (*out, decided)

def _middle_miss_system(seed=71, rows=1300, cols=300):
    """A random sparse system whose column 150 (panel 1 at K = 128) has its
    bit in the last row alone, beyond the first 512 unused rows of that
    panel: the subset misses there and nowhere else."""
    rng = np.random.default_rng(seed)
    coeff = (rng.random((rows, cols)) < 0.05).astype(np.uint8)
    coeff[:, 149] = 0
    coeff[-1, 149] = 1
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    bits = np.concatenate([((coeff @ secret) % 2)[:, None], coeff], axis=1)
    eqs = packing.pack_bits(bits, 1 + cols)
    return eqs, u32_to_torch(gauss_blocked._pad(eqs, 128, word_align=128), "cpu"), secret


def _spied(monkeypatch):
    calls = []
    real_sub, real_scan = gauss_blocked.scan_subset, gauss_blocked.scan

    def sub(bT, used, w0, K, cols, decided):
        calls.append(("subset", w0 * 32 // K))
        return real_sub(bT, used, w0, K, cols, decided)

    def full(bT, used, w0, K, cols, variant=""):
        calls.append(("scan" + variant, w0 * 32 // K))
        return real_scan(bT, used, w0, K, cols, variant)

    monkeypatch.setattr(gauss_blocked, "scan_subset", sub)
    monkeypatch.setattr(gauss_blocked, "scan", full)
    return calls


def test_a_middle_panels_miss_is_decided_by_the_full_scan(monkeypatch):
    eqs, a, _ = _middle_miss_system()
    calls = _spied(monkeypatch)
    rref, pof, bad, decided = _panels(a, 300, 128, False, "pallas_scan", "mxu")
    assert decided.tolist() == [1, 0, 1]
    assert calls == [("subset", 0), ("subset", 1), ("subset", 2)]
    calls.clear()
    want = _panels(a, 300, 128, False, "pallas_scan", "mxu", (False,) * 3)
    assert calls == [("scan", 0), ("scan", 1), ("scan", 2)] and want[3].tolist() == [0, 0, 0]
    for g, w in zip((rref, pof, bad), want[:3]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("plan", [(True, False, True), (False, True, False), None])
def test_a_plan_picks_each_panels_scan_and_keeps_the_result(monkeypatch, plan):
    _, a, _ = _middle_miss_system(seed=72)
    want = _panels(a, 300, 128, True, "pallas_scan", "mxu", (False,) * 3)
    calls = _spied(monkeypatch)
    got = _panels(a, 300, 128, True, "pallas_scan", "mxu", plan)
    picks = plan or (True,) * 3
    assert calls == [("subset" if p else "scan", t) for t, p in enumerate(picks)]
    assert got[3].tolist() == [int(p and t != 1) for t, p in enumerate(picks)]
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("p1,p2", [("pallas_scan2", "mxu"), ("pallas_scanm", "mxu_noseg"),
                                   ("pallas_sub", "mxu"), ("pallas", "mxu")])
def test_other_engines_never_scan_subset_first(monkeypatch, p1, p2):
    _, a, _ = _middle_miss_system(seed=73, rows=700)
    calls = _spied(monkeypatch)
    *_, decided = _panels(a, 300, 128, False, p1, p2)
    assert not any(c[0] == "subset" for c in calls) and not decided.any()


def test_a_graph_takes_its_plan_from_the_keys_first_call():
    key = ("cuda:0", 20224, 640, 19968, 256, "pallas_scan", "mxu", "rref")
    first = torch.tensor([0] + [1] * 78, dtype=torch.int32)
    gauss_blocked.clear_graphs()
    try:
        assert gauss_blocked._graph_for(key) is None
        gauss_blocked._record_seen(key, first)
        entry = gauss_blocked._graph_for(key)
        assert entry.first is first and entry.plan is None and key not in gauss_blocked._seen
    finally:
        gauss_blocked.clear_graphs()


def test_the_counters_count_the_panels_and_the_subsets_decisions():
    from torch.profiler import ProfilerActivity, profile

    eqs, a, _ = _middle_miss_system(seed=74)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]), profiling.span("request"):
        origin, bad = gauss_blocked.rref_origin_blocked(a, 300, 128)
    counts = {}
    for rec in profiling.spans():
        for k, v in rec["counters"].items():
            counts[k] = counts.get(k, 0) + v
    assert counts["scan_panels"] == 3 and counts["scan_subset_panels"] == 2
    ref = gauss_ref.solve_oracle(eqs, 300, mode=0)
    assert not bool(bad)
    assert np.array_equal(packing.from_u32(torch_to_u32(origin)[None, :])[0], ref.origin)
    profiling.reset()
    gauss_blocked.rref_origin_blocked(a, 300, 128)  # no profiler: nothing kept
    assert not profiling.spans()


# -- mirrored from csrc/ -----------------------------------------------------------------


def _const(name, source="scan_subset.cu"):
    m = re.search(rf"constexpr \w+ {name} = ([^;]+);", (CSRC / source).read_text())
    return m.group(1)


def test_constants_and_signature_mirror_csrc():
    src = (CSRC / "scan_subset.cu").read_text()
    assert int(_const("kSubsetKw")) * 32 == 256 and int(_const("kSubsetThreads")) == 512
    assert phase1.SCAN_SUBSET_ROWS == int(_const("kSubsetRows"))
    assert "scan_subset_kernel<kSubsetLane>" in src and "template <int kLane>" in src
    assert "hdr[2] = n;" in src and phase1.SUBSET_HEADER_WORDS == 3
    assert _cuda._SIGNATURES["gf2_scan_subset"][-1] is _cuda._SIGNATURES["gf2_scan"][-1]
    args = re.search(r'extern "C" int gf2_scan_subset\(([^)]*)\)', src).group(1)
    assert len(args.split(",")) == len(_cuda._SIGNATURES["gf2_scan_subset"])
    assert {"scan_subset", "scan_subset_test"} <= set(_cuda.LAUNCHES)

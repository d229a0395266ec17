"""The cached matrix of a lazily traced structure in pivot order
(``ops/lazy_solve._order_by_pivots``), as far as the CPU can hold it.

On the card the blocked backend's cached matrix is stored with the rows each
panel elects first, so the subset-first scan decides every panel.  The gate
(``lazy_solve._scans_subset_first``) holds only for a CUDA matrix; here it
is forced on CPU tensors by a monkeypatch, where the full scan runs and
``phase1.subset_decides`` gives each panel's ``decided`` flag.  The system
is a captured model over 22 words (704 columns, three panels of 256) whose
first 1280 rows touch only the first seven words: in the traced order every
pivot of panels 1 and 2 (and of the eighth word in panel 0) lies beyond the
first ``SCAN_SUBSET_ROWS`` unused rows, as SFMT19937's do.  Asserted: the
order is a permutation of ``kept`` with the pivot rows first; the flags;
the answers with and without the order, and against the host engine
(``oracle``), in mode 0, mode 1, unsatisfiable and literal-1 cases, through
``CapturedTrace.solve_one`` / ``solve_raw_space`` / ``solve_raw_batch``.

Seeded inputs; tolerance 0: integer GF(2) arithmetic.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gf2bv_tpu_torch import LinearSystem
from gf2bv_tpu_torch.ops import gauss_blocked, lazy_solve, phase1

torch.set_num_threads(2)

M32 = 0xFFFFFFFF
NWORDS = 22  # 704 columns: three panels of 256
COLS = 32 * NWORDS
JUNK = 40  # expressions over words 0-6 only: 1280 rows of rank <= 224
REAL = 30  # expressions over every word
PANELS = gauss_blocked._panel_count(128, COLS, gauss_blocked.K_PANEL)


def _rotl(x, r):
    if isinstance(x, int):
        return ((x << r) | (x >> (32 - r))) & M32
    return x.rotl(r)


def _terms():
    rng = random.Random(2024)
    junk = [(rng.randrange(7), rng.randrange(7), rng.randrange(1, 32)) for _ in range(JUNK)]
    real = [(rng.randrange(NWORDS), rng.randrange(NWORDS), rng.randrange(1, 32),
             rng.randrange(NWORDS), rng.randrange(1, 32)) for _ in range(REAL)]
    return junk, real


JUNK_TERMS, REAL_TERMS = _terms()


def _outputs(ws):
    """The model's outputs on words ``ws`` (ints or lazy words): the junk
    block first, then the rows over every word, then one expression whose
    coefficients cancel (its rows are dropped: the literal-1 slot)."""
    outs = [ws[a] ^ _rotl(ws[b], r) for a, b, r in JUNK_TERMS]
    outs += [ws[a] ^ _rotl(ws[b], r) ^ (ws[c] >> s) for a, b, r, c, s in REAL_TERMS]
    return outs + [ws[0] ^ ws[0]]


def _model(ws, p):
    return [o ^ p[k] for k, o in enumerate(_outputs(list(ws)))]


def _victim(seed):
    rng = random.Random(seed)
    words = [rng.getrandbits(32) for _ in range(NWORDS)]
    return words, _outputs(words)


class _Side:
    """A capture of the model on the CPU under the blocked backend, its
    cache entry built with the gate forced to ``ordered``.  Both sides share
    one cache key, so each call puts its own entry back in the cache."""

    def __init__(self, monkeypatch, ordered: bool):
        monkeypatch.setattr(lazy_solve, "_scans_subset_first",
                            lambda cs: ordered and cs.backend == "blocked")
        lazy_solve.clear_cache()
        self.lin = LinearSystem([32] * NWORDS, backend="blocked", device="cpu")
        self.tmpl = self.lin.capture(_model)
        self.cs = lazy_solve.cached_system(self.lin, self.tmpl.zeros)
        (self.key, _), = lazy_solve._CACHE.items()

    def __call__(self, method, *args):
        lazy_solve._CACHE.clear()
        lazy_solve._CACHE[self.key] = self.cs
        out = getattr(self.tmpl, method)(*args)
        assert lazy_solve._CACHE[self.key] is self.cs  # no entry built anew
        return out


@pytest.fixture
def both(monkeypatch):
    """(plain, ordered) :class:`_Side` s."""
    monkeypatch.delenv("GF2BV_TPU_PHASE1", raising=False)
    monkeypatch.delenv("GF2BV_TPU_PHASE2", raising=False)
    sides = _Side(monkeypatch, False), _Side(monkeypatch, True)
    yield sides
    lazy_solve.clear_cache()


def _decided(a):
    flags = torch.zeros((PANELS,), dtype=torch.int32)
    gauss_blocked.rref_blocked(a, COLS, gauss_blocked.K_PANEL, True, decided=flags)
    return flags.tolist()


def test_the_gate_holds_only_for_the_kernels_subset_first_scan():
    def gate(device="cuda", backend="blocked", p1="pallas_scan", p2="mxu"):
        cs = SimpleNamespace(backend=backend, phase1=p1, phase2=p2,
                             a_dev=SimpleNamespace(device=torch.device(device)))
        return lazy_solve._scans_subset_first(cs)

    assert gate() and not gate("cpu")
    for change in (dict(backend="jax"), dict(p1="pallas_scan2"), dict(p1="pallas_sub"),
                   dict(p1="pallas"), dict(p1="jnp"), dict(p2="mxu_la")):
        assert not gate(**change), change
    for p2 in ("mxu2", "mxu_noseg", "pallas"):
        assert gate(p2=p2)


def test_the_order_is_a_permutation_of_kept_with_the_pivot_rows_first(both):
    plain, ordered = (side.cs for side in both)
    n = plain.kept.shape[0]
    assert n == JUNK * 32 + REAL * 32 and plain.rows_padded == ordered.rows_padded
    assert sorted(ordered.kept.tolist()) == plain.kept.tolist()
    assert np.array_equal(ordered.kept_mask, plain.kept_mask)
    assert np.array_equal(ordered.struct_aff, plain.struct_aff)
    _, pof, _ = gauss_blocked.rref_blocked(plain.a_dev, COLS, gauss_blocked.K_PANEL, True)
    pof = pof.numpy()
    pivots = pof[pof >= 0]
    rest = np.setdiff1d(np.arange(n), pivots)
    assert np.array_equal(ordered.kept, plain.kept[np.concatenate([pivots, rest])])
    assert torch.equal(ordered.a_dev[:n], plain.a_dev[torch.from_numpy(
        np.concatenate([pivots, rest]))])
    assert not ordered.a_dev[n:].any()  # the padding stays at the bottom
    # the traced order puts pivots past the first rows: the junk block first
    assert pivots.max() >= JUNK * 32 and (pivots >= phase1.SCAN_SUBSET_ROWS).any()


def test_the_ordered_matrix_is_decided_on_every_panel(both):
    plain, ordered = (side.cs for side in both)
    assert PANELS == 3
    assert _decided(plain.a_dev) == [0, 0, 0]
    assert _decided(ordered.a_dev) == [1, 1, 1]


def _oracle(values, mode):
    host = LinearSystem([32] * NWORDS, backend="oracle", device="cpu")
    tmpl = host.capture(_model)
    return tmpl.solve_raw_one(values) if mode == 0 else tmpl.solve_raw_space(values)


def _cases():
    _, sat = _victim(5)
    unsat = list(sat)
    unsat[3] ^= 1 << 7  # a junk row: the junk block is dependent
    lit_one = list(sat)
    lit_one[-1] = 1  # the cancelled expression's slot: 0 = 1 in a dropped row
    return {"sat": sat, "unsat": unsat, "lit_one": lit_one}


@pytest.mark.parametrize("case", ["sat", "unsat", "lit_one"])
@pytest.mark.parametrize("mode", [0, 1])
def test_answers_are_equal_with_and_without_the_order(both, case, mode):
    plain, ordered = both
    values = _cases()[case]
    solve = "solve_raw_one" if mode == 0 else "solve_raw_space"
    got = ordered(solve, values)
    want = plain(solve, values)
    host = _oracle(values, mode)
    if case == "sat":
        assert got is not None
    else:
        assert got is None and want is None and host is None
        return
    if mode == 0:
        assert got == want == host
    else:
        assert got.dimension == want.dimension == host.dimension > 0
        assert got.origin == want.origin == host.origin
        assert got.basis == want.basis == host.basis


def test_captured_solves_of_several_victims_are_equal(both):
    plain, ordered = both
    batch = []
    for seed in range(11, 15):
        _, outs = _victim(seed)
        got = ordered("solve_one", outs)
        assert got is not None and got == plain("solve_one", outs)
        assert ordered.lin.convert_sol(_oracle(outs, 0)) == got
        assert _outputs(list(got)) == outs  # the answer reproduces the victim's outputs
        batch.append(outs)
    batch += [_cases()["unsat"], _cases()["lit_one"]]
    for mode in (0, 1):
        got = ordered("solve_raw_batch", batch, mode)
        want = plain("solve_raw_batch", batch, mode)
        assert got[-2:] == want[-2:] == [None, None]
        single = "solve_raw_one" if mode == 0 else "solve_raw_space"
        for values, g, w in zip(batch, got[:-2], want[:-2]):
            one = ordered(single, values)
            if mode == 0:
                assert g == w == one
            else:
                assert (g.origin, g.basis) == (w.origin, w.basis) == (one.origin, one.basis)

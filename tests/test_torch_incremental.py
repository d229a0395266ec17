"""IncrementalSolver of the port against the JAX package's, on the CPU.

Every scenario of tests/test_incremental.py runs on both solvers with the
same packed equations (made from a numpy seed); after the start and after
every add the whole state is compared exactly: the matrix M, the pivot maps
pof and pcol, nrows, rank and unsat.  The maintained matrix is also held
against a from-scratch full RREF of all rows (the port's rref_blocked with
trailing=False), the strongest oracle, as the reference's test does.
"""

import numpy as np
import pytest

from gf2bv_tpu import LinearSystem as JaxLinearSystem
from gf2bv_tpu.ops.incremental import IncrementalSolver as JaxIncremental
from gf2bv_tpu_torch import IncrementalSolver, LinearSystem
from gf2bv_tpu_torch.core import packing
from gf2bv_tpu_torch.core.words import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import incremental
from gf2bv_tpu_torch.ops.gauss_blocked import _pad, rref_blocked
from gf2bv_tpu_torch.ops.gauss_ref import solve_oracle


def _rand_zeros(lin, rng, n):
    """The reference test's workload: ``n`` random parities of a secret."""
    (x,) = lin.gens(lazy=False)
    w = len(x)

    def rbits():
        v = int.from_bytes(rng.bytes(w // 8 + 1), "little") & ((1 << w) - 1)
        return v or 1

    secret = rbits()
    outs = []
    for _ in range(n):
        mask = rbits()
        bit = bin(secret & mask).count("1") & 1
        outs.append((x & mask).sum() ^ bit)
    return secret, outs


def _state(inc) -> dict:
    """The whole state of either package's solver as numpy arrays."""
    if hasattr(inc._M, "device") and not hasattr(inc._M, "devices"):  # torch
        m = torch_to_u32(inc._M)
        pof, pcol = inc._pof.cpu().numpy(), inc._pcol.cpu().numpy()
    else:
        m = np.asarray(inc._M, np.uint32)
        pof, pcol = np.asarray(inc._pof), np.asarray(inc._pcol)
    return {"M": m, "pof": pof.astype(np.int32), "pcol": pcol.astype(np.int32),
            "nrows": int(inc._nrows), "rank": inc.rank, "unsat": inc.unsat}


def _same_state(port, ref):
    got, want = _state(port), _state(ref)
    for key in ("nrows", "rank", "unsat"):
        assert got[key] == want[key], key
    for key in ("M", "pof", "pcol"):
        assert got[key].shape == want[key].shape, key
        assert np.array_equal(got[key], want[key]), key


def _pair(eqs, cols, **kw):
    return (IncrementalSolver.from_packed(eqs, cols, device="cpu", **kw),
            JaxIncremental.from_packed(eqs, cols, **kw))


def _add_both(port, ref, eqs):
    port.add_packed(eqs)
    ref.add_packed(eqs)
    _same_state(port, ref)


def _fresh_rref(eqs, cols):
    """From-scratch full RREF (trailing=False) of all rows on the CPU."""
    a32 = _pad(eqs, 256, word_align=128)
    rref, pof, bad = rref_blocked(u32_to_torch(a32, "cpu"), cols, 256, trailing=False)
    return torch_to_u32(rref), pof.numpy(), bool(bad)


def _sorted_rows(m):
    rows = m[m.any(axis=1)]
    return rows[np.lexsort(rows.T[::-1])]


def _matches_fresh(inc, eqs, cols):
    """The maintained matrix is the from-scratch RREF: same nonzero rows, the
    same pivot-column set and each pivot column's row content."""
    want, want_pof, bad = _fresh_rref(eqs, cols)
    st = _state(inc)
    got, got_pof = st["M"], st["pof"]
    ww = max(got.shape[1], want.shape[1])
    g = np.pad(_sorted_rows(got), ((0, 0), (0, ww - got.shape[1])))
    w = np.pad(_sorted_rows(want), ((0, 0), (0, ww - want.shape[1])))
    assert np.array_equal(g, w)
    assert np.array_equal(got_pof >= 0, want_pof >= 0)
    for c in np.nonzero(want_pof >= 0)[0]:
        row = got[got_pof[c]][: want.shape[1]]
        assert np.array_equal(row, want[want_pof[c]][: row.shape[0]])
    return bad


@pytest.mark.parametrize("w", [48, 200])
def test_incremental_matches_jax_and_fresh_elimination(w):
    rng = np.random.default_rng(101 + w)
    lin = LinearSystem([w], device="cpu")
    secret, zeros = _rand_zeros(lin, rng, w + 10)
    parts = [zeros[: w // 3], zeros[w // 3 : w // 2], zeros[w // 2 :]]
    eqs = [lin.get_eqs_packed(p) for p in parts]

    port, ref = _pair(eqs[0], w)
    _same_state(port, ref)
    for e in eqs[1:]:
        _add_both(port, ref, e)
    assert not _matches_fresh(port, lin.get_eqs_packed(zeros), w)
    assert not port.unsat
    assert port.solve_raw_one() == ref.solve_raw_one()
    assert lin.convert_sol(port.solve_raw_one()) == (secret,)


def test_incremental_system_path_and_dimension_collapse():
    """Both packages' LinearSystem front ends, adds of 4 rows: the
    dimension falls to 0 monotonically, the state stays equal, and the
    mid-way space equals the reference's and the oracle's."""
    rng = np.random.default_rng(7)
    w = 64
    lin = LinearSystem([w], device="cpu")
    jlin = JaxLinearSystem([w])
    secret, zeros = _rand_zeros(lin, rng, w + 8)
    _, jzeros = _rand_zeros(jlin, np.random.default_rng(7), w + 8)

    port = IncrementalSolver(lin, zeros[: w - 10])
    ref = JaxIncremental(jlin, jzeros[: w - 10])
    _same_state(port, ref)
    sp, jsp = port.solve_raw_space(), ref.solve_raw_space()
    oracle = solve_oracle(lin.get_eqs_packed(zeros[: w - 10]), w)
    assert sp.dimension == jsp.dimension == len(oracle.basis)
    assert sp.origin == jsp.origin == packing.words_to_int(oracle.origin)
    assert sorted(sp.basis) == sorted(jsp.basis)

    dims = [port.dimension]
    for k in range(w - 10, len(zeros), 4):
        port.add(zeros[k : k + 4])
        ref.add(jzeros[k : k + 4])
        _same_state(port, ref)
        dims.append(port.dimension)
    assert dims[0] > dims[-1] == 0
    assert all(a >= b for a, b in zip(dims, dims[1:]))
    assert port.solve_one() == ref.solve_one() == (secret,)
    sp = port.solve_raw_space()
    assert sp.dimension == 0 and sp.get(0) == port.solve_raw_one()


def test_incremental_unsat_detection():
    lin = LinearSystem([16], device="cpu")
    (x,) = lin.gens(lazy=False)
    port, ref = _pair(lin.get_eqs_packed([x ^ 0x1234]), 16)
    assert not port.unsat and lin.convert_sol(port.solve_raw_one()) == (0x1234,)
    _add_both(port, ref, lin.get_eqs_packed([x ^ 0x1235]))  # contradicts bit 0
    assert port.unsat and port.solve_raw_one() is None and port.solve_raw_space() is None
    _add_both(port, ref, lin.get_eqs_packed([x ^ 0x1234]))  # unsat is sticky
    assert port.unsat


def test_incremental_unsat_init_keeps_rref_exact():
    """A 0 = 1 row in the initial matrix: pcol's -1 slots never select the
    affine column, so later adds keep the unique RREF."""
    rng = np.random.default_rng(77)
    w = 64
    lin = LinearSystem([w], device="cpu")
    _, zeros = _rand_zeros(lin, rng, 30)
    eqs = lin.get_eqs_packed(zeros[:12])
    contradiction = np.zeros((1, eqs.shape[1]), np.uint64)
    contradiction[0, 0] = 1
    init = np.concatenate([eqs, contradiction])
    port, ref = _pair(init, w)
    _same_state(port, ref)
    assert port.unsat
    more = lin.get_eqs_packed(zeros[12:])
    _add_both(port, ref, more)
    assert port.unsat and port.solve_raw_one() is None
    assert _matches_fresh(port, np.concatenate([init, more]), w)


def test_incremental_from_empty_and_redundant_adds():
    rng = np.random.default_rng(17)
    w = 40
    lin = LinearSystem([w], device="cpu")
    secret, zeros = _rand_zeros(lin, rng, w + 6)
    port = IncrementalSolver(lin)  # empty start
    ref = JaxIncremental.from_packed(lin.get_eqs_packed([]), w)
    _same_state(port, ref)
    assert port.dimension == w and port.rank == 0
    _add_both(port, ref, lin.get_eqs_packed(zeros))
    assert port.solve_one() == (secret,)
    r = port.rank
    _add_both(port, ref, lin.get_eqs_packed(zeros[:5]))  # redundant rows change nothing
    assert port.rank == r and port.solve_one() == (secret,)


def test_incremental_capacity_growth():
    rng = np.random.default_rng(23)
    w = 32
    lin = LinearSystem([w], device="cpu")
    secret, zeros = _rand_zeros(lin, rng, 64)
    port, ref = _pair(lin.get_eqs_packed(zeros[:4]), w, slack=128)
    cap0 = port._M.shape[0]
    for k in range(4, 64, 8):
        _add_both(port, ref, lin.get_eqs_packed(zeros[k : k + 8]))
    assert port._M.shape[0] > cap0  # grew by 2048 rows, as the reference's
    assert lin.convert_sol(port.solve_raw_one()) == (secret,)


def test_incremental_largest_bucket_and_chunked_adds():
    """An add past the largest bucket splits into chunks of 2048 rows; the
    512- and 2048-row buckets run pass 3 over two and eight 256-row
    chunks."""
    rng = np.random.default_rng(5)
    w = 96
    lin = LinearSystem([w], device="cpu")
    secret, zeros = _rand_zeros(lin, rng, 300)
    eqs = lin.get_eqs_packed(zeros)
    port, ref = _pair(eqs[:10], w)
    _add_both(port, ref, eqs[10:400])
    big = np.concatenate([eqs] * 8)[:2100]  # 2048 + 52 rows, all redundant
    _add_both(port, ref, big)
    assert lin.convert_sol(port.solve_raw_one()) == (secret,)


def test_incremental_from_packed_matches_system_path():
    rng = np.random.default_rng(31)
    w = 96
    lin = LinearSystem([w], device="cpu")
    secret, zeros = _rand_zeros(lin, rng, w + 6)
    inc = IncrementalSolver.from_packed(lin.get_eqs_packed(zeros[:40]), w, device="cpu")
    inc.add_packed(lin.get_eqs_packed(zeros[40:]))
    sys_path = IncrementalSolver(lin, zeros[:40]).add(zeros[40:])
    _same_state(inc, sys_path)
    assert inc.solve_raw_one() == sys_path.solve_raw_one()
    assert sys_path.solve_one() == (secret,)
    with pytest.raises(TypeError):
        inc.solve_one()


def test_xor_select_update_and_bits_at_against_numpy():
    """The two helpers against a numpy model, with a pf taller than one
    update launch (320 rows: chunks of 256 and 64)."""
    rng = np.random.default_rng(3)
    n, k, wp = 40, 320, 12
    a = rng.integers(0, 2**32, size=(n, wp), dtype=np.uint64).astype(np.uint32)
    pf = rng.integers(0, 2**32, size=(k, wp), dtype=np.uint64).astype(np.uint32)
    sel = rng.integers(0, 2, size=(n, k)).astype(np.int32)
    want = a.copy()
    for i in range(n):
        for t in np.nonzero(sel[i])[0]:
            want[i] ^= pf[t]
    got = incremental._xor_select_update(
        u32_to_torch(a, "cpu"), u32_to_torch(sel.astype(np.uint32), "cpu"),
        u32_to_torch(pf, "cpu"))
    assert np.array_equal(torch_to_u32(got), want)
    pos = np.array([-1, 0, 31, 32, 63, 5 * 32 + 17, -5], np.int32)
    bits = incremental._bits_at(u32_to_torch(a, "cpu"), u32_to_torch(pos.view(np.uint32), "cpu"))
    ref = np.where(pos >= 0, (a[:, np.maximum(pos, 0) >> 5] >> (np.maximum(pos, 0) & 31)) & 1, 0)
    assert np.array_equal(bits.numpy(), ref)


def test_bucket_rows():
    assert [incremental._bucket_rows(n) for n in (1, 128, 129, 512, 2048)] == [
        128, 128, 512, 512, 2048]
    with pytest.raises(ValueError):
        incremental._bucket_rows(2049)

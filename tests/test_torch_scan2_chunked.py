"""The chained two-pivot scan of slices taller than one cluster, as far as the
CPU can hold it.

The kernel (``gf2_scan2_chunked`` in ``csrc/scan2_chunked.cu``, body
``scan2_cluster_body`` with ``kChain`` in ``csrc/scan2_cluster.cuh``) runs only
on the card (``tests/test_torch_cuda.py``).  Here:

* its twin in the chain's order, ``phase1.scan2_chunked_plain`` (the chunks in
  turn, each pair of columns one of four cases against the record of the
  columns the chunks before it took), with the chunk size forced small, bit
  for bit against the JAX package's Pallas two-pivot scan
  (``_make_scan_kernel2``) in interpret mode, the step twin ``scan2_plain``
  and the 1-pivot chain's twin ``scan_chunked_plain``, on hand-built slices on
  which each pair case occurs (asserted on the input and the reference's
  outputs), with invalid columns at both ends, and on random ones;
* the route: ``scan2_route`` gives the chained two-pivot scan exactly past
  what the largest cluster holds, on the 1-pivot chain's chunks;
* the C signature and the shared-memory constants mirrored from ``csrc/``;
  the wrappers on CPU tensors.

Seeded numpy inputs; tolerance 0: integer GF(2) arithmetic.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu.ops.pallas_phase1 import _call_scan_kernel
from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import _cuda, phase1

torch.set_num_threads(2)

CSRC = Path(phase1.__file__).resolve().parent.parent / "csrc"
PAIR_CASES = ("both columns taken by an earlier chunk",
              "column jj0 taken, jj0 + 1 elected in the chunk",
              "column jj0 elected in the chunk, jj0 + 1 taken",
              "neither taken: both elected in a later chunk",
              "pivot 1 corrected by pivot 0, its record swept by a later chunk")


def t32(a):
    return u32_to_torch(a, "cpu")


def _pallas2(bT, used, w0, K, cols):
    return [np.asarray(x) for x in _call_scan_kernel(
        jnp.asarray(bT), jnp.asarray(used), jnp.asarray([w0], jnp.int32), K, cols, True, "2")]


def _all_agree(bT, used, w0, K, cols, chunk, pallas=True):
    """The chain's twin = the Pallas two-pivot scan = the step twin = the
    1-pivot chain's twin; returns the reference's outputs as numpy."""
    bt, u = t32(bT), torch.from_numpy(used)
    got = phase1.scan2_chunked_plain(bt, u, w0, K, cols, chunk)
    for ref in (phase1.scan2_plain(bt, u, w0, K, cols),
                phase1.scan_chunked_plain(bt, u, w0, K, cols, chunk)):
        for g, w in zip(got, ref):
            assert torch.equal(g, w)
    if pallas:
        prow, used_j, cT = _pallas2(bT, used, w0, K, cols)
        assert np.array_equal(got[0].numpy(), prow)
        assert np.array_equal(got[1].numpy(), used_j)
        assert np.array_equal(torch_to_u32(got[2]), cT)
    return got[0].numpy(), torch_to_u32(got[2])


# -- hand-built slices: each pair case occurs -----------------------------------------

# rows of word 0 by chunk of 40 rows (chunk 0: rows 0-39, 1: 40-79, 2: 80-119,
# 3: 120-129), each {row: its bits among columns 1-13}; every other row has none
# of those bits, and rows of chunk 0 not named here are used
BUILT_ROWS = {
    # pair (2, 3): both pivots in chunk 0, both swept into chunk 1 (row 41 has
    # both bits, row 42 bit 3)
    1: {2}, 2: {3}, 41: {2, 3}, 42: {3},
    # pair (4, 5): pivot 4 in chunk 0 (no free row there has bit 5), so chunk 1
    # sweeps it into row 43 and then elects pivot 5 (43) over row 44
    3: {4}, 43: {4, 5}, 44: {5},
    # pair (6, 7): no free row of chunk 0 has bit 6, row 4 takes 7; chunk 1
    # elects 45 for 6 (which gives row 46 bit 7), then sweeps pivot 7 into rows
    # 46 and 47
    4: {7}, 45: {6, 7}, 46: {6}, 47: {7},
    # pair (8, 9): nothing in chunk 0; chunk 1 elects both (pivot 0's bit 9 set:
    # row 50 becomes a column-9 candidate through pivot 0's elimination)
    48: {8, 9}, 49: {9}, 50: {8},
    # pair (10, 11): pivot 10 (row 5) eliminates pivot 11 (row 6), whose record
    # words are therefore row 6 ^ row 5: they carry bit 12 into row 81 of
    # chunk 2, which then pivots column 12 (uncorrected words would not)
    5: {10, 12}, 6: {10, 11}, 81: {11},
    # column 13 has candidates in chunks 2 and 3 alone
    90: {13}, 125: {13},
}
CONTROLLED = (1 << 14) - 1  # columns 0-13 of word 0


def _built_slice(seed, cols, rows=130, K=64, chunk=40):
    """The hand-built rows over sparse random bits (one in ten) in the other
    columns; invalid columns at both ends carry bits on free rows: column 0
    (w0 = 0) and the columns past ``cols``."""
    rng = np.random.default_rng(seed)
    bits = rng.random((K // 32, rows, 32)) < 0.1
    bT = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
    bT[0] &= np.uint32(~CONTROLLED & 0xFFFFFFFF)
    used = (rng.random((1, rows)) < 0.3).astype(np.int32)
    used[0, :chunk] = 1
    for r, cs in BUILT_ROWS.items():
        bT[0, r] |= np.uint32(sum(1 << c for c in cs))
        used[0, r] = 0
    for r in (7, 60, 100):  # column 0, which is not valid at w0 = 0
        bT[0, r] |= np.uint32(1)
        used[0, r] = 0
    return bT, used


def _pair_cases(bT, used, w0, cols, chunk, prow, cT):
    """Which of PAIR_CASES the reference's outputs hold: prow, and cT (row r's
    bit jj is set iff pivot jj eliminated row r; pivot 1 keeps its column-0
    bit)."""
    K, rows = 32 * bT.shape[0], bT.shape[1]
    chunks = -(-rows // chunk)

    def elim(jj):  # the chunks whose rows pivot jj eliminated
        r = np.flatnonzero((cT[jj >> 5] >> np.uint32(jj & 31)) & 1)
        return set((r // chunk).tolist())

    def chunk_of(jj):
        return prow[jj] // chunk if prow[jj] >= 0 else None

    found = set()
    for jj0 in range(0, K, 2):
        if not (1 <= 32 * w0 + jj0 and 32 * w0 + jj0 + 1 <= cols):
            continue
        c0, c1 = chunk_of(jj0), chunk_of(jj0 + 1)
        for c in range(1, chunks):
            t0, t1 = c0 is not None and c0 < c, c1 is not None and c1 < c
            if t0 and t1 and c in elim(jj0) and c in elim(jj0 + 1):
                found.add(PAIR_CASES[0])
            if t0 and not t1 and c in elim(jj0) and c1 == c:
                found.add(PAIR_CASES[1])
            if not t0 and t1 and c0 == c and c in elim(jj0 + 1):
                found.add(PAIR_CASES[2])
            if not t0 and not t1 and c0 == c1 == c:
                found.add(PAIR_CASES[3])
        p1 = prow[jj0 + 1]
        if (c0 is not None and c0 == c1 and (cT[jj0 >> 5][p1] >> np.uint32(jj0 & 31)) & 1
                and any(c > c1 for c in elim(jj0 + 1))):
            found.add(PAIR_CASES[4])
    return found


@pytest.mark.parametrize("cols", [49, 50])
@pytest.mark.parametrize("seed", [1, 2])
def test_every_pair_case_occurs_and_the_twin_is_the_pallas_scan(seed, cols):
    """130 rows in four chunks of 40 (the last of 10), K = 64, w0 = 0 (column
    0 not valid, and set on free rows), the last valid column odd (49) or
    even (50: its pair has column 0 alone), set columns past it: each pair
    case occurs, and the chain's twin equals the Pallas two-pivot scan, the
    step twin and the 1-pivot chain's twin."""
    bT, used = _built_slice(seed, cols)
    w0, K, chunk = 0, 64, 40
    prow, cT = _all_agree(bT, used, w0, K, cols, chunk)
    assert _pair_cases(bT, used, w0, cols, chunk, prow, cT) == set(PAIR_CASES)
    # the hand-built pivots: pair (6, 7) is case 3, column 12 pivots in chunk 2
    assert (prow[6], prow[7], prow[11], prow[12]) == (45, 4, 6, 81)
    # invalid columns at both ends held bits on free rows and pivot nothing
    free = used[0] == 0
    assert (bT[0][free] & 1).any() and prow[0] == -1
    tail = [j for j in range(cols + 1, K) if ((bT[j >> 5][free] >> np.uint32(j & 31)) & 1).any()]
    assert tail and (prow[cols + 1 :] == -1).all()


@pytest.mark.parametrize("rows,K,w0,cols,chunk,density,used_frac", [
    (130, 64, 0, 10**6, 40, 0.5, 0.3), (300, 64, 2, 80, 96, 0.5, 0.9),
    (257, 256, 1, 10**6, 64, 0.05, 0.5), (300, 256, 8, 300, 96, 0.02, 0.2),
])
def test_random_slices(rows, K, w0, cols, chunk, density, used_frac):
    """Dense and sparse random slices, K 64 and 256, w0 0 and > 0, a panel
    crossing cols: pivots come from more than one chunk, and the chain's twin
    equals the Pallas two-pivot scan and both step twins."""
    rng = np.random.default_rng(rows + K + w0)
    bits = rng.random((K // 32, rows, 32)) < density
    bT = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
    used = (rng.random((1, rows)) < used_frac).astype(np.int32)
    prow, _ = _all_agree(bT, used, w0, K, cols, chunk)
    assert len(set((prow[prow >= 0] // chunk).tolist())) > 1


@pytest.mark.parametrize("chunk", [1, 2, 7, 41, 129, 130, 500])
def test_any_chunk_size_gives_the_same_scan(chunk):
    """From one row a chunk (every election in a chunk of its own) to one
    chunk for the whole slice."""
    bT, used = _built_slice(3, 50)
    bt, u = t32(bT), torch.from_numpy(used)
    want = phase1.scan2_plain(bt, u, 0, 64, 50)
    for g, w in zip(phase1.scan2_chunked_plain(bt, u, 0, 64, 50, chunk), want):
        assert torch.equal(g, w)


def test_every_row_used_and_no_valid_column():
    bT, used = _built_slice(4, 50)
    bt = t32(bT)
    for u, cols in ((np.ones_like(used), 50), (used, 0)):
        got = phase1.scan2_chunked_plain(bt, torch.from_numpy(u), 0, 64, cols, 40)
        assert (got[0] == -1).all() and int(got[2].abs().sum()) == 0
        assert torch.equal(got[1], torch.from_numpy(u))


# -- the route -----------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [1, 4, 8])
@pytest.mark.parametrize("rows", [65536, 65537, 67328])
def test_scan2_route_chains_exactly_past_the_largest_cluster(rows, kw):
    """Up to 65536 rows the two-pivot cluster kernel; past them the chained
    two-pivot scan on the 1-pivot chain's equal chunks and clusters, its
    shared memory sized for the pair's header and the record."""
    route = phase1.scan2_route(rows, kw)
    if rows <= 65536:
        assert route.kernel == "scan2" and route.nblocks == 16
        return
    chained = phase1.scan_route(rows, kw)
    assert chained.kernel == "scan_chunked"
    assert route == chained._replace(kernel="scan2_chunked", smem_bytes=phase1.scan_smem_bytes(
        chained.rows_per_block, kw, pairs=True, chained=True))
    assert route.chunks == 2 and route.chunk_rows == -(-rows // 2)
    assert phase1.scan_fits(route.rows_per_block, kw, pairs=True, chained=True)


def test_the_pair_header_and_record_cost_no_rows():
    """The two-pivot header and the record in shared memory still leave a
    cluster 65536 rows at every width: a thread's 8 rows bind."""
    for kw in range(1, 9):
        assert phase1.scan_max_rows(kw, chained=True, pairs=True) == 65536
        assert phase1.scan_chunk_rows(67328, kw, pairs=True) == phase1.scan_chunk_rows(67328, kw)
    assert phase1.scan_chunked_route(5000, 8, 1024, kernel="scan2_chunked")[4:] == (
        5, 1024, 1)


# -- constants, signature, wrappers ----------------------------------------------------


def _c_parameters(name: str) -> list[str]:
    for source in sorted(CSRC.glob("*.cu")):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source.read_text())
        if m:
            return [p.strip() for p in m.group(1).split(",")]
    raise AssertionError(f"{name} is declared in no source")


def test_signature_and_shared_memory_mirror_the_source():
    """gf2_scan2_chunked takes the 1-pivot chain's arguments; its links' header
    is the two-pivot header then the record, as scan_smem_bytes counts it."""
    text = (CSRC / "scan2_chunked.cu").read_text()
    assert 'extern "C" int gf2_scan2_chunked(' in text
    assert _c_parameters("gf2_scan2_chunked") == _c_parameters("gf2_scan_chunked")
    assert _cuda._SIGNATURES["gf2_scan2_chunked"] == _cuda._SIGNATURES["gf2_scan_chunked"]
    assert _cuda.LAUNCHES["scan2_chunked"] == 0
    assert ("constexpr int kScan2ChainHeaderQuads = gf2::kScan2HeaderQuads + gf2::kRecordQuads;"
            in text)
    assert "scan2_cluster_body<kCluster, kSlots, true>" in text
    assert "mbarrier" not in text and "st.async" not in text
    header = phase1._SCAN2_HEADER_BYTES + phase1._RECORD_BYTES
    assert phase1.scan_smem_bytes(0, 8, pairs=True, chained=True) == header
    assert phase1.scan_smem_bytes(2104, 8, pairs=True, chained=True) == header + 2 * 16 * 2112
    body = (CSRC / "scan2_cluster.cuh").read_text()
    assert "bool kChain = false" in body and "sweep_taken_run<kSlots>" in body


def test_wrappers_run_the_twins_on_cpu_tensors():
    """On CPU tensors the chain's wrapper runs its twin and the entry point
    (phase1.scan, variant "2") the step twin; nothing is launched."""
    bT, used = _built_slice(5, 50)
    bt, u = t32(bT), torch.from_numpy(used)
    want = phase1.scan2_plain(bt, u, 0, 64, 50)
    _cuda.reset_launches()
    for got in (phase1.scan2_chunked(bt, u, 0, 64, 50), phase1.scan2_chunked(bt, u, 0, 64, 50, 40),
                phase1.scan(bt, u, 0, 64, 50, "2")):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert not any(_cuda.LAUNCHES.values())
    with pytest.raises(ValueError, match="does not match"):
        phase1.scan2_chunked(bt, u, 0, 96, 50)
    with pytest.raises(ValueError, match="chunk_rows"):
        phase1.scan2_chunked(bt, u, 0, 64, 50, 0)

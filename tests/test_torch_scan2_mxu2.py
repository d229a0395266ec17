"""The two-pivot scan as a cluster kernel and the one-launch mxu2 and mxu4
updates, as far as the CPU can hold them.

The kernels run only on the card (``tests/test_torch_cuda.py``).  Here:

* ``phase1.scan2_cluster_plain`` (the cluster kernel's order: each block's
  m0, P0, P1 from the same state, then the fold over the slots) against the
  step-by-step twin, the 1-pivot twin and the Pallas two-pivot scan in
  interpret mode: cluster sizes 1-16, ragged and empty last blocks, slices
  built by hand so that each election case that breaks a wrong election
  occurs (each asserted on the input), a first column that is not valid, a
  last valid column of either parity, no pivot, every row used;
* ``phase1.scan2_route`` as a pure function of the shape (the chained
  two-pivot scan past the largest cluster), the constants the Python side
  mirrors from ``csrc/`` and the new C signatures;
* a numpy model of the strip kernel's fragments (the five-stage shuffle
  transpose that builds B, held against the ballot definition; which thread
  holds which bit column of which row, the B column order and shared-memory
  layout, the repack into whole words, the staged 16-byte write-out) against
  ``update_mxu2_plain`` / ``update_mxu4_plain`` and the Pallas
  ``panel_update_mxu2`` / ``panel_update_mxu4`` in interpret mode under every
  trailing ``w0`` the card tests use and each engine's rule.

Seeded numpy inputs; tolerance 0: integer GF(2) arithmetic.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu.ops import pallas_update as pu_jax
from gf2bv_tpu.ops.pallas_phase1 import _call_scan_kernel
from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import _cuda, panel_update, phase1

torch.set_num_threads(2)

CSRC = Path(phase1.__file__).resolve().parent.parent / "csrc"
CLUSTERS = [1, 2, 4, 8, 16]


def t32(a):
    return u32_to_torch(a, "cpu")


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr \w+ {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def _same(got, want, what=""):
    for g, w in zip(got, want):
        assert torch.equal(g, w), what


def _pallas_scan2(bT, used, w0, K, cols):
    return [np.asarray(x) for x in _call_scan_kernel(
        jnp.asarray(bT), jnp.asarray(used), jnp.asarray([w0], jnp.int32), K, cols, True, "2")]


def _all_agree(bT, used, w0, K, cols, nblocks, pallas=False):
    """The cluster twin on ``nblocks`` blocks = the step twin = the 1-pivot
    twin (= the Pallas kernel); returns the step twin's outputs."""
    bt, u = t32(bT), torch.from_numpy(used)
    want = phase1.scan2_plain(bt, u, w0, K, cols)
    _same(phase1.scan2_cluster_plain(bt, u, w0, K, cols, nblocks), want, "cluster twin")
    _same(phase1.scan_plain(bt, u, w0, K, cols), want, "1-pivot twin")
    if pallas:
        prow, used_j, cT = _pallas_scan2(bT, used, w0, K, cols)
        assert np.array_equal(want[0].numpy(), prow)
        assert np.array_equal(want[1].numpy(), used_j)
        assert np.array_equal(torch_to_u32(want[2]), cT)
    return want


def _random_slice(rows, K, seed, density=0.5, used_frac=0.25):
    rng = np.random.default_rng(seed)
    bits = rng.random((K // 32, rows, 32)) < density
    bT = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
    used = (rng.random((1, rows)) < used_frac).astype(np.int32)
    return bT, used


# -- the cluster twin against the step twin -----------------------------------------


@pytest.mark.parametrize("nblocks", CLUSTERS)
@pytest.mark.parametrize("rows,K,w0,cols,density", [
    (300, 64, 2, 80, 0.5), (700, 96, 1, 10**6, 0.05), (64, 256, 0, 200, 0.02),
    (47, 64, 3, 10**6, 0.3), (33, 64, 1, 10**6, 0.3),
])
def test_scan2_cluster_twin_matches_the_step_twin(rows, K, w0, cols, density, nblocks):
    """Dense and sparse slices on every cluster size; 47 rows on 16 blocks
    leaves a ragged last block, 33 rows on 16 blocks five empty ones."""
    bT, used = _random_slice(rows, K, rows + K + nblocks, density)
    prow = _all_agree(bT, used, w0, K, cols, nblocks)[0]
    assert (prow >= 0).any()


# Hand-built sparse slices: 64 rows, K = 64, w0 = 1 (every column valid), four
# blocks of 16 rows.  Each sets bits jj0 = 0 and 1 of word 0 on a few rows (the
# first pair), with sparse random bits in the other columns.
ELECTION_CASES = {
    # pivot 0 in block 2, pivot 1 (bit 1 alone) in block 0
    "pivot 1 before pivot 0's block": {35: 0b01, 3: 0b10, 50: 0b11},
    # pivot 0 in block 0 with its bit 1 set (h = 1); block 2's m0 (bit 0 alone)
    # is a column-1 candidate through the virtual elimination and the lowest
    "pivot 1 is m0 of a later block": {5: 0b11, 36: 0b01, 37: 0b11, 52: 0b10},
    # pivot 0 in block 1 is the only row of block 1 with bit 1: under h = 1 its
    # own candidacy vanishes and pivot 1 comes from block 2
    "m0 of pivot 0's block is its only bit-1 row": {20: 0b11, 40: 0b10, 41: 0b01},
    # h = 1 flips candidacy: row 4 has bit 1 but is eliminated by pivot 0 to 0;
    # row 9 has bit 0 alone and becomes the candidate
    "pivot 0's bit 1 flips candidacy": {2: 0b11, 4: 0b11, 9: 0b01, 30: 0b10},
}


def _election_slice(name, seed):
    rng = np.random.default_rng(seed)
    rows, K = 64, 64
    bT = ((rng.random((K // 32, rows, 32)) < 0.06) * (1 << np.arange(32, dtype=np.uint64))
          ).sum(-1).astype(np.uint32)
    bT[0] &= np.uint32(~3 & 0xFFFFFFFF)
    for r, bits in ELECTION_CASES[name].items():
        bT[0, r] |= np.uint32(bits)
    used = np.zeros((1, rows), np.int32)
    used[0, 60] = 1
    bT[0, 60] |= np.uint32(3)  # a used row with both bits: never a candidate
    return bT, used


def _first_pair_cases(bT, used, nblocks):
    """Which election cases the first pair (columns 0 and 1 of word 0, both
    valid) of this slice holds, by an election of its own in numpy."""
    rows = bT.shape[1]
    rpb = -(-rows // nblocks)
    free = used[0] == 0
    c0 = free & ((bT[0] & 1) == 1)
    b1 = free & ((bT[0] & 2) == 2)
    block = np.arange(rows) // rpb
    piv0 = int(np.flatnonzero(c0)[0])
    h = bool(b1[piv0])
    cand1 = b1 ^ (c0 & h)
    piv1 = int(np.flatnonzero(cand1)[0])
    m0 = {b: int(np.flatnonzero(c0 & (block == b))[0]) for b in set(block[c0])}
    raw1 = np.flatnonzero(b1 & (block == block[piv0]))
    found = set()
    if block[piv1] < block[piv0]:
        found.add("pivot 1 before pivot 0's block")
    if any(b > block[piv0] and m == piv1 for b, m in m0.items()):
        found.add("pivot 1 is m0 of a later block")
    if list(raw1) == [piv0]:
        found.add("m0 of pivot 0's block is its only bit-1 row")
    without_h = np.flatnonzero(b1 & (np.arange(rows) != piv0))
    if h and (not without_h.size or int(without_h[0]) != piv1):
        found.add("pivot 0's bit 1 flips candidacy")
    return found, piv0, piv1


@pytest.mark.parametrize("nblocks", [4, 16])
@pytest.mark.parametrize("name", sorted(ELECTION_CASES))
def test_scan2_election_cases(name, nblocks):
    """Each case that breaks a wrong election occurs in its slice (asserted
    on the input), and the cluster twin, the step twin, the 1-pivot twin and
    the Pallas two-pivot scan agree on the whole panel."""
    bT, used = _election_slice(name, seed=len(name))
    found, piv0, piv1 = _first_pair_cases(bT, used, 4)
    assert name in found
    prow = _all_agree(bT, used, 1, 64, 10**6, nblocks, pallas=nblocks == 4)[0]
    assert (int(prow[0]), int(prow[1])) == (piv0, piv1)


@pytest.mark.parametrize("w0,cols,what", [
    (0, 10**6, "column 0 of the panel is not valid: the first pair has column 1 alone"),
    (2, 64 + 40, "the last valid column is even: its pair has column 0 alone"),
    (2, 64 + 41, "the last valid column is odd"),
    (2, 0, "no valid column"),
    (2, 64, "only the first column of the panel is valid"),
])
def test_scan2_invalid_columns(w0, cols, what):
    bT, used = _random_slice(400, 64, w0 + cols, density=0.3)
    want = _all_agree(bT, used, w0, 64, cols, 4, pallas=True)
    prow = want[0].numpy()
    valid = [1 <= 32 * w0 + j <= cols for j in range(64)]
    assert ((prow >= 0) <= np.array(valid)).all(), what
    for nb in CLUSTERS:
        _same(phase1.scan2_cluster_plain(t32(bT), torch.from_numpy(used), w0, 64, cols, nb),
              want, what)


@pytest.mark.parametrize("kind", ["zero slice", "every row used"])
def test_scan2_without_pivots(kind):
    bT, used = _random_slice(200, 64, 5, density=0.3)
    if kind == "zero slice":
        bT[:] = 0
    else:
        used[:] = 1
    want = _all_agree(bT, used, 1, 64, 10**6, 8, pallas=True)
    assert (want[0] == -1).all() and int(want[2].abs().sum()) == 0


@pytest.mark.parametrize("K,w0,cols", [(64, 0, 5000), (64, 2, 80), (256, 8, 300)])
def test_scan2_cluster_twin_matches_pallas(K, w0, cols):
    bT, used = _random_slice(512, K, K + w0, density=0.5, used_frac=0.3)
    _all_agree(bT, used, w0, K, cols, 4, pallas=True)


# -- routes, constants, signatures, wrappers ---------------------------------------------


@pytest.mark.parametrize("kw", [1, 4, 8])
@pytest.mark.parametrize("rows", [1, 256, 768, 2560, 20224, 40192, 65536, 65537, 67328])
def test_scan2_route(rows, kw):
    """The cluster kernel on the 1-pivot scan's cluster size with the
    two-pivot header; the chained two-pivot scan exactly past its largest
    cluster."""
    route = phase1.scan2_route(rows, kw)
    scan = phase1.scan_route(rows, kw)
    if scan.kernel != "scan" or not phase1.scan_fits(scan.rows_per_block, kw, pairs=True):
        assert route == phase1.scan_chunked_route(rows, kw, kernel="scan2_chunked")
        # the 1-pivot chain's equal chunks and clusters, under the pair's header
        assert route[1:3] + route[4:] == scan[1:3] + scan[4:]
        assert route.smem_bytes == phase1.scan_smem_bytes(route.rows_per_block, kw, pairs=True,
                                                          chained=True) <= phase1.SCAN_SMEM_MAX
        return
    assert route.kernel == "scan2"
    assert (route.nblocks, route.rows_per_block) == (scan.nblocks, scan.rows_per_block)
    assert route.smem_bytes == phase1.scan_smem_bytes(route.rows_per_block, kw, pairs=True)
    assert route.smem_bytes <= phase1.SCAN_SMEM_MAX


def test_scan2_route_of_the_solver_shapes():
    assert phase1.scan2_route(20224, 8)[:3] == ("scan2", 16, 1264)
    assert phase1.scan2_route(40192, 8)[:3] == ("scan2", 16, 2512)
    assert phase1.scan2_route(768, 8)[:3] == ("scan2", 1, 768)
    assert phase1.scan2_route(65536, 8).kernel == "scan2"
    assert phase1.scan2_route(65537, 8).kernel == "scan2_chunked"
    assert phase1.scan2_route(67328, 8) == (
        "scan2_chunked", 16, 2104, phase1.scan_smem_bytes(2104, 8, pairs=True, chained=True), 2,
        33664, 16)


@pytest.mark.parametrize("rows,kw", [(0, 8), (300, 9), (300, 0)])
def test_scan2_route_rejects_what_no_kernel_takes(rows, kw):
    with pytest.raises(ValueError):
        phase1.scan2_route(rows, kw)


def test_scan2_constants_mirror_the_sources():
    slot = _constant("scan2_cluster.cuh", "kScan2SlotQuads")
    assert slot == phase1.SCAN2_SLOT_QUADS == 7  # words of m0, P0, P1; then the rows
    header = (CSRC / "scan2_cluster.cuh").read_text()
    assert "2 * kMaxCluster * kScan2SlotQuads + 2 * (kClusterThreads / 32) + 1" in header
    warps = phase1.SCAN_THREADS // 32
    assert phase1.scan_smem_bytes(0, 8, pairs=True) == 16 * (2 * 16 * slot + 2 * warps + 1)
    assert phase1.scan_smem_bytes(32, 8, pairs=True) == phase1.scan_smem_bytes(0, 8, pairs=True) \
        + 2 * 16 * 32
    text = (CSRC / "scan2.cu").read_text()
    assert '#include "scan2_cluster.cuh"' in text
    assert "mbarrier" not in text and "st.async" not in text
    assert "gf2::scan2_cluster_body<" in text and "scan2_cluster_body" in header
    assert "scan2" not in (CSRC / "scan.cu").read_text().replace(
        "The two-pivot scan (gf2_scan2) lives in scan2.cu", "")


def _c_parameters(name: str) -> list[str]:
    for source in sorted(CSRC.glob("*.cu")):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source.read_text())
        if m:
            return [p.strip() for p in m.group(1).split(",")]
    raise AssertionError(f"{name} is declared in no source")


@pytest.mark.parametrize("name", ["gf2_scan2", "gf2_update_mxu2", "gf2_update_mxu4"])
def test_new_signatures_match_the_c_entry_points(name):
    params = _c_parameters(name)
    want = [ctypes.c_void_p if "*" in p or p.startswith("cudaStream_t") else ctypes.c_int
            for p in params]
    assert _cuda._SIGNATURES[name] == want, params


def test_new_kernels_are_counted_under_their_own_names():
    for key in ("scan2", "update_mxu2"):
        assert key in _cuda.LAUNCHES
    # one launch, no scratch: neither tensor-core entry point takes pf
    # transposed any more, and the two share their C signature
    assert "pfT" not in " ".join(_c_parameters("gf2_update_mxu2"))
    assert "pfT" not in " ".join(_c_parameters("gf2_update_mxu4"))
    assert _cuda._SIGNATURES["gf2_update_mxu4"] == _cuda._SIGNATURES["gf2_update_mxu2"]


def test_scan2_wrappers_run_the_twins_on_cpu_tensors():
    bT, used = _random_slice(300, 64, 11)
    bt, u = t32(bT), torch.from_numpy(used)
    want = phase1.scan2_plain(bt, u, 2, 64, 10**6)
    _cuda.reset_launches()
    for got in (phase1.scan(bt, u, 2, 64, 10**6, "2"), phase1.scan2(bt, u, 2, 64, 10**6),
                phase1.scan2_cluster(bt, u, 2, 64, 10**6, 4)):
        _same(got, want)
    assert not any(_cuda.LAUNCHES.values())
    with pytest.raises(ValueError, match="no cluster"):
        phase1.scan2_cluster(bt, u, 2, 64, 10**6, 3)
    with pytest.raises(ValueError, match="does not match"):
        phase1.scan2(bt, u, 2, 96, 10**6)


# -- the mxu2 kernel's fragments, modelled in numpy ---------------------------------------

STRIP = _constant("update_mma.cu", "kMx2Strip")
B_WORDS = _constant("update_mma.cu", "kMx2BWords")
STAGE = _constant("update_mma.cu", "kMx2Stage")


def _b_index(w, p, k):
    """update_mma.cu: mx2_b_index."""
    J, e = p >> 1, p & 1
    return w * B_WORDS + (J >> 1) * 32 + e * 16 + (k & 3) * 4 + (J & 1) * 2 + (k >> 2)


LANE = np.arange(32)
G_OF, T_OF = LANE >> 2, LANE & 3  # lane 4g + t


def _mma16(a_frag, b_frag):
    """16 products mma.sync.m16n8k256 b1 and.popc from the 32 threads'
    fragments.  a_frag (32, 4): thread (g, t) = lane 4g + t holds A words t,
    4 + t of rows g and g + 8 (a0: row g word t, a1: row g + 8 word t, a2: row
    g word 4 + t, a3: row g + 8 word 4 + t).  b_frag (32, 16, 2): for each
    product, k-words t and 4 + t of column g.  Returns (32, 16, 4): thread
    (g, t)'s counts of columns 2t, 2t + 1 of rows g and g + 8."""
    A = np.zeros((16, 8), np.uint32)
    A[G_OF, T_OF], A[G_OF + 8, T_OF] = a_frag[:, 0], a_frag[:, 1]
    A[G_OF, 4 + T_OF], A[G_OF + 8, 4 + T_OF] = a_frag[:, 2], a_frag[:, 3]
    B = np.zeros((16, 8, 8), np.uint32)  # [product][column][k-word]
    B[:, G_OF, T_OF] = b_frag[:, :, 0].T
    B[:, G_OF, 4 + T_OF] = b_frag[:, :, 1].T
    D = np.bitwise_count(A[None, :, None, :] & B[:, None, :, :]).sum(-1)  # (16, 16, 8)
    return np.stack([D[:, G_OF, 2 * T_OF], D[:, G_OF, 2 * T_OF + 1],
                     D[:, G_OF + 8, 2 * T_OF], D[:, G_OF + 8, 2 * T_OF + 1]], -1).transpose(1, 0, 2)


def _ballot_transpose(x):
    """The definition of the B build's transpose: x (..., 32) words, row j in
    lane j; lane p of the result holds bit j = bit p of x[j] (what 32 ballots,
    each kept by lane p, give)."""
    shifts = np.arange(32, dtype=np.uint64)
    bits = (x.astype(np.uint64)[..., :, None] >> shifts) & 1  # [..][j][p]
    return (bits << shifts[:, None]).sum(-2).astype(np.uint32)  # [..][p]


def _shuffle_transpose(x):
    """update_mma.cu: transpose32 on every warp of x (..., 32) at once:
    stage d = 16, 8, 4, 2, 1 exchanges x with lane ^ d (__shfl_xor_sync); a
    lane with bit d clear keeps its low bits of each 2d-bit group and takes
    its partner's low bits into its high ones, the partner the other way."""
    x = x.astype(np.uint32).copy()
    lane = np.arange(32)
    for d, m in zip((16, 8, 4, 2, 1), (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333,
                                       0x55555555)):
        m, dd = np.uint32(m), np.uint32(d)
        y = x[..., lane ^ d]
        upper = (lane & d) != 0
        x = np.where(upper, (x & ~m) | ((y >> dd) & m), (x & m) | ((y & m) << dd))
    return x


def _strip_rule(wp, w0, engine):
    """update_mma.cu: mxu2_rule / mxu4_rule as (head_words, word_lo)."""
    tw = 128 if wp % 128 == 0 else wp
    if engine == "mxu4":
        return (1, w0 // tw * tw) if w0 is not None and tw <= w0 else (0, 0)
    dead = 0 if w0 is None else w0 // tw
    return (tw, dead * tw) if dead >= 2 else (0, 0)


def _mxu2_model(a, sel, pf, w0, engine="mxu2"):
    """The strip kernel step by step on numpy arrays: a (rows, wp), sel (rows,
    kw), pf (32 kw, wp) uint32; returns a ^ S.PF under the engine's trailing
    rule (the same kernel runs both)."""
    a = a.copy()
    rows, wp = a.shape
    kw = sel.shape[1]
    head, lo = _strip_rule(wp, w0, engine)
    strips = [(s, head) for s in range(0, head, STRIP)] + [(s, wp) for s in range(lo, wp, STRIP)]
    w_idx, p_idx, k_idx = np.meshgrid(np.arange(STRIP), np.arange(32), np.arange(8), indexing="ij")
    b_at = _b_index(w_idx, p_idx, k_idx)
    sel_pad = np.zeros((rows + 16, 8), np.uint32)
    sel_pad[:rows, :kw] = sel
    for s, end in strips:
        nw = min(STRIP, end - s)
        # B of the strip: warp k transposes k-word k by five shuffle stages;
        # lane p gets bit j = bit p of pf[32k + j][s + w]
        x = np.zeros((STRIP, 8, 32), np.uint32)  # [w][k][lane j]
        x[:nw, :kw] = pf[:, s : s + nw].T.reshape(nw, kw, 32)
        bsm = np.zeros(STRIP * B_WORDS, np.uint32)
        bsm[b_at] = _shuffle_transpose(x).transpose(0, 2, 1)
        for rbase in range(0, rows, 16):
            af = np.stack([sel_pad[rbase + G_OF, T_OF], sel_pad[rbase + G_OF + 8, T_OF],
                           sel_pad[rbase + G_OF, 4 + T_OF], sel_pad[rbase + G_OF + 8, 4 + T_OF]],
                          1)
            stage = np.zeros((16, STAGE), np.uint32)
            for G in range((nw + 3) // 4):
                base = (4 * G + (G_OF >> 1)) * B_WORDS + (G_OF & 1) * 16 + 4 * T_OF
                quads = bsm[base[:, None, None] + 32 * np.arange(8)[None, :, None]
                            + np.arange(4)[None, None, :]]  # (32, jp, 4)
                frag = quads.reshape(32, 8, 2, 2).reshape(32, 16, 2)  # product J = 2 jp + j
                c = (_mma16(af, frag) & 1).astype(np.uint64)  # (32, 16, 4)
                bit = np.uint64(1) << (2 * np.arange(16, dtype=np.uint64))
                lo_w = ((c[:, :, 0] | (c[:, :, 1] << 1)) * bit).sum(1)
                hi_w = ((c[:, :, 2] | (c[:, :, 3] << 1)) * bit).sum(1)
                stage[G_OF, 4 * G + T_OF] = lo_w.astype(np.uint32)
                stage[G_OF + 8, 4 * G + T_OF] = hi_w.astype(np.uint32)
            # write-out: lane l, rows 4i + l // 8, words 4 (l % 8) .. + 3 of the strip
            for i in range(4):
                for lane in range(32):
                    rl, cq = 4 * i + (lane >> 3), lane & 7
                    r = rbase + rl
                    n = max(0, min(4, nw - 4 * cq))
                    if r < rows and n:
                        a[r, s + 4 * cq : s + 4 * cq + n] ^= stage[rl, 4 * cq : 4 * cq + n]
    return a


def test_mxu2_b_layout_is_a_bijection_and_conflict_free():
    """Every (word, bit column, k-word) has its own B word; a thread's 16-byte
    load is the B fragments of products J and J + 1 of its column; each
    quarter of a warp's 16-byte loads, and each of its stage stores, hits 32
    distinct banks."""
    idx = {_b_index(w, p, k) for w in range(STRIP) for p in range(32) for k in range(8)}
    assert idx == set(range(STRIP * B_WORDS))
    for G in range(8):
        for jp in range(8):
            banks = []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                w, e = 4 * G + (g >> 1), g & 1
                base = (4 * G + (g >> 1)) * B_WORDS + e * 16 + 4 * t + 32 * jp
                assert [base, base + 1, base + 2, base + 3] == [
                    _b_index(w, 4 * jp + e, t), _b_index(w, 4 * jp + e, t + 4),
                    _b_index(w, 4 * jp + 2 + e, t), _b_index(w, 4 * jp + 2 + e, t + 4)]
                banks.append({(base + i) % 32 for i in range(4)})
            for phase in range(4):
                quarter = banks[8 * phase : 8 * phase + 8]
                assert len(set().union(*quarter)) == 32
        stores = {(g * STAGE + 4 * G + t) % 32 for g in range(8) for t in range(4)}
        assert len(stores) == 32
    assert (STAGE * 4) % 16 == 0  # staged rows keep 16-byte alignment


@pytest.mark.parametrize("seed", range(4))
def test_shuffle_transpose_is_the_ballot_transpose(seed):
    """The five-stage shuffle transpose of the B build gives every lane what
    the 32 ballots gave (lane p: bit j = bit p of row j's word) on random,
    sparse and structured 32 x 32 blocks."""
    rng = np.random.default_rng(seed)
    blocks = [rng.integers(0, 2**32, size=(64, 32), dtype=np.uint32),
              np.where(rng.random((64, 32)) < 0.05,
                       np.uint32(1) << rng.integers(0, 32, size=(64, 32)).astype(np.uint32),
                       np.uint32(0)),
              np.uint32(1) << np.arange(32, dtype=np.uint32)[None, :].repeat(2, 0),
              np.full((1, 32), 0xFFFFFFFF, np.uint32), np.zeros((1, 32), np.uint32)]
    for x in blocks:
        got = _shuffle_transpose(x)
        assert np.array_equal(got, _ballot_transpose(x))
        assert np.array_equal(_shuffle_transpose(got), x)  # a transpose twice is the block
    eye = np.uint32(1) << np.arange(32, dtype=np.uint32)
    assert np.array_equal(_shuffle_transpose(eye[None])[0], eye)


MODEL_SHAPES = [(40, 13, 32), (17, 384, 96), (20, 200, 256), (33, 256, 64), (36, 8, 256)]


@pytest.mark.parametrize("rows,wp,K", MODEL_SHAPES)
def test_mxu2_fragment_model_matches_the_twin_and_pallas(rows, wp, K):
    """Full and trailing at every w0 of the card tests: the model equals
    update_mxu2_plain and the Pallas mxu2 kernel in interpret mode."""
    rng = np.random.default_rng(rows + wp + K)
    a = rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32)
    sel = rng.integers(0, 2**32, size=(rows, K // 32), dtype=np.uint32)
    pf = rng.integers(0, 2**32, size=(K, wp), dtype=np.uint32)
    rows_j = -(-rows // 8) * 8  # the Pallas kernel tiles rows by 8
    pad = np.zeros((rows_j - rows, wp), np.uint32)
    for w0 in [None] + sorted({0, 8, 127, 128, 160, 256, wp - 8} & set(range(wp))):
        model = _mxu2_model(a, sel, pf, w0)
        twin = torch_to_u32(panel_update.update_mxu2_plain(t32(a), t32(sel), t32(pf), w0))
        assert np.array_equal(model, twin), w0
        if w0 in (None, 0, 256, wp - 8):
            got = np.asarray(pu_jax.panel_update_mxu2(
                jnp.asarray(np.concatenate([a, pad])),
                jnp.asarray(np.concatenate([sel, np.zeros((rows_j - rows, K // 32), np.uint32)])),
                jnp.asarray(pf), interpret=True,
                w0=None if w0 is None else jnp.asarray(w0, jnp.int32)))[:rows]
            assert np.array_equal(model, got), w0


@pytest.mark.parametrize("rows,wp,K", MODEL_SHAPES)
def test_mxu4_on_the_strip_kernel_matches_the_twin_and_pallas(rows, wp, K):
    """The strip kernel under mxu4's rule (word 0 alone of tile 0 and the
    tiles from w0's on, once tw <= w0) equals update_mxu4_plain, which
    follows the TPU body's second product, and the Pallas mxu4 kernel in
    interpret mode, full and at every w0 of the card tests."""
    rng = np.random.default_rng(rows + wp + K + 1)
    a = rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32)
    sel = rng.integers(0, 2**32, size=(rows, K // 32), dtype=np.uint32)
    pf = rng.integers(0, 2**32, size=(K, wp), dtype=np.uint32)
    rows_j = -(-rows // 8) * 8  # the Pallas kernel tiles rows by 8
    pad = np.zeros((rows_j - rows, wp), np.uint32)
    for w0 in [None] + sorted({0, 8, 127, 128, 160, 256, wp - 8} & set(range(wp))):
        model = _mxu2_model(a, sel, pf, w0, "mxu4")
        twin = torch_to_u32(panel_update.update_mxu4_plain(t32(a), t32(sel), t32(pf), w0))
        assert np.array_equal(model, twin), w0
        if w0 in (None, 160, wp - 8):
            got = np.asarray(pu_jax.panel_update_mxu4(
                jnp.asarray(np.concatenate([a, pad])),
                jnp.asarray(np.concatenate([sel, np.zeros((rows_j - rows, K // 32), np.uint32)])),
                jnp.asarray(pf), interpret=True,
                w0=None if w0 is None else jnp.asarray(w0, jnp.int32)))[:rows]
            assert np.array_equal(model, got), w0


@pytest.mark.parametrize("wp", [8, 13, 128, 200, 256, 384, 640, 768])
def test_mxu4_rule_covers_what_the_twin_updates(wp):
    """mxu4_rule's words are exactly those update_mxu4_plain changes (with an
    all-ones product every live word flips), at every w0."""
    rows, K = 16, 32
    sel = np.full((rows, 1), 1, np.uint32)  # selector bit 0: a ^= pf[0]
    pf = np.zeros((K, wp), np.uint32)
    pf[0] = 0xFFFFFFFF
    a = np.zeros((rows, wp), np.uint32)
    for w0 in [None] + list(range(0, wp, max(1, wp // 17))):
        head, lo = _strip_rule(wp, w0, "mxu4")
        live = np.zeros(wp, bool)
        live[:head] = True
        live[lo:] = True
        twin = torch_to_u32(panel_update.update_mxu4_plain(t32(a), t32(sel), t32(pf), w0))
        assert np.array_equal(twin[0] != 0, live), w0

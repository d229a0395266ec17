"""The fused kernels of slices taller than one cluster, as far as the CPU can
hold them.

The kernels (``gf2_phase1_fused_chunked``, ``gf2_update_scan_chunked`` in
``csrc/fused_chunked.cu``) run only on the card (``tests/test_torch_cuda.py``).
Here:

* their twins in the kernels' order, ``phase1.phase1_panel_chunked_plain``
  (the chained scan, then the blocked coefficient solve and the product
  through prow) and ``panel_update.update_scan_chunked_plain`` (the update
  under its rule, then the chained scan), with the chunks forced small (2 to
  8 of them), bit for bit against the JAX package's Pallas kernels
  (``pallas_phase1.phase1_panel``, ``pallas_update.panel_update_mxu_scan``) in
  interpret mode, on hand-built inputs on which each case that breaks a wrong
  chain or a wrong product occurs (asserted from the reference's outputs);
* the routes: past what the largest cluster holds both fused kernels take
  the chained scan's chunks and clusters, and up to it their cluster kernels;
* the shared memory of the chained kernel's last link, mirrored from
  ``csrc/``; the wrappers on CPU tensors.

Seeded numpy inputs; tolerance 0: integer GF(2) arithmetic.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu.ops import pallas_phase1
from gf2bv_tpu.ops.pallas_phase1 import _call_scan_kernel
from gf2bv_tpu.ops.pallas_update import panel_update_mxu_scan
from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import _cuda, panel_update, phase1

torch.set_num_threads(2)

CSRC = Path(phase1.__file__).resolve().parent.parent / "csrc"
ROWS = 136  # a multiple of 8: the Pallas fused kernel copies 8-row blocks
CHUNK0_ELIMINATES = "a chunk-0 pivot eliminates rows of later chunks"
ONLY_IN_LAST = "a column's only candidate lies in the last chunk"
EVERY_CHUNK = "the product reads pivot rows of every chunk"
ALL_USED = "every row is used"
NO_COLUMN = "cols = 0"
PARTIAL_LAST = "a partial last panel"
TRAILING = "the update trailing at a w0 past tile 0"
FULL = "the update at full width"
CASES = {CHUNK0_ELIMINATES, ONLY_IN_LAST, EVERY_CHUNK, ALL_USED, NO_COLUMN, PARTIAL_LAST,
         TRAILING, FULL}


def t32(a):
    return u32_to_torch(a, "cpu")


def _built_slice(rng, kw, chunk, used_frac, hand):
    """A sparse (kw, ROWS) slice (one bit in ten) whose first chunk is mostly
    used.  With ``hand`` three columns are made by hand:
      column 5: an unused row of chunk 0 and rows of chunks 1 and 2;
      column 20: one row of the last chunk alone, which has no bit below 20
        (so no earlier step touches it) while no other row has bit 20;
      column 30: no row at all."""
    bits = rng.random((kw, ROWS, 32)) < 0.1
    used = (rng.random((1, ROWS)) < used_frac).astype(np.int32)
    used[0, :chunk] = rng.random(chunk) < 0.8
    if hand:
        free0 = np.flatnonzero(used[0, :chunk] == 0)
        bits[0, :, 20] = bits[0, :, 30] = False
        last = ROWS - 5
        used[0, last] = 0
        bits[0, last, :21] = False
        bits[0, last, 20] = True
        for r in (free0[0], chunk + 5, chunk + 10, 2 * chunk + 5, 2 * chunk + 9):
            bits[0, r, 5] = True
            used[0, r] = 0 if r >= chunk else used[0, r]
    bT = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
    return bT, used


def _scan_cases(prow, cT, chunk, w0, K, cols):
    """The scan's cases this input holds, read from the reference's prow and
    cT (row r's bit jj is set iff pivot jj eliminated row r)."""
    last = (ROWS - 1) // chunk
    found = set()
    for jj in range(K):
        p = int(prow[jj])
        elim = np.flatnonzero((cT[jj >> 5] >> np.uint32(jj & 31)) & 1)
        if p >= 0 and p // chunk == 0 and (elim // chunk > 0).any():
            found.add(CHUNK0_ELIMINATES)
        if p >= 0 and p // chunk == last and elim.size == 0:
            found.add(ONLY_IN_LAST)
    pivots = prow[prow >= 0]
    if set((pivots // chunk).tolist()) == set(range(last + 1)):
        found.add(EVERY_CHUNK)
    if pivots.size == 0 and cols == 0:
        found.add(NO_COLUMN)
    first_out = cols - 32 * w0 + 1  # the panel's first column past cols
    if 0 < first_out < K and pivots.size and (prow[first_out:] < 0).all():
        found.add(PARTIAL_LAST)
    return found


# -- the fused phase 1 ---------------------------------------------------------------------

# (seed, wp, kw, panel, cols, chunk, used_frac, hand, the cases it must show);
# panel: "first", "middle" or "last" of the rows' words
PHASE1 = [
    (1, 128, 2, "first", 50, 40, 0.1, True, {CHUNK0_ELIMINATES, ONLY_IN_LAST, EVERY_CHUNK}),
    (2, 128, 2, "last", 32 * 128 - 40, 20, 0.1, True, {PARTIAL_LAST, ONLY_IN_LAST}),
    (3, 128, 2, "middle", 10**6, 68, 1.0, False, {ALL_USED}),
    (4, 128, 2, "middle", 0, 17, 0.1, False, {NO_COLUMN}),
    (5, 256, 3, "middle", 10**6, 34, 0.2, False, {EVERY_CHUNK}),
]


@pytest.mark.parametrize("seed,wp,kw,panel,cols,chunk,used_frac,hand,cases", PHASE1)
def test_phase1_chunked_twin_is_the_pallas_fused_kernel(seed, wp, kw, panel, cols, chunk,
                                                         used_frac, hand, cases):
    """136 rows in chunks of 17 to 68 (8 to 2 chunks): the chain's twin equals
    the Pallas fused phase 1 (pf, prow, used') and the step twin, and each
    case occurs, read from the Pallas kernels' outputs."""
    rng = np.random.default_rng(seed)
    K = 32 * kw
    w0 = {"first": 0, "middle": (wp // 2) // kw * kw, "last": wp - kw}[panel]
    a = rng.integers(0, 2**32, size=(ROWS, wp), dtype=np.uint32)
    bT, used = _built_slice(rng, kw, chunk, used_frac, hand)
    if used_frac == 1.0:
        used[:] = 1
    a[:, w0 : w0 + kw] = bT.T
    want = [np.asarray(x) for x in pallas_phase1.phase1_panel(
        jnp.asarray(a), jnp.asarray(bT), jnp.asarray(used), w0, K, cols, True)]
    scan_ref = [np.asarray(x) for x in _call_scan_kernel(
        jnp.asarray(bT), jnp.asarray(used), jnp.asarray([w0], jnp.int32), K, cols, True)]
    assert np.array_equal(scan_ref[0], want[1])
    found = _scan_cases(want[1], scan_ref[2], chunk, w0, K, cols)
    if (used == 1).all() and (want[1] < 0).all() and not want[0].any():
        found.add(ALL_USED)
    assert cases <= found, cases - found
    args = (t32(a), t32(bT), torch.from_numpy(used), w0, K, cols)
    got = phase1.phase1_panel_chunked_plain(*args, chunk)
    assert np.array_equal(torch_to_u32(got[0]), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert np.array_equal(got[2].numpy(), want[2])
    for g, p in zip(got, phase1.phase1_panel_plain(*args)):
        assert torch.equal(g, p)


# -- the fused update + scan ---------------------------------------------------------------

# (seed, w0, cols, chunk, used_frac, the cases it must show): 256-word rows
# (two 128-word tiles), K = 32, the next slice at w0n = 0
UPDATE = [
    (6, None, 50, 40, 0.1, {FULL, CHUNK0_ELIMINATES, ONLY_IN_LAST}),
    (7, 130, 50, 20, 0.1, {TRAILING, CHUNK0_ELIMINATES, ONLY_IN_LAST}),
    (8, 200, 0, 68, 1.0, {TRAILING, NO_COLUMN}),
]


def _update_cases(a, out, w0):
    """The update's rule, read from the reference's updated matrix: at full
    width tile 0 changes past word 0; trailing past tile 0 it changes only in
    word 0 there, and in the tile that holds w0."""
    found = set()
    tile0 = (out[:, 1:128] != a[:, 1:128]).any()
    if w0 is None and tile0:
        found.add(FULL)
    if (w0 is not None and w0 >= 128 and not tile0 and (out[:, 0] != a[:, 0]).any()
            and (out[:, 128:] != a[:, 128:]).any()):
        found.add(TRAILING)
    return found


@pytest.mark.parametrize("seed,w0,cols,chunk,used_frac,cases", UPDATE)
def test_update_scan_chunked_twin_is_the_pallas_fused_kernel(seed, w0, cols, chunk, used_frac,
                                                             cases):
    """The update of a 136 x 256-word matrix at full width or trailing past
    tile 0, fused with the chained scan of a hand-built next slice in 2 to 7
    chunks: the twin equals the Pallas look-ahead kernel (a', prow, cT,
    used') and the step twin, and each case occurs, read from the Pallas
    kernel's outputs."""
    rng = np.random.default_rng(seed)
    wp, kw = 256, 1
    K = 32 * kw
    a = rng.integers(0, 2**32, size=(ROWS, wp), dtype=np.uint32)
    sel = rng.integers(0, 2**32, size=(ROWS, kw), dtype=np.uint32)
    pf = rng.integers(0, 2**32, size=(K, wp), dtype=np.uint32)
    bTn, used = _built_slice(rng, kw, chunk, used_frac, used_frac < 1.0)
    if used_frac == 1.0:
        used[:] = 1
    want = [np.asarray(x) for x in panel_update_mxu_scan(
        jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), jnp.asarray(bTn),
        jnp.asarray(used), jnp.asarray(0, jnp.int32), cols=cols,
        w0=None if w0 is None else jnp.asarray(w0, jnp.int32), interpret=True)]
    found = _update_cases(a, want[0], w0) | _scan_cases(want[1], want[2], chunk, 0, K, cols)
    assert cases <= found, cases - found
    args = (t32(sel), t32(pf), t32(bTn), torch.from_numpy(used), 0, cols, w0)
    got = panel_update.update_scan_chunked_plain(t32(a), *args, chunk)
    assert np.array_equal(torch_to_u32(got[0]), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert np.array_equal(torch_to_u32(got[2]), want[2])
    assert np.array_equal(got[3].numpy(), want[3])
    for g, p in zip(got, panel_update.update_scan_plain(t32(a), *args)):
        assert torch.equal(g, p)


def test_every_case_is_required_somewhere():
    assert set().union(*(c[-1] for c in PHASE1 + UPDATE)) == CASES


# -- the routes ----------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [1, 4, 8])
@pytest.mark.parametrize("rows", [65537, 67328, 131073, 140000])
def test_fused_routes_chain_past_the_largest_cluster(rows, kw):
    """Both fused kernels take the chained scan's chunks and clusters under
    their own names."""
    scan = phase1.scan_route(rows, kw)
    assert scan.kernel == "scan_chunked"
    assert phase1.phase1_fused_route(rows, kw) == scan._replace(kernel="phase1_fused_chunked")
    assert panel_update.update_scan_route(rows, kw) == scan._replace(
        kernel="update_scan_chunked")


@pytest.mark.parametrize("rows", [768, 20224, 40192, 65536])
def test_fused_routes_keep_their_cluster_kernels(rows):
    scan = phase1.scan_route(rows, 8)
    assert phase1.phase1_fused_route(rows, 8)[:3] == ("phase1_fused",) + scan[1:3]
    assert panel_update.update_scan_route(rows, 8) == scan._replace(kernel="update_scan")


def test_routes_of_the_very_tall_system():
    """67328 rows at K = 256: two chunks of 33664 rows on 16 blocks, the last
    link's blocks asking for the product's 151 KB."""
    route = phase1.phase1_fused_route(67328, 8)
    assert (route.chunks, route.chunk_rows, route.nblocks, route.nblocks_last) == (
        2, 33664, 16, 16)
    assert phase1.phase1_fused_smem_bytes(route.rows_per_block, 8, chained=True) == 154384
    assert phase1.phase1_fused_smem_bytes(2104, 8, chained=True) <= phase1.SCAN_SMEM_MAX


@pytest.mark.parametrize("rows", [1, 2, 130, 67328, 140000])
def test_update_share_beside_the_first_link(rows):
    """Three quarters of the update's rows beside the chain's first link, at
    least one; the kernel takes any count from 1 to rows."""
    first = panel_update.update_scan_first_rows(rows)
    assert 1 <= first <= rows and first == max(1, 3 * rows // 4)


# -- what the Python side mirrors from csrc/ -----------------------------------------------


def _constant(source: str, name: str) -> str:
    m = re.search(rf"constexpr \w+ {name} = ([^;]+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return m.group(1)


@pytest.mark.parametrize("kw", range(1, 9))
def test_last_link_shared_memory_mirrors_the_sources(kw):
    """The last link asks for the larger of the chained scan's shared memory
    and the chained header plus the product stages, which start after it."""
    assert _constant("scan_chunked.cuh", "kChainHeaderQuads") == (
        "scan_header_quads<false, true>()")
    header = 16 * (2 * int(_constant("scan_cluster.cuh", "kMaxCluster"))
                   * int(_constant("scan_cluster.cuh", "kSlotQuads")) + 2 * 32 // 4 + 1)
    record = 16 * (2 * 256 + 256 // 4)
    assert phase1.scan_smem_bytes(0, kw, chained=True) == header + record
    words = int(_constant("phase1_product.cuh", "kFusedSolveSmemWords"))
    assert words == phase1.FUSED_SOLVE_SMEM_WORDS
    product = 4 * 32 * kw * kw + max(4 * words, 16 * (4 * kw * 256 + 32 * kw))
    for rpb in (1, 2104, 4096):
        assert phase1.phase1_fused_smem_bytes(rpb, kw, chained=True) == max(
            phase1.scan_smem_bytes(rpb, kw, chained=True), header + record + product)
    text = (CSRC / "fused_chunked.cu").read_text()
    assert "smem4 + gf2::kChainHeaderQuads" in text
    assert "sizeof(uint4) * gf2::kChainHeaderQuads + gf2::fused_product_bytes(kw)" in text


def test_chained_fused_kernels_are_declared_and_counted():
    text = (CSRC / "fused_chunked.cu").read_text()
    for fn, key in (("gf2_phase1_fused_chunked", "phase1_fused_chunked"),
                    ("gf2_update_scan_chunked", "update_scan_chunked")):
        assert f'extern "C" int {fn}(' in text
        assert fn in _cuda._SIGNATURES and _cuda.LAUNCHES[key] == 0
    # one body each for the scan, the product and the update beside the scan
    assert "scan_cluster_body<kCluster, kSlots, false, true>" in text
    assert "gf2::phase1_product_body(" in text
    assert "launch_update_scan_by_slots<true>" in text
    assert "gf2::launch_chain_link(" in text
    assert "mbarrier" not in text and "st.async" not in text
    assert "gf2::phase1_product_body(" in (CSRC / "phase1_fused.cu").read_text()
    assert "launch_update_scan_by_slots<false>" in (CSRC / "panel_update.cu").read_text()


# -- the wrappers on CPU tensors -----------------------------------------------------------


def _small(seed, rows=300, wp=256, K=64):
    rng = np.random.default_rng(seed)
    a = t32(rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32))
    sel = t32(rng.integers(0, 2**32, size=(rows, K // 32), dtype=np.uint32))
    pf = t32(rng.integers(0, 2**32, size=(K, wp), dtype=np.uint32))
    bTn = t32(rng.integers(0, 2**32, size=(K // 32, rows), dtype=np.uint32))
    used = torch.from_numpy((rng.random((1, rows)) < 0.3).astype(np.int32))
    return a, sel, pf, bTn, used


@pytest.mark.parametrize("chunk", [None, 7, 77, 300])
def test_chunked_wrappers_run_the_twins_on_cpu_tensors(chunk):
    """On CPU tensors the wrappers run the chain's twins, launch nothing, and
    give the step twins' outputs at any chunk size."""
    a, sel, pf, bTn, used = _small(chunk or 0)
    bT = a[:, 4:6].T.contiguous()
    _cuda.reset_launches()
    got = phase1.phase1_panel_chunked(a, bT, used, 4, 64, 5000, chunk)
    for g, w in zip(got, phase1.phase1_panel_plain(a, bT, used, 4, 64, 5000)):
        assert torch.equal(g, w)
    for w0 in (None, 130):
        want = panel_update.update_scan_plain(a.clone(), sel, pf, bTn, used, 4, 5000, w0)
        for first in (None, 1, 100):  # the update's rows beside the first link
            got = panel_update.update_scan_chunked(a.clone(), sel, pf, bTn, used, 4, 5000, w0,
                                                   chunk, first)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    assert not any(_cuda.LAUNCHES.values())


def test_chunked_wrappers_reject():
    a, sel, pf, bTn, used = _small(9)
    bT = a[:, 4:6].T.contiguous()
    with pytest.raises(ValueError, match="outside"):
        phase1.phase1_panel_chunked(a, bT, used, 255, 64, 5000)
    with pytest.raises(ValueError, match="does not match"):
        phase1.phase1_panel_chunked(a, bT, used, 4, 96, 5000)
    with pytest.raises(ValueError, match="chunk_rows"):
        phase1.phase1_panel_chunked(a, bT, used, 4, 64, 5000, 0)
    with pytest.raises(ValueError, match="outside"):
        panel_update.update_scan_chunked(a.clone(), sel, pf, bTn, used, 4, 5000, 256)
    with pytest.raises(ValueError, match="chunk_rows"):
        panel_update.update_scan_chunked(a.clone(), sel, pf, bTn, used, 4, 5000, None, 70000)
    for first in (0, 301):
        with pytest.raises(ValueError, match="first_rows"):
            panel_update.update_scan_chunked(a.clone(), sel, pf, bTn, used, 4, 5000, None, None,
                                             first)

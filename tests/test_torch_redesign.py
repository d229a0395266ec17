"""The two kernels redesigned for Hopper, as far as the CPU can hold them.

The cluster scan and the table update run only on the card
(``tests/test_torch_cuda.py``).  Here: the scan's route and the update's
live strips as pure functions of the shapes, held against the plain twins;
the constants the Python side mirrors from the CUDA sources; and the
wrappers on CPU tensors, which run the twins, against the JAX package.
Tolerance 0: integer GF(2) arithmetic.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu.ops.pallas_phase1 import _call_scan_kernel
from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import _cuda, panel_update, phase1

torch.set_num_threads(2)

CSRC = Path(phase1.__file__).resolve().parent.parent / "csrc"
ROUTE_ROWS = [1, 255, 768, 20224, 40192]
WIDTHS = [13, 128, 200, 384, 640, 768]
W0_SWEEP = [0, 1, 7, 8, 12, 120, 127, 128, 129, 160, 255, 256, 300, 383, 384, 500, 632, 639,
            640, 700, 767]


def t32(a):
    return u32_to_torch(a, "cpu")


# -- the scan's route ----------------------------------------------------------


def _check_route(rows, kw):
    route = phase1.scan_route(rows, kw)
    if route.kernel == "scan_chunked":  # past the largest cluster: the chained scan
        assert rows > phase1.scan_max_rows(kw)
        assert route.chunks == -(-rows // route.chunk_rows) > 1
        assert route.chunk_rows <= phase1.scan_max_rows(kw, chained=True)
        return route
    assert route.kernel == "scan"
    assert route.nblocks in phase1.SCAN_CLUSTER_SIZES
    assert route.rows_per_block == -(-rows // route.nblocks)
    assert route.rows_per_block <= phase1.SCAN_MAX_SLOTS * phase1.SCAN_THREADS
    assert route.smem_bytes == phase1.scan_smem_bytes(route.rows_per_block, kw)
    assert route.smem_bytes <= 227 * 1024 == phase1.SCAN_SMEM_MAX
    # every row is owned by exactly one block: the blocks' ranges tile [0, rows)
    owned = np.zeros(rows, np.int32)
    for b in range(route.nblocks):
        lo = b * route.rows_per_block
        owned[lo : min(rows, lo + route.rows_per_block)] += 1
    assert (owned == 1).all()
    return route


@pytest.mark.parametrize("kw", range(1, 9))
@pytest.mark.parametrize("rows", ROUTE_ROWS)
def test_scan_route_holds_every_row_once(rows, kw):
    route = _check_route(rows, kw)
    assert route.kernel == "scan"
    if route.nblocks > 1:  # a smaller cluster would own more rows a block than aimed at
        assert -(-rows // (route.nblocks // 2)) > phase1.SCAN_BLOCK_ROWS


@pytest.mark.parametrize("kw", range(1, 9))
def test_scan_route_past_the_largest_cluster(kw):
    most = phase1.scan_max_rows(kw)
    route = _check_route(most, kw)
    assert (route.kernel, route.nblocks) == ("scan", phase1.SCAN_CLUSTER_SIZES[-1])
    assert _check_route(most + 1, kw).kernel == "scan_chunked"
    assert not phase1.scan_fits(-(-(most + 1) // phase1.SCAN_CLUSTER_SIZES[-1]), kw)


def test_scan_route_of_the_solver_shapes():
    """The flagship and the tall system take the largest cluster, the subset
    engine's 768 rows one block; the route depends on the shape alone."""
    assert phase1.scan_route(20224, 8)[:3] == ("scan", 16, 1264)
    assert phase1.scan_route(40192, 8)[:3] == ("scan", 16, 2512)
    assert phase1.scan_route(phase1.SUBSET_ROWS, 8)[:3] == ("scan", 1, 768)
    assert phase1.scan_route(10000, 8)[:2] == ("scan", 8)
    assert phase1.scan_route(67328, 8).kernel == "scan_chunked"
    assert phase1.scan_route(20224, 8) == phase1.scan_route(20224, 8)


@pytest.mark.parametrize("rows,kw", [(0, 8), (-5, 1), (100, 0), (100, 9)])
def test_scan_route_rejects_what_no_kernel_takes(rows, kw):
    with pytest.raises(ValueError):
        phase1.scan_route(rows, kw)


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr \w+ {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def test_route_constants_mirror_the_cuda_source():
    assert phase1.SCAN_THREADS == _constant("scan_cluster.cuh", "kClusterThreads")
    assert phase1.SCAN_MAX_SLOTS == _constant("scan_cluster.cuh", "kMaxSlots")
    assert phase1.SCAN_CLUSTER_SIZES[-1] == _constant("scan_cluster.cuh", "kMaxCluster")
    assert phase1.SCAN_SMEM_MAX == _constant("scan_cluster.cuh", "kMaxBlockSmem")
    slot_quads = _constant("scan_cluster.cuh", "kSlotQuads")
    header = 16 * (2 * phase1.SCAN_CLUSTER_SIZES[-1] * slot_quads + 2 * 32 // 4 + 1)
    assert phase1.scan_smem_bytes(0, 8) == header
    assert panel_update.STRIP_WORDS == _constant("update_table.cuh", "kStrip")


def test_new_entry_points_are_declared():
    """Every C entry point a wrapper calls has its signature and its count."""
    for fn in ("gf2_scan", "gf2_reconstruct_coeff"):
        assert fn in _cuda._SIGNATURES
        source = "reconstruct.cu" if "reconstruct" in fn else "scan.cu"
        assert f'extern "C" int {fn}(' in (CSRC / source).read_text()
    for key in ("scan", "reconstruct_coeff"):
        assert key in _cuda.LAUNCHES
    # the coefficient solve: four pointers, batch, three ints, stream
    assert len(_cuda._SIGNATURES["gf2_reconstruct_coeff"]) == 9
    # gf2_scan takes no working copy: five pointers, five ints, the stream
    assert len(_cuda._SIGNATURES["gf2_scan"]) == 11


# -- the update's live strips ----------------------------------------------------


def _changed_words(update, wp):
    """The words an update changes: every selector picks pf row 0, which is
    nonzero in every word."""
    a = torch.zeros((2, wp), dtype=torch.int32)
    sel = torch.ones((2, 1), dtype=torch.int32)
    pf = torch.zeros((32, wp), dtype=torch.int32)
    pf[0] = 0x5A5A5A5
    out = update(a, sel, pf)
    return set(torch.nonzero(out[0]).flatten().tolist())


def _strip_words(strips, wp):
    words = [w for lo, n in strips for w in range(lo, lo + n)]
    assert len(words) == len(set(words)), "a word lies in two strips"
    assert all(0 <= w < wp for w in words)
    assert all(1 <= n <= panel_update.STRIP_WORDS for _, n in strips)
    return set(words)


@pytest.mark.parametrize("wp", WIDTHS)
def test_live_strips_full_width(wp):
    strips = panel_update.live_strips(wp, 0, False)
    assert _strip_words(strips, wp) == set(range(wp))
    assert _strip_words(strips, wp) == _changed_words(panel_update.update_full_plain, wp)
    # word 0 is in the live range already: no const strip
    assert panel_update.live_strips(wp, 0, True) == strips
    assert len(strips) == -(-wp // panel_update.STRIP_WORDS)


@pytest.mark.parametrize("wp,dead", [(wp, d) for wp in WIDTHS if wp % 128 == 0
                                     for d in range(1, wp // 128)])
def test_live_strips_match_update_seg(wp, dead):
    strips = panel_update.live_strips(wp, 128 * dead, True)
    assert strips[0] == (0, 1)
    want = _changed_words(lambda a, s, pf: panel_update.update_seg_plain(a, s, pf, dead), wp)
    assert _strip_words(strips, wp) == want == {0} | set(range(128 * dead, wp))


@pytest.mark.parametrize("wp,w0", [(wp, w0) for wp in WIDTHS for w0 in W0_SWEEP if w0 < wp])
def test_live_strips_match_update_trailing(wp, w0):
    lo = panel_update._trailing_range(wp, w0)
    strips = panel_update.live_strips(wp, lo, lo > 0)
    want = _changed_words(lambda a, s, pf: panel_update.update_trailing_plain(a, s, pf, w0), wp)
    assert _strip_words(strips, wp) == want
    if wp % 128 == 0 and w0 >= 128:
        assert want == {0} | set(range(128 * (w0 // 128), wp))
    else:
        assert want == set(range(wp))


def test_live_strips_reject_a_start_outside_the_row():
    for lo in (-1, 641):
        with pytest.raises(ValueError):
            panel_update.live_strips(640, lo, True)
    assert panel_update.live_strips(640, 640, True) == [(0, 1)]
    assert panel_update.live_strips(640, 640, False) == []


# -- the wrappers on CPU tensors against the JAX package ---------------------------


def _jax_scan(bT, used, w0, K, cols):
    prow, used_o, cT = _call_scan_kernel(
        jnp.asarray(bT), jnp.asarray(used), jnp.asarray([w0], jnp.int32), K, cols, True,
    )
    return np.asarray(prow), np.asarray(used_o), np.asarray(cT)


def test_scan_matches_pallas_at_ten_row_tiles():
    """One more shape than tests/test_torch_kernels.py: 2560 rows, K = 256, a
    panel whose first column (bit 0, the affine term) is invalid."""
    rows, K, w0, cols = 2560, 256, 0, 5000
    rng = np.random.default_rng(2560)
    bT = rng.integers(0, 2**32, size=(K // 32, rows), dtype=np.uint32)
    used = (rng.random((1, rows)) < 0.25).astype(np.int32)
    prow_j, used_j, cT_j = _jax_scan(bT, used, w0, K, cols)
    prow_t, used_t, cT_t = phase1.scan(t32(bT), torch.from_numpy(used), w0, K, cols)
    assert prow_j[0] == -1 and (prow_j[1:] >= 0).all()
    assert np.array_equal(prow_t.numpy(), prow_j)
    assert np.array_equal(used_t.numpy(), used_j)
    assert np.array_equal(torch_to_u32(cT_t), cT_j)


@pytest.mark.parametrize("rows,K,w0,cols", [(300, 64, 2, 80), (1000, 128, 0, 10**6)])
def test_scan_wrappers_run_the_twin_on_cpu_tensors(rows, K, w0, cols):
    """scan and scan_cluster take the plain twin for a CPU tensor whatever the
    route says, and count no launch."""
    rng = np.random.default_rng(rows)
    bT = t32(rng.integers(0, 2**32, size=(K // 32, rows), dtype=np.uint32))
    used = torch.from_numpy((rng.random((1, rows)) < 0.3).astype(np.int32))
    want = phase1.scan_plain(bT, used, w0, K, cols)
    _cuda.reset_launches()
    for got in (phase1.scan(bT, used, w0, K, cols),
                phase1.scan_cluster(bT, used, w0, K, cols, 16)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert not any(_cuda.LAUNCHES.values())
    with pytest.raises(ValueError, match="does not match"):
        phase1.scan_cluster(bT, used, w0, K + 32, cols, 16)

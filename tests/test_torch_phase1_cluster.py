"""The min-key scan and the fused phase 1 as cluster kernels, as far as the
CPU can hold them.

The kernels run only on the card (``tests/test_torch_cuda.py``).  Here: the
fused kernel's route and the min-key scan's as pure functions of the shape;
the constants the Python side mirrors from ``csrc/``; the min-key cluster
twin (the kernel's order: each block's key minima, then the minima over the
slots) against the step-by-step twin and the Pallas min-key scan in
interpret mode; the fused phase 1 on CPU tensors, and the cluster kernel's
composition (scan, the blocked coefficient solve on the rows prow names, the
product), against the Pallas fused kernel in interpret mode.  Seeded numpy
inputs; tolerance 0: integer GF(2) arithmetic.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu.ops import pallas_phase1
from gf2bv_tpu.ops.pallas_phase1 import _call_scan_kernel
from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import _cuda, phase1

torch.set_num_threads(2)

CSRC = Path(phase1.__file__).resolve().parent.parent / "csrc"
ROUTE_ROWS = [256, 768, 2560, 20224, 40192, 65536, 65537]
MINKEY_ROWS = [1, 300, 768, 2560, 20011, 20224, 32767]
CLUSTERS = [1, 2, 4, 8, 16]


def t32(a):
    return u32_to_torch(a, "cpu")


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr \w+ {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


# -- the routes ------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [1, 4, 8])
@pytest.mark.parametrize("rows", ROUTE_ROWS)
def test_phase1_fused_route(rows, kw):
    """The cluster kernel on the 1-pivot scan's cluster, its shared memory
    the larger of the scan's and the product stages' and under 227 KB; the
    chained kernel on the chained scan's chunks and clusters exactly past the
    largest cluster's rows, its last link's shared memory under 227 KB."""
    route = phase1.phase1_fused_route(rows, kw)
    scan = phase1.scan_route(rows, kw)
    if rows > phase1.scan_max_rows(kw):
        assert scan.kernel == "scan_chunked"
        assert route == scan._replace(kernel="phase1_fused_chunked")
        assert phase1.phase1_fused_smem_bytes(route.rows_per_block, kw, chained=True) <= (
            phase1.SCAN_SMEM_MAX)
        return
    assert route.kernel == "phase1_fused"
    assert (route.nblocks, route.rows_per_block) == (scan.nblocks, scan.rows_per_block)
    assert route.smem_bytes >= scan.smem_bytes
    assert route.smem_bytes == phase1.phase1_fused_smem_bytes(route.rows_per_block, kw)
    assert route.smem_bytes <= phase1.SCAN_SMEM_MAX


def test_phase1_fused_route_of_the_solver_shapes():
    """The flagship and the tall system run one cluster of 16 blocks, the
    tables (132 KB at K = 256) setting the shared memory; the very tall
    system the chained kernel; the boundary is the scan's."""
    assert phase1.scan_max_rows(8) == 65536
    assert phase1.phase1_fused_route(20224, 8)[:3] == ("phase1_fused", 16, 1264)
    tables = 16 * (4 * 8 * 256 + 32 * 8)
    assert phase1.phase1_fused_route(20224, 8).smem_bytes == (
        phase1.scan_smem_bytes(0, 8) + 4 * 256 * 8 + tables)
    assert phase1.phase1_fused_route(40192, 8)[:3] == ("phase1_fused", 16, 2512)
    assert phase1.phase1_fused_route(65536, 8).kernel == "phase1_fused"
    assert phase1.phase1_fused_route(65537, 8).kernel == "phase1_fused_chunked"
    assert phase1.phase1_fused_route(67328, 8).kernel == "phase1_fused_chunked"
    # one block owning 4096 rows: the scan's state outweighs the tables
    one = phase1.phase1_fused_route(4000, 8)
    assert one.smem_bytes == max(phase1.scan_smem_bytes(one.rows_per_block, 8),
                                 phase1.scan_smem_bytes(0, 8) + 4 * 256 * 8 + tables)


@pytest.mark.parametrize("kw", range(1, 9))
@pytest.mark.parametrize("rows", MINKEY_ROWS)
def test_scan_minkey_route(rows, kw):
    """The min-key scan runs on the 1-pivot scan's cluster with the larger
    header of its election; every slice it takes fits."""
    route = phase1.scan_minkey_route(rows, kw)
    scan = phase1.scan_route(rows, kw)
    assert route.kernel == "scan_minkey"
    assert (route.nblocks, route.rows_per_block) == (scan.nblocks, scan.rows_per_block)
    assert route.smem_bytes == phase1.scan_smem_bytes(route.rows_per_block, kw, minkey=True)
    assert route.smem_bytes <= phase1.SCAN_SMEM_MAX
    assert phase1.scan_fits(route.rows_per_block, kw, minkey=True)


@pytest.mark.parametrize("rows,kw", [(phase1.MINKEY_MAX_ROWS, 8), (70000, 1), (0, 8),
                                     (300, 9)])
def test_scan_minkey_route_rejects_what_no_kernel_takes(rows, kw):
    with pytest.raises(ValueError):
        phase1.scan_minkey_route(rows, kw)


# -- what the Python side mirrors from csrc/ ----------------------------------------------


def test_constants_mirror_the_sources():
    slot = _constant("scan_cluster.cuh", "kMinKeySlotQuads")
    assert slot == 4  # the block's 16 key minima, four to a quad
    warps = phase1.SCAN_THREADS // 32
    header = 16 * (2 * 16 * slot) + 4 * (2 * warps * 16) + 16
    assert phase1.scan_smem_bytes(0, 8, minkey=True) == header
    assert phase1.scan_smem_bytes(0, 8) == 16 * (2 * 16 * _constant(
        "scan_cluster.cuh", "kSlotQuads") + 2 * 32 // 4 + 1)
    words = _constant("phase1_product.cuh", "kFusedSolveSmemWords")
    solve_kw = _constant("phase1_product.cuh", "kFusedSolveKw")
    assert phase1.FUSED_SOLVE_SMEM_WORDS == words == 32 * solve_kw * (solve_kw + 1) + 64 * solve_kw
    assert "(size_t)(4 * kw * 256 + 32 * kw) * sizeof(uint4)" in (
        CSRC / "update_table.cuh").read_text()


def test_bodies_live_in_the_headers():
    """The coefficient solve is one body (reconstruct_coeff.cuh) that the
    rebuild and the fused phase 1's product stages (phase1_product.cuh, which
    the fused kernels call) use; the cluster scan's exchange lives in
    scan_cluster.cuh alone."""
    assert "coeff_blocked_body" in (CSRC / "reconstruct_coeff.cuh").read_text()
    for source, call in (("reconstruct.cu", "gf2::coeff_blocked_body<"),
                         ("phase1_product.cuh", "coeff_blocked_body<")):
        text = (CSRC / source).read_text()
        assert '#include "reconstruct_coeff.cuh"' in text
        assert call in text
        assert "shfl4(r[g]" not in text
    for source in ("scan.cu", "phase1_fused.cu"):
        text = (CSRC / source).read_text()
        assert '#include "scan_cluster.cuh"' in text
        assert "mbarrier" not in text and "st.async" not in text
    assert "table_update_body<true, true>" in (CSRC / "phase1_product.cuh").read_text()
    for source in ("phase1_fused.cu", "fused_chunked.cu"):
        text = (CSRC / source).read_text()
        assert '#include "phase1_product.cuh"' in text
        assert "gf2::phase1_product_body(" in text


def test_new_entry_points_are_declared_and_counted():
    for fn, key in (("gf2_scan_minkey", "scan_minkey"),
                    ("gf2_phase1_fused", "phase1_fused")):
        assert fn in _cuda._SIGNATURES and key in _cuda.LAUNCHES
    # the cluster kernels take a block count and no working copy of the slice
    assert (_cuda._SIGNATURES["gf2_scan_minkey"] == _cuda._SIGNATURES["gf2_scan"]
            == _cuda._SIGNATURES["gf2_scan2"])
    assert len(_cuda._SIGNATURES["gf2_phase1_fused"]) == 14


# -- the min-key scan -------------------------------------------------------------------


def _slice(rows, K, seed, used_frac=0.3):
    rng = np.random.default_rng(seed)
    bT = rng.integers(0, 2**32, size=(K // 32, rows), dtype=np.uint32)
    used = (rng.random((1, rows)) < used_frac).astype(np.int32)
    return bT, used


@pytest.mark.parametrize("nblocks", CLUSTERS)
@pytest.mark.parametrize("rows,K,w0,cols", [(300, 64, 2, 80), (1001, 128, 0, 10**6),
                                            (2560, 256, 8, 300), (47, 96, 1, 90),
                                            (5000, 32, 0, 20)])
def test_scan_minkey_cluster_twin(rows, K, w0, cols, nblocks):
    """The cluster order gives the step-by-step twin's outputs for every
    cluster size, ragged last blocks and empty blocks included (47 rows on 16
    blocks: three rows a block, the last ones empty)."""
    bT, used = _slice(rows, K, rows + K + nblocks)
    want = phase1.scan_minkey_plain(t32(bT), torch.from_numpy(used), w0, K, cols)
    got = phase1.scan_minkey_cluster_plain(t32(bT), torch.from_numpy(used), w0, K, cols,
                                           nblocks)
    assert (want[0] >= 0).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_scan_minkey_cluster_twin_without_a_pivot():
    """Every row used, or no valid column: no block has a candidate, every
    key is the sentinel and prow stays -1."""
    bT, _ = _slice(640, 256, 5)
    full = np.ones((1, 640), np.int32)
    for used, cols in ((full, 10**6), (np.zeros_like(full), 0)):
        got = phase1.scan_minkey_cluster_plain(t32(bT), torch.from_numpy(used), 4, 256, cols, 4)
        assert (got[0] == -1).all()
        assert torch.equal(got[1], torch.from_numpy(used))
        assert not got[2].any()


def test_scan_minkey_cluster_twin_rejects():
    bT, used = _slice(phase1.MINKEY_MAX_ROWS, 32, 1)
    with pytest.raises(ValueError, match="fewer than"):
        phase1.scan_minkey_cluster_plain(t32(bT), torch.from_numpy(used), 0, 32, 90, 16)
    bT, used = _slice(300, 32, 1)
    with pytest.raises(ValueError, match="cluster"):
        phase1.scan_minkey_cluster_plain(t32(bT), torch.from_numpy(used), 0, 32, 90, 3)


@pytest.mark.parametrize("rows,K,w0,cols,nblocks", [(512, 64, 2, 80, 2), (1536, 256, 0, 5000, 8),
                                                    (2560, 128, 4, 10**6, 16)])
def test_scan_minkey_cluster_matches_pallas(rows, K, w0, cols, nblocks):
    """The cluster twin, and the wrappers on CPU tensors, against the Pallas
    min-key scan in interpret mode."""
    bT, used = _slice(rows, K, rows + w0)
    prow_j, used_j, cT_j = (np.asarray(x) for x in _call_scan_kernel(
        jnp.asarray(bT), jnp.asarray(used), jnp.asarray([w0], jnp.int32), K, cols, True, "m"))
    assert (prow_j >= 0).any()
    _cuda.reset_launches()
    for prow_t, used_t, cT_t in (
            phase1.scan_minkey_cluster_plain(t32(bT), torch.from_numpy(used), w0, K, cols,
                                             nblocks),
            phase1.scan_minkey_cluster(t32(bT), torch.from_numpy(used), w0, K, cols, nblocks),
            phase1.scan_minkey(t32(bT), torch.from_numpy(used), w0, K, cols)):
        assert np.array_equal(prow_t.numpy(), prow_j)
        assert np.array_equal(used_t.numpy(), used_j)
        assert np.array_equal(torch_to_u32(cT_t), cT_j)
    assert not any(_cuda.LAUNCHES.values())


def test_scan_minkey_wrappers_reject():
    bT, used = _slice(300, 64, 2)
    with pytest.raises(ValueError, match="does not match"):
        phase1.scan_minkey(t32(bT), torch.from_numpy(used), 0, 96, 90)
    with pytest.raises(ValueError, match="does not match"):
        phase1.scan_minkey_cluster(t32(bT), torch.from_numpy(used), 0, 96, 90, 2)
    tall, tused = _slice(phase1.MINKEY_MAX_ROWS, 32, 3)
    with pytest.raises(ValueError, match="fewer than"):
        phase1.scan_minkey(t32(tall), torch.from_numpy(tused), 0, 32, 90)


# -- the fused phase 1 --------------------------------------------------------------------


ROWS, WP = 512, 256


def _fused_cases():
    """(K, w0, cols, used_frac): the first, a middle and the last panel of
    256-word rows, a panel with no valid column, a system with no pivot."""
    out = []
    for K in (64, 128, 256):
        kw = K // 32
        cols = 32 * WP - 40  # the last panel crosses cols
        out += [(K, 0, cols, 0.3), (K, (WP // 2) // kw * kw, cols, 0.3),
                (K, WP - kw, cols, 0.3), (K, 2 * kw, 0, 0.3), (K, kw, cols, 1.0)]
    return out


def _fused_inputs(K, w0, used_frac, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(ROWS, WP), dtype=np.uint32)
    bT = np.ascontiguousarray(a[:, w0 : w0 + K // 32].T)
    used = (rng.random((1, ROWS)) < used_frac).astype(np.int32)
    return a, bT, used


@pytest.mark.parametrize("K,w0,cols,used_frac", _fused_cases())
def test_phase1_panel_matches_pallas(K, w0, cols, used_frac):
    a, bT, used = _fused_inputs(K, w0, used_frac, K + w0 + int(10 * used_frac))
    want = [np.asarray(x) for x in pallas_phase1.phase1_panel(
        jnp.asarray(a), jnp.asarray(bT), jnp.asarray(used), w0, K, cols, True)]
    has_pivot = cols > 0 and used_frac < 1.0
    assert (want[1] >= 0).any() == has_pivot
    args = (t32(a), t32(bT), torch.from_numpy(used), w0, K, cols)
    _cuda.reset_launches()
    # the cluster kernel's composition (scan, blocked coefficient solve through
    # prow, product) is the chained kernel's twin with one chunk of all the rows
    for got in (phase1.phase1_panel(*args), phase1.phase1_panel_cluster(*args, 16),
                phase1.phase1_panel_chunked_plain(*args, ROWS)):
        assert np.array_equal(torch_to_u32(got[0]), want[0])
        assert np.array_equal(got[1].numpy(), want[1])
        assert np.array_equal(got[2].numpy(), want[2])
    assert not any(_cuda.LAUNCHES.values())


def test_phase1_panel_wrappers_reject():
    a, bT, used = _fused_inputs(64, 0, 0.3, 1)
    args = (t32(a), t32(bT), torch.from_numpy(used))
    with pytest.raises(ValueError, match="outside"):
        phase1.phase1_panel(*args, WP - 1, 64, 100)
    with pytest.raises(ValueError, match="does not match"):
        phase1.phase1_panel(*args, 0, 96, 100)
    with pytest.raises(ValueError, match="outside"):
        phase1.phase1_panel_cluster(*args, WP, 64, 100, 4)

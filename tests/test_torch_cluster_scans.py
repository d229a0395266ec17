"""The kernels that carry the cluster scan inside another launch, as far as
the CPU can hold them: the batched scan (one cluster per system) and the fused
update + scan (a scan cluster beside table updates).

The kernels run only on the card (``tests/test_torch_cuda.py``).  Here: the
batched scan's route and the fused kernel's update rule as pure functions of
the shapes; the constants and C signatures the Python side mirrors from
``csrc/``; the wrappers on CPU tensors, which run the plain twins; and the
twins against the JAX package's Pallas kernels in interpret mode on seeded
numpy inputs.  Tolerance 0: integer GF(2) arithmetic.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu.ops import gauss_batched as gbat_jax
from gf2bv_tpu.ops.pallas_update import panel_update_mxu_scan
from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import _cuda, gauss_batched, panel_update, phase1

torch.set_num_threads(2)

CSRC = Path(phase1.__file__).resolve().parent.parent / "csrc"
BATCHES = [1, 4, 8, 16, 17]
ROUTE_ROWS = [256, 768, 2560, 20224, 40192, 65536, 65537]
WIDTHS = [13, 128, 200, 384, 640, 768]
W0_SWEEP = [None, 0, 1, 7, 8, 120, 127, 128, 129, 160, 255, 256, 300, 383, 384, 500, 632, 639,
            640, 700, 767]


def t32(a):
    return u32_to_torch(a, "cpu")


# -- the batched scan's route -----------------------------------------------------


@pytest.mark.parametrize("kw", [1, 4, 8])
@pytest.mark.parametrize("rows", ROUTE_ROWS)
@pytest.mark.parametrize("batch", BATCHES)
def test_scan_batched_route_holds_every_system(batch, rows, kw):
    route = phase1.scan_batched_route(batch, rows, kw)
    single = phase1.scan_route(rows, kw)
    if single.kernel == "scan_chunked":  # the chained scan exactly where the single scan's is
        assert route == phase1.scan_chunked_route(rows, kw, batch=batch,
                                                  kernel="scan_batched_chunked")
        assert route.chunk_rows == single.chunk_rows and route.chunks == single.chunks
        return
    assert route.kernel == "scan_batched"
    assert route.nblocks in phase1.SCAN_CLUSTER_SIZES and route.nblocks <= single.nblocks
    assert route.rows_per_block == -(-rows // route.nblocks)
    assert route.rows_per_block <= phase1.SCAN_MAX_SLOTS * phase1.SCAN_THREADS
    assert route.smem_bytes == phase1.scan_smem_bytes(route.rows_per_block, kw)
    assert route.smem_bytes <= phase1.SCAN_SMEM_MAX
    assert phase1.scan_fits(route.rows_per_block, kw)
    # each system's rows are owned once by its cluster's blocks
    assert route.nblocks * route.rows_per_block >= rows
    assert (route.nblocks - 1) * route.rows_per_block < rows or rows < route.nblocks
    # a cluster is halved only while the batch outnumbers the clusters the card runs at
    # once, and stops where the batch fits or the smaller cluster cannot hold a slice
    nb = single.nblocks
    while nb > route.nblocks:
        assert batch > phase1.SCAN_RESIDENT_CLUSTERS[nb]
        nb //= 2
    if route.nblocks > 1 and batch > phase1.SCAN_RESIDENT_CLUSTERS[route.nblocks]:
        assert not phase1.scan_fits(-(-rows // (route.nblocks // 2)), kw)


def test_scan_batched_route_of_the_solver_shapes():
    """The flagship batch of 4 keeps the single scan's 16 blocks a system;
    from 8 systems on 8 blocks, so that all clusters run at once; the tall
    system cannot halve (5024 rows a block are more than a thread's 8 rows)."""
    assert phase1.scan_batched_route(1, 20224, 8) == ("scan_batched", 16, 1264, 42768)
    assert phase1.scan_batched_route(4, 20224, 8)[:3] == ("scan_batched", 16, 1264)
    assert phase1.scan_batched_route(7, 20224, 8)[:3] == ("scan_batched", 16, 1264)
    assert phase1.scan_batched_route(8, 20224, 8)[:3] == ("scan_batched", 8, 2528)
    assert phase1.scan_batched_route(16, 20224, 8)[:3] == ("scan_batched", 8, 2528)
    assert phase1.scan_batched_route(16, 40192, 8)[:3] == ("scan_batched", 16, 2512)
    assert phase1.scan_batched_route(16, 10000, 8)[:3] == ("scan_batched", 4, 2500)
    assert phase1.scan_batched_route(3, 67328, 8).kernel == "scan_batched_chunked"
    assert phase1.scan_batched_route(4, 20224, 8)[1:] == phase1.scan_route(20224, 8)[1:]


@pytest.mark.parametrize("batch,rows,kw", [(0, 512, 8), (-1, 512, 8), (4, 0, 8), (4, 512, 9)])
def test_scan_batched_route_rejects_what_no_kernel_takes(batch, rows, kw):
    with pytest.raises(ValueError):
        phase1.scan_batched_route(batch, rows, kw)


def test_resident_clusters_cover_every_cluster_size():
    assert set(phase1.SCAN_RESIDENT_CLUSTERS) == set(phase1.SCAN_CLUSTER_SIZES)
    for nb, n in phase1.SCAN_RESIDENT_CLUSTERS.items():
        assert 1 <= n * nb <= 132  # one block an SM


# -- the fused kernel's update part -------------------------------------------------


def _changed_words(update, wp):
    """The words an update changes: every selector picks pf row 0, which is
    nonzero in every word."""
    a = torch.zeros((2, wp), dtype=torch.int32)
    sel = torch.ones((2, 1), dtype=torch.int32)
    pf = torch.zeros((32, wp), dtype=torch.int32)
    pf[0] = 0x5A5A5A5
    out = update(a, sel, pf)
    return set(torch.nonzero(out[0]).flatten().tolist())


@pytest.mark.parametrize("wp,w0", [(wp, w0) for wp in WIDTHS for w0 in W0_SWEEP
                                   if w0 is None or w0 < wp])
def test_update_scan_strips_are_the_live_strips(wp, w0):
    """The strips the fused kernel's update clusters cover are live_strips of
    the trailing rule (the full rule for w0 None): exactly the words the twin
    changes."""
    lo, const = panel_update.update_scan_rule(wp, w0)
    strips = panel_update.live_strips(wp, lo, const)
    words = [w for first, n in strips for w in range(first, first + n)]
    assert len(words) == len(set(words))
    bTn = torch.zeros((1, 2), dtype=torch.int32)
    used = torch.zeros((1, 2), dtype=torch.int32)
    want = _changed_words(
        lambda a, s, pf: panel_update.update_scan_plain(a, s, pf, bTn, used, 0, 40, w0)[0], wp)
    assert set(words) == want
    if w0 is None:
        assert (lo, const) == (0, False)
        assert strips == panel_update.live_strips(wp, 0, False)
    else:
        assert lo == panel_update._trailing_range(wp, w0) and const == (lo > 0)


def test_update_scan_rule_rejects_a_start_outside_the_row():
    for w0 in (-1, 640, 641):
        with pytest.raises(ValueError):
            panel_update.update_scan_rule(640, w0)


# -- what the Python side mirrors from csrc/ ------------------------------------------


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr \w+ {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def test_cluster_scan_constants_mirror_the_header():
    assert phase1.SCAN_THREADS == _constant("scan_cluster.cuh", "kClusterThreads")
    assert phase1.SCAN_THREADS == _constant("update_table.cuh", "kTabThreads")
    assert phase1.SCAN_MAX_SLOTS == _constant("scan_cluster.cuh", "kMaxSlots")
    assert max(phase1.SCAN_RESIDENT_CLUSTERS) == _constant("scan_cluster.cuh", "kMaxCluster")
    assert phase1.SCAN_SMEM_MAX == _constant("scan_cluster.cuh", "kMaxBlockSmem")
    assert panel_update.STRIP_WORDS == _constant("update_table.cuh", "kStrip")
    # the cluster scan's body and its PTX helpers live in the header alone
    for source in ("scan.cu", "panel_update.cu"):
        text = (CSRC / source).read_text()
        assert '#include "scan_cluster.cuh"' in text
        assert "mbarrier" not in text and "st.async" not in text
    assert "scan_cluster_body" in (CSRC / "scan_cluster.cuh").read_text()
    assert "table_update_body" in (CSRC / "update_table.cuh").read_text()


def _c_parameters(name: str) -> list[str]:
    """The parameter declarations of ``extern "C" int name(...)`` in csrc/."""
    for source in sorted(CSRC.glob("*.cu")):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source.read_text())
        if m:
            return [p.strip() for p in m.group(1).split(",")]
    raise AssertionError(f"{name} is declared in no source")


@pytest.mark.parametrize("name", sorted(_cuda._SIGNATURES))
def test_ctypes_signature_matches_the_c_entry_point(name):
    """A pointer or the stream is a c_void_p, an int a c_int, in the C order:
    a mismatch would cut a pointer to 32 bits or shift every argument."""
    params = _c_parameters(name)
    want = [ctypes.c_void_p if "*" in p or p.startswith("cudaStream_t") else ctypes.c_int
            for p in params]
    assert _cuda._SIGNATURES[name] == want, params


def test_new_kernels_are_counted_under_their_own_names():
    for key in ("scan_batched", "update_scan", "update_scan_chunked"):
        assert key in _cuda.LAUNCHES
    assert "gf2_scan_occupancy" in _cuda._SIGNATURES


# every ``extern "C" int gf2_*`` the sources of csrc/ define
C_ENTRY_POINTS = sorted({m.group(1) for source in CSRC.glob("*.cu")
                         for m in re.finditer(r'extern "C" int (gf2_\w+)\(', source.read_text())})


# the C entry points whose launches LAUNCHES counts under another name, and the
# one that launches nothing
LAUNCH_KEY_OF = {"gf2_update_table": "update_pallas", "gf2_scan_occupancy": None}
OPS = Path(phase1.__file__).resolve().parent


@pytest.mark.parametrize("name", C_ENTRY_POINTS)
def test_every_c_entry_point_is_declared_and_counted(name):
    """C -> Python: an entry point compiled into the library has its ctypes
    signature, and unless it launches nothing, a LAUNCHES key that a wrapper
    of ops/ names, so no kernel stays compiled after its wrapper is gone."""
    assert name in _cuda._SIGNATURES
    key = LAUNCH_KEY_OF.get(name, name.removeprefix("gf2_"))
    if key is None:
        return
    assert key in _cuda.LAUNCHES
    wrappers = "".join(f.read_text() for f in sorted(OPS.glob("*.py")) if f.name != "_cuda.py")
    assert f'"{key}"' in wrappers


# (route, rows): every route function at the cells' slice heights (the flagship,
# the SFMT system, the very tall system) at kw = 8; the min-key route takes
# fewer than MINKEY_MAX_ROWS rows only
ROUTES = {
    "scan_route": phase1.scan_route,
    "scan_chunked_route": phase1.scan_chunked_route,
    "scan_batched_route": lambda rows, kw: phase1.scan_batched_route(4, rows, kw),
    "scan2_route": phase1.scan2_route,
    "scan_minkey_route": phase1.scan_minkey_route,
    "phase1_fused_route": phase1.phase1_fused_route,
    "update_scan_route": panel_update.update_scan_route,
}
CELL_ROWS = [20224, 40192, 67328]


@pytest.mark.parametrize("route,rows", [
    (r, rows) for r in ROUTES for rows in CELL_ROWS
    if r != "scan_minkey_route" or rows < phase1.MINKEY_MAX_ROWS])
def test_routes_name_a_declared_kernel(route, rows):
    """What a route picks is a kernel the library has: a LAUNCHES key with a
    ctypes signature and a C entry point of that name."""
    kernel = ROUTES[route](rows, 8).kernel
    assert kernel in _cuda.LAUNCHES
    assert f"gf2_{kernel}" in _cuda._SIGNATURES
    assert f"gf2_{kernel}" in C_ENTRY_POINTS


# -- the wrappers on CPU tensors -------------------------------------------------------


def _batch_inputs(B, rows, K, seed, used_fracs):
    rng = np.random.default_rng(seed)
    bT = rng.integers(0, 2**32, size=(B, K // 32, rows), dtype=np.uint32)
    used = (rng.random((B, rows)) < np.asarray(used_fracs)[:, None]).astype(np.int32)
    return bT, used


@pytest.mark.parametrize("rows,K,w0,cols", [(300, 64, 2, 80), (700, 128, 0, 10**6)])
def test_batched_scan_wrappers_run_the_twin_on_cpu_tensors(rows, K, w0, cols):
    bT, used = _batch_inputs(3, rows, K, rows, (0.0, 0.3, 0.6))
    bT, used = t32(bT), torch.from_numpy(used)
    want = gauss_batched.scan_batched_plain(bT, used, w0, K, cols)
    _cuda.reset_launches()
    for got in (gauss_batched.scan_batched(bT, used, w0, K, cols),
                gauss_batched.scan_batched_cluster(bT, used, w0, K, cols, 16)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert not any(_cuda.LAUNCHES.values())
    with pytest.raises(ValueError, match="does not match"):
        gauss_batched.scan_batched(bT, used, w0, K + 32, cols)
    with pytest.raises(ValueError, match="does not match"):
        gauss_batched.scan_batched_cluster(bT, used, w0, K + 32, cols, 2)


@pytest.mark.parametrize("w0", [None, 0, 130])
def test_update_scan_wrappers_run_the_twin_on_cpu_tensors(w0):
    rng = np.random.default_rng(12)
    rows, wp, K = 300, 256, 64
    a = t32(rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32))
    sel = t32(rng.integers(0, 2**32, size=(rows, K // 32), dtype=np.uint32))
    pf = t32(rng.integers(0, 2**32, size=(K, wp), dtype=np.uint32))
    bTn = t32(rng.integers(0, 2**32, size=(K // 32, rows), dtype=np.uint32))
    used = torch.from_numpy((rng.random((1, rows)) < 0.3).astype(np.int32))
    want = panel_update.update_scan_plain(a.clone(), sel, pf, bTn, used, 4, 5000, w0)
    _cuda.reset_launches()
    for got in (panel_update.update_scan(a.clone(), sel, pf, bTn, used, 4, 5000, w0),
                panel_update.update_scan_cluster(a.clone(), sel, pf, bTn, used, 4, 5000, w0, 8),
                panel_update.update_scan_chunked(a.clone(), sel, pf, bTn, used, 4, 5000, w0,
                                                 100)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert not any(_cuda.LAUNCHES.values())
    for fn in (panel_update.update_scan, panel_update.update_scan_chunked):
        with pytest.raises(ValueError, match="outside"):
            fn(a.clone(), sel, pf, bTn, used, 4, 5000, wp)


def test_scan_occupancy_is_for_the_card_only():
    """There is no plain twin of a question to the card: without a CUDA build
    the query raises instead of inventing a number."""
    with pytest.raises((RuntimeError, OSError)):
        phase1.scan_occupancy(20224, 8, 16)


# -- the twins against the Pallas kernels ------------------------------------------------


@pytest.mark.parametrize("K,w0,cols", [(64, 0, 5000), (64, 2, 80), (256, 8, 300),
                                       (256, 16, 100000)])
def test_scan_batched_matches_pallas_with_uneven_systems(K, w0, cols):
    """B = 3 systems of 512 rows that differ in their used rows: none used,
    a third used, and every row used, so the last system has no pivot at all."""
    bT, used = _batch_inputs(3, 512, K, K + w0, (0.0, 0.33, 1.0))
    assert used[2].all() and not used[0].any()
    want = [np.asarray(x) for x in gbat_jax._scan_batched(
        jnp.asarray(bT), jnp.asarray(used), w0, K, cols, True)]
    got = gauss_batched.scan_batched(t32(bT), torch.from_numpy(used), w0, K, cols)
    assert (want[0][0] >= 0).any() and (want[0][2] == -1).all()
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert np.array_equal(torch_to_u32(got[2]), want[2])
    # each system alone is the single scan
    for b in range(3):
        one = phase1.scan_plain(t32(bT[b]), torch.from_numpy(used[b : b + 1]), w0, K, cols)
        assert torch.equal(one[0], got[0][b]) and torch.equal(one[2], got[2][b])


@pytest.mark.parametrize("w0,w0n", [(None, 272), (264, 272), (264, 376), (None, 384)],
                         ids=["full-next", "trailing-next", "trailing-last", "full-past-cols"])
def test_update_scan_matches_pallas_at_k256(w0, w0n):
    """rows 512, K = 256 on 384 words: the whole updated matrix (w0 = 264:
    tile 0 const-only, tile 1 kept, tile 2 live) and the scan of the next
    slice; w0n = 384 is the look-ahead's step past the last panel, where the
    slice is clamped and no column is valid."""
    rng = np.random.default_rng(47)
    rows, wp, k = 512, 384, 256
    kw = k // 32
    cols = 32 * wp - 40
    a = rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32)
    sel = rng.integers(0, 2**32, size=(rows, kw), dtype=np.uint32)
    pf = rng.integers(0, 2**32, size=(k, wp), dtype=np.uint32)
    used = (rng.random((1, rows)) < 0.2).astype(np.int32)
    full = torch_to_u32(panel_update.update_full_plain(t32(a), t32(sel), t32(pf)))
    lo = min(w0n, wp - kw)  # the clamp of the look-ahead loop
    bTn = np.ascontiguousarray(full[:, lo : lo + kw].T)
    want = [np.asarray(x) for x in panel_update_mxu_scan(
        jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), jnp.asarray(bTn),
        jnp.asarray(used), jnp.asarray(w0n, jnp.int32), cols=cols,
        w0=None if w0 is None else jnp.asarray(w0, jnp.int32), interpret=True,
    )]
    got = panel_update.update_scan(
        t32(a), t32(sel), t32(pf), t32(bTn), torch.from_numpy(used), w0n, cols, w0
    )
    assert np.array_equal(torch_to_u32(got[0]), want[0])  # a'
    assert np.array_equal(got[1].numpy(), want[1])  # prow of the next panel
    assert np.array_equal(torch_to_u32(got[2]), want[2])  # cT
    assert np.array_equal(got[3].numpy(), want[3])  # used'
    assert (want[1] >= 0).any() == (w0n < wp)

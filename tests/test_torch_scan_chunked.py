"""The chained scan of slices taller than one cluster, as far as the CPU can
hold it.

The kernels (``gf2_scan_chunked``, ``gf2_scan_batched_chunked`` in
``csrc/scan_chunked.cu``) run only on the card (``tests/test_torch_cuda.py``).
Here:

* the twins in the chain's order, ``phase1.scan_chunked_plain`` and
  ``gauss_batched.scan_batched_chunked_plain`` (the chunks in turn, each
  alone but for a record of the columns the chunks before it took), with the
  chunk size forced small, bit for bit against the JAX package's Pallas scans
  (``_make_scan_kernel``, ``_make_scan_kernel_b``) in interpret mode and the
  step twins ``scan_plain`` / ``scan_batched_plain``, on hand-built slices on
  which each case that breaks a wrong chain occurs (asserted on the input
  and the reference's outputs) and on random ones;
* the routes: ``scan_route`` and ``scan_batched_route`` give the chained scan
  past what the largest cluster holds, and so, on the same chunks, do the
  fused phase 1, the fused update + scan and the two-pivot scan (its chain,
  ``scan2_chunked``; tests/test_torch_scan2_chunked.py);
* the constants and C signatures mirrored from ``csrc/``; the wrappers on
  CPU tensors.

Seeded numpy inputs; tolerance 0: integer GF(2) arithmetic.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu.ops import gauss_batched as gbat_jax
from gf2bv_tpu.ops.pallas_phase1 import _call_scan_kernel
from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import _cuda, gauss_batched, panel_update, phase1

torch.set_num_threads(2)

CSRC = Path(phase1.__file__).resolve().parent.parent / "csrc"
CASES = ("a chunk-0 pivot eliminates rows of chunks 1 and 2",
         "a column's only candidate is in the last chunk",
         "used_in covers most of chunk 0",
         "a valid column with no candidate",
         "invalid columns at both ends")


def t32(a):
    return u32_to_torch(a, "cpu")


def _pallas(bT, used, w0, K, cols):
    """The Pallas 1-pivot scan in interpret mode; one system or a batch."""
    if bT.ndim == 2:
        out = _call_scan_kernel(jnp.asarray(bT), jnp.asarray(used),
                                jnp.asarray([w0], jnp.int32), K, cols, True)
    else:
        out = gbat_jax._scan_batched(jnp.asarray(bT), jnp.asarray(used), w0, K, cols, True)
    return tuple(np.asarray(x) for x in out)


def _same_as_pallas(got, want):
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert np.array_equal(torch_to_u32(got[2]), want[2])


# -- hand-built slices: each case of the chain occurs ------------------------------------


def _built_slice(seed, rows=130, K=64, chunk_rows=40):
    """A sparse slice (one bit in ten) whose first chunk is mostly used, with
    columns made by hand (w0 = 0, cols = 50: column 0 and columns 51.. are
    not valid, and carry bits):
      column 5: an unused row of chunk 0 and rows of chunks 1 and 2;
      column 20: one row of the last chunk alone, which has no bit below 20
        (so no earlier step touches it) while no other row has bit 20 (so no
        pivot's words bring it in);
      column 30: no row at all."""
    rng = np.random.default_rng(seed)
    bits = rng.random((K // 32, rows, 32)) < 0.1
    used = (rng.random((1, rows)) < 0.1).astype(np.int32)
    used[0, :chunk_rows] = rng.random(chunk_rows) < 0.8
    free0 = np.flatnonzero(used[0, :chunk_rows] == 0)
    bits[0, :, 20] = bits[0, :, 30] = False
    last = rows - 5
    used[0, last] = 0
    bits[0, last, :21] = False
    bits[0, last, 20] = True
    for r in (free0[0], chunk_rows + 5, chunk_rows + 10, 2 * chunk_rows + 5, 2 * chunk_rows + 9):
        bits[0, r, 5] = True
        used[0, r] = 0 if r >= chunk_rows else used[0, r]
    bT = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
    return bT, used


def _cases_held(bT, used, w0, cols, chunk_rows, prow, cT):
    """Which of CASES this input holds, read from the reference's outputs
    (prow, and cT: row r's bit jj is set iff pivot jj eliminated row r)."""
    K, rows = 32 * bT.shape[0], bT.shape[1]
    last = (rows - 1) // chunk_rows
    found = set()
    for jj in range(K):
        p = int(prow[jj])
        elim = np.flatnonzero((cT[jj >> 5] >> np.uint32(jj & 31)) & 1)
        chunks = set((elim // chunk_rows).tolist())
        if p >= 0 and p // chunk_rows == 0 and {1, 2} <= chunks:
            found.add(CASES[0])
        if p >= 0 and p // chunk_rows == last and elim.size == 0:
            found.add(CASES[1])
        if 1 <= 32 * w0 + jj <= cols and p < 0:
            found.add(CASES[3])
    if used[0, :chunk_rows].mean() > 0.5:
        found.add(CASES[2])
    free = used[0] == 0

    def has_bits(jj):
        return bool(((bT[jj >> 5][free] >> np.uint32(jj & 31)) & 1).any())

    if (32 * w0 < 1 and has_bits(0) and 32 * w0 + K - 1 > cols
            and has_bits(cols - 32 * w0 + 1) and (prow[: 1 - 32 * w0] < 0).all()
            and (prow[cols - 32 * w0 + 1 :] < 0).all()):
        found.add(CASES[4])
    return found


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_every_case_occurs_and_the_twin_is_the_pallas_scan(seed):
    """130 rows in four chunks of 40 (the last of 10): each case occurs on the
    input, and the chain's twin equals the Pallas scan and the step twin."""
    bT, used = _built_slice(seed)
    w0, K, cols, chunk = 0, 64, 50, 40
    want = _pallas(bT, used, w0, K, cols)
    assert _cases_held(bT, used, w0, cols, chunk, want[0], want[2]) == set(CASES)
    got = phase1.scan_chunked_plain(t32(bT), torch.from_numpy(used), w0, K, cols, chunk)
    _same_as_pallas(got, want)
    for g, p in zip(got, phase1.scan_plain(t32(bT), torch.from_numpy(used), w0, K, cols)):
        assert torch.equal(g, p)


@pytest.mark.parametrize("chunk", [1, 7, 40, 64, 129, 130, 500])
def test_any_chunk_size_gives_the_same_scan(chunk):
    """From one row a chunk to one chunk for the whole slice."""
    bT, used = _built_slice(4)
    want = phase1.scan_plain(t32(bT), torch.from_numpy(used), 0, 64, 50)
    got = phase1.scan_chunked_plain(t32(bT), torch.from_numpy(used), 0, 64, 50, chunk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_batched_twin_keeps_a_record_per_system():
    """Three systems in chunks of 40: two hand-built, one with every row used
    (no pivot at all); each case occurs in system 0, and the batched twin
    equals the batched Pallas scan and each system's single twin."""
    slices = [_built_slice(s) for s in (5, 6, 7)]
    bT = np.stack([s[0] for s in slices])
    used = np.concatenate([s[1] for s in slices])
    used[2] = 1
    w0, K, cols, chunk = 0, 64, 50, 40
    want = _pallas(bT, used, w0, K, cols)
    assert _cases_held(bT[0], used[:1], w0, cols, chunk, want[0][0], want[2][0]) == set(CASES)
    assert (want[0][2] == -1).all()
    got = gauss_batched.scan_batched_chunked_plain(t32(bT), torch.from_numpy(used), w0, K,
                                                   cols, chunk)
    _same_as_pallas(got, want)
    for b in range(3):
        one = phase1.scan_chunked_plain(t32(bT[b]), torch.from_numpy(used[b : b + 1]), w0, K,
                                        cols, chunk)
        assert torch.equal(one[0], got[0][b]) and torch.equal(one[2], got[2][b])


@pytest.mark.parametrize("kw,w0,cols", [(1, 0, 10**6), (3, 1, 100), (8, 2, 10**6)])
def test_random_slices_in_eight_chunks(kw, w0, cols):
    """1000 rows in chunks of 128 (eight, the last of 104), dense random
    slices with 30% of the rows used, against the Pallas scan and the step
    twin; one batch of three such systems against the batched Pallas scan."""
    rng = np.random.default_rng(kw + w0)
    K, rows, chunk = 32 * kw, 1000, 128
    bT = rng.integers(0, 2**32, size=(3, kw, rows), dtype=np.uint32)
    used = (rng.random((3, rows)) < np.array([[0.3], [0.0], [0.9]])).astype(np.int32)
    want = _pallas(bT[0], used[:1], w0, K, cols)
    assert (want[0] >= 0).any()
    _same_as_pallas(phase1.scan_chunked_plain(t32(bT[0]), torch.from_numpy(used[:1]), w0, K,
                                              cols, chunk), want)
    want_b = _pallas(bT, used, w0, K, cols)
    got_b = gauss_batched.scan_batched_chunked_plain(t32(bT), torch.from_numpy(used), w0, K,
                                                     cols, chunk)
    _same_as_pallas(got_b, want_b)
    for g, p in zip(got_b, gauss_batched.scan_batched_plain(t32(bT), torch.from_numpy(used),
                                                            w0, K, cols)):
        assert torch.equal(g, p)


# -- the routes ------------------------------------------------------------------------


@pytest.mark.parametrize("kw", range(1, 9))
@pytest.mark.parametrize("rows", [65537, 67328, 131072, 131073, 140000, 300000])
def test_scan_route_chains_past_the_largest_cluster(rows, kw):
    """Past what the largest cluster holds: the fewest chunks a cluster holds,
    of equal rows, each on a cluster that holds it with the record."""
    assert rows > phase1.scan_max_rows(kw)
    route = phase1.scan_route(rows, kw)
    most = phase1.scan_max_rows(kw, chained=True)
    assert route.kernel == "scan_chunked"
    assert route.chunks == -(-rows // most) == -(-rows // route.chunk_rows)
    assert route.chunk_rows == -(-rows // route.chunks) <= most
    assert route.nblocks == route.nblocks_last == phase1.SCAN_CLUSTER_SIZES[-1]
    assert route.rows_per_block == -(-route.chunk_rows // route.nblocks)
    assert route.smem_bytes == phase1.scan_smem_bytes(route.rows_per_block, kw, chained=True)
    assert phase1.scan_fits(route.rows_per_block, kw, chained=True)
    last = rows - (route.chunks - 1) * route.chunk_rows
    assert 0 < last <= route.chunk_rows


def test_the_record_costs_no_rows():
    """With the record in shared memory a cluster still holds 65536 rows at
    every width: the thread's 8 rows bind, not shared memory."""
    for kw in range(1, 9):
        assert phase1.scan_max_rows(kw, chained=True) == phase1.scan_max_rows(kw) == 65536
        assert (phase1.scan_smem_bytes(4096, kw, chained=True)
                == phase1.scan_smem_bytes(4096, kw) + 16 * (2 * 256 + 256 // 4))


def test_routes_of_the_very_tall_system():
    """67328 rows at K = 256: two chunks of 33664 rows on 16 blocks (5 rows a
    thread) for the 1-pivot and the batched scan, and for the chained fused
    phase 1, fused update + scan and two-pivot scan (under the pair's
    header); every route is the cluster's up to 65536 rows."""
    assert phase1.scan_route(67328, 8) == (
        "scan_chunked", 16, 2104, phase1.scan_smem_bytes(2104, 8, chained=True), 2, 33664, 16)
    for batch in (1, 2, 4, 7, 16):
        route = phase1.scan_batched_route(batch, 67328, 8)
        assert route[:1] + route[4:] == ("scan_batched_chunked", 2, 33664, 16)
        assert route.nblocks == 16  # 8 blocks cannot hold 33664 rows
    chained = phase1.scan_route(67328, 8)
    assert phase1.scan2_route(67328, 8) == chained._replace(
        kernel="scan2_chunked", smem_bytes=phase1.scan_smem_bytes(2104, 8, pairs=True,
                                                                  chained=True))
    assert phase1.phase1_fused_route(67328, 8) == chained._replace(kernel="phase1_fused_chunked")
    assert panel_update.update_scan_route(67328, 8) == chained._replace(
        kernel="update_scan_chunked")
    assert phase1.scan_route(65536, 8)[:2] == ("scan", 16)
    assert phase1.scan_batched_route(2, 65536, 8).kernel == "scan_batched"
    assert panel_update.update_scan_route(65536, 8)[:2] == ("update_scan", 16)
    assert panel_update.update_scan_route(20224, 8)[:2] == (
        "update_scan", phase1.scan_route(20224, 8).nblocks)


@pytest.mark.parametrize("batch", [1, 8, 16])
@pytest.mark.parametrize("rows,chunk", [(5000, 1024), (130, 40), (1000, 1), (67328, 65536),
                                        (200000, 20000)])
def test_forced_chunks(rows, chunk, batch):
    """A forced chunk size: each chunk and the last on the cluster rule's size
    for its rows, halved as the batched route halves while the batch
    outnumbers the resident clusters."""
    route = phase1.scan_chunked_route(rows, 8, chunk, batch)
    assert route.chunks == -(-rows // chunk) and route.chunk_rows == chunk
    for n, nb in ((min(chunk, rows), route.nblocks),
                  (rows - (route.chunks - 1) * chunk, route.nblocks_last)):
        assert phase1.scan_fits(-(-n // nb), 8, chained=True)
        single = phase1.scan_route(n, 8).nblocks
        assert nb <= single
        if nb < single:
            assert batch > phase1.SCAN_RESIDENT_CLUSTERS[2 * nb]


@pytest.mark.parametrize("rows,kw,chunk,batch", [
    (0, 8, None, 1), (100, 9, None, 1), (100, 8, 0, 1), (100000, 8, 65537, 1), (100, 8, None, 0)])
def test_chunked_route_rejects_what_no_kernel_takes(rows, kw, chunk, batch):
    with pytest.raises(ValueError):
        phase1.scan_chunked_route(rows, kw, chunk, batch)


# -- constants, signatures, wrappers -----------------------------------------------------


def _constant(source: str, name: str) -> str:
    m = re.search(rf"constexpr \w+ {name} = ([^;]+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return m.group(1)


def test_record_constants_mirror_the_header():
    cols = int(_constant("scan_cluster.cuh", "kMaxRecordCols"))
    assert cols == 256 == 32 * 8
    assert _constant("scan_cluster.cuh", "kRecordQuads") == (
        "2 * kMaxRecordCols + kMaxRecordCols / 4")
    assert phase1._RECORD_BYTES == 16 * (2 * cols + cols // 4)
    text = (CSRC / "scan_chunked.cu").read_text()
    assert '#include "scan_cluster.cuh"' in text and "scan_cluster_body<" in text
    assert "mbarrier" not in text and "st.async" not in text


def test_chained_kernels_are_declared_and_counted():
    for fn, key in (("gf2_scan_chunked", "scan_chunked"),
                    ("gf2_scan_batched_chunked", "scan_batched_chunked")):
        assert f'extern "C" int {fn}(' in (CSRC / "scan_chunked.cu").read_text()
        assert fn in _cuda._SIGNATURES and _cuda.LAUNCHES[key] == 0
    assert (len(_cuda._SIGNATURES["gf2_scan_batched_chunked"])
            == len(_cuda._SIGNATURES["gf2_scan_chunked"]) + 1)


def test_chunked_wrappers_run_the_twins_on_cpu_tensors():
    """On CPU tensors the wrappers run the chain's twin, launch nothing, and
    the entry points (phase1.scan, scan_batched) the step twins."""
    bT, used = _built_slice(8)
    bT, used = t32(bT), torch.from_numpy(used)
    want = phase1.scan_plain(bT, used, 0, 64, 50)
    _cuda.reset_launches()
    for got in (phase1.scan_chunked(bT, used, 0, 64, 50),
                phase1.scan_chunked(bT, used, 0, 64, 50, 40), phase1.scan(bT, used, 0, 64, 50)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    b3, u3 = bT.expand(3, *bT.shape).contiguous(), used.expand(3, -1).contiguous()
    for got in (gauss_batched.scan_batched_chunked(b3, u3, 0, 64, 50, 40),
                gauss_batched.scan_batched(b3, u3, 0, 64, 50)):
        assert torch.equal(got[0][1], want[0]) and torch.equal(got[2][1], want[2])
        assert torch.equal(got[1][1:2], want[1])
    assert not any(_cuda.LAUNCHES.values())
    with pytest.raises(ValueError, match="does not match"):
        phase1.scan_chunked(bT, used, 0, 96, 50)
    with pytest.raises(ValueError, match="does not match"):
        gauss_batched.scan_batched_chunked(b3, u3, 0, 96, 50)

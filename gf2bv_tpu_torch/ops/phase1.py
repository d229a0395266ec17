"""Phase 1 of the blocked solver: pivot scan + pivot-row rebuild.

Port of ``gf2bv_tpu/ops/pallas_phase1.py``.  Five kernels carry it, each
with a plain PyTorch twin of the same contract that follows the kernel's own
step structure:

* :func:`scan` — the forward pivot scan of one K-column panel, the dispatch
  of ``_call_scan_kernel`` over its variants:

  - ``""``: one pivot per step (``_make_scan_kernel``); CUDA
    ``csrc/scan.cu`` ``gf2_scan``, a thread-block cluster with the state in
    shared memory (body in ``csrc/scan_cluster.cuh``), or, for more rows than the largest cluster holds,
    ``gf2_scan_chunked`` (:func:`scan_chunked`, ``csrc/scan_chunked.cu``: a
    chain of cluster scans over row chunks, each applying the pivots the
    chunks before it elected); :func:`scan_route` picks between them from the
    shape alone; twin of both :func:`scan_plain`, and
    :func:`scan_chunked_plain` in the chain's order;
  - ``"2"``: two pivots per step (``_make_scan_kernel2``), :func:`scan2`;
    CUDA ``csrc/scan2.cu`` ``gf2_scan2``, a thread-block cluster that elects
    both pivots of a pair in one exchange (body in
    ``csrc/scan2_cluster.cuh``), or past the largest cluster's rows
    ``gf2_scan2_chunked`` (:func:`scan2_chunked`, ``csrc/scan2_chunked.cu``:
    the chain of :func:`scan_chunked` with the two-pivot body);
    :func:`scan2_route` picks between them; twin :func:`scan2_plain`,
    :func:`scan2_cluster_plain` in the cluster kernel's order and
    :func:`scan2_chunked_plain` in the chain's;
  - ``"m"``: election and extraction through packed min-keys
    (``_make_scan_kernel_minkey``), :func:`scan_minkey`; CUDA
    ``gf2_scan_minkey``, the cluster scan with the min-key election
    (:func:`scan_minkey_route`), twin :func:`scan_minkey_plain`, and
    :func:`scan_minkey_cluster_plain` in the cluster kernel's order.  Systems
    of ``MINKEY_MAX_ROWS`` rows or more take variant ``""``, as in the
    reference.

* :func:`reconstruct` — full-width pivot-row rebuild + triangular back pass
  (``_make_reconstruct_kernel`` via ``phase1_reconstruct``); CUDA source
  ``csrc/reconstruct.cu`` (a coefficient solve blocked by groups of 32 rows
  whose dependent steps are warp-wide broadcasts, then the product
  ``pf = T.arows`` through the table kernel), plain twin
  :func:`reconstruct_plain`; :func:`reconstruct_coeff_blocked_plain` is the
  twin of the kernel's own order, and :func:`reconstruct_coeff` launches the
  coefficient solve alone.
* :func:`phase1_panel` — the fused phase 1 (``_make_kernel``, the
  ``pallas`` engine): scan, rebuild and back pass in one launch; CUDA source
  ``csrc/phase1_fused.cu``: ``gf2_phase1_fused``, one thread-block cluster
  (the cluster scan, then in every block the blocked coefficient solve and
  its share of the product ``pf = T.a[prow]``), or past the largest
  cluster's rows ``gf2_phase1_fused_chunked`` (:func:`phase1_panel_chunked`,
  ``csrc/fused_chunked.cu``: the chained scan, its last link followed by the
  coefficient solve and the product); :func:`phase1_fused_route` picks
  between them; plain twin :func:`phase1_panel_plain`, and
  :func:`phase1_panel_chunked_plain` in the chain's order.

:func:`phase1_panel_split` (scan, gather, rebuild) and
:func:`phase1_scan_subset` (the scan of the ``pallas_sub`` engine) are the
reference's compositions of those kernels.

A wrapper launches its kernel for CUDA tensors and runs the plain twin only
for CPU tensors; there is no fallback between the two.  Words are int32
tensors holding the reference's uint32 bit patterns (core/words.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.words import I32, bit_i32, srl, torch_to_u32, u32_to_torch, xor_fold
from . import _cuda
from .panel_update import rank_k_xor_

# min-key packing puts the row index in int32 bits 16..30
MINKEY_MAX_ROWS = 1 << 15
# rows of the subset scan (pallas_sub): K pivots leave >= 512 live candidates
SUBSET_ROWS = 768


# -- kernel 1: forward scan ----------------------------------------------------


def _bitval(sh: int) -> int:
    """The int32 value of a word with only bit ``sh`` set."""
    return (1 << sh) if sh < 31 else -(1 << 31)


def scan_steps_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int):
    """The scan's steps over B independent systems, plain torch: bT
    (B, kw, rows), used (B, rows) int32.  Returns (prow (B, K), used'
    (B, rows), cT (B, kw, rows)).  The plain twin of both scan kernels."""
    nb, kw, rows = bT.shape
    dev = bT.device
    b = bT.clone()
    u = used.clone()
    c = torch.zeros_like(bT)
    prow = torch.full((nb, K), -1, dtype=I32, device=dev)
    lane = torch.arange(rows, dtype=I32, device=dev)[None, :]
    batch = torch.arange(nb, device=dev)[:, None]
    for jj in range(K):
        gbit = 32 * w0 + jj
        if not 1 <= gbit <= cols:
            continue
        sw, sh = jj >> 5, jj & 31
        cand = (((b[:, sw] >> sh) & 1) == 1) & (u == 0)  # (B, rows)
        piv = torch.where(cand, lane, rows).amin(dim=1)  # (B,)
        has = piv < rows
        piv_safe = torch.where(has, piv, 0).long()
        prow[:, jj] = torch.where(has, piv, -1)
        elim = cand & (lane != piv[:, None])
        words = torch.arange(sw, kw, device=dev)[None, :]
        bpiv = b[batch, words, piv_safe[:, None]]  # (B, kw - sw)
        b[:, sw:] ^= torch.where(elim[:, None, :], bpiv[:, :, None], 0)
        c[:, sw] ^= torch.where(elim, _bitval(sh), 0).to(I32)
        u = torch.where((lane == piv[:, None]) & has[:, None], 1, u).to(I32)
    return prow, u, c


def scan_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int):
    """Plain twin of the scan kernel.  bT (kw, rows), used (1, rows) int32.
    Returns (prow (K,), used' (1, rows), cT (kw, rows))."""
    prow, u, c = scan_steps_plain(bT[None], used, w0, K, cols)
    return prow[0], u, c[0]


def _launch_scan(fn_name: str, key: str, bT: torch.Tensor, used: torch.Tensor,
                 w0: int, K: int, cols: int, nblocks: int):
    """Launch one of the single-system cluster scans (1-pivot, two-pivot,
    min-key), which share a C signature, on ``nblocks`` blocks."""
    kw, rows = bT.shape
    dev = bT.device
    _cuda.require(bT, "bT", (kw, rows), dev)
    _cuda.require(used, "used", (1, rows), dev)
    prow = torch.empty((K,), dtype=I32, device=dev)
    used_o = torch.empty_like(used)
    cT = torch.empty_like(bT)
    rc = getattr(_cuda.lib(), fn_name)(
        bT.data_ptr(), used.data_ptr(), prow.data_ptr(), used_o.data_ptr(), cT.data_ptr(),
        rows, kw, int(w0), int(cols), int(nblocks), _cuda.stream_of(bT),
    )
    _cuda.check(rc, f"{key} kernel")
    _cuda.LAUNCHES[key] += 1
    return prow, used_o, cT


# The route of the 1-pivot scan: a pure function of (rows, kw), taken before
# the launch and never after a failure.  The constants mirror
# csrc/scan_cluster.cuh.
SCAN_THREADS = 512  # threads per block of the cluster scan
SCAN_MAX_SLOTS = 8  # rows a thread can own
SCAN_SMEM_MAX = 232448  # bytes of shared memory a block may use (227 KB)
SCAN_CLUSTER_SIZES = (1, 2, 4, 8, 16)
SCAN_BLOCK_ROWS = 3 * SCAN_THREADS  # rows per block the route aims at: three a thread
_SCAN_HEADER_BYTES = 16 * (2 * 16 * 3) + 4 * (2 * 32) + 16  # slots, warp minima, mbarriers
# the min-key election's header: slots of 4 quads, a record of 4 quads a warp
_MINKEY_HEADER_BYTES = 16 * (2 * 16 * 4) + 4 * (2 * (SCAN_THREADS // 32) * 16) + 16
# the two-pivot election's header (csrc/scan2_cluster.cuh): slots of 7 quads (the
# words of m0, P0 and P1, then the three rows), a record of one quad a warp
SCAN2_SLOT_QUADS = 7
_SCAN2_HEADER_BYTES = 16 * (2 * 16 * SCAN2_SLOT_QUADS + 2 * (SCAN_THREADS // 32) + 1)


# the chained scan's record of the columns taken, in shared memory after the
# election's header: the pivots' words [256][2] quads, then their rows [256]
_RECORD_BYTES = 16 * (2 * 256 + 256 // 4)


class ScanRoute(NamedTuple):
    """One launch of a cluster kernel on the whole slice: ``nblocks``
    blocks of ``rows_per_block`` rows and ``smem_bytes`` of dynamic shared
    memory each."""

    kernel: str  # the kernel's LAUNCHES key: "scan", "scan2", "phase1_fused", ...
    nblocks: int
    rows_per_block: int
    smem_bytes: int


class ChunkedScanRoute(NamedTuple):
    """The chained scan of a slice too tall for one cluster: ``chunks``
    launches, chunk c the rows [c * chunk_rows, (c + 1) * chunk_rows), each
    on a cluster of ``nblocks`` blocks (``rows_per_block`` rows and
    ``smem_bytes`` of shared memory a block) but the last, on
    ``nblocks_last``."""

    # "scan_chunked", "scan_batched_chunked", the two-pivot "scan2_chunked", or a
    # fused kernel on the same chunks: "phase1_fused_chunked", "update_scan_chunked"
    kernel: str
    nblocks: int
    rows_per_block: int
    smem_bytes: int
    chunks: int
    chunk_rows: int
    nblocks_last: int


def scan_smem_bytes(rows_per_block: int, kw: int, minkey: bool = False,
                    pairs: bool = False, chained: bool = False) -> int:
    """Shared memory of one block of the cluster scan: the header (the
    min-key election's with ``minkey``, the two-pivot election's with
    ``pairs``; with ``chained`` the chained scan's record after it), then the
    slice words of each row in 16-byte halves of four, rows padded to 32."""
    header = (_SCAN2_HEADER_BYTES if pairs else _MINKEY_HEADER_BYTES if minkey
              else _SCAN_HEADER_BYTES) + (_RECORD_BYTES if chained else 0)
    return header + 16 * (-(-kw // 4)) * (-(-rows_per_block // 32) * 32)


def scan_fits(rows_per_block: int, kw: int, minkey: bool = False, pairs: bool = False,
              chained: bool = False) -> bool:
    """Whether one block of the cluster scan can own that many rows."""
    return (rows_per_block <= SCAN_MAX_SLOTS * SCAN_THREADS
            and scan_smem_bytes(rows_per_block, kw, minkey, pairs, chained) <= SCAN_SMEM_MAX)


def scan_max_rows(kw: int, chained: bool = False, pairs: bool = False) -> int:
    """The most rows the largest cluster holds (with ``chained``: as one
    chunk of the chained scan; with ``pairs``: under the two-pivot header); a
    taller slice takes :func:`scan_chunked` (:func:`scan2_chunked`)."""
    header = scan_smem_bytes(0, kw, pairs=pairs, chained=chained)
    per_block = (SCAN_SMEM_MAX - header) // (16 * (-(-kw // 4))) // 32 * 32
    return SCAN_CLUSTER_SIZES[-1] * min(per_block, SCAN_MAX_SLOTS * SCAN_THREADS)


def scan_route(rows: int, kw: int) -> ScanRoute | ChunkedScanRoute:
    """Which kernel scans a (kw, rows) slice, and on how many blocks: the
    smallest cluster whose blocks own at most ``SCAN_BLOCK_ROWS`` rows each;
    failing that the largest cluster, if its blocks hold the state (shared
    memory, and ``SCAN_MAX_SLOTS`` rows a thread); else the chained scan
    (:func:`scan_chunked_route`)."""
    if rows < 1 or not 1 <= kw <= 8:
        raise ValueError(f"no scan kernel for rows={rows}, kw={kw}")
    nb = _cluster_rule(rows, kw)
    if nb is None:
        return scan_chunked_route(rows, kw)
    rpb = -(-rows // nb)
    return ScanRoute("scan", nb, rpb, scan_smem_bytes(rpb, kw))


def _cluster_rule(rows: int, kw: int, chained: bool = False, pairs: bool = False) -> int | None:
    """The smallest cluster whose blocks own at most ``SCAN_BLOCK_ROWS`` rows
    each, failing that the largest, if its blocks hold the state; None when
    none does."""
    for nb in SCAN_CLUSTER_SIZES:
        rpb = -(-rows // nb)
        if scan_fits(rpb, kw, pairs=pairs, chained=chained) and (
                rpb <= SCAN_BLOCK_ROWS or nb == SCAN_CLUSTER_SIZES[-1]):
            return nb
    return None


def _halved_for_batch(nb: int, batch: int, rows: int, kw: int, chained: bool = False) -> int:
    """``nb`` halved while the batch has more systems than the card runs
    clusters of that size at once (``SCAN_RESIDENT_CLUSTERS``) and the smaller
    cluster still holds a slice of ``rows`` rows."""
    while (nb > 1 and batch > SCAN_RESIDENT_CLUSTERS[nb]
           and scan_fits(-(-rows // (nb // 2)), kw, chained=chained)):
        nb //= 2
    return nb


def scan_chunk_rows(rows: int, kw: int, pairs: bool = False) -> int:
    """The chained scan's chunk: the fewest chunks a cluster holds, of equal
    rows (the last may have fewer).  A step's cost grows with the rows a
    thread owns, so equal chunks beat filling the largest cluster first
    (both cuts measured on the H100: ``PERF.md`` §6)."""
    chunks = -(-rows // scan_max_rows(kw, chained=True, pairs=pairs))
    return -(-rows // chunks)


def _chunk_cluster(rows: int, kw: int, batch: int, pairs: bool = False) -> int:
    """Blocks a system for one chunk of ``rows`` rows of the chained scan: the
    cluster rule of :func:`scan_route`, halved for the batch as in
    :func:`scan_batched_route`, with the record in shared memory."""
    nb = _cluster_rule(rows, kw, chained=True, pairs=pairs)
    if nb is None:
        raise ValueError(f"a chunk of {rows} rows fits no cluster at kw={kw}")
    return _halved_for_batch(nb, batch, rows, kw, chained=True)


def scan_chunked_route(rows: int, kw: int, chunk_rows: int | None = None, batch: int = 1,
                       kernel: str = "scan_chunked") -> ChunkedScanRoute:
    """The chained scan's launches for ``batch`` (kw, rows) slices: chunks of
    ``chunk_rows`` rows (by default :func:`scan_chunk_rows`; any count from 1
    to what the largest cluster holds), each on the cluster
    :func:`_chunk_cluster` picks for its rows, with the two-pivot header for
    ``scan2_chunked``'s links.  A pure function of the shape."""
    if rows < 1 or not 1 <= kw <= 8 or batch < 1:
        raise ValueError(f"no chained scan for rows={rows}, kw={kw}, batch={batch}")
    pairs = kernel == "scan2_chunked"
    most = scan_max_rows(kw, chained=True, pairs=pairs)
    if chunk_rows is None:
        chunk_rows = scan_chunk_rows(rows, kw, pairs)
    if not 1 <= chunk_rows <= most:
        raise ValueError(f"chunk_rows={chunk_rows} outside 1..{most}")
    chunks = -(-rows // chunk_rows)
    full = min(chunk_rows, rows)
    nb = _chunk_cluster(full, kw, batch, pairs)
    rpb = -(-full // nb)
    last = _chunk_cluster(rows - (chunks - 1) * chunk_rows, kw, batch, pairs)
    return ChunkedScanRoute(kernel, nb, rpb,
                            scan_smem_bytes(rpb, kw, pairs=pairs, chained=True), chunks,
                            chunk_rows, last)


# Clusters of each size that an H100 (132 SMs) runs at once, one block an SM
# (``cudaOccupancyMaxActiveClusters``: a cluster of 16 needs 16 free SMs in
# one GPC): measured at the flagship slice for 16 and 8 blocks and at 5000 rows
# for 4; 2 and 1 by the same 120 blocks (slices small enough for two blocks an
# SM run more: 66 of 2 blocks at 5000 rows).
SCAN_RESIDENT_CLUSTERS = {16: 7, 8: 15, 4: 30, 2: 60, 1: 120}


def scan_batched_route(batch: int, rows: int, kw: int) -> ScanRoute:
    """Which kernel scans a batch of (kw, rows) slices, and on how many
    blocks per system: one cluster per system in one launch.  It starts from
    the single scan's cluster (:func:`scan_route`) and halves it while the
    batch has more systems than the card runs clusters of that size at once
    (``SCAN_RESIDENT_CLUSTERS``) and the smaller cluster still holds a slice:
    measured at the flagship slice, one wave of 8-block clusters (0.30 ms a
    panel) beats two waves of 16-block ones (0.48), and two of 8 (0.59) three
    of 16 (0.71).  Past the largest cluster's rows the chained scan, a
    cluster per system in each launch (``scan_batched_chunked``)."""
    if batch < 1:
        raise ValueError(f"no scan kernel for a batch of {batch}")
    route = scan_route(rows, kw)
    if route.kernel == "scan_chunked":
        return scan_chunked_route(rows, kw, batch=batch, kernel="scan_batched_chunked")
    nb = _halved_for_batch(route.nblocks, batch, rows, kw)
    rpb = -(-rows // nb)
    return ScanRoute("scan_batched", nb, rpb, scan_smem_bytes(rpb, kw))


def scan_occupancy(rows: int, kw: int, nblocks: int) -> int:
    """How many clusters of ``nblocks`` blocks, each holding a (kw, rows)
    slice, the current CUDA device runs at once
    (``cudaOccupancyMaxActiveClusters``); raises when the slice does not fit
    such a cluster or the card cannot place one."""
    import ctypes

    out = ctypes.c_int(0)
    rc = _cuda.lib().gf2_scan_occupancy(rows, kw, int(nblocks), ctypes.addressof(out))
    _cuda.check(rc, "scan occupancy query")
    return out.value


def scan_chunked_steps_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int,
                             cols: int, chunk_rows: int):
    """The chained scan's order over B systems, plain torch: bT (B, kw,
    rows), used (B, rows).  The chunks of ``chunk_rows`` rows in turn, each
    alone but for a record of the columns the chunks before it took (the
    pivot's global row and its words as they stood at that step): at a taken
    column every candidate of the chunk gets the recorded words and its
    coefficient bit; at another valid column the chunk elects its lowest
    candidate, which is the global pivot, and records it.  Returns (prow
    (B, K), used' (B, rows), cT (B, kw, rows)), bit for bit those of
    :func:`scan_steps_plain`."""
    nb, kw, rows = bT.shape
    dev = bT.device
    prow = torch.full((nb, K), -1, dtype=I32, device=dev)
    rec_words = torch.zeros((nb, K, kw), dtype=I32, device=dev)
    u_out = torch.empty_like(used)
    c_out = torch.empty_like(bT)
    for base in range(0, rows, chunk_rows):
        b = bT[:, :, base : base + chunk_rows].clone()
        u = used[:, base : base + chunk_rows].clone()
        c = torch.zeros_like(b)
        n = b.shape[2]
        lane = torch.arange(n, dtype=I32, device=dev)[None, :]
        for jj in range(K):
            if not 1 <= 32 * w0 + jj <= cols:
                continue
            sw, sh = jj >> 5, jj & 31
            cand = (((b[:, sw] >> sh) & 1) == 1) & (u == 0)  # (B, n)
            taken = prow[:, jj] >= 0  # (B,): the record's rows are prow's
            piv = torch.where(cand & ~taken[:, None], lane, n).amin(dim=1)
            has = piv < n
            mine = (lane == piv[:, None]) & has[:, None]
            words = b.gather(2, torch.where(has, piv, 0).long()[:, None, None]
                             .expand(nb, kw, 1))[:, :, 0]  # (B, kw): the pivot's now
            bp = torch.where(taken[:, None], rec_words[:, jj], words)
            elim = cand & ~mine
            b[:, sw:] ^= torch.where(elim[:, None, :], bp[:, sw:, None], 0)
            c[:, sw] ^= torch.where(elim, _bitval(sh), 0).to(I32)
            u = torch.where(mine, 1, u).to(I32)
            prow[:, jj] = torch.where(has, base + piv, prow[:, jj])
            rec_words[:, jj] = torch.where(has[:, None], words, rec_words[:, jj])
        u_out[:, base : base + n] = u
        c_out[:, :, base : base + n] = c
    return prow, u_out, c_out


def scan_chunked_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                       chunk_rows: int):
    """Plain twin of :func:`scan_chunked` in the chain's order: bT (kw, rows),
    used (1, rows).  Outputs as :func:`scan_plain`, bit for bit."""
    prow, u, c = scan_chunked_steps_plain(bT[None], used, w0, K, cols, chunk_rows)
    return prow[0], u, c[0]


def launch_chunked(fn_name: str, key: str, bT: torch.Tensor, used: torch.Tensor, w0: int,
                   K: int, cols: int, route: ChunkedScanRoute, batched: bool):
    """Launch a chained scan (1-pivot, batched or two-pivot): one C call that
    launches its ``route.chunks`` kernels in order on the stream, counted as
    that many launches.  bT (B, kw, rows), used (B, rows); the record is
    scratch of 9 K words a system."""
    nb, kw, rows = bT.shape
    dev = bT.device
    _cuda.require(bT, "bT", (nb, kw, rows), dev)
    _cuda.require(used, "used", (nb, rows), dev)
    prow = torch.empty((nb, K), dtype=I32, device=dev)
    used_o = torch.empty_like(used)
    cT = torch.empty_like(bT)
    record = torch.empty((nb, 9 * K), dtype=I32, device=dev)
    shape = (rows, kw, int(w0), int(cols), route.chunk_rows, route.nblocks, route.nblocks_last)
    rc = getattr(_cuda.lib(), fn_name)(
        bT.data_ptr(), used.data_ptr(), prow.data_ptr(), used_o.data_ptr(), cT.data_ptr(),
        record.data_ptr(), *((nb,) if batched else ()), *shape, _cuda.stream_of(bT),
    )
    _cuda.check(rc, f"{key} kernel")
    _cuda.LAUNCHES[key] += route.chunks
    return prow, used_o, cT


def scan_chunked(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                 chunk_rows: int | None = None):
    """The 1-pivot scan as a chain of cluster scans over row chunks: the
    kernel for slices taller than the largest cluster holds
    (:func:`scan_route`), any slice with ``chunk_rows`` given (by default
    :func:`scan_chunk_rows`).  Raises when a chunk fits no cluster or the card
    cannot place one.  Outputs as :func:`scan`."""
    _check_k(bT, K)
    route = scan_chunked_route(bT.shape[1], bT.shape[0], chunk_rows)
    if not _cuda.on_cuda(bT):
        return scan_chunked_plain(bT, used, w0, K, cols, route.chunk_rows)
    prow, used_o, cT = launch_chunked("gf2_scan_chunked", "scan_chunked", bT[None], used, w0,
                                      K, cols, route, batched=False)
    return prow[0], used_o, cT[0]


def scan_cluster(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                 nblocks: int):
    """The 1-pivot scan on a cluster of ``nblocks`` blocks whatever
    :func:`scan_route` would pick (:func:`scan` asks the route); raises when
    the state does not fit the blocks or the card cannot place the cluster.
    Outputs as :func:`scan`."""
    _check_k(bT, K)
    if not _cuda.on_cuda(bT):
        return scan_plain(bT, used, w0, K, cols)
    return _launch_scan("gf2_scan", "scan", bT, used, w0, K, cols, nblocks)


def _check_k(bT: torch.Tensor, K: int) -> None:
    if K != 32 * bT.shape[0]:
        raise ValueError(f"K={K} does not match bT's {bT.shape[0]} words")


def scan(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
         variant: str = ""):
    """Forward scan of one panel: the lowest unused row with the column's
    bit set pivots (columns 1..cols are valid); its slice words from the
    column's word on are XORed into the other candidates, whose coefficient
    bit is set in cT.  Returns (prow (K,), used' (1, rows), cT (kw, rows)).

    ``variant`` picks the kernel, as ``_call_scan_kernel`` does: ``""`` the
    1-pivot scan, ``"2"`` :func:`scan2`, ``"m"`` :func:`scan_minkey` (the
    1-pivot scan for ``MINKEY_MAX_ROWS`` rows or more).  All three give the
    same outputs.  On the card the 1-pivot scan is the cluster kernel or, past
    the largest cluster's rows, :func:`scan_chunked` (:func:`scan_route`)."""
    if variant == "m" and bT.shape[1] >= MINKEY_MAX_ROWS:
        variant = ""
    if variant == "2":
        return scan2(bT, used, w0, K, cols)
    if variant == "m":
        return scan_minkey(bT, used, w0, K, cols)
    if variant:
        raise ValueError(f"unknown scan variant {variant!r}; expected '', '2' or 'm'")
    _check_k(bT, K)
    if not _cuda.on_cuda(bT):
        return scan_plain(bT, used, w0, K, cols)
    route = scan_route(bT.shape[1], bT.shape[0])
    if route.kernel == "scan_chunked":
        return scan_chunked(bT, used, w0, K, cols, route.chunk_rows)
    return scan_cluster(bT, used, w0, K, cols, route.nblocks)


# -- kernel 1c: the subset-first scan (the default engine's scan on the card) ----------

# Rows of the subset-first scan: the first SCAN_SUBSET_ROWS unused rows of a
# panel, 16 a lane of one warp (csrc/scan_subset.cu: kSubsetRows, a
# compile-time constant).  At 256 the NLFSR attack's dense rows leave columns
# free on most panels; a step costs more the more rows a lane holds (PERF.md
# §6).
SCAN_SUBSET_ROWS = 512
# words of the kernel's scratch after the record: flag, sub_end, the subset's rows
SUBSET_HEADER_WORDS = 3


def subset_scratch_words(K: int) -> int:
    """Words of the subset-first scan's scratch: the record (the pivots'
    slice words [K][8] at their election, then their rows [K], the chained
    scan's layout) and the header."""
    return 9 * K + SUBSET_HEADER_WORDS


def _valid_steps(w0: int, K: int, cols: int) -> tuple[int, int]:
    """The panel's valid columns as the steps [lo, hi): global bits 1..cols."""
    return max(0, min(K, 1 - 32 * w0)), max(0, min(K, cols - 32 * w0 + 1))


def scan_subset_steps_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                            S: int = SCAN_SUBSET_ROWS):
    """The subset kernel in its own order, plain torch: bT (kw, rows), used
    (1, rows).  The first ``S`` unused rows (the subset, in row order) are
    scanned a word of 32 columns at a time: a step elects among the rows'
    current word alone and records the candidates' coefficient bits; after
    the word its pivots' later words at their election are solved (pivot t's
    are its stored words XOR those of the earlier pivots its coefficients
    name), and every row XORs in the pivots its coefficient word names.

    Returns (prow (K,) global rows, used' (1, rows), cT (kw, rows): the
    coefficient words of the subset's rows, zero elsewhere, scratch
    (``subset_scratch_words(K)``,) as the kernel leaves it: the record and
    the header (flag: a valid column left free while unused rows lie above
    the subset; sub_end: the row after the subset's last, ``rows`` when the
    subset is every unused row; the subset's rows))."""
    kw, rows = bT.shape
    dev = bT.device
    unused = torch.nonzero(used[0] == 0)[:, 0]
    idx = unused[:S]
    n = idx.shape[0]
    whole = unused.shape[0] < S  # the subset is every unused row
    sub_end = rows if whole else int(idx[-1]) + 1
    w = bT[:, idx].clone()  # (kw, n)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    cT = torch.zeros_like(bT)
    rec = np.zeros((K, 8), dtype=np.uint32)
    pslot = [-1] * K
    lo, hi = _valid_steps(w0, K, cols)
    free = False
    for g in range(kw):
        c = torch.zeros(n, dtype=I32, device=dev)
        for b in range(32):
            jj = 32 * g + b
            if not lo <= jj < hi:
                continue
            cand = (((w[g] >> b) & 1) == 1) & live
            hits = torch.nonzero(cand)[:, 0]
            if not hits.shape[0]:
                free = True
                continue
            s = int(hits[0])
            pw = w[g, s].clone()
            cand[s] = False
            live[s] = False
            w[g] ^= torch.where(cand, pw, 0).to(I32)
            c |= torch.where(cand, _bitval(b), 0).to(I32)
            pslot[jj] = s
            rec[jj, g] = int(pw) & 0xFFFFFFFF
        cT[g, idx] = c
        if g + 1 == kw:
            continue
        # the word's pivots' later words at their election: a triangular solve
        later = torch_to_u32(w[g + 1 :].T.contiguous())  # (n, kw - g - 1)
        coef = torch_to_u32(c)
        for t in range(32):
            s = pslot[32 * g + t]
            if s < 0:
                continue
            p = later[s].copy()
            for u in range(t):
                if (int(coef[s]) >> u) & 1:
                    p ^= rec[32 * g + u, g + 1 : kw]
            rec[32 * g + t, g + 1 : kw] = p
        # every row XORs in the pivots its coefficient word names
        rec_t = u32_to_torch(np.ascontiguousarray(rec[32 * g : 32 * g + 32, g + 1 : kw]), dev)
        for t in range(32):
            on = ((c >> t) & 1) == 1
            w[g + 1 :] ^= torch.where(on[None, :], rec_t[t][:, None], 0).to(I32)
    prow = torch.full((K,), -1, dtype=I32, device=dev)
    for jj, s in enumerate(pslot):
        if s >= 0:
            prow[jj] = idx[s]
    used_o = used.clone()
    used_o[0, idx[~live]] = 1
    header = [int(free and not whole and sub_end < rows), sub_end, n]
    scratch = torch.cat([u32_to_torch(rec.reshape(-1), dev), prow,
                         torch.tensor(header, dtype=I32, device=dev)])
    return prow, used_o, cT, scratch


def scan_subset_test_plain(bT: torch.Tensor, used: torch.Tensor, scratch: torch.Tensor,
                           w0: int, K: int, cols: int) -> bool:
    """The miss test of the subset-first scan, plain torch: where the header
    is flagged, every unused row from sub_end on is reduced by the record's
    pivots column by column; True where such a row has the bit of a valid
    column that the subset left free (its pivot would be that row)."""
    kw, rows = bT.shape
    flag, sub_end = (int(v) for v in scratch[9 * K : 9 * K + 2])
    if not flag:
        return False
    rec = scratch[: 8 * K].view(K, 8)[:, :kw]
    taken = (scratch[8 * K : 9 * K] >= 0).tolist()
    above = used[0] == 0
    above[:sub_end] = False
    w = bT[:, above].clone()
    lo, hi = _valid_steps(w0, K, cols)
    for jj in range(lo, hi):
        sw, sh = jj >> 5, jj & 31
        has = ((w[sw] >> sh) & 1) == 1
        if not taken[jj]:
            if bool(has.any()):
                return True
            continue
        w[sw:] ^= torch.where(has[None, :], rec[jj, sw:][:, None], 0).to(I32)
    return False


def scan_subset_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                      chunk_rows: int | None = None, S: int = SCAN_SUBSET_ROWS):
    """Plain twin of :func:`scan_subset`: the subset kernel
    (:func:`scan_subset_steps_plain`), the miss test
    (:func:`scan_subset_test_plain`) and, on a miss, the full scan from the
    same inputs (:func:`scan_plain`, or :func:`scan_chunked_plain` on chunks
    of ``chunk_rows``).  Returns (prow, used', cT, decided): ``decided``
    True where the subset decided the panel; prow, used' and cT at the pivot
    rows are :func:`scan_plain`'s."""
    prow, used_o, cT, scratch = scan_subset_steps_plain(bT, used, w0, K, cols, S)
    if not scan_subset_test_plain(bT, used, scratch, w0, K, cols):
        return prow, used_o, cT, True
    if chunk_rows is None:
        return (*scan_plain(bT, used, w0, K, cols), False)
    return (*scan_chunked_plain(bT, used, w0, K, cols, chunk_rows), False)


def launch_scan_subset(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                       decided: torch.Tensor):
    """One ``gf2_scan_subset`` call on CUDA tensors: the subset kernel on
    ``SCAN_SUBSET_ROWS`` rows, the miss test, and the fallback
    :func:`scan_route` picks (the cluster scan, or the chained scan past the
    largest cluster's rows) gated on ``decided`` (1,) int32, which ends 1
    where the subset decided the panel and 0 where the fallback ran.  No launch waits on the host.
    Returns (prow, used', cT, scratch); raises where the fallback's geometry
    fits no kernel."""
    _check_k(bT, K)
    kw, rows = bT.shape
    dev = bT.device
    _cuda.require(bT, "bT", (kw, rows), dev)
    _cuda.require(used, "used", (1, rows), dev)
    _cuda.require(decided, "decided", (1,), dev)
    route = scan_route(rows, kw)
    chained = route.kernel == "scan_chunked"
    prow = torch.empty((K,), dtype=I32, device=dev)
    used_o = torch.empty_like(used)
    cT = torch.empty_like(bT)
    scratch = torch.empty((subset_scratch_words(K),), dtype=I32, device=dev)
    fallback = ((route.chunk_rows, route.nblocks, route.nblocks_last) if chained
                else (0, route.nblocks, route.nblocks))
    rc = _cuda.lib().gf2_scan_subset(
        bT.data_ptr(), used.data_ptr(), prow.data_ptr(), used_o.data_ptr(), cT.data_ptr(),
        scratch.data_ptr(), decided.data_ptr(), rows, kw, int(w0), int(cols),
        *fallback, _cuda.stream_of(bT),
    )
    _cuda.check(rc, "scan_subset kernel")
    _cuda.LAUNCHES["scan_subset"] += 1
    _cuda.LAUNCHES["scan_subset_test"] += 1
    _cuda.LAUNCHES[route.kernel] += route.chunks if chained else 1
    return prow, used_o, cT, scratch


def subset_decides(prow: torch.Tensor, used: torch.Tensor, S: int = SCAN_SUBSET_ROWS) -> bool:
    """Whether the subset-first scan decides a panel, from the full scan's
    ``prow`` and the panel's ``used``: every pivot lies among the first
    ``S`` unused rows.  The subset misses exactly where the full scan elects
    a row above it (up to the first such column both scans take the same
    pivots), so this is :func:`scan_subset_test_plain`'s verdict negated."""
    unused = torch.nonzero(used[0] == 0)[:, 0]
    return unused.shape[0] <= S or bool((prow < unused[S]).all())


def scan_subset(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                decided: torch.Tensor):
    """The subset-first scan of one panel: the 1-pivot scan on the first
    ``SCAN_SUBSET_ROWS`` unused rows, exact wherever it decides the panel,
    with a test of the rows above the subset and the full scan where the
    subset missed a pivot (csrc/scan_subset.cu).  ``decided`` (1,) int32 is
    set to 1 where the subset decided, 0 where the full scan ran.  Outputs
    as :func:`scan`: prow, used' and cT at the pivot rows are bit for bit
    the full scan's, and cT at the other rows is left unspecified (the
    solver reads it only at the pivot rows).  On the card every choice is
    made on the device.  On the CPU the full scan runs
    (:func:`scan_plain`) and :func:`subset_decides` sets ``decided``; the
    kernels' own order is :func:`scan_subset_plain`, the tests' reference."""
    _check_k(bT, K)
    if not _cuda.on_cuda(bT):
        prow, used_o, cT = scan_plain(bT, used, w0, K, cols)
        decided.fill_(int(subset_decides(prow, used)))
        return prow, used_o, cT
    return launch_scan_subset(bT, used, w0, K, cols, decided)[:3]


# -- kernel 6: two pivots per step --------------------------------------------------


def scan2_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int):
    """Plain twin of :func:`scan2`, step for step: columns jj and jj+1 in
    one step.  Column jj+1's candidates see pivot jj's elimination
    virtually (pivot jj's bit jj+1), pivot jj+1's row is corrected by pivot
    jj where pivot jj eliminates it, and one update applies both."""
    kw, rows = bT.shape
    dev = bT.device
    b = bT.clone()
    u = used[0].clone()
    c = torch.zeros_like(bT)
    prow = torch.full((K,), -1, dtype=I32, device=dev)
    lane = torch.arange(rows, dtype=I32, device=dev)

    def elect(cand):
        piv = torch.where(cand, lane, rows).amin()
        has = piv < rows
        return piv, has, torch.where(has, piv, 0).long()

    for jj0 in range(0, K, 2):
        sw, sh0 = jj0 >> 5, jj0 & 31
        g0 = 32 * w0 + jj0
        valid0, valid1 = 1 <= g0 <= cols, 1 <= g0 + 1 <= cols
        cur = b[sw]
        free = u == 0
        cand0 = (((cur >> sh0) & 1) == 1) & free & valid0
        piv0, has0, p0 = elect(cand0)
        bp0 = b[sw:, p0]
        elim0 = cand0 & (lane != piv0)
        p0b1 = (bp0[0] >> (sh0 + 1)) & 1
        col1 = ((cur >> (sh0 + 1)) & 1) ^ torch.where(elim0, p0b1, 0)
        cand1 = (col1 == 1) & free & valid1 & ~((lane == piv0) & has0)
        piv1, has1, p1 = elect(cand1)
        bp1 = b[sw:, p1] ^ torch.where(elim0[p1], bp0, 0)
        elim1 = cand1 & (lane != piv1)
        prow[jj0] = torch.where(has0, piv0, -1)
        prow[jj0 + 1] = torch.where(has1, piv1, -1)
        b[sw:] ^= (torch.where(elim0[None, :], bp0[:, None], 0)
                   ^ torch.where(elim1[None, :], bp1[:, None], 0))
        c[sw] ^= (torch.where(elim0, _bitval(sh0), 0)
                  ^ torch.where(elim1, _bitval(sh0 + 1), 0)).to(I32)
        u = torch.where(((lane == piv0) & has0) | ((lane == piv1) & has1), 1, u).to(I32)
    return prow, u[None, :], c


def _scan2_pair_step(b, u, c, jj0: int, valid0: bool, valid1: bool, nblocks: int):
    """One pair step of the two-pivot cluster kernel on (kw, n) words ``b``,
    used flags ``u`` (n,) and coefficients ``c``, updated in place, with the
    columns' validity as the kernel's election sees it: each of ``nblocks``
    blocks (``ceil(n / nblocks)`` contiguous rows) elects, from the same
    state, m0 (its lowest column-0 candidate), P0 and P1: its lowest row of
    ``cand1_h = valid1 & free & (bit1 ^ (cand0 & h))`` for h = 0 and 1.  That
    formula needs pivot 0 only through its own bit jj0 + 1 (h), and excludes
    pivot 0 itself (h ^ h = 0), so no block needs to know pivot 0 before it
    elects.  The fold over the slots: pivot 0 is the first block's m0, h its
    bit jj0 + 1, pivot 1 the first block's P_h.  Returns the pivots (n when
    none) and their words from word jj0 // 32 on as they stand at their steps
    (pivot 1's corrected by pivot 0), and the new used flags."""
    kw, n = b.shape
    rpb = -(-n // nblocks)
    pad = nblocks * rpb - n
    lane = torch.arange(n, dtype=I32, device=b.device)

    def block_minima(cand):  # (nblocks,): each block's lowest row of cand, n if none
        rws = torch.nn.functional.pad(torch.where(cand, lane, n), (0, pad), value=n)
        return rws.reshape(nblocks, rpb).amin(dim=1)

    sw, sh0 = jj0 >> 5, jj0 & 31
    cur = b[sw]
    free = u == 0
    cand0 = (((cur >> sh0) & 1) == 1) & free & valid0
    bit1 = (((cur >> (sh0 + 1)) & 1) == 1) & free & valid1
    # the slots: each block's m0, P0, P1; the first block with a row wins
    m0, p0, p1 = (block_minima(x) for x in (cand0, bit1, bit1 ^ (cand0 & valid1)))
    piv0 = m0.amin()
    has0 = piv0 < n
    bp0 = b[sw:, torch.where(has0, piv0, 0).long()]
    h = has0 & (((bp0[0] >> (sh0 + 1)) & 1) == 1)
    piv1 = torch.where(h, p1, p0).amin()
    has1 = piv1 < n
    p1s = torch.where(has1, piv1, 0).long()
    elim0 = cand0 & (lane != piv0)
    cand1 = bit1 ^ (cand0 & h & valid1)
    bp1 = b[sw:, p1s] ^ torch.where(elim0[p1s], bp0, 0)
    elim1 = cand1 & (lane != piv1)
    b[sw:] ^= (torch.where(elim0[None, :], bp0[:, None], 0)
               ^ torch.where(elim1[None, :], bp1[:, None], 0))
    c[sw] ^= (torch.where(elim0, _bitval(sh0), 0)
              ^ torch.where(elim1, _bitval(sh0 + 1), 0)).to(I32)
    u = torch.where(((lane == piv0) & has0) | ((lane == piv1) & has1), 1, u).to(I32)
    return piv0, piv1, bp0, bp1, u


def scan2_cluster_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                        nblocks: int):
    """:func:`scan2_plain` in the order of the cluster kernel on ``nblocks``
    blocks (``ceil(rows / nblocks)`` contiguous rows a block), a pair at a
    time as :func:`_scan2_pair_step` elects it.  Same arguments and outputs as
    :func:`scan2_plain`, bit for bit."""
    kw, rows = bT.shape
    if nblocks not in SCAN_CLUSTER_SIZES:
        raise ValueError(f"no cluster of {nblocks} blocks")
    b = bT.clone()
    u = used[0].clone()
    c = torch.zeros_like(bT)
    prow = torch.full((K,), -1, dtype=I32, device=bT.device)
    for jj0 in range(0, K, 2):
        g0 = 32 * w0 + jj0
        piv0, piv1, _, _, u = _scan2_pair_step(b, u, c, jj0, 1 <= g0 <= cols,
                                               1 <= g0 + 1 <= cols, nblocks)
        prow[jj0] = torch.where(piv0 < rows, piv0, -1)
        prow[jj0 + 1] = torch.where(piv1 < rows, piv1, -1)
    return prow, u[None, :], c


def scan2_chunked_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                        chunk_rows: int):
    """Plain twin of :func:`scan2_chunked` in the chain's order: the chunks
    of ``chunk_rows`` rows in turn, each alone but for a record of the
    columns the chunks before it took (the pivot's global row and its words
    as they stood at its step), each on the cluster its route gives.  A pair
    (jj0, jj0 + 1) of a chunk is one of four cases: both taken (both recorded
    pivots swept in order into the candidates); jj0 taken (its pivot swept,
    then the pair's election with column jj0 empty); jj0 + 1 taken (the
    election with column jj0 + 1 empty, then its pivot swept); neither (the
    pair's election, :func:`_scan2_pair_step`).  An elected pivot is the
    global one and is recorded, pivot 1 with its words after pivot 0's
    correction.  Outputs as :func:`scan2_plain`, bit for bit."""
    kw, rows = bT.shape
    dev = bT.device
    route = scan_chunked_route(rows, kw, chunk_rows, kernel="scan2_chunked")
    prow = torch.full((K,), -1, dtype=I32, device=dev)
    rec_words = torch.zeros((K, kw), dtype=I32, device=dev)
    u_out = torch.empty_like(used)
    c_out = torch.empty_like(bT)
    for base in range(0, rows, chunk_rows):
        b = bT[:, base : base + chunk_rows].clone()
        u = used[0, base : base + chunk_rows].clone()
        c = torch.zeros_like(b)
        n = b.shape[1]
        nblocks = route.nblocks if base + chunk_rows < rows else route.nblocks_last
        taken = (prow >= 0).tolist()  # the record as this chunk loads it

        def sweep(jj):  # a taken column: its recorded pivot into every candidate
            sw, sh = jj >> 5, jj & 31
            cand = (((b[sw] >> sh) & 1) == 1) & (u == 0)
            b[sw:] ^= torch.where(cand[None, :], rec_words[jj, sw:, None], 0)
            c[sw] ^= torch.where(cand, _bitval(sh), 0).to(I32)

        for jj0 in range(0, K, 2):
            g0 = 32 * w0 + jj0
            valid = (1 <= g0 <= cols, 1 <= g0 + 1 <= cols)
            took = (valid[0] and taken[jj0], valid[1] and taken[jj0 + 1])
            if took[0]:
                sweep(jj0)
            elect = (valid[0] and not took[0], valid[1] and not took[1])
            if any(elect):
                piv0, piv1, bp0, bp1, u = _scan2_pair_step(b, u, c, jj0, *elect, nblocks)
                sw = jj0 >> 5
                for jj, piv, bp in ((jj0, piv0, bp0), (jj0 + 1, piv1, bp1)):
                    if piv < n:
                        prow[jj] = base + piv
                        rec_words[jj, sw:] = bp
            if took[1]:
                sweep(jj0 + 1)
        u_out[0, base : base + n] = u
        c_out[:, base : base + n] = c
    return prow, u_out, c_out


def scan2_route(rows: int, kw: int) -> ScanRoute | ChunkedScanRoute:
    """Which kernel runs the two-pivot scan of a (kw, rows) slice, and on how
    many blocks: the 1-pivot scan's cluster size (:func:`scan_route`) with the
    two-pivot election's header; wherever the 1-pivot scan chains, or the
    pair's header alone makes the cluster's slice not fit, the chained
    two-pivot scan ``scan2_chunked`` on the chain's equal chunks.  A pure
    function of the shape."""
    route = scan_route(rows, kw)
    rpb = route.rows_per_block
    if route.kernel != "scan" or not scan_fits(rpb, kw, pairs=True):
        return scan_chunked_route(rows, kw, kernel="scan2_chunked")
    return ScanRoute("scan2", route.nblocks, rpb, scan_smem_bytes(rpb, kw, pairs=True))


def _check_k2(bT: torch.Tensor, K: int) -> None:
    _check_k(bT, K)
    if K % 2:
        raise ValueError(f"K={K} must be even")


def scan2_chunked(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                  chunk_rows: int | None = None):
    """The two-pivot scan as a chain of two-pivot cluster scans over row
    chunks: the kernel for slices taller than the largest cluster holds
    (:func:`scan2_route`), any slice with ``chunk_rows`` given (by default
    the chain's equal chunks).  Raises when a chunk fits no cluster or the
    card cannot place one.  Outputs as :func:`scan`."""
    _check_k2(bT, K)
    route = scan_chunked_route(bT.shape[1], bT.shape[0], chunk_rows, kernel="scan2_chunked")
    if not _cuda.on_cuda(bT):
        return scan2_chunked_plain(bT, used, w0, K, cols, route.chunk_rows)
    prow, used_o, cT = launch_chunked("gf2_scan2_chunked", "scan2_chunked", bT[None], used, w0,
                                      K, cols, route, batched=False)
    return prow[0], used_o, cT[0]


def scan2_cluster(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                  nblocks: int):
    """The two-pivot scan on a cluster of ``nblocks`` blocks whatever
    :func:`scan2_route` would pick (:func:`scan2` asks the route); raises when
    the state does not fit the blocks or the card cannot place the cluster.
    Outputs as :func:`scan`."""
    _check_k2(bT, K)
    if not _cuda.on_cuda(bT):
        return scan2_cluster_plain(bT, used, w0, K, cols, nblocks)
    return _launch_scan("gf2_scan2", "scan2", bT, used, w0, K, cols, nblocks)


def scan2(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int):
    """The scan with two pivots per sequential step; outputs as :func:`scan`.
    On the card the cluster kernel or, past the largest cluster's rows,
    :func:`scan2_chunked` (:func:`scan2_route`)."""
    _check_k2(bT, K)
    if not _cuda.on_cuda(bT):
        return scan2_plain(bT, used, w0, K, cols)
    route = scan2_route(bT.shape[1], bT.shape[0])
    if route.kernel == "scan2_chunked":
        return scan2_chunked(bT, used, w0, K, cols, route.chunk_rows)
    return scan2_cluster(bT, used, w0, K, cols, route.nblocks)


# -- kernel 7: min-key election + extraction ----------------------------------------


def _check_minkey_rows(rows: int) -> None:
    if rows >= MINKEY_MAX_ROWS:
        raise ValueError(f"the min-key scan takes fewer than {MINKEY_MAX_ROWS} rows, got {rows}")


def scan_minkey_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int):
    """Plain twin of :func:`scan_minkey`, step for step: per live slice word
    a lo and a hi key ``row << 16 | 16-bit half`` on every candidate row (the
    sentinel ``rows << 16`` elsewhere); the minima elect the lowest
    candidate, and their low halves are its words."""
    kw, rows = bT.shape
    _check_minkey_rows(rows)
    dev = bT.device
    b = bT.clone()
    u = used[0].clone()
    c = torch.zeros_like(bT)
    prow = torch.full((K,), -1, dtype=I32, device=dev)
    lane = torch.arange(rows, dtype=I32, device=dev)
    none = rows << 16
    for jj in range(K):
        if not 1 <= 32 * w0 + jj <= cols:
            continue
        sw, sh = jj >> 5, jj & 31
        cand = (((b[sw] >> sh) & 1) == 1) & (u == 0)
        live = b[sw:]
        key_lo = torch.where(cand, (lane << 16) | (live & 0xFFFF), none)
        key_hi = torch.where(cand, (lane << 16) | srl(live, 16), none)
        min_lo, min_hi = key_lo.amin(dim=1), key_hi.amin(dim=1)
        piv = min_lo[0] >> 16
        has = piv < rows
        prow[jj] = torch.where(has, piv, -1)
        bpiv = ((min_hi & 0xFFFF) << 16) | (min_lo & 0xFFFF)
        elim = cand & (lane != piv)
        b[sw:] ^= torch.where(elim[None, :], bpiv[:, None], 0)
        c[sw] ^= torch.where(elim, _bitval(sh), 0).to(I32)
        u = torch.where((lane == piv) & has, 1, u).to(I32)
    return prow, u[None, :], c


def scan_minkey_cluster_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int,
                              cols: int, nblocks: int):
    """:func:`scan_minkey_plain` in the order of the cluster kernel on
    ``nblocks`` blocks: at each step every block takes the least key of each
    live half over its own contiguous rows (``ceil(rows / nblocks)`` a
    block), and the least over the ``nblocks`` slots elects the pivot and
    carries its words.  Same arguments and outputs, bit for bit."""
    kw, rows = bT.shape
    _check_minkey_rows(rows)
    if nblocks not in SCAN_CLUSTER_SIZES:
        raise ValueError(f"no cluster of {nblocks} blocks")
    dev = bT.device
    rpb = -(-rows // nblocks)
    pad = nblocks * rpb - rows
    b = bT.clone()
    u = used[0].clone()
    c = torch.zeros_like(bT)
    prow = torch.full((K,), -1, dtype=I32, device=dev)
    lane = torch.arange(rows, dtype=I32, device=dev)
    none = rows << 16
    for jj in range(K):
        if not 1 <= 32 * w0 + jj <= cols:
            continue
        sw, sh = jj >> 5, jj & 31
        cand = (((b[sw] >> sh) & 1) == 1) & (u == 0)
        live = b[sw:]
        keys = torch.stack([(lane << 16) | (live & 0xFFFF), (lane << 16) | srl(live, 16)], 1)
        keys = torch.where(cand, keys, none)  # (kw - sw, 2, rows)
        keys = torch.nn.functional.pad(keys, (0, pad), value=none)
        slots = keys.reshape(kw - sw, 2, nblocks, rpb).amin(dim=3)  # each block's minima
        lo, hi = slots.amin(dim=2).unbind(1)  # the least over the slots
        piv = lo[0] >> 16
        has = piv < rows
        prow[jj] = torch.where(has, piv, -1)
        bpiv = ((hi & 0xFFFF) << 16) | (lo & 0xFFFF)
        elim = cand & (lane != piv)
        b[sw:] ^= torch.where(elim[None, :], bpiv[:, None], 0)
        c[sw] ^= torch.where(elim, _bitval(sh), 0).to(I32)
        u = torch.where((lane == piv) & has, 1, u).to(I32)
    return prow, u[None, :], c


def scan_minkey_route(rows: int, kw: int) -> ScanRoute:
    """The cluster on which the min-key scan runs a (kw, rows) slice: the
    1-pivot scan's cluster size (:func:`scan_route`), with the min-key
    election's larger header.  Every slice it takes (fewer than
    ``MINKEY_MAX_ROWS`` rows) fits a cluster."""
    _check_minkey_rows(rows)
    route = scan_route(rows, kw)
    rpb = route.rows_per_block
    return ScanRoute("scan_minkey", route.nblocks, rpb, scan_smem_bytes(rpb, kw, minkey=True))


def scan_minkey_cluster(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                        nblocks: int):
    """The min-key scan on a cluster of ``nblocks`` blocks whatever
    :func:`scan_minkey_route` would pick; raises when the state does not fit
    the blocks or the card cannot place the cluster.  Outputs as
    :func:`scan`."""
    _check_k(bT, K)
    _check_minkey_rows(bT.shape[1])
    if not _cuda.on_cuda(bT):
        return scan_minkey_cluster_plain(bT, used, w0, K, cols, nblocks)
    return _launch_scan("gf2_scan_minkey", "scan_minkey", bT, used, w0, K, cols, nblocks)


def scan_minkey(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int):
    """The scan with election and pivot-word extraction in one reduction
    round; outputs as :func:`scan`.  Needs fewer than ``MINKEY_MAX_ROWS``
    rows (:func:`scan` with ``variant="m"`` routes taller systems to the
    1-pivot scan).  On the card a cluster kernel
    (:func:`scan_minkey_route`)."""
    _check_k(bT, K)
    _check_minkey_rows(bT.shape[1])
    if not _cuda.on_cuda(bT):
        return scan_minkey_plain(bT, used, w0, K, cols)
    route = scan_minkey_route(bT.shape[1], bT.shape[0])
    return scan_minkey_cluster(bT, used, w0, K, cols, route.nblocks)


# -- kernel 2: pivot-row rebuild + back pass -------------------------------------


def _row_ints(t: torch.Tensor) -> list[int]:
    """The rows of a packed int32 matrix as Python ints (bit j = column j)."""
    return [int.from_bytes(r.tobytes(), "little") for r in torch_to_u32(t)]


def _ints_to_words(vals: list[int], kw: int, device) -> torch.Tensor:
    """Python ints of 32*kw bits as a packed (len, kw) int32 tensor."""
    words = np.frombuffer(
        b"".join(v.to_bytes(4 * kw, "little") for v in vals), dtype="<u4"
    ).reshape(len(vals), kw)
    return u32_to_torch(words, device)


def reconstruct_coeff_plain(sl: torch.Tensor, coeff: torch.Tensor,
                            prow: torch.Tensor) -> torch.Tensor:
    """The coefficient solve of the rebuild, step by step.  sl (K, kw) is the
    panel's slice of the gathered pivot rows, coeff (K, kw), prow (K,).
    Returns tbits (K, kw): the K x K bit matrix T with ``pf = T.arows``.

    Both passes are GF(2) row operations, so they run on Python-int rows of
    ``[T | slice]`` (K bits each: the combination of arows rows, and the
    pivot-column slice that decides the back pass)."""
    K, kw = sl.shape
    has = (prow >= 0).tolist()
    cf, sl_i = _row_ints(coeff), _row_ints(sl)
    T, S = [0] * K, [0] * K
    for j in range(K):  # forward: row j from the final rows t < j
        if not has[j]:
            continue
        tj, sj = 1 << j, sl_i[j]
        c = cf[j] & ((1 << j) - 1)
        while c:
            low = c & -c
            t = low.bit_length() - 1
            tj ^= T[t]
            sj ^= S[t]
            c ^= low
        T[j], S[j] = tj, sj
    for j in range(K - 1, -1, -1):  # back pass, triangular window
        if not has[j]:
            continue
        for k in range(32 * ((j >> 5) + 1)):
            if k != j and (S[k] >> j) & 1:
                T[k] ^= T[j]
                S[k] ^= S[j]
    return _ints_to_words(T, kw, sl.device)


def reconstruct_coeff_blocked_plain(sl: torch.Tensor, coeff: torch.Tensor,
                                    prow: torch.Tensor) -> torch.Tensor:
    """The coefficient solve in the order the CUDA kernel
    (``csrc/reconstruct.cu``) takes it, group of 32 rows by group: same
    arguments and result as :func:`reconstruct_coeff_plain`, bit for bit.
    The tests hold the kernel's control flow through it; no solve runs it.

    Forward, group g ascending, steps t = 0..31: row ``32 g + t`` is final and
    is pushed, in the same step, into the later rows of the group (the
    diagonal part) and into every row of the later groups (the panel part)
    whose bit t of the ONE coefficient word ``coeff[k][g]`` is set.  A row
    without a pivot is never pushed, and is zeroed only when its group is
    done: nothing reads it before.

    Back, group g descending, steps j = 31..0: row ``32 g + j`` AS IT IS AT
    STEP j (the snapshot: a later step of the same group may change it again,
    since the window covers the whole group) is taken by every other row of
    this and the lower groups whose bit j is set at that moment.  The
    decisions need only the row's word g of the slice, which a row carries
    as ``d`` beside its ``[T | slice]`` words and updates with the
    snapshot's own ``d``, as the kernel's threads do: the word is read from
    the row once per group, not once per step."""
    K, kw = sl.shape
    mask32 = 0xFFFFFFFF
    has = (prow >= 0).tolist()
    cf, sl_i = _row_ints(coeff), _row_ints(sl)
    # a row is one int: T in bits [0, K), the slice in bits [K, 2K)
    row = [(1 << k) | (sl_i[k] << K) for k in range(K)]
    for g in range(kw):  # forward
        base = 32 * g
        pivots = sum(1 << t for t in range(32) if has[base + t])
        takes = {k: (cf[k] >> base) & pivots for k in range(base, K)}
        for k in range(base, base + 32):  # the group's own rows: only steps before them
            takes[k] &= (1 << (k - base)) - 1
        for t in range(32):
            final = row[base + t]
            for k in range(base, K):
                if (takes[k] >> t) & 1:
                    row[k] ^= final
        for t in range(32):
            if not has[base + t]:
                row[base + t] = 0
    for g in range(kw - 1, -1, -1):  # back
        base = 32 * g
        shift = K + base  # word g of the slice
        pivots = sum(1 << j for j in range(32) if has[base + j])
        d = [(row[k] >> shift) & mask32 for k in range(base + 32)]
        for j in range(31, -1, -1):
            snap, dsnap = row[base + j], d[base + j]
            for k in range(base + 32):
                if k != base + j and ((d[k] & pivots) >> j) & 1:
                    row[k] ^= snap
                    d[k] ^= dsnap
        for k in range(base + 32):  # the carried word is the row's own
            assert d[k] == (row[k] >> shift) & mask32
    return _ints_to_words([r & ((1 << K) - 1) for r in row], kw, sl.device)


def reconstruct_plain(arows: torch.Tensor, coeff: torch.Tensor, prow: torch.Tensor,
                      w0: int) -> torch.Tensor:
    """Plain twin of the reconstruct kernel.  arows (K, wp), coeff (K, kw),
    prow (K,).  Returns pf (K, wp): the coefficient solve
    (:func:`reconstruct_coeff_plain`) on the panel's slice, then the rank-K
    product ``pf = T.arows``."""
    kw = arows.shape[0] // 32
    tbits = reconstruct_coeff_plain(arows[:, w0 : w0 + kw], coeff, prow)
    pf = torch.zeros_like(arows)
    rank_k_xor_(pf, tbits, arows)
    return pf


def reconstruct_coeff(arows: torch.Tensor, coeff: torch.Tensor, prow: torch.Tensor,
                      w0: int) -> torch.Tensor:
    """The first launch of :func:`reconstruct` alone: the coefficient solve
    on the slice ``arows[..., w0 : w0 + kw]`` by the blocked warp-level
    kernel, one block per system.  arows (K, wp) or (B, K, wp); returns tbits
    (K, kw) or (B, K, kw).  No solve calls it: it is there to time and check
    the coefficient solve apart from the product."""
    if arows.dim() not in (2, 3):
        raise ValueError(f"arows: shape {tuple(arows.shape)}, expected (K, wp) or (B, K, wp)")
    lead, (K, wp) = arows.shape[:-2], arows.shape[-2:]
    kw = K // 32
    if not _cuda.on_cuda(arows):
        flat = [reconstruct_coeff_plain(a[:, w0 : w0 + kw], c, p)
                for a, c, p in zip(arows.reshape(-1, K, wp), coeff.reshape(-1, K, kw),
                                   prow.reshape(-1, K))]
        return torch.stack(flat).reshape(*lead, K, kw)
    dev = arows.device
    _cuda.require(arows, "arows", (*lead, K, wp), dev)
    _cuda.require(coeff, "coeff", (*lead, K, kw), dev)
    _cuda.require(prow, "prow", (*lead, K), dev)
    if not 0 <= w0 <= wp - kw:
        raise ValueError(f"w0={w0} outside the {wp}-word rows")
    tbits = torch.empty((*lead, K, kw), dtype=I32, device=dev)
    rc = _cuda.lib().gf2_reconstruct_coeff(
        arows.data_ptr(), coeff.data_ptr(), prow.data_ptr(), tbits.data_ptr(),
        lead[0] if lead else 1, wp, kw, int(w0), _cuda.stream_of(arows),
    )
    _cuda.check(rc, "reconstruct_coeff kernel")
    _cuda.LAUNCHES["reconstruct_coeff"] += 1
    return tbits


def reconstruct(arows: torch.Tensor, coeff: torch.Tensor, prow: torch.Tensor,
                w0: int) -> torch.Tensor:
    """Rebuild the panel's forward pivot rows at full width
    (``pf[j] = arows[j] ^ XOR{pf[t] : t < j, coeff bit t}``, zero without a
    pivot), then back-eliminate them into the panel's intra-panel RREF rows:
    for j descending with a pivot, ``pf[k] ^= pf[j]`` for each k != j below
    ``32*(j//32 + 1)`` whose bit j is set.  The bound is the reference
    kernel's triangular window; in the solver rows above it never have bit
    j set, and on arbitrary inputs it keeps the two bit for bit equal."""
    K, wp = arows.shape
    kw = K // 32
    if not _cuda.on_cuda(arows):
        return reconstruct_plain(arows, coeff, prow, w0)
    dev = arows.device
    _cuda.require(arows, "arows", (K, wp), dev)
    _cuda.require(coeff, "coeff", (K, kw), dev)
    _cuda.require(prow, "prow", (K,), dev)
    if not 0 <= w0 <= wp - kw:
        raise ValueError(f"w0={w0} outside the {wp}-word rows")
    tbits = torch.empty((K, kw), dtype=I32, device=dev)
    pf = torch.empty_like(arows)
    rc = _cuda.lib().gf2_reconstruct(
        arows.data_ptr(), coeff.data_ptr(), prow.data_ptr(), tbits.data_ptr(),
        pf.data_ptr(), wp, kw, int(w0), _cuda.stream_of(arows),
    )
    _cuda.check(rc, "reconstruct kernel")
    _cuda.LAUNCHES["reconstruct"] += 1
    return pf


# -- kernel 5: the fused phase 1 (pallas_phase1.phase1_panel) ----------------------


def phase1_panel_plain(a: torch.Tensor, bT: torch.Tensor, used: torch.Tensor,
                       w0: int, K: int, cols: int):
    """Plain twin of :func:`phase1_panel`, step for step: each scan step
    that finds a pivot rebuilds panel row jj, held as ``[T | slice]`` (the
    combination of pivot rows it is made of, and its words w0..w0+kw-1),
    from ``[e_jj | a[piv] slice]`` and the earlier rows selected by the
    pivot's coefficients; then the triangular back pass on those rows, then
    ``pf = T·a[prow]``."""
    rows, wp = a.shape
    kw = K // 32
    dev = a.device
    b = bT.clone()
    u = used[0].clone()
    c = torch.zeros_like(bT)
    prow = torch.full((K,), -1, dtype=I32, device=dev)
    lane = torch.arange(rows, dtype=I32, device=dev)
    k_ids = torch.arange(K, device=dev)
    k_bits = (k_ids & 31).to(I32)
    eye = torch.zeros((K, kw), dtype=I32, device=dev)
    eye[k_ids, k_ids >> 5] = bit_i32(k_bits)
    ts = torch.zeros((K, 2 * kw), dtype=I32, device=dev)  # rows as [T | slice]
    for jj in range(K):
        if not 1 <= 32 * w0 + jj <= cols:
            continue
        sw, sh = jj >> 5, jj & 31
        cand = (((b[sw] >> sh) & 1) == 1) & (u == 0)
        piv = torch.where(cand, lane, rows).amin()
        has = piv < rows
        ps = torch.where(has, piv, 0).long()
        prow[jj] = torch.where(has, piv, -1)
        # rebuild row jj from the earlier rows its coefficient bits select
        take = (((c[k_ids >> 5, ps] >> k_bits) & 1) == 1) & (k_ids < jj)
        x = xor_fold(torch.where(take[:, None], ts, 0), dim=0)
        base = torch.cat([eye[jj], a[ps, w0 : w0 + kw]])
        ts[jj] = torch.where(has, base ^ x, 0)
        bpiv = b[sw:, ps]
        elim = cand & (lane != piv)
        b[sw:] ^= torch.where(elim[None, :], bpiv[:, None], 0)
        c[sw] ^= torch.where(elim, _bitval(sh), 0).to(I32)
        u = torch.where((lane == piv) & has, 1, u).to(I32)
    pivoted = prow >= 0
    for j in range(K - 1, -1, -1):  # back pass, triangular window
        window = k_ids < 32 * ((j >> 5) + 1)
        hit = (((ts[:, kw + (j >> 5)] >> (j & 31)) & 1) == 1) & window & (k_ids != j)
        ts ^= torch.where((hit & pivoted[j])[:, None], ts[j][None, :], 0)
    arows = torch.where(pivoted[:, None], a[prow.clamp(min=0).long()], 0)
    pf = torch.zeros((K, wp), dtype=I32, device=dev)
    rank_k_xor_(pf, ts[:, :kw].contiguous(), arows)
    return pf, prow, u[None, :]


# The fused kernels' shared memory past the scan's header (mirrors
# csrc/phase1_product.cuh): T (32 kw rows of kw words), then the larger of the
# coefficient solve's words (compiled for K = 256) and the tables of the
# product (csrc/update_table.cuh: 4 kw x 256 entries of 16 bytes, and the
# strip's 32 kw rows).
FUSED_SOLVE_SMEM_WORDS = 2816


def phase1_fused_smem_bytes(rows_per_block: int, kw: int, chained: bool = False) -> int:
    """Shared memory of one block of the fused cluster kernel (with
    ``chained``: of the chained kernel's last link): the larger of the
    scan's and the scan's header plus the product stages, which start after
    the header (with ``chained`` the election's header and the record)."""
    tables = 16 * (4 * kw * 256 + 32 * kw)
    product = 4 * 32 * kw * kw + max(4 * FUSED_SOLVE_SMEM_WORDS, tables)
    header = _SCAN_HEADER_BYTES + (_RECORD_BYTES if chained else 0)
    return max(scan_smem_bytes(rows_per_block, kw, chained=chained), header + product)


def phase1_fused_route(rows: int, kw: int) -> ScanRoute | ChunkedScanRoute:
    """Which kernel runs the fused phase 1 of a (rows, wp) matrix with a
    (kw, rows) slice: the cluster kernel on the 1-pivot scan's cluster
    (:func:`scan_route`), or past the largest cluster's rows the chained
    kernel (``phase1_fused_chunked``) on the chained scan's chunks and
    clusters, its last link's blocks asking for
    ``phase1_fused_smem_bytes(..., chained=True)``.  A pure function of the
    shape."""
    route = scan_route(rows, kw)
    if route.kernel == "scan_chunked":
        return route._replace(kernel="phase1_fused_chunked")
    rpb = route.rows_per_block
    return ScanRoute("phase1_fused", route.nblocks, rpb, phase1_fused_smem_bytes(rpb, kw))


def _check_panel(a: torch.Tensor, bT: torch.Tensor, w0: int, K: int) -> None:
    _check_k(bT, K)
    if not 0 <= w0 <= a.shape[1] - K // 32:
        raise ValueError(f"w0={w0} outside the {a.shape[1]}-word rows")


def phase1_panel_cluster(a: torch.Tensor, bT: torch.Tensor, used: torch.Tensor,
                         w0: int, K: int, cols: int, nblocks: int):
    """The fused phase 1 on a cluster of ``nblocks`` blocks whatever
    :func:`phase1_fused_route` would pick; raises when the slice does not fit
    the blocks or the card cannot place the cluster.  Outputs as
    :func:`phase1_panel`."""
    _check_panel(a, bT, w0, K)
    if not _cuda.on_cuda(a):
        return phase1_panel_plain(a, bT, used, w0, K, cols)
    rows, wp = a.shape
    kw = K // 32
    dev = a.device
    _cuda.require(a, "a", (rows, wp), dev)
    _cuda.require(bT, "bT", (kw, rows), dev)
    _cuda.require(used, "used", (1, rows), dev)
    prow = torch.empty((K,), dtype=I32, device=dev)
    used_o = torch.empty_like(used)
    cT = torch.empty_like(bT)
    pf = torch.empty((K, wp), dtype=I32, device=dev)
    rc = _cuda.lib().gf2_phase1_fused(
        a.data_ptr(), bT.data_ptr(), used.data_ptr(), prow.data_ptr(), used_o.data_ptr(),
        cT.data_ptr(), pf.data_ptr(), rows, wp, kw, int(w0), int(cols), int(nblocks),
        _cuda.stream_of(a),
    )
    _cuda.check(rc, "phase1_fused kernel")
    _cuda.LAUNCHES["phase1_fused"] += 1
    return pf, prow, used_o


def phase1_panel_chunked_plain(a: torch.Tensor, bT: torch.Tensor, used: torch.Tensor,
                               w0: int, K: int, cols: int, chunk_rows: int):
    """Plain twin of :func:`phase1_panel_chunked` in the kernel's order: the
    chained scan (:func:`scan_chunked_plain`), then the blocked coefficient
    solve (:func:`reconstruct_coeff_blocked_plain`) on the slice words of
    ``a[prow]`` and the coefficients ``cT[:, prow]`` read through prow (zero
    where prow is -1), then the product ``pf = T.a[prow]``.  Outputs as
    :func:`phase1_panel_plain`, bit for bit."""
    kw = K // 32
    prow, used_o, cT = scan_chunked_plain(bT, used, w0, K, cols, chunk_rows)
    has = (prow >= 0)[:, None]
    ps = prow.clamp(min=0).long()
    arows = torch.where(has, a[ps], 0)
    coeff = torch.where(has, cT[:, ps].T, 0).contiguous()
    tbits = reconstruct_coeff_blocked_plain(arows[:, w0 : w0 + kw].contiguous(), coeff, prow)
    pf = torch.zeros((K, a.shape[1]), dtype=I32, device=a.device)
    rank_k_xor_(pf, tbits, arows)
    return pf, prow, used_o


def phase1_panel_chunked(a: torch.Tensor, bT: torch.Tensor, used: torch.Tensor,
                         w0: int, K: int, cols: int, chunk_rows: int | None = None):
    """The fused phase 1 as a chain of cluster launches over row chunks: the
    chained scan's links, the last followed in the same launch by the
    coefficient solve and the product.  The kernel for matrices taller than
    the largest cluster holds (:func:`phase1_fused_route`), any matrix with
    ``chunk_rows`` given (by default :func:`scan_chunk_rows`).  Raises when
    a chunk fits no cluster or the card cannot place one.  Outputs as
    :func:`phase1_panel`."""
    _check_panel(a, bT, w0, K)
    route = scan_chunked_route(a.shape[0], K // 32, chunk_rows, kernel="phase1_fused_chunked")
    if not _cuda.on_cuda(a):
        return phase1_panel_chunked_plain(a, bT, used, w0, K, cols, route.chunk_rows)
    return launch_phase1_chunked(a, bT, used, w0, K, cols, route)


def launch_phase1_chunked(a: torch.Tensor, bT: torch.Tensor, used: torch.Tensor, w0: int,
                          K: int, cols: int, route: ChunkedScanRoute):
    """Launch the chained fused phase 1 on ``route``'s chunks: one C call
    that launches its ``route.chunks`` kernels in order on the stream,
    counted as that many launches; the record is scratch of 9 K words."""
    rows, wp = a.shape
    kw = K // 32
    dev = a.device
    _cuda.require(a, "a", (rows, wp), dev)
    _cuda.require(bT, "bT", (kw, rows), dev)
    _cuda.require(used, "used", (1, rows), dev)
    prow = torch.empty((K,), dtype=I32, device=dev)
    used_o = torch.empty_like(used)
    cT = torch.empty_like(bT)
    record = torch.empty((9 * K,), dtype=I32, device=dev)
    pf = torch.empty((K, wp), dtype=I32, device=dev)
    rc = _cuda.lib().gf2_phase1_fused_chunked(
        a.data_ptr(), bT.data_ptr(), used.data_ptr(), prow.data_ptr(), used_o.data_ptr(),
        cT.data_ptr(), record.data_ptr(), pf.data_ptr(), rows, wp, kw, int(w0), int(cols),
        route.chunk_rows, route.nblocks, route.nblocks_last, _cuda.stream_of(a),
    )
    _cuda.check(rc, "phase1_fused_chunked kernel")
    _cuda.LAUNCHES["phase1_fused_chunked"] += route.chunks
    return pf, prow, used_o


def phase1_panel(a: torch.Tensor, bT: torch.Tensor, used: torch.Tensor,
                 w0: int, K: int, cols: int):
    """Phase 1 of one panel in one launch: the scan of :func:`scan`, the
    rebuild of the forward pivot rows from the matrix, and the triangular
    back pass of :func:`reconstruct`.  a (rows, wp) is the matrix at the
    panel's start, bT (kw, rows) its panel slice transposed, used (1, rows).
    Returns (pf (K, wp), prow (K,), used' (1, rows)), the contract of
    :func:`phase1_panel_split`.  On the card one thread-block cluster (the
    cluster scan, then in every block the coefficient solve and its strips of
    ``pf = T.a[prow]``), or past the largest cluster's rows
    :func:`phase1_panel_chunked` (:func:`phase1_fused_route`)."""
    _check_panel(a, bT, w0, K)
    if not _cuda.on_cuda(a):
        return phase1_panel_plain(a, bT, used, w0, K, cols)
    route = phase1_fused_route(a.shape[0], K // 32)
    if route.kernel == "phase1_fused_chunked":
        return phase1_panel_chunked(a, bT, used, w0, K, cols, route.chunk_rows)
    return phase1_panel_cluster(a, bT, used, w0, K, cols, route.nblocks)


# -- the split phase 1 (pallas_phase1.phase1_panel_split) ------------------------


def phase1_panel_split(a: torch.Tensor, bT: torch.Tensor, used: torch.Tensor,
                       w0: int, K: int, cols: int, variant: str = ""):
    """Phase 1 of one panel: scan (``variant`` as :func:`scan`), gather the
    pivot rows and their coefficient words, rebuild.  a (rows, wp); bT
    (kw, rows); used (1, rows).  Returns (pf (K, wp), prow (K,), used'
    (1, rows))."""
    prow, used_o, cT = scan(bT, used, w0, K, cols, variant)
    return rebuild_pivots(a, prow, cT, w0), prow, used_o


def rebuild_pivots(a: torch.Tensor, prow: torch.Tensor, cT: torch.Tensor,
                   w0: int) -> torch.Tensor:
    """The split phase 1 after its scan: gather the pivot rows (K, wp) and
    their coefficient words (K, kw) and rebuild them (:func:`reconstruct`)."""
    prow_safe = prow.clamp(min=0).long()
    return reconstruct(a[prow_safe], cT[:, prow_safe].T.contiguous(), prow, w0)


def phase1_scan_subset(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int):
    """The forward scan alone on a row subset: bT (kw, S), used (1, S).
    Returns (prow (K,) subset-local rows, cT (kw, S))."""
    prow, _, cT = scan(bT, used, w0, K, cols)
    return prow, cT

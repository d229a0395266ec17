"""Batched panel-blocked RREF: B large systems eliminated together.

Port of ``gf2bv_tpu/ops/gauss_batched.py``.  Per K-column panel:

* :func:`scan_batched` — the forward pivot scan of all B systems in one
  launch (``_make_scan_kernel_b`` via ``_scan_batched``); CUDA source
  ``csrc/scan.cu`` (``gf2_scan_batched``: one thread-block cluster per system
  with its state in shared memory, body in ``csrc/scan_cluster.cuh``; past the
  largest cluster's rows ``gf2_scan_batched_chunked``, the chained scan of
  ``csrc/scan_chunked.cu`` with a cluster per system in each launch,
  :func:`scan_batched_chunked`), plain twin :func:`scan_batched_plain`, and
  :func:`scan_batched_chunked_plain` in the chain's order;
* gathers of each system's pivot rows and coefficient words;
* :func:`reconstruct_batched` — pivot-row rebuild + triangular back pass of
  all B systems (``_make_reconstruct_kernel_b`` via ``_reconstruct_batched``);
  CUDA source ``csrc/reconstruct.cu`` (``gf2_reconstruct_batched``), plain
  twin :func:`reconstruct_batched_plain`;
* phase 2 per system: the full-width update, or in trailing mode (mode 0)
  the trailing update with the panel start ``w0``
  (``ops/panel_update.update_trailing``).

:func:`solve_chained` is the mode-0 batch path of ``parallel/batch.py``: a
loop of the single-system ``rref_origin_blocked`` with one stacked readback;
it takes any engine of ``gauss_blocked``.  The batched solver's phase 2 goes
through ``gauss_blocked.apply_rank_k_update``, as the reference's does, so it
takes every phase-2 engine (``mxu``, ``mxu_noseg``, ``mxu_la`` all run the
full or trailing update here).  The RREF is unique, so every result is bit
for bit the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.words import I32, resolve_device, torch_to_u32, u32_to_torch
from . import _cuda, extract_device
from .gauss_blocked import (
    K_PANEL,
    _ROW_BUCKET,
    _pick_engines,
    apply_rank_k_update,
    engine,
    origin_parity_unsat,
    rref_origin_blocked,
    selector_from_prow,
)
from .phase1 import (
    launch_chunked,
    reconstruct_plain,
    scan_batched_route,
    scan_chunked_route,
    scan_chunked_steps_plain,
    scan_steps_plain,
)

# Systems per batched elimination.  The reference's VMEM_BATCH_MAX = 16 was
# the TPU's scoped-VMEM compile limit; here it bounds the device memory of a
# chunk (two copies of B padded matrices: 1.7 GB at the flagship shape); at 16
# flagship systems the batched scan's clusters of 8 blocks just fill the card.
# A TPU value kept for parity, to be re-derived on the H100.
BATCH_CHUNK_MAX = 16


# -- kernel 13: batched forward scan ---------------------------------------------


def scan_batched_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int):
    """Plain twin of :func:`scan_batched`."""
    return scan_steps_plain(bT, used, w0, K, cols)


def _check_batched(bT: torch.Tensor, K: int) -> None:
    if K != 32 * bT.shape[1]:
        raise ValueError(f"K={K} does not match bT's {bT.shape[1]} words")


def scan_batched_chunked_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int,
                               cols: int, chunk_rows: int):
    """Plain twin of :func:`scan_batched_chunked` in the chain's order
    (``phase1.scan_chunked_steps_plain``); outputs as :func:`scan_batched`."""
    return scan_chunked_steps_plain(bT, used, w0, K, cols, chunk_rows)


def scan_batched_chunked(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                         chunk_rows: int | None = None):
    """The batched scan as a chain of launches over row chunks, each of one
    cluster per system: the kernel for slices taller than the largest cluster
    holds (``phase1.scan_batched_route``), any slices with ``chunk_rows``
    given (by default ``phase1.scan_chunk_rows``).  Raises when a chunk fits
    no cluster or the card cannot place one.  Outputs as
    :func:`scan_batched`."""
    _check_batched(bT, K)
    nb, kw, rows = bT.shape
    route = scan_chunked_route(rows, kw, chunk_rows, nb, "scan_batched_chunked")
    if not _cuda.on_cuda(bT):
        return scan_batched_chunked_plain(bT, used, w0, K, cols, route.chunk_rows)
    return launch_chunked("gf2_scan_batched_chunked", "scan_batched_chunked", bT, used, w0, K,
                          cols, route, batched=True)


def scan_batched_cluster(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int,
                         nblocks: int):
    """The batched scan on one cluster of ``nblocks`` blocks per system
    whatever the route would pick (:func:`scan_batched` asks the route); raises
    when a slice does not fit such a cluster or the card cannot place one.
    Outputs as :func:`scan_batched`."""
    _check_batched(bT, K)
    if not _cuda.on_cuda(bT):
        return scan_batched_plain(bT, used, w0, K, cols)
    nb, kw, rows = bT.shape
    dev = bT.device
    _cuda.require(bT, "bT", (nb, kw, rows), dev)
    _cuda.require(used, "used", (nb, rows), dev)
    prow = torch.empty((nb, K), dtype=I32, device=dev)
    used_o = torch.empty_like(used)
    cT = torch.empty_like(bT)
    rc = _cuda.lib().gf2_scan_batched(
        bT.data_ptr(), used.data_ptr(), prow.data_ptr(), used_o.data_ptr(), cT.data_ptr(),
        nb, rows, kw, int(w0), int(cols), int(nblocks), _cuda.stream_of(bT),
    )
    _cuda.check(rc, "scan_batched kernel")
    _cuda.LAUNCHES["scan_batched"] += 1
    return prow, used_o, cT


def scan_batched(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int):
    """The forward scan of one panel in each of B systems: bT (B, kw, rows),
    used (B, rows) int32.  Returns (prow (B, K), used' (B, rows), cT
    (B, kw, rows)); per system the contract of ``phase1.scan``.  On the card
    one launch of B clusters, or past the largest cluster's rows the chained
    scan, a launch of B clusters a chunk (``phase1.scan_batched_route``,
    decided from the shape alone)."""
    _check_batched(bT, K)
    if not _cuda.on_cuda(bT):
        return scan_batched_plain(bT, used, w0, K, cols)
    nb, kw, rows = bT.shape
    route = scan_batched_route(nb, rows, kw)
    if route.kernel == "scan_batched_chunked":
        return scan_batched_chunked(bT, used, w0, K, cols, route.chunk_rows)
    return scan_batched_cluster(bT, used, w0, K, cols, route.nblocks)


# -- kernel 14: batched pivot-row rebuild + back pass ------------------------------


def reconstruct_batched_plain(arows: torch.Tensor, coeff: torch.Tensor,
                              prow: torch.Tensor, w0: int) -> torch.Tensor:
    """Plain twin of :func:`reconstruct_batched`."""
    return torch.stack([
        reconstruct_plain(arows[b], coeff[b], prow[b], w0) for b in range(arows.shape[0])
    ])


def reconstruct_batched(arows: torch.Tensor, coeff: torch.Tensor, prow: torch.Tensor,
                        w0: int) -> torch.Tensor:
    """Rebuild and back-eliminate the pivot rows of B systems: arows
    (B, K, wp), coeff (B, K, kw), prow (B, K).  Returns pf (B, K, wp); per
    system the contract of ``phase1.reconstruct``, triangular window
    included."""
    nb, K, wp = arows.shape
    kw = K // 32
    if not _cuda.on_cuda(arows):
        return reconstruct_batched_plain(arows, coeff, prow, w0)
    dev = arows.device
    _cuda.require(arows, "arows", (nb, K, wp), dev)
    _cuda.require(coeff, "coeff", (nb, K, kw), dev)
    _cuda.require(prow, "prow", (nb, K), dev)
    if not 0 <= w0 <= wp - kw:
        raise ValueError(f"w0={w0} outside the {wp}-word rows")
    tbits = torch.empty((nb, K, kw), dtype=I32, device=dev)
    pf = torch.empty_like(arows)
    rc = _cuda.lib().gf2_reconstruct_batched(
        arows.data_ptr(), coeff.data_ptr(), prow.data_ptr(), tbits.data_ptr(),
        pf.data_ptr(), nb, wp, kw, int(w0), _cuda.stream_of(arows),
    )
    _cuda.check(rc, "batched reconstruct kernel")
    _cuda.LAUNCHES["reconstruct_batched"] += 1
    return pf


# -- the batched solver -------------------------------------------------------------


def rref_blocked_batched(a: torch.Tensor, cols: int, k_panel: int = K_PANEL,
                         trailing: bool = False, phase2: str = "mxu"):
    """Batched blocked RREF of a (B, rows, wp) int32, ``wp % (k_panel//32)
    == 0``; the input is not modified.

    Returns (rref (B, rows, wp), pof (B, cols), inconsistent (B,)), per
    system what ``gauss_blocked.rref_blocked`` returns.  Like the reference
    it runs all ``wp // kw`` panels; those past ``cols`` find no pivot.
    ``trailing=True`` (mode 0) uses the trailing update of the engine
    ``phase2``, which leaves the tiles left of the panel stale: callers
    verify the extracted origin (:func:`rref_origin_batched`)."""
    p2 = engine(phase2, "phase2")
    K = k_panel
    kw = K // 32
    nb, rows, wp = a.shape
    if wp % kw:
        raise ValueError(f"wp={wp} is not a multiple of {kw}")
    a = a.clone()
    dev = a.device
    bit_ids = torch.arange(K, dtype=I32, device=dev)
    used = torch.zeros((nb, rows), dtype=I32, device=dev)
    pof = torch.full((nb, cols + 1), -1, dtype=I32, device=dev)  # + dump slot
    for t in range(wp // kw):
        w0 = t * kw
        b_orig = a[:, :, w0 : w0 + kw].clone()  # saved before the update
        prow, used, cT = scan_batched(b_orig.transpose(1, 2).contiguous(), used, w0, K, cols)
        prow_safe = prow.clamp(min=0).long()
        arows = torch.gather(a, 1, prow_safe[:, :, None].expand(nb, K, wp))
        coeff = torch.gather(cT, 2, prow_safe[:, None, :].expand(nb, kw, K))
        pf = reconstruct_batched(arows, coeff.transpose(1, 2).contiguous(), prow, w0)
        dst = torch.where(prow >= 0, 32 * w0 + bit_ids - 1, cols).long()
        pof.scatter_(1, dst, prow)
        for b in range(nb):
            s = selector_from_prow(b_orig[b], prow[b])
            apply_rank_k_update(a[b], s, pf[b], p2, w0 if trailing else None)
    return a, pof[:, :cols], extract_device.inconsistent_device(a)


def rref_origin_batched(a: torch.Tensor, cols: int, k_panel: int = K_PANEL,
                        phase2: str = "mxu"):
    """Batched mode 0: trailing elimination, per-system origin and the
    parity check of each origin against its original system.  Returns
    (origin32 (B, Wsol32), unsat (B,))."""
    rref32, pof, _ = rref_blocked_batched(a, cols, k_panel, True, phase2)
    origins = extract_device._origin_batch(rref32, pof, cols)
    unsat = torch.stack([origin_parity_unsat(a[b], origins[b]) for b in range(a.shape[0])])
    return origins, unsat


def padded_batch_dims(rows_max: int, w64: int) -> tuple[int, int]:
    """(rows_pad, wp32): the per-system dims :func:`solve_batched` allocates;
    parallel/batch.py's memory guard uses the same arithmetic."""
    rows_pad = max(_ROW_BUCKET, -(-rows_max // _ROW_BUCKET) * _ROW_BUCKET)
    walign = max(K_PANEL // 32, 128)
    wp = -(-(2 * w64) // walign) * walign
    return rows_pad, wp


def _stack(eq_mats, device) -> torch.Tensor:
    """A list of packed (rows_i, W64) systems -> one zero-padded (B, rows,
    wp) int32 tensor on ``device``; a (B, rows, W32) array or int32 tensor
    is taken as it is."""
    if isinstance(eq_mats, torch.Tensor):
        if eq_mats.dtype != torch.int32 or eq_mats.ndim != 3:
            raise TypeError("a batch tensor must be (B, rows, W32) int32")
        resolve_device(eq_mats.device)
        return eq_mats
    if not isinstance(eq_mats, (list, tuple)):
        return u32_to_torch(np.asarray(eq_mats, np.uint32), device)
    rows_max = max(m.shape[0] for m in eq_mats)
    rows_pad, wp = padded_batch_dims(rows_max, eq_mats[0].shape[1])
    a = np.zeros((len(eq_mats), rows_pad, wp), np.uint32)
    for i, m in enumerate(eq_mats):
        a32 = packing.to_u32(m)
        a[i, : a32.shape[0], : a32.shape[1]] = a32
    return u32_to_torch(a, device)


def _origins_or_none(origins32: torch.Tensor, unsat: torch.Tensor) -> list:
    """One stacked readback -> per system the packed origin or None."""
    o = torch_to_u32(origins32)
    u = unsat.cpu().numpy()
    return [None if u[b] else packing.from_u32(o[b][None, :])[0] for b in range(o.shape[0])]


def solve_batched(eq_mats, cols: int, mode: int, phase2: str | None = None,
                  device="cuda"):
    """Batched large-system solve, per system the contract of
    ``gauss_blocked.solve_blocked``.  eq_mats: a list of packed (rows_i, W64)
    systems, or a (B, rows, W32) array or int32 tensor (a tensor is solved
    on its own device).  Runs in chunks of ``BATCH_CHUNK_MAX`` systems.
    ``phase2`` (default from ``_pick_engines``) is any phase-2 engine of
    ``gauss_blocked``."""
    a = _stack(eq_mats, resolve_device(device))
    p2 = engine(phase2 or _pick_engines(a.shape[2])[1], "phase2")
    out: list = []
    for c0 in range(0, a.shape[0], BATCH_CHUNK_MAX):
        chunk = a[c0 : c0 + BATCH_CHUNK_MAX]
        if mode == 0:
            out.extend(_origins_or_none(*rref_origin_batched(chunk, cols, phase2=p2)))
        else:
            rref32, pof, inconsistent = rref_blocked_batched(chunk, cols, phase2=p2)
            out.extend(extract_device.finalize_batch(rref32, pof, inconsistent, cols, mode))
    return out


def solve_chained(eq_mats, cols: int, phase1: str | None = None,
                  phase2: str | None = None, device="cuda"):
    """Mode-0 batch as a loop of the single-system trailing solver
    (``gauss_blocked.rref_origin_blocked``, engines from ``_pick_engines``
    where not given) with one stacked readback of the origins.  Input and
    result as :func:`solve_batched` mode 0."""
    a = _stack(eq_mats, resolve_device(device))
    auto1, auto2 = _pick_engines(a.shape[2])
    engines = dict(phase1=phase1 or auto1, phase2=phase2 or auto2)
    res = [rref_origin_blocked(a[b], cols, **engines) for b in range(a.shape[0])]
    return _origins_or_none(torch.stack([o for o, _ in res]), torch.stack([u for _, u in res]))

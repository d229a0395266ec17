"""Device-cached solving for lazily traced systems.

Port of ``gf2bv_tpu/ops/lazy_solve.py``: the packed coefficient matrix of a
traced zeros list is input-independent, so it is materialized once per
trace STRUCTURE, uploaded once and cached on the device; per solve only the
per-row affine delta crosses to the device, is XORed into a COPY of the
cached matrix (the cache survives every solve) and the solver runs.

The backend is resolved as ``solver.solve`` would (:func:`_backend_for`):
``blocked`` caches the matrix padded for the panel solver and runs it with
the engines of ``gauss_blocked._pick_engines``, resolved when the structure
is cached and kept with the entry; ``jax`` caches it padded to the
per-pivot solver's row bucket; ``native`` keeps the stacked uint64 matrix
on the host and swaps only its affine column per solve (the mode-1 basis,
affine-independent, is built once per entry).  ``oracle`` is not eligible.

Reference semantics kept: all-zero traced rows are dropped, and a dropped
row whose affine bit is set (the literal 1) makes the system unsatisfiable
before any device work.  ``GF2BV_TPU_PHASE1`` / ``GF2BV_TPU_PHASE2``, the
device and the resolved backend are part of the cache key, as in the
reference, so a change of either reaches the next solve at once (as a new
entry) and a cache hit never runs stale engines.  ``GF2BV_TPU_TRACE_CACHE``
(read at import, default 4) is the number of structures kept.

The blocked backend's matrix, where it is scanned subset-first on the card
(:func:`_scans_subset_first`), is cached in pivot order
(:func:`_order_by_pivots`): one elimination at build finds the rows each
panel elects, and the rows are stored with the pivot rows first, in the
order they are elected, then every other kept row in its present order,
the padding last.  Each panel's pivot rows then come first among its
unused rows, so the first ``SCAN_SUBSET_ROWS`` of them hold every pivot and
the subset-first scan decides every panel.  Every victim of a structure
elects the same rows, since a victim changes only column 0 and no scan
elects on it.  The answers cannot change: the RREF of the row space, mode
0's origin (free variables zero) and the verdict do not depend on the rows'
order, and mode 1's basis comes from the RREF.  ``kept`` is permuted with
the rows, so a victim's affine bits (``aff[kept]``) follow them;
``kept_mask`` and ``struct_aff`` stay indexed by the traced rows.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from ..core import lazy, packing
from ..core.lazy import LazyBitVec
from ..core.words import I32, to_device, u32_to_torch
from ..utils import profiling
from . import gauss_jax, solver
from .gauss_blocked import K_PANEL, _pad, _pick_engines, rref_blocked, solve_on_device

# cached structures (each one device matrix, or one host matrix under native)
_MAX_CACHED = int(os.environ.get("GF2BV_TPU_TRACE_CACHE", "4"))
_CACHE: "OrderedDict[bytes, _CachedSystem]" = OrderedDict()


class _CachedSystem:
    __slots__ = ("a_dev", "a_host", "kept", "kept_mask", "struct_aff", "widths",
                 "rows_padded", "backend", "phase1", "phase2", "basis_cache")


def _backend_for(system) -> str:
    return solver._resolve_backend(system._backend, system._cols, system._device)


def eligible(system, zeros) -> bool:
    return bool(zeros) and all(isinstance(z, LazyBitVec) for z in zeros) and (
        _backend_for(system) in ("blocked", "jax", "native")
    )


def clear_cache() -> None:
    _CACHE.clear()


def _build(system, exprs, key) -> _CachedSystem:
    cs = _CachedSystem()
    cs.backend = _backend_for(system)
    cs.widths = [e.width for e in exprs]
    mats = lazy.materialize_many(exprs, strip_consts=True)
    nw = packing.nwords64(1 + system._cols)
    stacked = np.concatenate(lazy.pad_mats_to_words(mats, nw), axis=0)
    cs.struct_aff = (stacked[:, 0] & np.uint64(1)).astype(np.uint8)
    cs.kept_mask = (stacked[:, 0] & ~np.uint64(1)) != 0
    if stacked.shape[1] > 1:
        cs.kept_mask |= stacked[:, 1:].any(axis=1)
    cs.kept = np.flatnonzero(cs.kept_mask)
    eqs = stacked[cs.kept]  # the structural affine bits stay in the matrix
    cs.basis_cache = {}
    if cs.backend == "native":
        cs.a_host = np.ascontiguousarray(eqs)
        cs.rows_padded = eqs.shape[0]
        cs.a_dev = cs.phase1 = cs.phase2 = None
    else:
        if cs.backend == "blocked":
            a32 = _pad(eqs, K_PANEL, word_align=128)
        else:
            a32 = gauss_jax._pad_rows(packing.to_u32(eqs), system._cols)
        cs.rows_padded = a32.shape[0]
        cs.phase1, cs.phase2 = _pick_engines(a32.shape[1])
        cs.a_dev = u32_to_torch(a32, system._device)
        cs.a_host = None
        if _scans_subset_first(cs):
            _order_by_pivots(cs, system._cols)
    _CACHE[key] = cs
    while len(_CACHE) > _MAX_CACHED:
        _CACHE.popitem(last=False)
    return cs


def _scans_subset_first(cs: _CachedSystem) -> bool:
    """Whether the solver scans ``cs``'s matrix subset-first with the
    kernels: the blocked backend on a CUDA device under ``pallas_scan``,
    with any phase 2 but ``mxu_la`` (whose lookahead scans every panel in
    its fused kernel).  On a CPU tensor the full scan runs anyway."""
    return (cs.backend == "blocked" and cs.a_dev.device.type == "cuda"
            and cs.phase1 == "pallas_scan" and cs.phase2 != "mxu_la")


def _order_by_pivots(cs: _CachedSystem, cols: int) -> None:
    """Put ``cs.a_dev``'s rows in pivot order (module docstring), and
    ``cs.kept`` with them: one elimination with ``cs``'s engines, one
    readback of its pivot map and one row gather on the matrix's device."""
    _, pof, _ = rref_blocked(cs.a_dev, cols, K_PANEL, True, phase1=cs.phase1,
                             phase2=cs.phase2)
    pof = pof.cpu().numpy()
    pivots = pof[pof >= 0]  # column order: the order the panels elect them
    rest = np.ones(cs.kept.shape[0], bool)
    rest[pivots] = False
    order = np.concatenate([pivots, np.flatnonzero(rest)])
    perm = np.concatenate([order, np.arange(order.shape[0], cs.rows_padded)])
    cs.a_dev = cs.a_dev[to_device(torch.from_numpy(perm), cs.a_dev.device)]
    cs.kept = cs.kept[order]


def _affine_vector(exprs, widths, env=None) -> np.ndarray:
    """Stacked per-row affine bits for THIS instance, (total_rows,) uint8."""
    vals = lazy.affine_many(exprs, env)
    parts = [packing.mask_bits(w, v) for v, w in zip(vals, widths)]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def cached_system(system, zeros) -> _CachedSystem:
    """The device-cached coefficient structure for a lazy zeros list,
    building (and LRU-inserting) it on first sight.  The key covers the
    trace structure, the column count, the device, the resolved backend and
    the two engine knobs of the environment."""
    exprs = [z._expr for z in zeros]
    knobs = ":".join(
        os.environ.get(k, "") for k in ("GF2BV_TPU_PHASE1", "GF2BV_TPU_PHASE2")
    )
    key = lazy.struct_key(
        exprs,
        extra=lazy._ints(system._cols)
        + str(system._device).encode()
        + _backend_for(system).encode()
        + knobs.encode(),
    )
    cs = _CACHE.get(key)
    if cs is None:
        cs = _build(system, exprs, key)
    else:
        _CACHE.move_to_end(key)
    return cs


def solve_lazy(system, zeros, mode: int, env=None):
    """The fused fast path; same return contract as ops.solver.solve."""
    cols = system._cols
    exprs = [z._expr for z in zeros]
    cs = cached_system(system, zeros)

    with profiling.span("lazy.bind"):
        aff = _affine_vector(exprs, cs.widths, env)
        if np.any(aff & ~cs.kept_mask):  # a dropped row reduced to the literal 1
            return None
        if cs.backend != "native":
            delta = (aff[cs.kept] ^ cs.struct_aff[cs.kept]).astype(np.int32)
            delta_dev = torch.zeros(cs.rows_padded, dtype=I32, device=cs.a_dev.device)
            delta_dev[: delta.shape[0]] = to_device(torch.from_numpy(delta), cs.a_dev.device)
            a = cs.a_dev.clone()
            a[:, 0] ^= delta_dev

    if cs.backend == "native":
        from .._native import solve_native

        raw = solve_native(cs.a_host, cols, mode, aff_bits=aff[cs.kept],
                           basis_cache=cs.basis_cache)
        return solver._result(raw, cols, mode)
    if cs.backend == "jax":
        raw = gauss_jax.solve_on_device(a, cols, mode)
    else:
        raw = solve_on_device(a, cols, mode, K_PANEL, cs.phase2, cs.phase1)
    return solver._result(raw, cols, mode)

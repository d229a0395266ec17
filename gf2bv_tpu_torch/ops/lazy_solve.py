"""Device-cached solving for lazily traced systems.

Port of ``gf2bv_tpu/ops/lazy_solve.py``: the packed coefficient matrix of a
traced zeros list is input-independent, so it is materialized once per
trace STRUCTURE, uploaded once and cached on the device; per solve only the
per-row affine delta crosses to the device, is XORed into a COPY of the
cached matrix (the cache survives every solve) and the blocked solver runs.

Reference semantics kept: all-zero traced rows are dropped, and a dropped
row whose affine bit is set (the literal 1) makes the system unsatisfiable
before any device work.  Mode 0 runs the trailing solver with its parity
check; mode 1 the full-width RREF and the basis extraction.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..core import lazy, packing
from ..core.lazy import LazyBitVec
from ..core.words import I32, u32_to_torch
from . import solver
from .gauss_blocked import K_PANEL, _pad, solve_on_device

_MAX_CACHED = 4  # cached structures (each one device matrix)
_CACHE: "OrderedDict[bytes, _CachedSystem]" = OrderedDict()


class _CachedSystem:
    __slots__ = ("a_dev", "kept", "kept_mask", "struct_aff", "widths", "rows_padded")


def eligible(system, zeros) -> bool:
    return bool(zeros) and all(isinstance(z, LazyBitVec) for z in zeros) and (
        solver._resolve_backend(system._backend) == "blocked"
    )


def clear_cache() -> None:
    _CACHE.clear()


def _build(system, exprs, key) -> _CachedSystem:
    cs = _CachedSystem()
    cs.widths = [e.width for e in exprs]
    mats = lazy.materialize_many(exprs, strip_consts=True)
    nw = packing.nwords64(1 + system._cols)
    stacked = np.concatenate(lazy.pad_mats_to_words(mats, nw), axis=0)
    cs.struct_aff = (stacked[:, 0] & np.uint64(1)).astype(np.uint8)
    cs.kept_mask = (stacked[:, 0] & ~np.uint64(1)) != 0
    if stacked.shape[1] > 1:
        cs.kept_mask |= stacked[:, 1:].any(axis=1)
    cs.kept = np.flatnonzero(cs.kept_mask)
    a32 = _pad(stacked[cs.kept], K_PANEL, word_align=128)
    cs.rows_padded = a32.shape[0]
    cs.a_dev = u32_to_torch(a32, system._device)
    _CACHE[key] = cs
    while len(_CACHE) > _MAX_CACHED:
        _CACHE.popitem(last=False)
    return cs


def _affine_vector(exprs, widths, env=None) -> np.ndarray:
    """Stacked per-row affine bits for THIS instance, (total_rows,) uint8."""
    vals = lazy.affine_many(exprs, env)
    parts = [packing.mask_bits(w, v) for v, w in zip(vals, widths)]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def cached_system(system, zeros) -> _CachedSystem:
    """The device-cached coefficient structure for a lazy zeros list,
    building (and LRU-inserting) it on first sight.  The key covers the
    trace structure, the column count and the device."""
    exprs = [z._expr for z in zeros]
    key = lazy.struct_key(
        exprs, extra=lazy._ints(system._cols) + str(system._device).encode()
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

    aff = _affine_vector(exprs, cs.widths, env)
    if np.any(aff & ~cs.kept_mask):  # a dropped row reduced to the literal 1
        return None

    delta = (aff[cs.kept] ^ cs.struct_aff[cs.kept]).astype(np.int32)
    delta_dev = torch.zeros(cs.rows_padded, dtype=I32, device=cs.a_dev.device)
    delta_dev[: delta.shape[0]] = torch.from_numpy(delta).to(cs.a_dev.device)
    a = cs.a_dev.clone()
    a[:, 0] ^= delta_dev
    return solver._result(solve_on_device(a, cols, mode), cols, mode)

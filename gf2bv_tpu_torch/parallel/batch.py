"""Batched multi-instance solving: many independent systems in one call.

Port of ``gf2bv_tpu/parallel/batch.py``.  Narrow systems (under
``_PER_PIVOT_MAX_COLS`` columns) are stacked and eliminated together by the
batched per-pivot solver (``ops/gauss_jax.rref_device_batched``); wide ones
go to the panel-blocked family: mode 0 to ``gauss_batched.solve_chained``,
mode 1 to ``gauss_batched.solve_batched``, or to a per-system
``solve_blocked`` loop past the 2 GiB guard.

Sharding a batch over a device mesh (``mesh=``) is ROADMAP queue 1 item 11
and raises.  The reference's host-engine loop has no counterpart: no
backend of the port resolves to a host engine.
"""

from __future__ import annotations

import numpy as np

from ..core import packing
from ..core.affine import AffineSpace
from ..core.words import resolve_device, u32_to_torch
from ..ops import extract_device, gauss_batched, solver
from ..ops.gauss_blocked import solve_blocked
from ..ops.gauss_jax import _ROW_BUCKET, rref_device_batched

# Column count from which the blocked family replaces the per-pivot solver.
# The reference measured this crossover on the TPU (BASELINE.md round 5); a
# TPU value kept for parity, to be re-derived on the H100.
_PER_PIVOT_MAX_COLS = 2048
_GUARD_BYTES = 2 << 30  # stacked batches above this solve one by one


def _mesh_not_ported(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded batches are not ported yet: ROADMAP queue 1 item 11"
        )


def pack_batch(eq_mats: list[np.ndarray], cols: int) -> np.ndarray:
    """Stack packed (rows_i, W64) systems into one (B, rows_max, W32) uint32
    array, padding rows with zeros (zero rows never pivot)."""
    rows_max = max((m.shape[0] for m in eq_mats), default=1)
    rows_pad = max(_ROW_BUCKET, -(-rows_max // _ROW_BUCKET) * _ROW_BUCKET)
    nw32 = 2 * packing.nwords64(1 + cols)
    out = np.zeros((len(eq_mats), rows_pad, nw32), dtype=np.uint32)
    for i, m in enumerate(eq_mats):
        out[i, : m.shape[0]] = packing.to_u32(m)
    return out


def solve_batch(eq_mats: list[np.ndarray], cols: int, mode: int, mesh=None,
                device="cuda"):
    """Solve many independent packed systems.  Returns one entry per
    system: None (unsatisfiable), the packed origin (mode 0), or an
    (origin, basis) pair (mode 1)."""
    _mesh_not_ported(mesh)
    if not eq_mats:
        return []
    dev = resolve_device(device)
    if cols >= _PER_PIVOT_MAX_COLS:
        rows_max = max(m.shape[0] for m in eq_mats)
        rows_pad, wp = gauss_batched.padded_batch_dims(rows_max, eq_mats[0].shape[1])
        if len(eq_mats) * rows_pad * wp * 4 <= _GUARD_BYTES:
            if mode == 0:
                return gauss_batched.solve_chained(eq_mats, cols, device=dev)
            return gauss_batched.solve_batched(eq_mats, cols, mode, device=dev)
        return [solve_blocked(m, cols, mode, device=dev) for m in eq_mats]
    a = u32_to_torch(pack_batch(eq_mats, cols), dev)
    rref32, pof, inconsistent = rref_device_batched(a, cols)
    return extract_device.finalize_batch(rref32, pof, inconsistent, cols, mode)


def solve_batch_systems(system, zeros_batch, mode: int = 0, mesh=None):
    """Batched LinearSystem front end: one entry per zeros list.  Mode 0: a
    raw solution int or None; mode 1: an AffineSpace or None."""
    _mesh_not_ported(mesh)
    solver._resolve_backend(system._backend)  # the unported backends raise
    cols = system._cols
    mats, unsat = [], []
    for zeros in zeros_batch:
        eqs = system.get_eqs_packed(zeros)
        lit_one = (eqs[:, 0] == 1) & ~eqs[:, 1:].any(axis=1)
        unsat.append(bool(lit_one.any()))
        mats.append(eqs)
    raw = solve_batch(mats, cols, mode, device=system._device)
    out = []
    for r, u in zip(raw, unsat):
        if u or r is None:
            out.append(None)
        elif mode == 0:
            out.append(packing.words_to_int(r))
        else:
            out.append(AffineSpace(r[0], r[1], cols))
    return out

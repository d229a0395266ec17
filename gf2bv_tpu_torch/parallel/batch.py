"""Batched multi-instance solving: many independent systems in one call.

Port of ``gf2bv_tpu/parallel/batch.py``.  Narrow systems (under
``_PER_PIVOT_MAX_COLS`` columns) are stacked and eliminated together by the
batched per-pivot solver (``ops/gauss_jax.rref_device_batched``); wide ones
go to the panel-blocked family: mode 0 to ``gauss_batched.solve_chained``,
mode 1 to ``gauss_batched.solve_batched``, or to a per-system
``solve_blocked`` loop past the 2 GiB guard.

A system whose backend resolves to a host engine (``native``, ``oracle``)
solves in a per-system loop, as in the reference: there is no launch or
transfer cost to amortize with a stacked program, unless a mesh is given.
``mesh=`` splits a narrow batch over the mesh's batch axis (parallel/
mesh.py), padded to a multiple of it: each batch shard eliminates its
contiguous block of systems on its device, with no collectives; wide
systems warn and ignore the mesh, as in the reference.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core import packing
from ..core.affine import AffineSpace
from ..core.words import resolve_device, u32_to_torch
from ..ops import extract_device, gauss_batched, solver
from ..ops.gauss_blocked import solve_blocked
from ..ops.gauss_jax import _ROW_BUCKET, rref_device_batched
from . import collectives, mesh as meshlib

# Column count from which the blocked family replaces the per-pivot solver.
# The reference measured this crossover on the TPU (BASELINE.md round 5); a
# TPU value kept for parity, to be re-derived on the H100.
_PER_PIVOT_MAX_COLS = 2048
_GUARD_BYTES = 2 << 30  # stacked batches above this solve one by one


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
    (origin, basis) pair (mode 1).  With ``mesh`` the narrow systems are
    split over its batch axis (``device`` is then unused); wide systems
    solve on ``device``."""
    if mesh is not None:
        meshlib.require_mesh(mesh)
    if not eq_mats:
        return []
    if cols >= _PER_PIVOT_MAX_COLS:
        dev = resolve_device(device)
        if mesh is not None:
            warnings.warn(
                f"solve_batch: cols={cols} routes through the batched "
                f"blocked solver on {dev}; the batch mesh is not used "
                "(shard wide systems with parallel.solve_sharded instead)",
                stacklevel=2,
            )
        rows_max = max(m.shape[0] for m in eq_mats)
        rows_pad, wp = gauss_batched.padded_batch_dims(rows_max, eq_mats[0].shape[1])
        if len(eq_mats) * rows_pad * wp * 4 <= _GUARD_BYTES:
            if mode == 0:
                return gauss_batched.solve_chained(eq_mats, cols, device=dev)
            return gauss_batched.solve_batched(eq_mats, cols, mode, device=dev)
        return [solve_blocked(m, cols, mode, device=dev) for m in eq_mats]
    a = pack_batch(eq_mats, cols)
    if mesh is None:
        rref32, pof, inconsistent = rref_device_batched(u32_to_torch(a, device), cols)
    else:
        sh = meshlib.batch_sharding(mesh)
        pad = (-len(eq_mats)) % sh.size
        if pad:
            a = np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)], axis=0)
        parts = [rref_device_batched(piece, cols) for piece in sh.split(a)]
        rref32, pof, inconsistent = (
            torch.cat(collectives.readout(sh, [p[i] for p in parts])) for i in range(3)
        )
    # slice the mesh padding off BEFORE extraction: an all-zero padding
    # system has dim == cols, and its mode-1 basis would be thrown away
    n = len(eq_mats)
    return extract_device.finalize_batch(rref32[:n], pof[:n], inconsistent[:n], cols, mode)


def solve_batch_systems(system, zeros_batch, mode: int = 0, mesh=None):
    """Batched LinearSystem front end: one entry per zeros list.  Mode 0: a
    raw solution int or None; mode 1: an AffineSpace or None.  A host
    backend solves in a loop; an explicit mesh still routes to the device
    batch."""
    cols = system._cols
    resolved = solver._resolve_backend(system._backend, cols, system._device)
    if mesh is None and resolved in solver._HOST_BACKENDS:
        out = []
        for zeros in zeros_batch:
            eqs = system.get_eqs_packed(zeros)
            lit_one = (eqs[:, 0] == 1) & ~eqs[:, 1:].any(axis=1)
            if lit_one.any():
                out.append(None)
                continue
            out.append(solver.solve(eqs[eqs.any(axis=1)], cols, mode, backend=resolved))
        return out
    mats, unsat = [], []
    for zeros in zeros_batch:
        eqs = system.get_eqs_packed(zeros)
        lit_one = (eqs[:, 0] == 1) & ~eqs[:, 1:].any(axis=1)
        unsat.append(bool(lit_one.any()))
        mats.append(eqs)
    raw = solve_batch(mats, cols, mode, mesh=mesh, device=system._device)
    out = []
    for r, u in zip(raw, unsat):
        if u or r is None:
            out.append(None)
        elif mode == 0:
            out.append(packing.words_to_int(r))
        else:
            out.append(AffineSpace(r[0], r[1], cols))
    return out

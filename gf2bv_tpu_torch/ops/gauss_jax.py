"""Per-pivot Gauss-Jordan to RREF — the small-system solver.

Port of ``gf2bv_tpu/ops/gauss_jax.py`` (plain jnp there, no Pallas kernel):
one step per variable column picks the lowest-index unused row with the
column's bit set as the pivot and XORs it into every other row with the bit
set.  Plain torch on either device; the steps are a Python loop of small
whole-matrix operations, so this path suits narrow systems
(``backend="jax"``, and batches under ``parallel.batch._PER_PIVOT_MAX_COLS``).

:func:`rref_device_batched` is the same elimination over a leading batch
dimension (the counterpart of ``parallel/batch._rref_batched``, a vmap of
``rref_device``); :func:`rref_device` is its single-matrix case.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.words import I32, resolve_device, srl, torch_to_u32, u32_to_torch
from . import extract_device

_ROW_BUCKET = 256  # row counts are padded to a multiple of this


def _pad_rows(a32: np.ndarray, cols: int) -> np.ndarray:
    del cols
    return packing.pad2d(a32, row_align=_ROW_BUCKET)


def rref_device_batched(a: torch.Tensor, cols: int):
    """Full Gauss-Jordan of B matrices; a (B, rows, W32) int32 (not modified).

    Returns (rref (B, rows, W32), pivot_row_of_col (B, cols) int32 with -1
    for a free column, inconsistent (B,) bool)."""
    a = a.clone()
    nb, rows, _ = a.shape
    dev = a.device
    lane = torch.arange(rows, dtype=I32, device=dev)[None, :]
    batch = torch.arange(nb, device=dev)
    used = torch.zeros((nb, rows), dtype=torch.bool, device=dev)
    pof = torch.full((nb, cols), -1, dtype=I32, device=dev)
    for k in range(cols):
        j = k + 1  # packed bit of variable column k+1
        col = (srl(a[:, :, j >> 5], j & 31) & 1) == 1  # (B, rows)
        piv = torch.where(col & ~used, lane, rows).amin(dim=1)  # lowest unused
        has = piv < rows
        piv_safe = torch.where(has, piv, 0).long()
        pivrow = a[batch, piv_safe]  # (B, W32), a copy
        elim = col & (lane != piv[:, None]) & has[:, None]
        a ^= torch.where(elim[:, :, None], pivrow[:, None, :], 0)
        used |= (lane == piv[:, None]) & has[:, None]
        pof[:, k] = torch.where(has, piv, -1)
    return a, pof, extract_device.inconsistent_device(a)


def rref_device(a: torch.Tensor, cols: int):
    """Full Gauss-Jordan of one (rows, W32) matrix.  Returns (rref,
    pivot_row_of_col (cols,), inconsistent 0-dim bool)."""
    rref, pof, inc = rref_device_batched(a[None], cols)
    return rref[0], pof[0], inc[0]


def rref_origin_device(a: torch.Tensor, cols: int):
    """RREF + mode-0 extraction: (origin32 (Wsol32,), inconsistent)."""
    rref32, pof, inconsistent = rref_device(a, cols)
    return extract_device.origin_device(rref32, pof, cols), inconsistent


def solve_on_device(a: torch.Tensor, cols: int, mode: int):
    """Solve a (rows, W32) int32 matrix where it lies.  Mode 0: the packed
    origin (W64,) uint64; mode 1: (origin, basis); None when unsatisfiable."""
    if mode == 0:
        origin32, inconsistent = rref_origin_device(a, cols)
        if bool(inconsistent):
            return None
        return packing.from_u32(torch_to_u32(origin32)[None, :])[0]
    rref32, pof, inconsistent = rref_device(a, cols)
    return extract_device.finalize(rref32, pof, inconsistent, cols, mode)


def solve_jax(eqs: np.ndarray, cols: int, mode: int, device="cuda"):
    """Solve a packed (rows, W64) uint64 system over ``cols`` variables;
    results as :func:`solve_on_device`."""
    a = u32_to_torch(_pad_rows(np.ascontiguousarray(packing.to_u32(eqs)), cols),
                     resolve_device(device))
    return solve_on_device(a, cols, mode)

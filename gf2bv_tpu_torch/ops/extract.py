"""Shared solution/kernel extraction from an RREF in packed form.

Both the numpy oracle and the JAX/TPU solvers reduce the augmented system to
reduced row echelon form (pivoting on variable columns 1..cols; packed column
0 is the affine constant, i.e. the RHS).  This module turns (pivot rows,
pivot columns) into the canonical particular solution and kernel basis:

* origin: free variables = 0, pivot variable x_c = RHS bit of its pivot row
* basis vector for free column f: v_f = 1, v_{c_j} = bit f of pivot row j

Solution packing: raw solution bit k = variable k+1 (so ``evaluate`` applies
``(s << 1) | 1`` exactly like the reference, ``__init__.py:128-134``).

Port copy of ``gf2bv_tpu/ops/extract.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

import numpy as np

from ..core import packing

_CHUNK = 1024


def extract_bit_columns(rows: np.ndarray, cols_idx: np.ndarray) -> np.ndarray:
    """bits[:, k] = bit cols_idx[k] of each packed uint64 row. -> (n, len) u8."""
    if rows.shape[0] == 0 or cols_idx.size == 0:
        return np.zeros((rows.shape[0], cols_idx.size), dtype=np.uint8)
    w = (cols_idx // packing.WORD).astype(np.int64)
    s = (cols_idx % packing.WORD).astype(np.uint64)
    return ((rows[:, w] >> s[None, :]) & np.uint64(1)).astype(np.uint8)


def build_origin(
    pivot_rows: np.ndarray, pivot_cols: np.ndarray, cols: int
) -> np.ndarray:
    """Particular solution, packed over ``cols`` bits."""
    x = np.zeros(cols, dtype=np.uint8)
    if pivot_cols.size:
        rhs = (pivot_rows[:, 0] & np.uint64(1)).astype(np.uint8)
        x[pivot_cols - 1] = rhs
    return packing.pack_bits(x[None, :], cols)[0]


def build_basis(
    pivot_rows: np.ndarray, pivot_cols: np.ndarray, cols: int
) -> np.ndarray:
    """Canonical RREF kernel basis, packed (dim, Wsol) uint64.

    Built in chunks so the unpacked intermediate stays small even when the
    kernel is huge (e.g. near-empty systems where dim ~ cols).
    """
    free_cols = np.setdiff1d(np.arange(1, 1 + cols), pivot_cols)
    dim = free_cols.size
    nw = packing.nwords64(cols)
    out = np.empty((dim, nw), dtype=np.uint64)
    for lo in range(0, dim, _CHUNK):
        hi = min(lo + _CHUNK, dim)
        fc = free_cols[lo:hi]
        vecs = np.zeros((hi - lo, cols), dtype=np.uint8)
        vecs[np.arange(hi - lo), fc - 1] = 1
        if pivot_cols.size:
            # coeffs[j, k] = bit fc[k] of pivot row j
            coeffs = extract_bit_columns(pivot_rows, fc)
            vecs[:, pivot_cols - 1] = coeffs.T
        out[lo:hi] = packing.pack_bits(vecs, cols)
    return out

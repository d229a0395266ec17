"""Slow, obviously-correct host GF(2) solver — the in-repo oracle.

Plays the role Sage's ``solve_right`` plays for the reference
(``reference:examples/sage_mt.py:39-43``): an independent implementation
the fast solvers are differentially tested against.  Pure numpy over an
unpacked uint8 bit matrix; Gauss-Jordan to reduced row echelon form.

Input convention matches the packed equation matrix: column 0 is the affine
constant (the right-hand side b), columns ``1..cols`` the variables, i.e. a
row encodes ``b + a_1 x_1 + ... + a_n x_n = 0``.

Port copy of ``gf2bv_tpu/ops/gauss_ref.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import packing


@dataclass
class RefSolution:
    """RREF-canonical solution of a GF(2) affine system."""

    consistent: bool
    rank: int
    # packed over `cols` bits: bit k = variable k+1
    origin: np.ndarray | None  # (Wsol,) uint64
    basis: np.ndarray | None  # (dim, Wsol) uint64
    pivot_cols: np.ndarray | None  # (rank,) int64, 1-based variable columns

    @property
    def dimension(self) -> int:
        return 0 if self.basis is None else self.basis.shape[0]


def rref_bits(mat: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """In-place-free Gauss-Jordan on an unpacked (rows, ncols) uint8 matrix.

    Pivots on columns 1.. (column 0 is the RHS).  Returns (rref, pivot_cols).
    """
    a = mat.astype(np.uint8).copy()
    rows, ncols = a.shape
    pivots: list[int] = []
    r = 0
    for c in range(1, ncols):
        if r >= rows:
            break
        nz = np.nonzero(a[r:, c])[0]
        if nz.size == 0:
            continue
        p = r + nz[0]
        if p != r:
            a[[r, p]] = a[[p, r]]
        sel = a[:, c].copy()
        sel[r] = 0
        a ^= np.outer(sel, a[r])
        pivots.append(c)
        r += 1
    return a, pivots


def rref_packed(eqs: np.ndarray, nbits: int) -> tuple[np.ndarray, list[int]]:
    """Gauss-Jordan on the PACKED (rows, W64) uint64 matrix.

    Same algorithm as rref_bits, 64 bit-columns per word instead of one
    uint8 per bit — still plain sequential numpy (independent of the device
    solvers), but feasible at MT19937 size (~8 TB of uint8 traffic becomes
    ~0.5 TB of packed traffic).
    """
    a = np.ascontiguousarray(eqs).copy()
    rows = a.shape[0]
    pivots: list[int] = []
    r = 0
    for c in range(1, nbits):
        if r >= rows:
            break
        w, s = c >> 6, np.uint64(c & 63)
        col = (a[r:, w] >> s) & np.uint64(1)
        nz = np.nonzero(col)[0]
        if nz.size == 0:
            continue
        p = r + nz[0]
        if p != r:
            a[[r, p]] = a[[p, r]]
        colall = (a[:, w] >> s) & np.uint64(1)
        colall[r] = 0
        idx = np.nonzero(colall)[0]
        a[idx] ^= a[r]
        pivots.append(c)
        r += 1
    return a, pivots


# above this many packed bits, the uint8 oracle's memory traffic becomes
# impractical (rows x nbits bytes PER PIVOT); switch to the packed variant
# (~15 s vs ~1 s per instance at 4000 cols — dominated hardware-fuzz time)
_PACKED_ORACLE_BITS = 1024


def solve_oracle(eqs: np.ndarray, cols: int, mode: int = 1) -> RefSolution:
    """Solve a packed (rows, W64) system over ``cols`` variables.

    Returns origin with free variables = 0 and the canonical RREF kernel
    basis (one vector per free column, ordered by column index).  mode 0
    skips the basis build (returns basis=None) — on large low-rank systems
    the basis is the dominant cost and mode-0 callers throw it away.
    """
    nbits = 1 + cols
    if nbits > _PACKED_ORACLE_BITS:
        rref_p, pivots = rref_packed(eqs, nbits)
        rank = len(pivots)
        if rank < rref_p.shape[0]:
            tail = rref_p[rank:]
            const = (tail[:, 0] & np.uint64(1)) == 1
            rest = (tail[:, 0] >> np.uint64(1)) != 0
            if tail.shape[1] > 1:
                rest = rest | tail[:, 1:].any(axis=1)
            if np.any(const & ~rest):
                return RefSolution(False, rank, None, None, None)
        pivot_rows = rref_p[:rank]
    else:
        bits = packing.unpack_rows(eqs, nbits)
        rref, pivots = rref_bits(bits)
        rank = len(pivots)
        # Inconsistent iff some row is 1 = 0 (only the constant bit set).
        if rank < rref.shape[0]:
            tail = rref[rank:]
            if np.any(tail[:, 0] & (tail[:, 1:].sum(axis=1) == 0)):
                return RefSolution(False, rank, None, None, None)
        pivot_rows = packing.pack_bits(rref[:rank], nbits)
    pivot_cols = np.asarray(pivots, dtype=np.int64)

    from . import extract

    origin = extract.build_origin(pivot_rows, pivot_cols, cols)
    basis = (
        extract.build_basis(pivot_rows, pivot_cols, cols) if mode == 1 else None
    )
    return RefSolution(True, rank, origin, basis, pivot_cols)

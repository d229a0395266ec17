"""Quadratic row construction on the device (the NLFSR hot path).

Port of ``gf2bv_tpu/ops/quad_device.py``, plain torch (the reference is
plain jnp, no Pallas kernel).  The inputs are the NARROW per-step tap
bitvecs (linear columns only, a few words a row), so only they cross to the
device; the outer-product cross terms, the linear and constant columns and
the bit packing run there, and the resulting (rows, W32) int32 equation
matrix stays on the device for ``ops/solver.solve_packed``.

Semantics are ``QuadraticSystem.mul_bits``' (bit for bit): row t of the
output is

    XOR_p  a_p[t] * b_p[t]   (quadratic products, linearized monomials)
  ^ XOR_l  l[t]              (linear terms)
  ^ const[t]                 (affine constant)

with the reference's monomial order (i outer, j inner, i > j).  The
bit-plane intermediates are uint8, one byte per product a_i b_j and row (at
the NLFSR's 17384 rows and n = 128, 285 MB each); the monomials are packed
eight bits to a byte with no signed arithmetic and viewed as int32 words.

:class:`RowSelection` (``QuadraticSystem.select_rows``) keeps such rows on
the device as a template of systems whose rows are picked per request: an
annihilator attack keeps the rows of the keystream's ones, a different
subset for every victim, and a request uploads only the kept indices.

:func:`mul_bits_batch` is the same expansion for a batch of products on the
host, as in the reference: its rows feed numpy assembly, so it runs
vectorized torch on the CPU in chunks of rows.  The reference's lazy trace
expands its large batches with it; the port's keeps numpy's ``mul_bits``,
which ties or wins on the card's host (scripts/time_mul_bits_torch.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.bitvec import BitVec
from ..core.words import to_device, u32_to_torch
from ..utils import profiling

_BYTE_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)
_HOST_CHUNK_BYTES = 1 << 26  # bound on one host chunk's (rows, n, n) bit plane


def _unpack(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """(rows, W32) int32 -> (rows, nbits) uint8 bits, LSB first."""
    j = torch.arange(nbits, device=words.device)
    # only bit 0 of each shifted word is kept, so the sign extension of >> is harmless
    return ((words[:, j >> 5] >> (j & 31).to(torch.int32)) & 1).to(torch.uint8)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(rows, 32 * nw32) uint8 0/1 bits -> (rows, nw32) int32 words, LSB first."""
    rows, nbits = bits.shape
    weights = torch.tensor(_BYTE_WEIGHTS, dtype=torch.uint8, device=bits.device)
    packed = (bits.view(rows, nbits // 8, 8) * weights).sum(dim=2, dtype=torch.uint8)
    return packed.view(torch.int32)  # little-endian bytes -> words


def _tri_flat(n: int, device) -> torch.Tensor:
    """Flat positions i * n + j of the monomials x_i x_j, i > j, in the
    reference's order (i outer, j inner)."""
    tri_i, tri_j = np.tril_indices(n, k=-1)
    return torch.from_numpy(tri_i * n + tri_j).to(device)


def _expand(pairs_a, pairs_b, head: torch.Tensor, n: int, nw32: int) -> torch.Tensor:
    """pairs_a / pairs_b: lists of (rows, Wn32) int32 narrow operands; head:
    (rows, 1 + n) uint8 bits XORed into the linear and constant columns.
    Returns the (rows, nw32) int32 full-width packed rows.

    The cross term of x_i x_j (i > j) is XOR_p a_p,i b_p,j ^ a_p,j b_p,i, so
    the pairs' outer products are XOR-accumulated into one (rows, n, n)
    plane M and the monomials are (M ^ M^T) at the lower triangle: one
    gather, however many pairs."""
    rows = head.shape[0]
    m = None
    for a32, b32 in zip(pairs_a, pairs_b):
        abits, bbits = _unpack(a32, 1 + n), _unpack(b32, 1 + n)
        head = head ^ (abits & bbits)  # the constant and x_i^2 = x_i terms
        outer = abits[:, 1:, None] & bbits[:, None, 1:]  # a_i b_j at [i, j]
        m = outer if m is None else m.bitwise_xor_(outer)
    out = torch.zeros((rows, 32 * nw32), dtype=torch.uint8, device=head.device)
    out[:, : 1 + n] = head
    flat = _tri_flat(n, head.device)
    out[:, 1 + n : 1 + n + flat.numel()] = (m ^ m.transpose(1, 2)).view(rows, n * n)[:, flat]
    return _pack(out)


def _narrow32(bv: BitVec, wn32: int, rows: int) -> np.ndarray:
    a32 = packing.to_u32(bv.rows)
    out = np.zeros((rows, wn32), np.uint32)
    out[: a32.shape[0], : a32.shape[1]] = a32
    return out


def quad_rows(system, pairs, linear=(), const=0) -> torch.Tensor:
    """Build full-width quadratic equation rows on ``system``'s device.

    system: a QuadraticSystem (supplies n, the monomial layout and the
    device).  pairs: iterable of (a, b) BitVec pairs, each NARROW (linear
    columns only, equal widths), e.g. tap streams traced against a plain
    LinearSystem with the same variable layout.  linear: BitVecs XORed in as
    linear terms.  const: int bitmask (bit t = affine constant of row t) or
    a bool array.

    Returns a (rows, W32) int32 tensor on the system's device with
    ``mul_bits`` semantics, ready for ``solve_packed`` / ``solve_*_packed``.
    """
    pairs = [(a, b) for a, b in pairs]
    assert pairs, "at least one product pair required"
    n = system._lin_size
    rows = len(pairs[0][0])
    for a, b in pairs:
        if len(a) != rows or len(b) != rows:
            raise ValueError("Widths must match")  # as mul_bits raises
    for l_bv in linear:
        if len(l_bv) != rows:
            raise ValueError("Widths must match")
    wn32 = 2 * packing.nwords64(1 + n)
    nw32 = 2 * packing.nwords64(system._nbits)
    dev = system._device

    lc = np.zeros((rows, wn32), np.uint32)
    for l_bv in linear:
        lc ^= _narrow32(l_bv, wn32, rows)
    if isinstance(const, (int, np.integer)):
        cbits = packing.mask_bits(rows, int(const))
    else:
        cbits = np.asarray(const, dtype=np.uint8)
    lc[:, 0] ^= cbits.astype(np.uint32) & 1

    pa = [u32_to_torch(_narrow32(a, wn32, rows), dev) for a, _ in pairs]
    pb = [u32_to_torch(_narrow32(b, wn32, rows), dev) for _, b in pairs]
    return _expand(pa, pb, _unpack(u32_to_torch(lc, dev), 1 + n), n, nw32)


class RowSelection:
    """Systems whose rows are picked per request from one device-resident
    matrix ``eqs`` ((rows, W32) int32, e.g. from :func:`quad_rows`) of
    ``system``.

    A request passes a host boolean mask over the rows.  :meth:`select`
    uploads the kept indices once and gathers the kept rows on the device,
    padded to the solver's row bucket with copies of the first kept row: a
    duplicate row is inert under RREF, and the solver then meets one shape
    per bucket (the CUDA graphs of ``gauss_blocked`` replay it).  Where the
    system solves on the blocked backend the template is padded once to the
    word alignment that ``solver.solve_packed`` pads to, so a request's
    gather is the whole padded matrix."""

    def __init__(self, system, eqs: torch.Tensor):
        from . import gauss_blocked, solver

        if not isinstance(eqs, torch.Tensor) or eqs.dtype != torch.int32 or eqs.dim() != 2:
            raise TypeError("eqs must be a (rows, W32) int32 tensor")
        self.system = system
        self.rows = eqs.shape[0]
        self.bucket = gauss_blocked._ROW_BUCKET
        if solver._resolve_backend(system._backend, system._cols, eqs.device) == "blocked":
            eqs = gauss_blocked._pad_device(eqs, gauss_blocked.K_PANEL, 128)
        self.eqs = eqs

    def select(self, keep) -> torch.Tensor:
        """The rows ``keep`` ((rows,) bool, on the host) marks, gathered on
        the device and padded to a multiple of the row bucket.  Span
        ``quad.select``."""
        with profiling.span("quad.select"):
            keep = np.asarray(keep, dtype=bool)
            if keep.shape != (self.rows,):
                raise ValueError(f"keep must be a ({self.rows},) mask, got {keep.shape}")
            sel = np.flatnonzero(keep)
            if not sel.size:
                raise ValueError("keep selects no row")
            idx = np.full(-(-sel.size // self.bucket) * self.bucket, sel[0], dtype=np.int64)
            idx[: sel.size] = sel
            return self.eqs.index_select(0, to_device(torch.from_numpy(idx), self.eqs.device))

    def space(self, keep):
        """The affine solution space of the kept rows (mode 1), or None when
        they are unsatisfiable."""
        return self.system.solve_raw_packed(self.select(keep), 1)

    def solve_one(self, keep, *, max_dimension: int = 16):
        """The first point of the kept rows' space that passes the system's
        consistency filter (as ``solve_one_packed``), or None.  A space past
        ``max_dimension`` raises ``DimensionTooLargeError``."""
        space = self.space(keep)
        if space is None:
            return None
        return next(self.system._enumerate_space(space, max_dimension), None)


def mul_bits_batch(system, a_rows: np.ndarray, b_rows: np.ndarray) -> np.ndarray:
    """Batched ``mul_bits`` on the host: (B, Wn64) uint64 narrow operand rows
    -> (B, W64) uint64 full-monomial-width rows, bit for bit
    ``QuadraticSystem.mul_bits``.  Runs vectorized torch on the CPU in
    chunks of rows that bound the bit-plane intermediates."""
    n = system._lin_size
    nw32 = 2 * packing.nwords64(system._nbits)
    a32 = packing.to_u32(np.ascontiguousarray(a_rows))
    b32 = packing.to_u32(np.ascontiguousarray(b_rows))
    B = a32.shape[0]
    out32 = np.empty((B, nw32), np.uint32)
    step = max(1, _HOST_CHUNK_BYTES // max(1, n * n, 32 * nw32))
    for lo in range(0, B, step):
        a = u32_to_torch(a32[lo : lo + step], "cpu")
        b = u32_to_torch(b32[lo : lo + step], "cpu")
        head = torch.zeros((a.shape[0], 1 + n), dtype=torch.uint8)
        out32[lo : lo + step] = _expand([a], [b], head, n, nw32).numpy().view(np.uint32)
    return packing.from_u32(out32)

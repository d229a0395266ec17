"""AffineSpace: origin + GF(2) kernel basis, with batched enumeration.

API-parity with the reference C type (``reference:gf2bv/_internal.c:
61-304``, stub ``_internal.pyi:8-15``): properties ``dimension`` / ``origin``
/ ``basis`` (Python ints), random access ``get(n)`` (origin XOR the basis rows
selected by the *binary* bits of n, ``_internal.c:242-273``), and iteration in
the reference's exact order — Gray-code order for dim <= 64
(``point(k) = origin ^ combo(gray(k))``, ``_internal.c:101-122``), plain
binary counter order otherwise (``_internal.c:63-91``).

Instead of the reference's one-row-XOR-per-point sequential iterator, points
are materialized in vectorized batches (whole chunks of the selector matrix
combined at once); the Python iterator facade yields ints from each batch, so
enumeration order is bit-identical while the arithmetic is array-shaped (and
can be pushed to the TPU for large spaces — see ops/enumerate.py).

Port copy of ``gf2bv_tpu/core/affine.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
Changed: a batch of fewer than ``_NATIVE_MIN_WORDS`` output words is
enumerated in numpy, not on the host C engine.
"""

from __future__ import annotations

import numpy as np

from . import packing

_ENUM_CHUNK = 4096
# Batches of fewer output words than this run in numpy, not on the host C
# engine: waking its OpenMP team took 3-48 ms on busy 8-core hosts, where
# the few points a quadratic solve filters take microseconds.
_NATIVE_MIN_WORDS = 1 << 18


def combine_batch(
    origin: np.ndarray, basis: np.ndarray, selectors: np.ndarray
) -> np.ndarray:
    """points[i] = origin ^ XOR_{j: selectors[i,j]} basis[j]  (packed rows).

    selectors: (batch, dim) uint8.  Vectorized over the batch; the dim loop is
    at most ``dimension`` iterations of whole-array work.
    """
    out = np.broadcast_to(origin, (selectors.shape[0], origin.shape[0])).copy()
    for j in range(basis.shape[0]):
        sel = selectors[:, j].astype(np.uint64)[:, None]
        out ^= basis[j][None, :] * sel
    return out


def _int_bits_lsb(values: np.ndarray, nbits: int) -> np.ndarray:
    """(n,) uint64 -> (n, nbits) uint8, LSB first."""
    v = values[:, None] >> np.arange(nbits, dtype=np.uint64)[None, :]
    return (v & np.uint64(1)).astype(np.uint8)


class AffineSpace:
    """Affine solution space ``{origin ^ span(basis)}`` over ``cols`` bits."""

    def __init__(self, origin: np.ndarray, basis: np.ndarray, cols: int):
        self._origin = np.asarray(origin, dtype=np.uint64)
        self._basis = np.asarray(basis, dtype=np.uint64).reshape(
            -1, self._origin.shape[0]
        )
        self._cols = cols

    # -- reference API -----------------------------------------------------

    @property
    def dimension(self) -> int:
        return self._basis.shape[0]

    @property
    def origin(self) -> int:
        return packing.words_to_int(self._origin)

    @property
    def basis(self) -> list[int]:
        # list, as the reference returns (_internal.pyi:13)
        return list(packing.rows_to_ints(self._basis))

    def get(self, n: int) -> int:
        """origin XOR basis rows selected by the binary bits of n."""
        row = self._origin.copy()
        i = 0
        while n and i < self.dimension:
            if n & 1:
                row ^= self._basis[i]
            n >>= 1
            i += 1
        return packing.words_to_int(row)

    def __iter__(self):
        return self.iter_ints()

    @property
    def size(self) -> int:
        """Number of points, 2**dimension.  (Not __len__: it can exceed
        the index-sized-int limit len() requires.)"""
        return 1 << self.dimension

    # -- batched enumeration ------------------------------------------------

    def enumerate_packed(self, start: int, count: int, gray: bool) -> np.ndarray:
        """Packed rows for points start..start+count-1 of the enumeration."""
        big = count * self._origin.shape[0] >= _NATIVE_MIN_WORDS
        if big and start + count <= (1 << 63):  # native path: uint64 index arithmetic
            from .. import _native

            if _native.available():
                return _native.enumerate_native(
                    self._origin, self._basis, start, count, gray
                )
        idx = np.arange(start, start + count, dtype=np.uint64)
        if gray:
            idx = idx ^ (idx >> np.uint64(1))
        sel = _int_bits_lsb(idx, max(self.dimension, 1))[:, : self.dimension]
        return combine_batch(self._origin, self._basis, sel)

    def iter_ints(self, chunk: int = _ENUM_CHUNK):
        """Yield all 2**dim points as raw ints, in the reference's order."""
        dim = self.dimension
        total = 1 << dim
        # Reference order: Gray-code iterator for dim <= 64, binary counter
        # otherwise (_internal.c:185-187).  Both orders are reproduced.
        use_gray = dim <= 64
        done = 0
        while done < total:
            n = min(chunk, total - done)
            rows = self.enumerate_packed(done, n, gray=use_gray)
            yield from packing.rows_to_ints(rows)
            done += n

    # -- pickling ----------------------------------------------------------

    def __reduce__(self):
        return (AffineSpace, (self._origin, self._basis, self._cols))

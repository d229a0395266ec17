"""Symbolic bitvector over GF(2), packed-array representation.

API-compatible with the reference ``gf2bv.BitVec``
(``reference:gf2bv/__init__.py:21-134``) but with a TPU-friendly data
model: instead of one Python big-int per bit, a BitVec of width ``w`` over a
system with ``cols`` variables is a single ``(w, W64)`` uint64 numpy matrix.
Row ``i`` (LSB first) packs the affine-form mask of bit ``i``: packed bit 0 is
the constant term, packed bits ``1..cols`` the linear variables — identical
bit-numbering to the reference (``__init__.py:151-152``), just packed.

Every operator is then a whole-array op (XOR, row slicing, row masking), so
tracing a 19968-variable MT19937 system manipulates ~80 KB arrays instead of
tuples of 19969-bit Python ints.  Arrays are treated as immutable: no method
mutates ``rows`` in place (the reference's ``tuple_where`` in-place mutation
footgun, ``_internal.c:667-675``, is deliberately not reproduced).

Port copy of ``gf2bv_tpu/core/bitvec.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

import functools

import numpy as np

from . import packing


@functools.lru_cache(maxsize=8192)
def _mask_bits_cached(width: int, mask: int) -> np.ndarray:
    """Unpacked bits of an int mask; models reuse the same constants
    thousands of times per trace (e.g. MT19937's tempering masks), so this
    memo removes the dominant per-op to_bytes/unpackbits cost."""
    bits = packing.mask_bits(width, mask)
    bits.setflags(write=False)
    return bits


@functools.lru_cache(maxsize=8192)
def _const_rows_cached(value: int, width: int, nw: int) -> np.ndarray:
    out = np.zeros((width, nw), dtype=np.uint64)
    out[:, 0] = _mask_bits_cached(width, value).astype(np.uint64)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=8192)
def _and_col_cached(width: int, mask: int):
    """uint64 0/1 column for ``BitVec & int`` (None = all-ones, a no-op).
    Symbolic register steps AND the same tap/tempering constant tens of
    thousands of times per trace; the cached column makes the op one
    vectorized multiply."""
    bits = _mask_bits_cached(width, mask)
    if bits.all():
        return None
    col = bits[:, None].astype(np.uint64)
    col.setflags(write=False)
    return col


class BitVec:
    __slots__ = ("rows", "nbits")

    def __init__(self, bits, nbits: int | None = None):
        """``bits`` is either a packed (width, W64) uint64 array (fast path)
        or, for reference compatibility, a tuple/list of int masks."""
        if isinstance(bits, np.ndarray):
            assert bits.dtype == np.uint64 and bits.ndim == 2
            if nbits is None:
                nbits = bits.shape[1] * packing.WORD
            self.rows = bits
            self.nbits = nbits
        else:
            masks = list(bits)
            if nbits is None:
                nbits = max(1, max((m.bit_length() for m in masks), default=1))
            self.rows = packing.ints_to_rows(masks, nbits)
            self.nbits = nbits

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return self.rows.shape[0]

    @property
    def _bits(self) -> tuple[int, ...]:
        """Reference-compatible view: tuple of big-int masks, LSB first."""
        return tuple(packing.rows_to_ints(self.rows))

    def __repr__(self) -> str:
        return f"BitVec(width={len(self)}, nbits={self.nbits})"

    # -- helpers -----------------------------------------------------------

    def _wrap(self, rows: np.ndarray) -> "BitVec":
        return BitVec(rows, self.nbits)

    def _const_rows(self, value: int, width: int) -> np.ndarray:
        """Rows for a constant: bit i of ``value`` -> affine bit set."""
        return _const_rows_cached(value, width, self.rows.shape[1])

    def _is_const_bit(self, i: int):
        """Return 0, 1 or None if row i is not a constant."""
        row = self.rows[i]
        if row[0] > 1 or np.any(row[1:]):
            return None
        return int(row[0])

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self._wrap(self.rows[key])
        if isinstance(key, (list, np.ndarray)):
            # numpy-style row selection: integer or boolean indexing picks
            # out a sub-bitvector (new capability; no reference analog)
            return self._wrap(self.rows[np.asarray(key)])
        # wrap single bits to prevent misuse (reference __init__.py:32-37);
        # out-of-range indices raise like the reference's tuple indexing
        # (a silent empty slice would drop equations from the trace)
        if not -len(self) <= key < len(self):
            raise IndexError(f"bit index {key} out of range for width {len(self)}")
        return self._wrap(self.rows[key : key + 1] if key != -1 else self.rows[-1:])

    @classmethod
    def stack(cls, items: "Sequence[BitVec]") -> "BitVec":
        """Concatenate many BitVecs low-to-high in one shot (the batched
        form of ``concat``; new capability for collecting per-step trace
        bits into one wide vector)."""
        items = list(items)
        for b in items:
            sub = type(b).stack
            if getattr(sub, "__func__", sub) is not BitVec.stack.__func__:
                return type(b).stack(items)  # lazy subclass: record instead
        nbits = max(b.nbits for b in items)
        return BitVec(np.concatenate([b.rows for b in items], axis=0), nbits)

    # -- linear ops --------------------------------------------------------

    def __xor__(self, other):
        if isinstance(other, BitVec):
            if len(self) != len(other):
                raise ValueError(
                    f"BitVec width mismatch: {len(self)} vs {len(other)}"
                )
            return self._wrap(self.rows ^ other.rows)
        return self._wrap(self.rows ^ self._const_rows(other, len(self)))

    __rxor__ = __xor__
    __pow__ = __xor__  # sage convenience alias, as in the reference

    def __rshift__(self, n: int):
        if n == 0:
            return self
        pad = np.zeros((min(n, len(self)), self.rows.shape[1]), dtype=np.uint64)
        return self._wrap(np.concatenate([self.rows[n:], pad], axis=0))

    def __lshift__(self, n: int):
        if n == 0:
            return self
        # for n >= width the result widens to n zero bits — matching the
        # reference's tuple arithmetic ((0,)*n + bits[:-n]); asymmetric
        # with >> (which clamps) but kept for bit-exact trace parity
        pad = np.zeros((n, self.rows.shape[1]), dtype=np.uint64)
        return self._wrap(np.concatenate([pad, self.rows[:-n]], axis=0))

    def lshift_ext(self, n: int):
        pad = np.zeros((n, self.rows.shape[1]), dtype=np.uint64)
        return self._wrap(np.concatenate([pad, self.rows], axis=0))

    def __and__(self, mask: int):
        col = _and_col_cached(len(self), mask)
        if col is None:
            return self
        return self._wrap(self.rows * col)

    __rand__ = __and__

    def __or__(self, mask):
        if isinstance(mask, BitVec):
            # Logical OR only defined when overlapping bits are constants
            # (reference __init__.py:73-90).
            a, b = (self, mask) if len(self) <= len(mask) else (mask, self)
            out = b.rows.copy()
            for i in range(len(a)):
                ca, cb = a._is_const_bit(i), b._is_const_bit(i)
                if ca is None and cb is None:
                    raise ValueError(
                        "BitVec | BitVec needs a constant bit on one side "
                        "wherever both overlap (OR of two symbolic bits is "
                        "not GF(2)-linear)"
                    )
                if ca == 1 or cb == 1:
                    out[i] = 0
                    out[i, 0] = 1
                elif ca == 0:
                    out[i] = b.rows[i]
                else:  # cb == 0
                    out[i] = a.rows[i]
            return self._wrap(out)
        bits = packing.mask_bits(len(self), mask)
        if bits.all():
            return self._wrap(self._const_rows((1 << len(self)) - 1, len(self)))
        out = self.rows * (1 - bits)[:, None].astype(np.uint64)
        out[:, 0] |= bits.astype(np.uint64)
        return self._wrap(out)

    __ror__ = __or__

    def __mod__(self, n: int):
        if n & (n - 1) != 0:
            raise ValueError("modulo non-power-of-2 is not a linear operation")
        return self & (n - 1)

    def rotr(self, n: int):
        return self._wrap(np.roll(self.rows, -n, axis=0))

    def rotl(self, n: int):
        return self._wrap(np.roll(self.rows, n, axis=0))

    def sum(self):
        acc = np.bitwise_xor.reduce(self.rows, axis=0, keepdims=True)
        return self._wrap(acc)

    def zeroext(self, n: int):
        pad = np.zeros((n, self.rows.shape[1]), dtype=np.uint64)
        return self._wrap(np.concatenate([self.rows, pad], axis=0))

    def signext(self, n: int):
        top = np.broadcast_to(self.rows[-1:], (n, self.rows.shape[1]))
        return self._wrap(np.concatenate([self.rows, top], axis=0))

    def broadcast(self, i: int, n: int):
        # np.repeat materializes ~3x faster than broadcast_to().copy()
        return self._wrap(np.repeat(self.rows[i : i + 1], n, axis=0))

    def dup(self, n: int):
        return self._wrap(np.tile(self.rows, (n, 1)))

    def concat(self, other: "BitVec"):
        return self._wrap(np.concatenate([self.rows, other.rows], axis=0))

    # -- evaluation --------------------------------------------------------

    def evaluate(self, s: int) -> int:
        """Evaluate against a raw solution int (reference __init__.py:128-134):
        bit i = parity(mask_i & ((s << 1) | 1))."""
        sol = packing.int_to_words((s << 1) | 1, self.nbits)
        if sol.shape[0] < self.rows.shape[1]:
            sol = np.pad(sol, (0, self.rows.shape[1] - sol.shape[0]))
        bits = packing.parity_rows(self.rows & sol[None, : self.rows.shape[1]])
        return packing.words_to_int(packing.pack_bits(bits))

    # -- pickling ----------------------------------------------------------

    def __reduce__(self):
        return (_rebuild_bitvec, (self.rows, self.nbits))


def _rebuild_bitvec(rows, nbits):
    return BitVec(rows, nbits)

"""Dual-mode word helpers for the symbolic PRNG models.

Every model in this package is written once and runs in two modes: with a
concrete ``int`` state (to generate reference outputs) or with a symbolic
:class:`~gf2bv_tpu.core.bitvec.BitVec` state (to trace the GF(2) system).
The handful of operations whose spelling differs between the two modes —
data-dependent selects that must be linearized, tap-parity feedback,
rotations of fixed-width words, bit extraction/concatenation — live here, so
the model classes themselves contain no ``isinstance`` branching at all.

The linearization rules match the reference models' semantics (e.g. the
broadcast-select of ``reference:gf2bv/crypto/mt.py:33-39`` and the
tap-parity reinsertion of ``reference:gf2bv/crypto/lfsr.py:31-37``)
while being expressed against this project's packed-array BitVec.

Port copy of ``gf2bv_tpu/crypto/_generic.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

from functools import reduce

from ..core.bitvec import BitVec


def select(bit, width: int, mask: int):
    """``mask`` if the LSB of ``bit`` is set, else 0.

    The GF(2)-linear form of the data-dependent select ``(bit & 1) * mask``:
    symbolically, bit 0 is broadcast across ``width`` lanes and ANDed with
    the constant mask.
    """
    if isinstance(bit, BitVec):
        return bit.broadcast(0, width) & mask
    return mask * (bit & 1)


def parity(x):
    """XOR-fold of all bits of ``x`` (a single-bit result)."""
    if isinstance(x, BitVec):
        return x.sum()
    return x.bit_count() & 1


def insert_top(bit, width: int):
    """A ``width``-wide word whose bit ``width - 1`` is the LSB of ``bit``
    and whose other bits are 0 (LFSR feedback reinsertion)."""
    if isinstance(bit, BitVec):
        return bit[0:1].lshift_ext(width - 1)
    return (bit & 1) << (width - 1)


def trunc(x, width: int):
    """Keep the low ``width`` bits.  A BitVec already has a fixed width, so
    this only does work in concrete mode."""
    if isinstance(x, BitVec):
        return x
    return x & ((1 << width) - 1)


def rotl(x, width: int, n: int):
    """Rotate a ``width``-wide word left by ``n``."""
    n %= width
    if isinstance(x, BitVec):
        return x.rotl(n)
    m = (1 << width) - 1
    return ((x << n) & m) | ((x & m) >> (width - n)) if n else x & m


def top_bits(x, width: int, k: int):
    """The high ``k`` bits of a ``width``-wide word, as a ``k``-bit value."""
    if isinstance(x, BitVec):
        return x[width - k :]
    return x >> (width - k)


def concat_words(parts, width: int):
    """Join words little-endian: ``parts[i]`` occupies bits
    ``[i * width, i * width + len(part))`` of the result."""
    if isinstance(parts[0], BitVec):
        # dispatch through the instance so lazy subclasses keep recording
        return reduce(lambda a, b: a.concat(b), parts)
    out = 0
    for i, p in enumerate(parts):
        out |= p << (i * width)
    return out

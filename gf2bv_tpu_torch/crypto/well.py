"""WELL512a (Panneton–L'Ecuyer–Matsumoto), generic over BitVec | int.

New-capability model (no analog in the reference): the WELL512 update is
pure xor/shift/constant-mask, i.e. GF(2)-linear, so full 512-bit state
recovery from ~16 outputs is a LinearSystem workload.

Port copy of ``gf2bv_tpu/crypto/well.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

from ..core.bitvec import BitVec

MASK32 = (1 << 32) - 1


def _m32(x):
    return x if isinstance(x, BitVec) else x & MASK32


class Well512:
    """State: 16 x 32-bit words + index.  One call returns one 32-bit word."""

    def __init__(self, state, index: int = 0):
        if len(state) != 16:
            raise ValueError("invalid state")
        self.s = list(state)
        self.i = index

    def __call__(self):
        s, i = self.s, self.i
        a = s[i]
        c = s[(i + 13) & 15]
        b = _m32(a ^ c ^ _m32(a << 16) ^ _m32(c << 15))
        c = s[(i + 9) & 15]
        c = c ^ (c >> 11)
        a = s[i] = _m32(b ^ c)
        d = _m32(a ^ (_m32(a << 5) & 0xDA442D24))
        i = self.i = (i + 15) & 15
        a = s[i]
        s[i] = _m32(a ^ b ^ d ^ _m32(a << 2) ^ _m32(b << 18) ^ _m32(c << 28))
        return s[i]

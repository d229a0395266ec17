"""SFMT (SIMD-oriented Fast Mersenne Twister), generic over BitVec | int.

New-capability model (no analog in the reference, which ships the scalar
MT19937 only — ``reference:gf2bv/crypto/mt.py``): the SFMT recursion
(Saito & Matsumoto 2006) is pure xor / lane-shift / 128-bit byte-shift /
constant-mask, i.e. GF(2)-linear end to end, and — unlike MT19937 — it has
NO output tempering: ``gen_rand32`` reads state words directly.  Full
19968-bit state recovery from truncated outputs is therefore a plain
LinearSystem workload at exactly the flagship MT shape.

The model follows this package's dual-mode convention (``_generic.py``):
one code path runs with concrete ``int`` words (reference stream
generation, seeded via :meth:`SFMT.from_seed` = ``init_gen_rand`` +
period certification) or with symbolic 32-bit :class:`BitVec` words.

Layout matches the canonical C implementation: the state is ``N32``
little-endian 32-bit words grouped into ``N32/4`` 128-bit lanes; the
recursion is

    r = a ^ (a <<128 8*SL2) ^ ((b >>32 SR1) & MSK) ^ (c >>128 8*SR2)
          ^ (d <<32 SL1)

with ``b`` the ``POS1``-lagged lane and ``c``/``d`` the two previously
produced lanes.

Port copy of ``gf2bv_tpu/crypto/sfmt.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

from ..core.bitvec import BitVec

MASK32 = (1 << 32) - 1


def _m32(x):
    return x if isinstance(x, BitVec) else x & MASK32


def _shift128(lanes, bits, left: bool):
    """Shift a 128-bit value (4 little-endian 32-bit lanes) by ``bits``.

    Works on int and BitVec lanes alike; ``zero`` is built as ``x ^ x`` so
    the mode (and, symbolically, the column count) is preserved.
    """
    whole, rem = divmod(bits, 32)
    zero = lanes[0] ^ lanes[0]
    out = []
    for i in range(4):
        j = i - whole if left else i + whole
        lo = lanes[j] if 0 <= j < 4 else zero
        k = j - 1 if left else j + 1
        hi = lanes[k] if 0 <= k < 4 else zero
        if rem == 0:
            out.append(lo)
        elif left:
            out.append(_m32(lo << rem) ^ (hi >> (32 - rem)))
        else:
            out.append((lo >> rem) ^ _m32(hi << (32 - rem)))
    return out


class SFMT:
    """Generic SFMT engine; parameter sets are subclasses (:class:`SFMT19937`).

    ``state`` is the flat list of ``N32`` 32-bit words (int or BitVec);
    ``index`` is the read cursor into the current block (``N32`` means
    "regenerate before the next output", as after seeding).
    """

    N32: int  # state size in 32-bit words (multiple of 4)
    POS1: int  # lane lag of the b term
    SL1: int  # per-lane left shift of the d term
    SL2: int  # 128-bit left shift of the a term, in BYTES
    SR1: int  # per-lane right shift of the b term
    SR2: int  # 128-bit right shift of the c term, in BYTES
    MSK: tuple[int, int, int, int]  # per-lane AND masks on the b term
    PARITY: tuple[int, int, int, int]  # period-certification vector

    def __init__(self, state, index: int = 0):
        state = list(state)
        if len(state) != self.N32:
            raise ValueError(f"state must be {self.N32} 32-bit words")
        if not 0 <= index <= self.N32:
            raise ValueError("index out of range")
        self.s = state
        self.idx = index

    # -- seeding (concrete only) -------------------------------------------

    @classmethod
    def from_seed(cls, seed: int) -> "SFMT":
        """``init_gen_rand``: KISS-style fill + period certification."""
        s = [seed & MASK32]
        for i in range(1, cls.N32):
            prev = s[-1]
            s.append((1812433253 * (prev ^ (prev >> 30)) + i) & MASK32)
        obj = cls(s, index=cls.N32)
        obj._certify_period()
        return obj

    def _certify_period(self):
        inner = 0
        for i in range(4):
            inner ^= self.s[i] & self.PARITY[i]
        for sh in (16, 8, 4, 2, 1):
            inner ^= inner >> sh
        if inner & 1:
            return
        for i in range(4):  # flip the lowest set parity bit
            work = 1
            for _ in range(32):
                if work & self.PARITY[i]:
                    self.s[i] ^= work
                    return
                work <<= 1

    # -- recursion -----------------------------------------------------------

    def _recursion(self, a, b, c, d):
        x = _shift128(a, 8 * self.SL2, left=True)
        y = _shift128(c, 8 * self.SR2, left=False)
        return [
            a[k]
            ^ x[k]
            ^ ((b[k] >> self.SR1) & self.MSK[k])
            ^ y[k]
            ^ _m32(d[k] << self.SL1)
            for k in range(4)
        ]

    def _gen_rand_all(self):
        s, n = self.s, self.N32 // 4

        def lane(i):
            return s[4 * i : 4 * i + 4]

        r1, r2 = lane(n - 2), lane(n - 1)
        for i in range(n):
            new = self._recursion(lane(i), lane((i + self.POS1) % n), r1, r2)
            s[4 * i : 4 * i + 4] = new
            r1, r2 = r2, new

    def __call__(self):
        """``gen_rand32``: the next 32-bit word, regenerating on block end."""
        if self.idx >= self.N32:
            self._gen_rand_all()
            self.idx = 0
        out = self.s[self.idx]
        self.idx += 1
        return out


class SFMT19937(SFMT):
    """The standard parameter set (period 2^19937 - 1); 624-word state,
    the same flagship shape as this repo's MT19937 headline solve."""

    MEXP = 19937
    N32 = 624
    POS1 = 122
    SL1 = 18
    SL2 = 1
    SR1 = 11
    SR2 = 1
    MSK = (0xDFFFFFEF, 0xDDFECB7F, 0xBFFAFFFF, 0xBFFFFFF6)
    PARITY = (0x00000001, 0x00000000, 0x00000000, 0x13C9E684)

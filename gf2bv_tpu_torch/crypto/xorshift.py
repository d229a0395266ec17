"""Marsaglia xorshift family, generic over BitVec | int.

New-capability models (no analog in the reference, which ships MT19937,
LFSRs, and xoshiro256** only — ``reference:gf2bv/crypto/``): the pure
xorshift updates are GF(2)-linear, so state recovery from outputs is a
straight LinearSystem workload.  ``Xorshift64star`` follows the
xoshiro256** pattern (``reference:gf2bv/crypto/xoshiro.py:28-37``):
its multiplicative output scrambler is inverted with a modular inverse
OUTSIDE the system via ``untemper``.

Port copy of ``gf2bv_tpu/crypto/xorshift.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

from ..core.bitvec import BitVec

MASK32 = (1 << 32) - 1
MASK64 = (1 << 64) - 1


def _m32(x):
    return x if isinstance(x, BitVec) else x & MASK32


def _m64(x):
    return x if isinstance(x, BitVec) else x & MASK64


class Xorshift32:
    """x ^= x<<13; x ^= x>>17; x ^= x<<5 (period 2^32-1)."""

    def __init__(self, x):
        self.x = x

    def __call__(self):
        x = self.x
        x = _m32(x ^ (x << 13))
        x = x ^ (x >> 17)
        x = _m32(x ^ (x << 5))
        self.x = x
        return x


class Xorshift64:
    """x ^= x<<13; x ^= x>>7; x ^= x<<17 (period 2^64-1)."""

    def __init__(self, x):
        self.x = x

    def __call__(self):
        x = self.x
        x = _m64(x ^ (x << 13))
        x = x ^ (x >> 7)
        x = _m64(x ^ (x << 17))
        self.x = x
        return x


class Xorshift128:
    """Marsaglia xorshift128: four 32-bit words, period 2^128-1."""

    def __init__(self, s):
        if len(s) != 4:
            raise ValueError("invalid state")
        self.s = list(s)

    def __call__(self):
        x, y, z, w = self.s
        t = _m32(x ^ (x << 11))
        t = t ^ (t >> 8)
        w_new = (w >> 19) ^ w ^ t
        self.s = [y, z, w, w_new]
        return w_new


class Xorshift64star:
    """xorshift64* : linear state update, output = state * M (mod 2^64).

    The multiply is not GF(2)-linear; ``untemper`` inverts it with the
    modular inverse so callers build equations against ``step()`` outputs,
    exactly like the reference handles xoshiro256**'s scrambler."""

    M = 0x2545F4914F6CDD1D
    M_INV = pow(M, -1, 1 << 64)

    def __init__(self, x):
        self.x = x

    def step(self):
        x = self.x
        x = x ^ (x >> 12)
        x = _m64(x ^ (x << 25))
        x = x ^ (x >> 27)
        self.x = x
        return x

    @staticmethod
    def temper(x):
        return (x * Xorshift64star.M) & MASK64

    @staticmethod
    def untemper(out):
        return (out * Xorshift64star.M_INV) & MASK64

    def __call__(self):
        return self.temper(self.step())


class Xorshift128Plus:
    """xorshift128+ (Vigna) — the engine behind V8's ``Math.random()``.

    Two 64-bit words of state; the transition is pure shift/xor and
    therefore GF(2)-linear::

        s1, s0 = state0, state1
        s1 ^= s1 << 23;  s1 ^= s1 >> 17;  s1 ^= s0;  s1 ^= s0 >> 26
        state0, state1 = s0, s1

    The canonical "+" output ``state0 + state1`` involves a carry chain and
    is NOT GF(2)-linear, so ``__call__`` is concrete-only.  V8 never uses
    it for ``Math.random()`` anyway: its double is built from ``state0``
    alone after the shift (bits [12, 64) become the mantissa), which IS
    linear — :meth:`step` returns exactly that word, so observed doubles
    turn into linear equations directly.  See :class:`V8MathRandom`.

    Follows the reference's pattern of keeping non-linear output maps
    outside the system (``reference:gf2bv/crypto/xoshiro.py:28-37``).
    """

    def __init__(self, s0, s1):
        self.s0 = s0
        self.s1 = s1

    def step(self):
        """Advance the state; return the new ``state0`` (GF(2)-linear)."""
        s1, s0 = self.s0, self.s1
        s1 = _m64(s1 ^ (s1 << 23))
        s1 = s1 ^ (s1 >> 17)
        s1 = s1 ^ s0
        s1 = s1 ^ (s0 >> 26)
        self.s0, self.s1 = s0, s1
        return self.s0

    def __call__(self):
        """The xorshift128+ output ``(state0 + state1) mod 2^64``.

        Integer addition is not GF(2)-linear; only concrete states can
        produce this output."""
        if isinstance(self.s0, BitVec) or isinstance(self.s1, BitVec):
            raise TypeError(
                "the xorshift128+ '+' output is not GF(2)-linear; build "
                "equations against step() outputs instead (V8's Math.random "
                "double uses only state0, which step() returns)"
            )
        self.step()
        return (self.s0 + self.s1) & MASK64


class V8MathRandom:
    """Concrete simulation of V8's ``Math.random()`` (node / Chrome).

    Semantics of V8's ``base::RandomNumberGenerator`` (public V8 source,
    ``src/base/utils/random-number-generator.h``):

    - state transition ``XorShift128`` == :meth:`Xorshift128Plus.step`;
    - ``ToDouble(state0)`` builds the double from bits [12, 64) of the
      *new* ``state0``: ``((state0 >> 12) | 0x3FF0...) as f64 - 1.0``,
      i.e. ``(state0 >> 12) * 2**-52``;
    - ``Math.random`` draws from a 64-entry cache that is filled in
      generation order and consumed in REVERSE (``cache[--index]``), the
      famous quirk every recovery script must model.

    This class is for generating/checking concrete observations; the
    symbolic side is plain :class:`Xorshift128Plus` tracing (see
    ``examples/v8_math_random.py``).
    """

    CACHE_SIZE = 64

    def __init__(self, s0: int, s1: int):
        self._engine = Xorshift128Plus(s0 & MASK64, s1 & MASK64)
        self._cache: list[int] = []

    @staticmethod
    def to_double(state0: int) -> float:
        """V8's ToDouble: mantissa = bits [12, 64) of state0."""
        return (state0 >> 12) * 2.0**-52

    @staticmethod
    def mantissa(d: float) -> int:
        """Inverse of :meth:`to_double`: the 52 observed state0 bits."""
        if not 0.0 <= d < 1.0:
            raise ValueError("Math.random() outputs lie in [0, 1)")
        return int(d * (1 << 52))

    def random(self) -> float:
        if not self._cache:
            self._cache = [
                self._engine.step() for _ in range(self.CACHE_SIZE)
            ]
        return self.to_double(self._cache.pop())

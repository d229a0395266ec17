"""xoshiro256** (Blackman-Vigna).

The state transition is GF(2)-linear, so it traces directly; the ``*5,
rotl 7, *9`` output scrambler is modular arithmetic, NOT GF(2)-linear, so —
as in the reference model (``reference:gf2bv/crypto/xoshiro.py``) —
callers invert it outside the system with :func:`Xoshiro256starstar.untemper`
and build equations against the raw ``step()`` outputs.

The transition is written here as a pure dataflow function of the old state
(each new word as an explicit formula) rather than a sequence of in-place
updates; the two forms are bit-identical.

Port copy of ``gf2bv_tpu/crypto/xoshiro.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

import secrets

from ._generic import rotl, trunc

_W = 64
_M64 = (1 << _W) - 1
_INV5 = pow(5, -1, 1 << _W)
_INV9 = pow(9, -1, 1 << _W)


def _next_state(s0, s1, s2, s3):
    """One xoshiro256 transition, as formulas over the previous state."""
    return (
        s0 ^ s3 ^ s1,
        s1 ^ s2 ^ s0,
        s2 ^ s0 ^ trunc(s1 << 17, _W),
        rotl(s3 ^ s1, _W, 45),
    )


class Xoshiro256starstar:
    """Four 64-bit words of state; output = scramble(s1) before stepping."""

    def __init__(self, s):
        if len(s) != 4:
            raise ValueError("xoshiro256 state must be 4 words")
        self.s = list(s)

    @classmethod
    def generate(cls) -> "Xoshiro256starstar":
        return cls([secrets.randbits(_W) for _ in range(4)])

    @staticmethod
    def temper(word: int) -> int:
        """The ** output scrambler: rotl64(s1 * 5, 7) * 9."""
        return rotl(word * 5 & _M64, _W, 7) * 9 & _M64

    @staticmethod
    def untemper(out: int) -> int:
        """Inverse scrambler (modular inverses of 9 and 5, rotate back)."""
        return rotl(out * _INV9 & _M64, _W, _W - 7) * _INV5 & _M64

    def step(self):
        """Advance the state; return the pre-step s1 (the linear output)."""
        result = self.s[1]
        self.s = list(_next_state(*self.s))
        return result

    def __call__(self):
        return self.temper(self.step())


def _next_state128(s0, s1):
    """One xoroshiro128 transition (a=24, b=16, c=37), as formulas."""
    t = s1 ^ s0
    return (
        rotl(s0, _W, 24) ^ t ^ trunc(t << 16, _W),
        rotl(t, _W, 37),
    )


class Xoroshiro128starstar:
    """xoroshiro128** (Blackman-Vigna): two 64-bit words of state.

    Same shape as :class:`Xoshiro256starstar` (and the reference model it
    mirrors, ``reference:gf2bv/crypto/xoshiro.py``): the rotl/shift/
    xor transition is GF(2)-linear; the ``*5, rotl 7, *9`` scrambler is
    inverted outside the system with :meth:`untemper`.  Output reads the
    pre-step ``s0``.
    """

    def __init__(self, s):
        if len(s) != 2:
            raise ValueError("xoroshiro128 state must be 2 words")
        self.s = list(s)

    @classmethod
    def generate(cls) -> "Xoroshiro128starstar":
        return cls([secrets.randbits(_W) for _ in range(2)])

    temper = staticmethod(Xoshiro256starstar.temper)
    untemper = staticmethod(Xoshiro256starstar.untemper)

    def step(self):
        """Advance the state; return the pre-step s0 (the linear output)."""
        result = self.s[0]
        self.s = list(_next_state128(*self.s))
        return result

    def __call__(self):
        return self.temper(self.step())

"""Mersenne Twister family (generic parameters + the MT19937 instance).

Model semantics follow the reference (``reference:gf2bv/crypto/mt.py``):
the same generator code runs concretely (``int`` state) or symbolically
(:class:`BitVec` state), and the one data-dependent operation in the twist —
conditionally XORing the matrix constant ``a`` depending on the parity bit —
is linearized through :func:`._generic.select`.  ``getrandbits`` reproduces
CPython's ``random.getrandbits`` output layout exactly (each generated word
contributes its TOP ``k`` bits; multi-word requests are little-endian joins),
which is what makes recovered states verifiable against ``random.Random``.

Port copy of ``gf2bv_tpu/crypto/mt.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

import random

from ._generic import concat_words, select, top_bits


class MersenneTwister:
    """Generic Mersenne Twister over parameters (w, n, m, r, a, u, d, s, b,
    t, c, l) in Matsumoto-Nishimura notation.  ``mt`` is the length-``n``
    state, each word either an int or a ``w``-bit BitVec."""

    def __init__(self, mt, w, n, m, r, a, u, d, s, b, t, c, l):  # noqa: E741
        word_max = (1 << w) - 1
        # Per-parameter validation.  (The reference folds this into one
        # combined min/max expression, mt.py:9, which only rejects inputs
        # when *both* the shift group and the mask group are out of range;
        # here each constraint is checked on its own.)
        if len(mt) != n:
            raise ValueError(f"state must have exactly {n} words")
        if not 0 < m < n:
            raise ValueError("middle offset m must satisfy 0 < m < n")
        if not 0 <= r <= w:
            raise ValueError("separation point r must satisfy 0 <= r <= w")
        for name, shift in (("u", u), ("s", s), ("t", t), ("l", l)):
            if not 0 < shift <= w:
                raise ValueError(f"tempering shift {name} must be in 1..w")
        for name, mask in (("a", a), ("d", d), ("b", b), ("c", c)):
            if mask & ~word_max:
                raise ValueError(f"constant {name} does not fit in {w} bits")

        self.w, self.n, self.m, self.r = w, n, m, r
        self.a, self.u, self.d, self.s = a, u, d, s
        self.b, self.t, self.c, self.l = b, t, c, l
        self.w1 = word_max
        self.lmsk = word_max >> (w - r) if r else 0
        self.umsk = word_max ^ self.lmsk

        self.mt = list(mt)
        self.mti = n  # exhausted: first output forces a twist

    # -- state transition ----------------------------------------------------

    def twist(self):
        """Advance all n words in place.  Words at index >= n - m mix with
        already-twisted words, matching the in-place reference recurrence."""
        st, n = self.mt, self.n
        for i in range(n):
            y = (st[i] & self.umsk) ^ (st[i + 1 if i + 1 < n else 0] & self.lmsk)
            st[i] = st[(i + self.m) % n] ^ (y >> 1) ^ select(y, self.w, self.a)

    def temper(self, y):
        y ^= (y >> self.u) & self.d
        for shift, mask in ((self.s, self.b), (self.t, self.c)):
            y ^= (y << shift) & self.w1 & mask
        return y ^ (y >> self.l)

    def __call__(self):
        if self.mti >= self.n:
            self.twist()
            self.mti = 0
        word = self.temper(self.mt[self.mti])
        self.mti += 1
        return word

    # -- CPython-compatible output -------------------------------------------

    def getrandbits(self, k: int | None = None):
        """``random.getrandbits(k)``: per generated word, take the top
        ``min(remaining, w)`` bits; words join little-endian."""
        if k is None:
            k = self.w
        if k < 0:
            raise ValueError("number of bits cannot be negative")
        if k == 0:
            return 0
        full, rem = divmod(k, self.w)
        widths = [self.w] * full + ([rem] if rem else [])
        return concat_words([top_bits(self(), self.w, c) for c in widths], self.w)


class MT19937(MersenneTwister):
    """The standard 32-bit MT19937 parameter set."""

    PARAMS = dict(
        w=32, n=624, m=397, r=31,
        a=0x9908B0DF,
        u=11, d=0xFFFFFFFF,
        s=7, b=0x9D2C5680,
        t=15, c=0xEFC60000,
        l=18,
    )

    # init_genrand's Knuth-line multiplier (mt19937ar.c; also what C++
    # std::mt19937's seed(value) uses per [rand.eng.mers])
    SEED_F = 1812433253

    def __init__(self, mt):
        super().__init__(mt, **self.PARAMS)

    @classmethod
    def from_seed(cls, seed: int):
        """Seed exactly like ``init_genrand`` / ``std::mt19937(seed)``:
        ``mt[0] = seed``; ``mt[i] = f*(mt[i-1] ^ (mt[i-1] >> (w-2))) + i``.
        (Concrete-only — seeding multiplies, which is not GF(2)-linear.)"""
        return cls(_seed_array(seed, cls.PARAMS["w"], cls.PARAMS["n"], cls.SEED_F))

    def to_python_random(self) -> random.Random:
        """Export the current state into a CPython ``random.Random`` (state
        tuple format: version 3, 624 words + the output index)."""
        rng = random.Random()
        rng.setstate((3, tuple(self.mt) + (self.mti,), None))
        return rng


class MT19937_64(MersenneTwister):
    """The 64-bit MT19937-64 parameter set (``std::mt19937_64``,
    mt19937-64.c).  Same generic machinery as the 32-bit twin — the state is
    312 64-bit words (19968 unknown bits, the same flagship scale), and the
    whole generator is GF(2)-linear, so state recovery from ~320 observed
    outputs is the identical attack.  The reference ships only the 32-bit
    instance (``reference:gf2bv/crypto/mt.py:84-102``); this class is
    new surface its generic-parameter design makes one PARAMS dict away."""

    PARAMS = dict(
        w=64, n=312, m=156, r=31,
        a=0xB5026F5AA96619E9,
        u=29, d=0x5555555555555555,
        s=17, b=0x71D67FFFEDA60000,
        t=37, c=0xFFF7EEE000000000,
        l=43,
    )

    SEED_F = 6364136223846793005  # init_genrand64's multiplier

    def __init__(self, mt):
        super().__init__(mt, **self.PARAMS)

    @classmethod
    def from_seed(cls, seed: int):
        """Seed exactly like ``init_genrand64`` / ``std::mt19937_64(seed)``."""
        return cls(_seed_array(seed, cls.PARAMS["w"], cls.PARAMS["n"], cls.SEED_F))


def _seed_array(seed: int, w: int, n: int, f: int) -> list[int]:
    mask = (1 << w) - 1
    mt = [seed & mask]
    for i in range(1, n):
        prev = mt[-1]
        mt.append((f * (prev ^ (prev >> (w - 2))) + i) & mask)
    return mt

"""PHP ``mt_rand`` — both engine modes, symbolic or concrete.

PHP's ``mt_rand()`` is MT19937 with a 31-bit output (``temper(word) >> 1``)
and, historically, a buggy reload: the legacy ``MT_RAND_PHP`` mode XORs the
matrix constant on the parity of ``s[i]`` (``loBit(u)``) where standard
MT19937 uses the parity of the mixed word (= ``loBit(s[i+1])``).  PHP 7.1
added the corrected ``MT_RAND_MT19937`` mode and kept the legacy one behind
``mt_srand(seed, MT_RAND_PHP)``.  Both twists are GF(2)-linear, so state
recovery from raw 31-bit outputs is the same linear solve as for CPython's
Mersenne Twister — this model runs symbolically for exactly that attack
(see ``examples/php_mt_rand.py``).

The reference has no PHP model; this extends its crypto library pattern
(generic-over-``BitVec|int`` generators, ``reference:gf2bv/crypto/
mt.py:31-39``) to a new real-world family.  Seeding (``mt_srand``) is the
standard ``init_genrand`` recurrence — concrete-only, since it multiplies.
Range draws (``mt_rand(min, max)``) are concrete-only too: the modern mode
uses PHP 8's modulo-rejection ``rand_range32`` and the legacy mode the
float "bad scaling" macro; both consume raw draws, so a recovered state
reproduces them exactly.

Port copy of ``gf2bv_tpu/crypto/php.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

from ._generic import select
from .mt import MT19937

MT_RAND_MT19937 = 0
MT_RAND_PHP = 1

_PHP_MT_RAND_MAX = 0x7FFFFFFF
_U32 = 0xFFFFFFFF


class PHPMtRand(MT19937):
    """``mt_rand`` over an explicit 624-word state (int or 32-bit BitVec).

    ``mode`` selects the reload recurrence: ``MT_RAND_MT19937`` (PHP >= 7.1
    default, standard twist) or ``MT_RAND_PHP`` (the pre-7.1 ``loBit(u)``
    twist).  Calling the instance returns one ``mt_rand()`` draw: the
    tempered word shifted right once (31 bits)."""

    def __init__(self, mt, mode: int = MT_RAND_MT19937):
        if mode not in (MT_RAND_MT19937, MT_RAND_PHP):
            raise ValueError("mode must be MT_RAND_MT19937 or MT_RAND_PHP")
        super().__init__(mt)
        self.mode = mode

    @classmethod
    def from_seed(cls, seed: int, mode: int = MT_RAND_MT19937):
        """``mt_srand(seed, mode)``: php_mt_initialize is init_genrand."""
        rng = MT19937.from_seed(seed)
        return cls(rng.mt, mode)

    # -- state transition ------------------------------------------------

    def twist(self):
        """Reload all 624 words in place.  The legacy mode's only delta is
        the select operand: parity of the untwisted ``s[i]`` instead of the
        mixed word's parity (= ``s[i+1]``'s LSB)."""
        if self.mode == MT_RAND_MT19937:
            return super().twist()
        st, n = self.mt, self.n
        for i in range(n):
            u = st[i]
            y = (u & self.umsk) ^ (st[i + 1 if i + 1 < n else 0] & self.lmsk)
            st[i] = st[(i + self.m) % n] ^ (y >> 1) ^ select(u, self.w, self.a)

    # -- outputs -----------------------------------------------------------

    def rand_raw(self):
        """One full 32-bit tempered word (php_mt_rand)."""
        return MT19937.__call__(self)

    def __call__(self):
        """``mt_rand()``: the tempered word >> 1, a 31-bit value.  Works
        symbolically (the shift is a row drop on the packed BitVec)."""
        return self.rand_raw() >> 1

    def mt_rand(self, min: int | None = None, max: int | None = None):
        """``mt_rand()`` or ``mt_rand(min, max)``.  The range form is
        concrete-only (rejection/float scaling is not GF(2)-linear)."""
        if min is None and max is None:
            return self()
        if min is None or max is None or min > max:
            raise ValueError("mt_rand(min, max) needs min <= max")
        if not isinstance(self.mt[0], int):
            raise TypeError("mt_rand(min, max) is concrete-only")
        if self.mode == MT_RAND_PHP:
            # RAND_RANGE_BADSCALING(n, min, max, PHP_MT_RAND_MAX)
            n = self()
            return min + int(
                (float(max) - min + 1.0) * (n / (_PHP_MT_RAND_MAX + 1.0))
            )
        umax = max - min
        if umax == _U32:
            return min + self.rand_raw()
        umax += 1
        if umax & (umax - 1) == 0:  # power of two: mask, no rejection
            return min + (self.rand_raw() & (umax - 1))
        limit = _U32 - (_U32 % umax) - 1
        result = self.rand_raw()
        while result > limit:
            result = self.rand_raw()
        return min + result % umax

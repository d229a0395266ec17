"""Combined Tausworthe generators (L'Ecuyer): taus88 and LFSR113.

New-capability models (no analog in the reference, which ships MT/LFSR/
xoshiro only — ``reference:gf2bv/crypto/``): the maximally-equidistributed
combined LFSR generators of L'Ecuyer 1996 ("Maximally equidistributed
combined Tausworthe generators", taus88 — GSL's ``taus``) and 1999
("Tables of maximally equidistributed combined LFSR generators", LFSR113).
Each 32-bit component steps

    z' = ((z & mask) << d) ^ (((z << q) ^ z) >> s)

and the output is the XOR of the components — shifts, masks and XORs only,
so the whole generator is GF(2)-linear and state recovery from a handful of
outputs is a ``LinearSystem`` solve.

Written in the package's dual-mode style (``int`` | ``BitVec`` state, no
``isinstance`` branching beyond the 32-bit truncation helper).

Recovery contract: each component ignores some low bits of its *initial*
word (bits below ``min(s - q, trailing zero bits of mask)`` never reach any
output — the same bits whose being zeroable makes seeds below the published
thresholds invalid).  The solution space of a recovery therefore has
dimension ``DONT_CARE_DIMS`` (8 for taus88, 15 for LFSR113); any point of
it replays and predicts the stream exactly, like numpy's dim-31 MT space
(``examples/numpy_random.py``).

Port copy of ``gf2bv_tpu/crypto/taus.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

from functools import reduce

from ..core.bitvec import BitVec

MASK32 = 0xFFFFFFFF


def _m32(x):
    return x if isinstance(x, BitVec) else x & MASK32


class Tausworthe:
    """Generic combined Tausworthe: ``components`` is a sequence of
    ``(q, s, mask, d)`` tuples, ``state`` the matching 32-bit words."""

    def __init__(self, components, state):
        if len(components) != len(state):
            raise ValueError("one state word per component")
        self.components = tuple(components)
        self.state = list(state)

    def __call__(self):
        for i, (q, s, mask, d) in enumerate(self.components):
            z = self.state[i]
            b = (_m32(z << q) ^ z) >> s
            self.state[i] = _m32((z & mask) << d) ^ b
        return reduce(lambda a, b: a ^ b, self.state)


TAUS88_PARAMS = (
    (13, 19, 0xFFFFFFFE, 12),
    (2, 25, 0xFFFFFFF8, 4),
    (3, 11, 0xFFFFFFF0, 17),
)

LFSR113_PARAMS = (
    (6, 13, 0xFFFFFFFE, 18),
    (2, 27, 0xFFFFFFF8, 2),
    (13, 21, 0xFFFFFFF0, 7),
    (3, 12, 0xFFFFFF80, 13),
)


def dont_care_dims(params) -> int:
    """Initial-state bits per component that never reach any output."""
    total = 0
    for q, s, mask, _ in params:
        low_zeros = (mask & -mask).bit_length() - 1
        total += min(s - q, low_zeros)
    return total


class Taus88(Tausworthe):
    """L'Ecuyer 1996 three-component generator (GSL ``taus``), period ~2^88."""

    def __init__(self, state):
        super().__init__(TAUS88_PARAMS, state)


class LFSR113(Tausworthe):
    """L'Ecuyer 1999 four-component generator, period ~2^113."""

    def __init__(self, state):
        super().__init__(LFSR113_PARAMS, state)

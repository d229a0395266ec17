"""Linear-feedback shift registers in Galois and Fibonacci form.

Semantics match the reference models (``reference:gf2bv/crypto/lfsr.py``):
both forms shift right and emit the pre-shift LSB, the Galois form XORs the
tap mask under the output bit (linearized via :func:`._generic.select`), the
Fibonacci form reinserts the tap parity at the top bit.  Written against the
dual-mode helpers so the classes run unchanged on ``int`` or ``BitVec``
state.

Port copy of ``gf2bv_tpu/crypto/lfsr.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

from ._generic import insert_top, parity, select


class GaloisLFSR:
    """width-``n`` Galois LFSR: ``out = s & 1; s = (s >> 1) ^ (out ? mask : 0)``."""

    def __init__(self, n: int, mask: int, state):
        self.n = n
        wrap = (1 << n) - 1
        self.mask = mask & wrap
        self.state = state & wrap

    def __call__(self):
        out = self.state & 1
        self.state = (self.state >> 1) ^ select(out, self.n, self.mask)
        return out


class FibonacciLFSR:
    """width-``n`` Fibonacci LFSR: ``out = s & 1; s = (s >> 1) | (<s, mask> << (n-1))``."""

    def __init__(self, n: int, mask: int, state):
        self.n = n
        wrap = (1 << n) - 1
        self.mask = mask & wrap
        self.state = state & wrap

    def __call__(self):
        out = self.state & 1
        feedback = parity(self.state & self.mask)
        # the top bit of (state >> 1) is always 0, so XOR == OR here
        self.state = (self.state >> 1) ^ insert_top(feedback, self.n)
        return out

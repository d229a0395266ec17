"""Berlekamp–Massey over GF(2): recover the minimal LFSR behind a bit stream.

The reference library (``reference:gf2bv/crypto/lfsr.py``) models LFSRs
with *known* taps and leaves the taps-recovery half of the classic workflow to
the user.  This module closes that gap: given any finite bit sequence it
returns the shortest linear recurrence generating it (its linear complexity
``L`` and connection polynomial), plus a converter into this package's
:class:`~gf2bv_tpu_torch.crypto.lfsr.FibonacciLFSR` tap convention so the recovered
register composes directly with the symbolic solver (recover taps from one
full leak, then solve a *sparse* leak of a fresh session with
``LinearSystem``).

Conventions
-----------
``berlekamp_massey`` returns ``(L, C)`` where ``C`` is the connection
polynomial as an int bitmask (bit ``i`` = coefficient of ``x**i``; bit 0 is
always set) satisfying, for all ``t >= L``::

    bits[t] = XOR_{i=1..L, C>>i & 1} bits[t - i]

A :class:`FibonacciLFSR` of width ``n`` emits ``o[t+n] = parity(mask & state)``
where state bit ``j`` holds ``o[t+j]``, i.e. ``o[s] = XOR_{j in mask} o[s-n+j]``.
Matching the two gives ``mask bit (L - i) = C bit i`` — the coefficient
bit-reversal done by :func:`fibonacci_taps`.

Uniqueness needs at least ``2 * L`` bits of stream; with fewer, the returned
register still reproduces every provided bit (tested), it just may not be the
generator's true minimal polynomial.

Port copy of ``gf2bv_tpu/crypto/bm.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

from .lfsr import FibonacciLFSR, GaloisLFSR


def berlekamp_massey(bits) -> tuple[int, int]:
    """Minimal GF(2) linear recurrence for ``bits``.

    Returns ``(L, C)``: the linear complexity and the connection polynomial
    as an int bitmask (bit ``i`` = coefficient of ``x**i``).  ``(0, 1)`` for
    the all-zero (or empty) stream.
    """
    bits = [int(b) & 1 for b in bits]
    C = 1  # current connection polynomial
    B = 1  # polynomial before the last length change
    L = 0
    m = 1  # steps since the last length change
    for n, s in enumerate(bits):
        # discrepancy between the stream and the current recurrence
        d = s
        poly = C >> 1
        i = 1
        while poly and i <= L:
            if poly & 1:
                d ^= bits[n - i]
            poly >>= 1
            i += 1
        if d:
            T = C
            C ^= B << m
            if 2 * L <= n:
                L = n + 1 - L
                B = T
                m = 1
            else:
                m += 1
        else:
            m += 1
    return L, C


def linear_complexity_profile(bits) -> list[int]:
    """Linear complexity of every prefix: ``out[k] = L(bits[:k+1])``.

    The standard randomness diagnostic (a truly random stream tracks
    ``k / 2``); computed in one Berlekamp–Massey pass, so it costs the same
    as a single :func:`berlekamp_massey` call.
    """
    bits = [int(b) & 1 for b in bits]
    profile = []
    C, B, L, m = 1, 1, 0, 1
    for n, s in enumerate(bits):
        d = s
        poly = C >> 1
        i = 1
        while poly and i <= L:
            if poly & 1:
                d ^= bits[n - i]
            poly >>= 1
            i += 1
        if d:
            T = C
            C ^= B << m
            if 2 * L <= n:
                L, B, m = n + 1 - L, T, 1
            else:
                m += 1
        else:
            m += 1
        profile.append(L)
    return profile


def fibonacci_taps(bits) -> tuple[int, int]:
    """Berlekamp–Massey, reported in :class:`FibonacciLFSR` tap convention.

    Returns ``(L, mask)`` such that ``FibonacciLFSR(L, mask, state)`` with
    ``state`` packing the first ``L`` stream bits (bit ``k`` = ``bits[k]``)
    reproduces the stream.
    """
    L, C = berlekamp_massey(bits)
    mask = 0
    for i in range(1, L + 1):
        if (C >> i) & 1:
            mask |= 1 << (L - i)
    return L, mask


def lfsr_from_stream(bits) -> FibonacciLFSR:
    """The shortest :class:`FibonacciLFSR` that replays ``bits`` exactly.

    The register is returned in the state *preceding* ``bits[0]``: calling it
    ``len(bits)`` times yields the input stream, and further calls extend it
    by the recovered recurrence.  Raises ``ValueError`` on an all-zero or
    empty stream (linear complexity 0 — no register to return).
    """
    bits = [int(b) & 1 for b in bits]
    L, mask = fibonacci_taps(bits)
    if L == 0:
        raise ValueError("stream has linear complexity 0 (all zeros)")
    state = 0
    for k, b in enumerate(bits[:L]):
        state |= b << k
    return FibonacciLFSR(L, mask, state)


def galois_taps(bits) -> tuple[int, int]:
    """Berlekamp–Massey, reported in :class:`GaloisLFSR` tap convention.

    A width-``L`` Galois register with mask ``g`` emits a stream whose
    connection polynomial is ``C(x) = 1 + x * g(x)`` (bit ``j`` of ``g`` =
    coefficient of ``x**j``) — verified empirically and by the update
    matrix's companion form — so the conversion is just ``g = C >> 1``.
    """
    L, C = berlekamp_massey(bits)
    return L, C >> 1


def galois_lfsr_from_stream(bits) -> GaloisLFSR:
    """The shortest :class:`GaloisLFSR` that replays ``bits`` exactly.

    The initial state back-substitutes from the outputs: ``s0[0] = bits[0]``
    and, since each step shifts the state down and folds the output bit into
    the tap positions, ``s0[k] = bits[k] ^ XOR_{i<k} bits[i] * g[k-1-i]``.
    Raises ``ValueError`` on an all-zero or empty stream.
    """
    bits = [int(b) & 1 for b in bits]
    L, g = galois_taps(bits)
    if L == 0:
        raise ValueError("stream has linear complexity 0 (all zeros)")
    state = 0
    for k in range(L):
        b = bits[k]
        for i in range(k):
            b ^= bits[i] & (g >> (k - 1 - i)) & 1
        state |= b << k
    return GaloisLFSR(L, g, state)

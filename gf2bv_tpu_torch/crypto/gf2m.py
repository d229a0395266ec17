"""GF(2^m) extension-field arithmetic, generic over BitVec | int.

New-capability model (no analog in the reference, whose models are all
word-level PRNGs — ``reference:gf2bv/crypto/``): in a binary
extension field, multiplication by a KNOWN element and squaring (the
Frobenius map) are GF(2)-LINEAR maps over the m coefficient bits.  Any
equation chain whose products each have at least one known operand is
therefore a LinearSystem workload — GHASH/POLYVAL tags, AES-GCM forgery
constructions, Galois-field LFSRs, Reed-Solomon-style syndromes.

Products of two symbolic elements are quadratic and rejected with a
TypeError (the QuadraticSystem path could linearize them, but every
practical GHASH-class attack has a known key-side operand).

Representation (:class:`GF2m`): natural polynomial basis — int/BitVec bit
``i`` is the coefficient of ``x^i``; the modulus includes the ``x^m``
term.  :class:`GHASH` wraps the NIST SP 800-38D convention (bit 0 = MSB,
right-shift reduction with ``R = 0xE1 << 120``) so blocks are plain
``int.from_bytes(b, "big")`` values.

The data-dependent reduction select is linearized with ``broadcast(i, m)
& mask`` — the same pattern as the reference's GaloisLFSR feedback
(``reference:gf2bv/crypto/lfsr.py:13-17``).

Port copy of ``gf2bv_tpu/crypto/gf2m.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

from ..core.bitvec import BitVec

#: x^128 + x^7 + x^2 + x + 1 (the GCM field polynomial, natural basis)
GCM_MODULUS = (1 << 128) | 0x87


class GF2m:
    """GF(2)[x] / (modulus), natural (little-endian) polynomial basis."""

    def __init__(self, m: int, modulus: int):
        if modulus >> m != 1:
            raise ValueError("modulus must have degree exactly m")
        if not modulus & 1:
            raise ValueError("modulus must have a nonzero constant term")
        self.m = m
        self.modulus = modulus
        self._low = modulus ^ (1 << m)  # reduction mask for the dropped bit

    # -- primitive ops ------------------------------------------------------

    def xtime(self, a):
        """Multiply by x (one reduction step).  a: BitVec | int."""
        m = self.m
        if isinstance(a, BitVec):
            if len(a) != m:
                raise ValueError(f"element width must be {m}")
            shifted = (a << 1)[:m]  # BitVec << widens; keep the low m bits
            return shifted ^ (a.broadcast(m - 1, m) & self._low)
        t = a << 1
        if (t >> m) & 1:
            t ^= self.modulus
        return t

    def mul(self, a, b):
        """Field product; at most one operand may be symbolic.

        Symbolic path: ``a·b = XOR_i a_i · (x^i·b)`` with the per-bit
        constants ``x^i·b`` computed concretely — m broadcast-AND-XOR row
        ops, one per coefficient bit."""
        if isinstance(a, BitVec) and isinstance(b, BitVec):
            raise TypeError(
                "GF(2^m) product of two symbolic elements is quadratic; "
                "one operand must be a known constant"
            )
        if isinstance(b, BitVec):
            a, b = b, a
        m = self.m
        if isinstance(a, BitVec):
            if len(a) != m:
                raise ValueError(f"element width must be {m}")
            b &= (1 << m) - 1
            acc = None
            cur = b
            for i in range(m):
                term = a.broadcast(i, m) & cur
                acc = term if acc is None else acc ^ term
                cur = self.xtime(cur)
            return acc
        r = 0
        cur = a & ((1 << m) - 1)
        for i in range(m):
            if (b >> i) & 1:
                r ^= cur
            cur = self.xtime(cur)
        return r

    def square(self, a):
        """Frobenius map a^2 — GF(2)-linear: coefficient i lands on
        ``x^(2i) mod modulus``."""
        m = self.m
        if isinstance(a, BitVec):
            if len(a) != m:
                raise ValueError(f"element width must be {m}")
            acc = None
            cur = 1
            for i in range(m):
                term = a.broadcast(i, m) & cur
                acc = term if acc is None else acc ^ term
                cur = self.xtime(self.xtime(cur))  # cur = x^(2(i+1))
            return acc
        return self.mul(a, a)

    # -- concrete-only helpers ----------------------------------------------

    def pow(self, a: int, e: int) -> int:
        """Square-and-multiply (concrete ints only)."""
        r, base = 1, a
        while e:
            if e & 1:
                r = self.mul(r, base)
            base = self.mul(base, base)
            e >>= 1
        return r

    def inv(self, a: int) -> int:
        """Multiplicative inverse via a^(2^m - 2) (concrete ints only)."""
        if a == 0:
            raise ZeroDivisionError("0 has no inverse in GF(2^m)")
        return self.pow(a, (1 << self.m) - 2)


#: SP 800-38D reduction constant (x^128 ≡ R in the GHASH bit order)
_GHASH_R = 0xE1 << 120
_M128 = (1 << 128) - 1


class GHASH:
    """GHASH_H over 128-bit blocks, NIST SP 800-38D bit order.

    Blocks are 128-bit values with the spec's convention: ``bit 0`` is the
    MSB of ``int.from_bytes(block, "big")``.  The key-side operand H is
    concrete; message blocks may be symbolic BitVecs — every ``·H`` is then
    a linear map, so GHASH preimages/forgeries are LinearSystem workloads
    (see ``examples/gcm_forgery.py``).
    """

    def __init__(self, h: int):
        self.h = h & _M128
        tab = []
        v = self.h
        for _ in range(128):
            tab.append(v)
            v = self._mulx(v)
        self._tab = tab  # tab[i] = H · x^i in spec order

    @staticmethod
    def _mulx(v: int) -> int:
        """Multiply by x in the GHASH bit order (right shift + R)."""
        return (v >> 1) ^ (_GHASH_R if v & 1 else 0)

    def mul_h(self, x):
        """x · H.  x: BitVec (width 128) | int."""
        if isinstance(x, BitVec):
            if len(x) != 128:
                raise ValueError("GHASH blocks are 128 bits wide")
            acc = None
            for j in range(128):
                # int bit j is spec bit 127 - j
                term = x.broadcast(j, 128) & self._tab[127 - j]
                acc = term if acc is None else acc ^ term
            return acc
        z = 0
        x &= _M128
        for i in range(128):
            if (x >> (127 - i)) & 1:
                z ^= self._tab[i]
        return z

    def process(self, blocks):
        """GHASH over already-padded 128-bit blocks:
        ``Y_0 = 0; Y_i = (Y_{i-1} ^ X_i) · H``; returns ``Y_n``."""
        y = 0
        for b in blocks:
            y = self.mul_h(y ^ b)
        return y

    @staticmethod
    def bytes_to_blocks(data: bytes) -> list[int]:
        """Zero-pad to a block boundary and split into big-endian ints."""
        if len(data) % 16:
            data = data + b"\x00" * (16 - len(data) % 16)
        return [
            int.from_bytes(data[i : i + 16], "big")
            for i in range(0, len(data), 16)
        ]

    @staticmethod
    def length_block(aad_bits: int, ct_bits: int) -> int:
        """The final ``len(A) || len(C)`` block (64-bit fields)."""
        return (aad_bits << 64) | ct_bits

    def tag(self, aad: bytes, ciphertext: bytes, ej0: int) -> int:
        """Full GCM tag: GHASH(A || C || lens) ⊕ E_K(J0) with the mask
        supplied by the caller (its recovery is the nonce-reuse attack)."""
        blocks = (
            self.bytes_to_blocks(aad)
            + self.bytes_to_blocks(ciphertext)
            + [self.length_block(8 * len(aad), 8 * len(ciphertext))]
        )
        return self.process(blocks) ^ ej0

"""CRC as an affine GF(2) map, generic over BitVec | int.

New-capability model (no analog in the reference): a CRC over unknown
message bits is affine in those bits, so "which input bytes produce CRC c?"
is a LinearSystem workload.  The data-dependent feedback select
``crc = (crc >> 1) ^ (lsb ? poly : 0)`` is linearized with
``broadcast(0, w) & poly`` — the same pattern as the reference's
GaloisLFSR (``reference:gf2bv/crypto/lfsr.py:13-17``).

Bit order: reflected (LSB-first) algorithm, the common form (CRC-32,
CRC-16/MODBUS, ...).  ``process(data, nbits)`` consumes data bits LSB
first — for byte strings use ``int.from_bytes(b, "little")``, which lays
out byte 0's LSB first, matching standard reflected CRCs.

Port copy of ``gf2bv_tpu/crypto/crc.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

from ..core.bitvec import BitVec


class ReflectedCRC:
    def __init__(self, width: int, poly_reversed: int, init: int, xorout: int):
        self.width = width
        self.poly = poly_reversed
        self.init = init
        self.xorout = xorout

    def process(self, data, nbits: int | None = None):
        """CRC of ``nbits`` data bits (LSB first).  data: BitVec | int.
        Returns a width-bit BitVec (symbolic) or int (concrete)."""
        w = self.width
        if isinstance(data, BitVec):
            if nbits is None:
                nbits = len(data)
            elif nbits > len(data):
                raise ValueError("nbits exceeds the BitVec width")
        elif nbits is None:
            raise ValueError("nbits required for concrete int data")
        crc = self.init
        for i in range(nbits):
            if isinstance(data, BitVec):
                din = data[i].zeroext(w - 1)  # bit i at position 0
            else:
                din = (data >> i) & 1
            fb = (din ^ crc) if isinstance(din, BitVec) else (crc ^ din)
            if isinstance(fb, BitVec):
                sel = fb.broadcast(0, w) & self.poly
            else:
                sel = self.poly if fb & 1 else 0
            crc = (fb >> 1) ^ sel
        return crc ^ self.xorout


def CRC32() -> ReflectedCRC:
    """Standard CRC-32 (zlib/PNG): poly 0x04C11DB7 reflected."""
    return ReflectedCRC(32, 0xEDB88320, 0xFFFFFFFF, 0xFFFFFFFF)


def CRC32C() -> ReflectedCRC:
    """CRC-32C (Castagnoli; iSCSI/ext4/SSE4.2): poly 0x1EDC6F41 reflected."""
    return ReflectedCRC(32, 0x82F63B78, 0xFFFFFFFF, 0xFFFFFFFF)


def CRC16_MODBUS() -> ReflectedCRC:
    """CRC-16/MODBUS: poly 0x8005 reflected, init 0xFFFF, no xorout."""
    return ReflectedCRC(16, 0xA001, 0xFFFF, 0x0000)


def CRC16_CCITT_KERMIT() -> ReflectedCRC:
    """CRC-16/KERMIT (reflected CCITT): poly 0x1021 reflected, init 0."""
    return ReflectedCRC(16, 0x8408, 0x0000, 0x0000)


def CRC64_XZ() -> ReflectedCRC:
    """CRC-64/XZ (GO-ECMA reflected): poly 0x42F0E1EBA9EA3693 reflected."""
    return ReflectedCRC(64, 0xC96C5795D7870F42, (1 << 64) - 1, (1 << 64) - 1)

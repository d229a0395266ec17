"""Coefficient-matrix visualization as a 1-bit PNG.

The reference's Sage export incidentally renders the matrix as a 1-bit PNG
via libgd (``reference:gf2bv/_internal.c:738-757``); this keeps the
visualizer capability with a dependency-free encoder (zlib + struct are
stdlib).  Black pixel = 1-bit, like the reference.

Port copy of ``gf2bv_tpu/utils/matviz.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..core import packing


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    chunk = tag + payload
    return struct.pack(">I", len(payload)) + chunk + struct.pack(
        ">I", zlib.crc32(chunk)
    )


def bits_to_png(bits: np.ndarray) -> bytes:
    """(rows, cols) 0/1 uint8 array -> 1-bit grayscale PNG bytes
    (bit 1 = black, matching the reference's rendering)."""
    rows, cols = bits.shape
    # PNG bit depth 1, grayscale: 0 = black; our 1-bits should be black
    pixels = 1 - (bits & 1).astype(np.uint8)
    packed = np.packbits(pixels, axis=1, bitorder="big")
    raw = b"".join(b"\x00" + packed[r].tobytes() for r in range(rows))
    ihdr = struct.pack(">IIBBBBB", cols, rows, 1, 0, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(raw, 6))
        + _png_chunk(b"IEND", b"")
    )


def system_matrix_png(system, zeros) -> bytes:
    """Render a system's coefficient matrix [b | A] as PNG bytes."""
    eqs = system.get_eqs_packed(zeros)
    bits = packing.unpack_rows(eqs, 1 + system.cols)
    return bits_to_png(bits)


def save_matrix_png(system, zeros, path: str) -> None:
    with open(path, "wb") as f:
        f.write(system_matrix_png(system, zeros))

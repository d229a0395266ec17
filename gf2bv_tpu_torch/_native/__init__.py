"""ctypes loader for the native host engine (native.c).

Port of ``gf2bv_tpu/_native/__init__.py``: a from-scratch M4R-family GF(2)
elimination engine for the host CPU (``native.c`` is a verbatim copy of the
reference's source), exposed through numpy-friendly wrappers with the same
contracts as the reference's.

gcc builds the two engine variants at first use, never at import, into the
git-ignored ``build/`` directory at the repository root (beside the CUDA
kernels, ops/_cuda.py).  Each library is named by a hash of the source, its
flags and the host's CPU (it is built with ``-march=native``), and is
written under a temporary name and renamed into place, so processes that
build at once never load a half-written file.  Everything
degrades gracefully: :func:`lib` returns None when no compiler is available,
:func:`available` is then False and ``auto`` never picks ``native``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "native.c"
BUILD_DIR = _HERE.parent.parent / "build"
# Two engine variants: the bulk-update macro-panel width (NSUB 8-bit tables
# per pass) trades per-panel overhead against matrix sweeps; the reference
# picks NSUB=2 below _NSUB_SPLIT_COLS columns and NSUB=8 from there on.
_NSUB_SMALL, _NSUB_LARGE = 2, 8
_NSUB_SPLIT_COLS = 4096
_LIBS: dict = {}  # nsub -> CDLL | False


def _flags(nsub: int) -> list[str]:
    return ["-O3", "-march=native", "-funroll-loops", "-fopenmp", f"-DNSUB={nsub}",
            "-shared", "-fPIC"]


def _host_cpu() -> bytes:
    """The host's CPU model and flags: ``-march=native`` code built on one
    host must not be loaded on another."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        lines = []
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))][:2]
    return (platform.machine() + "\n" + "\n".join(keep)).encode()


def _build(nsub: int) -> Path | None:
    """Compile the NSUB=``nsub`` variant into build/ (once per source, flags
    and host CPU); None when gcc is missing or fails."""
    h = hashlib.sha256(" ".join(_flags(nsub)).encode())
    h.update(_host_cpu())
    h.update(_SRC.read_bytes())
    so = BUILD_DIR / f"libgf2native_n{nsub}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["gcc", *_flags(nsub), "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)


def lib(cols: int | None = None) -> ctypes.CDLL | None:
    """The engine variant for a system of ``cols`` columns (default: the
    large variant); None when it cannot be built."""
    nsub = _NSUB_SMALL if (cols is not None and cols < _NSUB_SPLIT_COLS) else _NSUB_LARGE
    L = _LIBS.get(nsub)
    if L is None:
        so = _build(nsub)
        if so is None:
            L = False
        else:
            L = ctypes.CDLL(str(so))
            L.gf2_rref.restype = ctypes.c_int64
            L.gf2_rref.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int,
            ]
            L.gf2_inconsistent.restype = ctypes.c_int
            L.gf2_inconsistent.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ]
            L.gf2_verify.restype = ctypes.c_int
            L.gf2_verify.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ]
            L.gf2_enumerate.restype = None
            L.gf2_enumerate.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p,
            ]
        _LIBS[nsub] = L
    return L or None


def available() -> bool:
    """True when both variants build (solve paths pick one by column count)."""
    return lib() is not None and lib(1) is not None


def rref_native(eqs: np.ndarray, cols: int, trailing: bool = False,
                aff_bits: np.ndarray | None = None):
    """Native RREF of a copy of ``eqs``, (rows, W64) uint64 packed.

    Returns (rref (rows, W64), pof (cols,) int32, inconsistent bool|None).
    ``trailing=True`` is the mode-0 path: the matrix is then not a full RREF
    in the free columns and satisfiability is not determined (the flag comes
    back None; callers verify the candidate, see :func:`solve_native`).
    ``aff_bits``: optional (rows,) per-instance affine bits that REPLACE bit
    0 of each row (the lazy-trace path caches one structural matrix and
    swaps only this column per solve, ops/lazy_solve.py)."""
    L = lib(cols)
    assert L is not None, "native backend unavailable (no gcc?)"
    rows, w = eqs.shape
    a = np.empty((rows, w + 1), dtype=np.uint64)  # +1 pad word for strip reads
    a[:, :w] = eqs
    a[:, w] = 0
    if aff_bits is not None:
        a[:, 0] = (a[:, 0] & ~np.uint64(1)) | (
            np.asarray(aff_bits, np.uint64) & np.uint64(1)
        )
    pof = np.full(cols, -1, dtype=np.int32)
    used = np.zeros(rows, dtype=np.uint8)
    L.gf2_rref(
        a.ctypes.data, rows, w + 1, cols, pof.ctypes.data, used.ctypes.data,
        int(trailing),
    )
    inconsistent = None if trailing else bool(
        L.gf2_inconsistent(a.ctypes.data, rows, w + 1, cols)
    )
    return a[:, :w], pof, inconsistent


def enumerate_native(
    origin: np.ndarray, basis: np.ndarray, start: int, count: int, gray: bool
) -> np.ndarray:
    """Batched affine enumeration on the host (OpenMP)."""
    L = lib()
    assert L is not None
    w = origin.shape[0]
    out = np.empty((count, w), dtype=np.uint64)
    basis = np.ascontiguousarray(basis, dtype=np.uint64)
    origin = np.ascontiguousarray(origin, dtype=np.uint64)
    L.gf2_enumerate(
        origin.ctypes.data, basis.ctypes.data, basis.shape[0], w,
        ctypes.c_uint64(start), count, int(gray), out.ctypes.data,
    )
    return out


def solve_native(eqs: np.ndarray, cols: int, mode: int,
                 aff_bits: np.ndarray | None = None,
                 basis_cache: dict | None = None):
    """``solver.solve``-shaped entry on the native engine.

    Mode 0 runs the trailing update and verifies the candidate origin
    against the ORIGINAL system by row parity (None when it fails: the
    system is unsatisfiable); mode 1 runs the full update and returns
    (origin, basis).  ``aff_bits`` as in :func:`rref_native` (the check then
    uses the replaced column).  ``basis_cache``: a caller-held dict; the
    mode-1 kernel basis depends only on the coefficient columns, so repeated
    solves of one cached structure build it once."""
    from ..core import packing
    from ..ops import extract

    rref, pof, inconsistent = rref_native(
        eqs, cols, trailing=(mode == 0), aff_bits=aff_bits
    )
    if inconsistent:
        return None
    pivot_cols = np.nonzero(pof >= 0)[0].astype(np.int64) + 1
    pivot_rows = rref[pof[pivot_cols - 1]]
    origin = extract.build_origin(pivot_rows, pivot_cols, cols)
    if mode == 0:
        xfull = packing.int_to_words(
            (packing.words_to_int(origin) << 1) | 1, 1 + cols
        )
        eqs = np.ascontiguousarray(eqs)
        xfull = np.ascontiguousarray(xfull[: eqs.shape[1]])
        affp = (
            np.ascontiguousarray(aff_bits, np.uint8)
            if aff_bits is not None else None
        )
        ok = lib(cols).gf2_verify(
            eqs.ctypes.data, eqs.shape[0], eqs.shape[1], xfull.shape[0],
            xfull.ctypes.data,
            affp.ctypes.data if affp is not None else None,
        )
        if not ok:
            return None
        return origin
    if basis_cache is not None:
        if "basis" not in basis_cache:
            basis_cache["basis"] = extract.build_basis(
                pivot_rows, pivot_cols, cols
            )
        return origin, basis_cache["basis"]
    return origin, extract.build_basis(pivot_rows, pivot_cols, cols)


def solve_multi_rhs_native(eqs: np.ndarray, cols: int, rhs_bits: np.ndarray,
                           mode: int = 0, basis_cache: dict | None = None):
    """Host multi-RHS: solve the SAME coefficient matrix for many affine
    columns with ONE ``gf2_rref``, the host twin of
    ``ops.multi_rhs.solve_multi_rhs`` (the matrix's own bit-0 affine column
    is inert; one entry per instance, a raw int / AffineSpace / None; all
    mode-1 instances share one basis).  The appended per-instance RHS words
    sit past the coefficient words, so the elimination carries them along
    untouched by pivot selection.  ``basis_cache`` as in
    :func:`solve_native`."""
    from ..core import packing
    from ..core.affine import AffineSpace
    from ..ops import extract

    L = lib(cols)
    assert L is not None, "native backend unavailable (no gcc?)"
    eqs = np.asarray(eqs, np.uint64)
    rows, w = eqs.shape
    rhs_bits = np.asarray(rhs_bits, np.uint8)
    B = rhs_bits.shape[0]
    assert rhs_bits.shape[1] == rows, "one affine bit per row per instance"
    bw = (B + 63) // 64

    a = np.empty((rows, w + bw + 1), dtype=np.uint64)  # +1 pad word
    a[:, :w] = eqs
    a[:, w + bw] = 0
    a[:, 0] &= ~np.uint64(1)  # inert own-affine column
    # instance k's bit -> word w + (k>>6), bit k&63 (little-endian host);
    # packed in 512-instance chunks so the strided pack stays cache-resident
    rhs8 = np.zeros((rows, bw * 8), dtype=np.uint8)
    for lo in range(0, B, 512):
        pk = np.packbits(rhs_bits[lo : lo + 512], axis=0, bitorder="little")
        rhs8[:, lo // 8 : lo // 8 + pk.shape[0]] = pk.T
    a[:, w : w + bw] = rhs8.view(np.uint64)

    pof = np.full(cols, -1, dtype=np.int32)
    used = np.zeros(rows, dtype=np.uint8)
    L.gf2_rref(a.ctypes.data, rows, a.shape[1], cols,
               pof.ctypes.data, used.ctypes.data, 0)

    pivot_cols = np.nonzero(pof >= 0)[0].astype(np.int64) + 1
    prows = a[pof[pivot_cols - 1]] if pivot_cols.size else a[:0]

    # instance k unsatisfiable <=> some row with an empty coefficient part
    # still carries its RHS bit (the multi-column 0*x = 1)
    dead = ~a[:, :w].any(axis=1)
    if dead.any():
        unsat_words = np.bitwise_or.reduce(a[dead, w : w + bw], axis=0)
    else:
        unsat_words = np.zeros(bw, dtype=np.uint64)

    # origin_k: RHS-column-k bits of the pivot rows, scattered to pivot cols
    bits = np.unpackbits(
        prows[:, w : w + bw].copy().view(np.uint8), axis=1,
        bitorder="little",
    )[:, :B]  # (rank, B)
    xs = np.zeros((B, cols), dtype=np.uint8)
    if pivot_cols.size:
        xs[:, pivot_cols - 1] = bits.T
    origins = packing.pack_bits(xs, cols)  # (B, Wsol)

    bcache = basis_cache if basis_cache is not None else {}
    out = []
    for k in range(B):
        if (int(unsat_words[k >> 6]) >> (k & 63)) & 1:
            out.append(None)
            continue
        if mode == 0:
            out.append(packing.words_to_int(origins[k]))
        else:
            if "basis" not in bcache:
                bcache["basis"] = extract.build_basis(
                    prows, pivot_cols, cols
                )
            out.append(AffineSpace(origins[k], bcache["basis"], cols))
    return out

"""Build, load and launch the port's hand-written Hopper kernels.

The CUDA sources live in ``gf2bv_tpu_torch/csrc/*.cu``.  On first use each
is compiled by its own ``nvcc`` process for ``sm_90a`` (all started
together), and the objects are linked into ONE shared library with a plain
C interface (``build/`` at the repository root, named by a hash of the
sources and flags so an edited source never reuses a stale build), loaded
with ``ctypes``.  Importing the package never runs ``nvcc``; only the first
kernel launch on a CUDA tensor does.

Every C entry point launches on the caller's stream and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code.  The
wrappers (ops/phase1.py, ops/panel_update.py, ops/gauss_batched.py,
ops/launch_floor.py) count
their launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

# launches per kernel wrapper; reset with reset_launches()
LAUNCHES = {
    "scan": 0, "reconstruct": 0, "update_full": 0, "update_seg": 0,
    "update_trailing": 0, "scan_batched": 0, "reconstruct_batched": 0,
    "scan2": 0, "scan_minkey": 0, "phase1_fused": 0, "update_scan": 0,
    "update_pallas": 0, "update_mxu2": 0, "update_mxu4": 0, "launch_probe": 0,
    "reconstruct_coeff": 0, "scan_chunked": 0, "scan_batched_chunked": 0,
    "phase1_fused_chunked": 0, "update_scan_chunked": 0, "scan2_chunked": 0,
    "scan_subset": 0, "scan_subset_test": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (bT_in, used_in, prow, used_out, cT, rows, kw, w0, cols, nblocks, stream)
    "gf2_scan": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (arows, coeff, prow, tbits, pf, wp, kw, w0, stream)
    "gf2_reconstruct": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # (arows, coeff, prow, tbits, batch, wp, kw, w0, stream): the coefficient solve alone
    "gf2_reconstruct_coeff": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (a, sel, pf, rows, wp, kw, stream)
    "gf2_update_full": [_P, _P, _P, _I, _I, _I, _P],
    # (a, sel, pf, rows, wp, kw, dead_tiles, stream)
    "gf2_update_seg": [_P, _P, _P, _I, _I, _I, _I, _P],
    # (a, sel, pf, rows, wp, kw, w0, stream)
    "gf2_update_trailing": [_P, _P, _P, _I, _I, _I, _I, _P],
    # (bT_in, used_in, prow, used_out, cT, batch, rows, kw, w0, cols, nblocks, stream)
    "gf2_scan_batched": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (bT_in, used_in, prow, used_out, cT, record, rows, kw, w0, cols, chunk_rows,
    #  nblocks, nblocks_last, stream)
    "gf2_scan_chunked": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # (bT_in, used_in, prow, used_out, cT, record, batch, rows, kw, w0, cols, chunk_rows,
    #  nblocks, nblocks_last, stream)
    "gf2_scan_batched_chunked": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # (bT_in, used_in, prow, used_out, cT, scratch, decided, rows, kw, w0, cols,
    #  chunk_rows (0: the cluster scan), nblocks, nblocks_last, stream)
    "gf2_scan_subset": [_P] * 7 + [_I] * 7 + [_P],
    # (rows, kw, nblocks, out: resident clusters of that size)
    "gf2_scan_occupancy": [_I, _I, _I, _P],
    # (arows, coeff, prow, tbits, pf, batch, wp, kw, w0, stream)
    "gf2_reconstruct_batched": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (bT_in, used_in, prow, used_out, cT, rows, kw, w0, cols, nblocks, stream)
    "gf2_scan2": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (bT_in, used_in, prow, used_out, cT, record, rows, kw, w0, cols, chunk_rows,
    #  nblocks, nblocks_last, stream)
    "gf2_scan2_chunked": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # (bT_in, used_in, prow, used_out, cT, rows, kw, w0, cols, nblocks, stream)
    "gf2_scan_minkey": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (a, bT_in, used_in, prow, used_out, cT, pf, rows, wp, kw, w0, cols, nblocks, stream)
    "gf2_phase1_fused": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (a, sel, pf, rows, wp, kw, word_lo, const_word, bTn, used_in, prow, used_out, cT,
    #  w0n, cols, nblocks, stream)
    "gf2_update_scan": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # (a, bT_in, used_in, prow, used_out, cT, record, pf, rows, wp, kw, w0, cols, chunk_rows,
    #  nblocks, nblocks_last, stream)
    "gf2_phase1_fused_chunked": [_P] * 8 + [_I] * 8 + [_P],
    # (a, sel, pf, rows, wp, kw, word_lo, const_word, bTn, used_in, prow, used_out, cT, record,
    #  w0n, cols, chunk_rows, nblocks, nblocks_last, first_rows, stream)
    "gf2_update_scan_chunked": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _P],
    # (a, sel, pf, rows, wp, kw, stream)
    "gf2_update_table": [_P, _P, _P, _I, _I, _I, _P],
    # (a, sel, pf, rows, wp, kw, w0 (-1: full), stream)
    "gf2_update_mxu2": [_P, _P, _P, _I, _I, _I, _I, _P],
    # (a, sel, pf, rows, wp, kw, w0 (-1: full), stream)
    "gf2_update_mxu4": [_P, _P, _P, _I, _I, _I, _I, _P],
    # (out, a, n words, stream)
    "gf2_launch_probe": [_P, _P, _I, _P],
}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _run(procs: list) -> None:
    """Wait for every (cmd, Popen); raise with the output of the first failure."""
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}{err}"
    if failed:
        raise RuntimeError(failed)


def build() -> Path:
    """Compile csrc/*.cu into build/ (once per source hash); returns the .so.
    One nvcc per source runs in parallel, then one link."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    tag = h.hexdigest()[:16]
    so = BUILD_DIR / f"libgf2bv_kernels_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{src.stem}_{tag}.{os.getpid()}.o" for src in sources]
    procs = []
    try:
        for src, obj in zip(sources, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        _run(procs)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, so)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.gf2_error_string.argtypes = [ctypes.c_int]
        handle.gf2_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().gf2_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, shape: tuple, device: torch.device) -> None:
    """Validate a kernel argument: int32, contiguous, on ``device``, ``shape``."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if device.index != torch.cuda.current_device():
        # the C entry points launch on the current device
        raise ValueError(
            f"{name}: on {device} but the current CUDA device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: expected cuda or cpu")

"""Phase 1 of the blocked solver: pivot scan + pivot-row rebuild.

Port of ``gf2bv_tpu/ops/pallas_phase1.py`` (the split ``pallas_scan``
engine).  Two kernels carry it, each with a plain PyTorch twin of the same
contract:

* :func:`scan` — the forward pivot scan of one K-column panel
  (``_make_scan_kernel`` via ``_call_scan_kernel``); CUDA source
  ``csrc/scan.cu``, plain twin :func:`scan_plain`.
* :func:`reconstruct` — full-width pivot-row rebuild + triangular back pass
  (``_make_reconstruct_kernel`` via ``phase1_reconstruct``); CUDA source
  ``csrc/reconstruct.cu``, plain twin :func:`reconstruct_plain`.

A wrapper launches its kernel for CUDA tensors and runs the plain twin only
for CPU tensors; there is no fallback between the two.  Words are int32
tensors holding the reference's uint32 bit patterns (core/words.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.words import I32, torch_to_u32, u32_to_torch
from . import _cuda
from .panel_update import rank_k_xor_


# -- kernel 1: forward scan ----------------------------------------------------


def _bitval(sh: int) -> int:
    """The int32 value of a word with only bit ``sh`` set."""
    return (1 << sh) if sh < 31 else -(1 << 31)


def scan_steps_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int):
    """The scan's steps over B independent systems, plain torch: bT
    (B, kw, rows), used (B, rows) int32.  Returns (prow (B, K), used'
    (B, rows), cT (B, kw, rows)).  The plain twin of both scan kernels."""
    nb, kw, rows = bT.shape
    dev = bT.device
    b = bT.clone()
    u = used.clone()
    c = torch.zeros_like(bT)
    prow = torch.full((nb, K), -1, dtype=I32, device=dev)
    lane = torch.arange(rows, dtype=I32, device=dev)[None, :]
    batch = torch.arange(nb, device=dev)[:, None]
    for jj in range(K):
        gbit = 32 * w0 + jj
        if not 1 <= gbit <= cols:
            continue
        sw, sh = jj >> 5, jj & 31
        cand = (((b[:, sw] >> sh) & 1) == 1) & (u == 0)  # (B, rows)
        piv = torch.where(cand, lane, rows).amin(dim=1)  # (B,)
        has = piv < rows
        piv_safe = torch.where(has, piv, 0).long()
        prow[:, jj] = torch.where(has, piv, -1)
        elim = cand & (lane != piv[:, None])
        words = torch.arange(sw, kw, device=dev)[None, :]
        bpiv = b[batch, words, piv_safe[:, None]]  # (B, kw - sw)
        b[:, sw:] ^= torch.where(elim[:, None, :], bpiv[:, :, None], 0)
        c[:, sw] ^= torch.where(elim, _bitval(sh), 0).to(I32)
        u = torch.where((lane == piv[:, None]) & has[:, None], 1, u).to(I32)
    return prow, u, c


def scan_plain(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int):
    """Plain twin of the scan kernel.  bT (kw, rows), used (1, rows) int32.
    Returns (prow (K,), used' (1, rows), cT (kw, rows))."""
    prow, u, c = scan_steps_plain(bT[None], used, w0, K, cols)
    return prow[0], u, c[0]


def scan(bT: torch.Tensor, used: torch.Tensor, w0: int, K: int, cols: int):
    """Forward scan of one panel: the lowest unused row with the column's
    bit set pivots (columns 1..cols are valid); its slice words from the
    column's word on are XORed into the other candidates, whose coefficient
    bit is set in cT.  Returns (prow (K,), used' (1, rows), cT (kw, rows))."""
    kw, rows = bT.shape
    if K != 32 * kw:
        raise ValueError(f"K={K} does not match bT's {kw} words")
    if not _cuda.on_cuda(bT):
        return scan_plain(bT, used, w0, K, cols)
    dev = bT.device
    _cuda.require(bT, "bT", (kw, rows), dev)
    _cuda.require(used, "used", (1, rows), dev)
    prow = torch.empty((K,), dtype=I32, device=dev)
    used_o = torch.empty_like(used)
    cT = torch.empty_like(bT)
    work = torch.empty_like(bT)
    rc = _cuda.lib().gf2_scan(
        bT.data_ptr(), used.data_ptr(), prow.data_ptr(), used_o.data_ptr(),
        cT.data_ptr(), work.data_ptr(), rows, kw, int(w0), int(cols),
        _cuda.stream_of(bT),
    )
    _cuda.check(rc, "scan kernel")
    _cuda.LAUNCHES["scan"] += 1
    return prow, used_o, cT


# -- kernel 2: pivot-row rebuild + back pass -------------------------------------


def reconstruct_plain(arows: torch.Tensor, coeff: torch.Tensor, prow: torch.Tensor,
                      w0: int) -> torch.Tensor:
    """Plain twin of the reconstruct kernel.  arows (K, wp), coeff (K, kw),
    prow (K,).  Returns pf (K, wp).

    Both passes are GF(2) row operations, so they run on Python-int rows of
    ``[T | slice]`` (K bits each: the combination of arows rows, and the
    pivot-column slice that decides the back pass), and ``pf = T·arows`` is
    one rank-K product at the end."""
    K, wp = arows.shape
    kw = K // 32
    has = (prow >= 0).tolist()

    def ints(t: torch.Tensor) -> list[int]:
        return [int.from_bytes(r.tobytes(), "little") for r in torch_to_u32(t)]

    cf = ints(coeff)
    sl = ints(arows[:, w0 : w0 + kw])
    T, S = [0] * K, [0] * K
    for j in range(K):  # forward: row j from the final rows t < j
        if not has[j]:
            continue
        tj, sj = 1 << j, sl[j]
        c = cf[j] & ((1 << j) - 1)
        while c:
            low = c & -c
            t = low.bit_length() - 1
            tj ^= T[t]
            sj ^= S[t]
            c ^= low
        T[j], S[j] = tj, sj
    for j in range(K - 1, -1, -1):  # back pass, triangular window
        if not has[j]:
            continue
        for k in range(32 * ((j >> 5) + 1)):
            if k != j and (S[k] >> j) & 1:
                T[k] ^= T[j]
                S[k] ^= S[j]
    tbits = np.frombuffer(
        b"".join(v.to_bytes(4 * kw, "little") for v in T), dtype="<u4"
    ).reshape(K, kw)
    pf = torch.zeros_like(arows)
    rank_k_xor_(pf, u32_to_torch(tbits, arows.device), arows)
    return pf


def reconstruct(arows: torch.Tensor, coeff: torch.Tensor, prow: torch.Tensor,
                w0: int) -> torch.Tensor:
    """Rebuild the panel's forward pivot rows at full width
    (``pf[j] = arows[j] ^ XOR{pf[t] : t < j, coeff bit t}``, zero without a
    pivot), then back-eliminate them into the panel's intra-panel RREF rows:
    for j descending with a pivot, ``pf[k] ^= pf[j]`` for each k != j below
    ``32*(j//32 + 1)`` whose bit j is set.  The bound is the reference
    kernel's triangular window; in the solver rows above it never have bit
    j set, and on arbitrary inputs it keeps the two bit for bit equal."""
    K, wp = arows.shape
    kw = K // 32
    if not _cuda.on_cuda(arows):
        return reconstruct_plain(arows, coeff, prow, w0)
    dev = arows.device
    _cuda.require(arows, "arows", (K, wp), dev)
    _cuda.require(coeff, "coeff", (K, kw), dev)
    _cuda.require(prow, "prow", (K,), dev)
    if not 0 <= w0 <= wp - kw:
        raise ValueError(f"w0={w0} outside the {wp}-word rows")
    tbits = torch.empty((K, kw), dtype=I32, device=dev)
    pf = torch.empty_like(arows)
    rc = _cuda.lib().gf2_reconstruct(
        arows.data_ptr(), coeff.data_ptr(), prow.data_ptr(), tbits.data_ptr(),
        pf.data_ptr(), wp, kw, int(w0), _cuda.stream_of(arows),
    )
    _cuda.check(rc, "reconstruct kernel")
    _cuda.LAUNCHES["reconstruct"] += 1
    return pf


# -- the split phase 1 (pallas_phase1.phase1_panel_split) ------------------------


def phase1_panel_split(a: torch.Tensor, bT: torch.Tensor, used: torch.Tensor,
                       w0: int, K: int, cols: int):
    """Phase 1 of one panel: scan, gather the pivot rows and their
    coefficient words, rebuild.  a (rows, wp); bT (kw, rows); used (1, rows).
    Returns (pf (K, wp), prow (K,), used' (1, rows))."""
    prow, used_o, cT = scan(bT, used, w0, K, cols)
    prow_safe = prow.clamp(min=0).long()
    arows = a[prow_safe]  # (K, wp)
    coeff = cT[:, prow_safe].T.contiguous()  # (K, kw)
    pf = reconstruct(arows, coeff, prow, w0)
    return pf, prow, used_o


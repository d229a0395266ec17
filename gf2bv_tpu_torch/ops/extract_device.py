"""On-device solution extraction: origin (mode 0) and kernel basis (mode 1).

Port of ``gf2bv_tpu/ops/extract_device.py``.  The RREF never leaves the
device; only the small canonical outputs are read back:

* origin: each pivot row's RHS bit, gathered by pivot_row_of_col and packed
  into (Wsol32,) words (:func:`origin_device`);
* kernel basis: for free column f, ``v_f = e_f + sum_j coeff_jf e_{c_j}``
  with coeff_jf = bit f of pivot row j.  Bits of distinct pivot columns never
  share a word position, so the per-word accumulation over pivot rows is an
  integer sum that equals OR (:func:`_basis_partial`).

The sums run on int64 (``index_add_``), where no carry can reach bit 31, and
are masked back to int32 words.  Rank and dimension are bucketed as in the
reference (:func:`_bucket`), and the pivot axis is processed in chunks of
``_PCHUNK``, which on the card bounds the gathered (chunk, wp) block.  Plain
torch on either device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.words import I32, bit_i32, or_fold, srl, to_device, torch_to_u32

_BUCKETS = (16, 64, 256, 1024, 4096, 16384, 65536, 2**18, 2**20)
_PCHUNK = 4096  # pivots per basis chunk


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return n


def _wsol32(cols: int) -> int:
    return 2 * packing.nwords64(cols)


def _i64_to_words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 words with the same low 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(I32)


def origin_device(rref32: torch.Tensor, pof: torch.Tensor, cols: int) -> torch.Tensor:
    """Packed particular solution (free variables 0), (Wsol32,) int32 words:
    variable ``c`` (1-based column c+1) takes the RHS bit of its pivot row."""
    nw32 = _wsol32(cols)
    prow_safe = pof.clamp(min=0).long()
    rhs = rref32[prow_safe, 0] & 1
    x = torch.where(pof >= 0, rhs, 0).to(I32)  # (cols,)
    pad = nw32 * 32 - cols
    if pad:
        x = torch.cat([x, torch.zeros(pad, dtype=I32, device=x.device)])
    shifts = torch.arange(32, dtype=I32, device=x.device)
    return or_fold(x.view(nw32, 32) << shifts[None, :], dim=1)


def _basis_partial(rref32: torch.Tensor, prow: torch.Tensor, pcol: torch.Tensor,
                   fcol: torch.Tensor, cols: int) -> torch.Tensor:
    """Contribution of one pivot chunk: (dimb, Wsol32) int32 words.

    prow (chunk,) pivot rows (0 for padding), pcol (chunk,) their packed-bit
    columns (-1 = padding), fcol (dimb,) free packed-bit columns (-1 =
    padding)."""
    nw32 = _wsol32(cols)
    fpos = fcol.clamp(min=0)
    pivrows = rref32[prow.clamp(min=0).long()]  # (chunk, wp)
    # coeff[j, k] = bit fcol[k] of pivot row prow[j]
    coeff = (pivrows[:, (fpos >> 5).long()] >> (fpos & 31)[None, :]) & 1
    valid = (pcol >= 0)[:, None] & (fcol >= 0)[None, :]
    coeff = torch.where(valid, coeff, 0).long()
    svar = (pcol - 1).clamp(min=0)  # solution bit index of each pivot column
    vals = coeff << (svar & 31).long()[:, None]  # (chunk, dimb), < 2**32
    acc = torch.zeros((nw32, fcol.shape[0]), dtype=torch.int64, device=rref32.device)
    acc.index_add_(0, (svar >> 5).long(), vals)  # distinct bits: add == OR
    return _i64_to_words(acc).T.contiguous()


def _basis_onehot(fcol: torch.Tensor, acc: torch.Tensor, cols: int) -> torch.Tensor:
    """Set the one-hot free-variable bit in each accumulated basis row."""
    del cols
    fvar = (fcol - 1).clamp(min=0)
    ohv = torch.where(fcol >= 0, bit_i32(fvar & 31), 0).to(I32)
    out = acc.clone()
    rows = torch.arange(fcol.shape[0], device=acc.device)
    out[rows, (fvar >> 5).long()] ^= ohv  # one write per row: no duplicates
    return out


def _basis_device(rref32: torch.Tensor, prow: torch.Tensor, pcol: torch.Tensor,
                  fcol: torch.Tensor, cols: int) -> torch.Tensor:
    """(dimb, Wsol32) int32 basis rows, chunked over the pivot axis."""
    acc = None
    for c0 in range(0, prow.shape[0], _PCHUNK):
        part = _basis_partial(
            rref32, prow[c0 : c0 + _PCHUNK], pcol[c0 : c0 + _PCHUNK], fcol, cols
        )
        acc = part if acc is None else acc ^ part
    return _basis_onehot(fcol, acc, cols)


def inconsistent_device(rref32: torch.Tensor) -> torch.Tensor:
    """Any row reduced to 0*x = 1 (variable bits empty, const bit set).
    rref32 (..., rows, wp); a bool tensor of the leading shape (0-dim for a
    single matrix)."""
    const_bit = (rref32[..., 0] & 1) == 1
    var_any = srl(rref32[..., 0], 1) != 0
    if rref32.shape[-1] > 1:
        var_any = var_any | (rref32[..., 1:] != 0).any(dim=-1)
    return (const_bit & ~var_any).any(dim=-1)


def _origin_batch(rref32_b: torch.Tensor, pof_b: torch.Tensor, cols: int) -> torch.Tensor:
    """(B, Wsol32) origins of B RREFs."""
    return torch.stack([origin_device(r, p, cols) for r, p in zip(rref32_b, pof_b)])


def _basis_host_orchestrated(rref32: torch.Tensor, pof_h: np.ndarray, cols: int) -> np.ndarray:
    """Bucketed device basis build for one instance: (dim, W64) uint64."""
    pivot_mask = pof_h >= 0
    rank = int(pivot_mask.sum())
    dim = cols - rank
    if dim == 0:
        return np.zeros((0, packing.nwords64(cols)), dtype=np.uint64)
    rankb, dimb = _bucket(max(rank, 1)), _bucket(dim)
    pcol = np.full(rankb, -1, np.int32)
    prow = np.zeros(rankb, np.int32)
    pc = np.nonzero(pivot_mask)[0].astype(np.int32) + 1
    pcol[:rank] = pc
    prow[:rank] = pof_h[pc - 1]
    fcol = np.full(dimb, -1, np.int32)
    fcol[:dim] = np.nonzero(~pivot_mask)[0].astype(np.int32) + 1
    dev = rref32.device
    basis32 = _basis_device(
        rref32, to_device(torch.from_numpy(prow), dev), to_device(torch.from_numpy(pcol), dev),
        to_device(torch.from_numpy(fcol), dev), cols,
    )[:dim]
    return packing.from_u32(torch_to_u32(basis32))


def finalize_batch(rref32_b: torch.Tensor, pof_b: torch.Tensor,
                   inconsistent_b: torch.Tensor, cols: int, mode: int) -> list:
    """Batched extraction: the origins of all instances in one readback; the
    per-instance basis build only in mode 1.  One entry per instance: None,
    the packed origin (W64,) uint64 (mode 0) or (origin, basis) (mode 1)."""
    origins32 = torch_to_u32(_origin_batch(rref32_b, pof_b, cols))
    inc = inconsistent_b.cpu().numpy()
    pof_h = pof_b.cpu().numpy()
    out = []
    for i in range(origins32.shape[0]):
        if inc[i]:
            out.append(None)
            continue
        origin = packing.from_u32(origins32[i][None, :])[0]
        if mode == 0:
            out.append(origin)
            continue
        out.append((origin, _basis_host_orchestrated(rref32_b[i], pof_h[i], cols)))
    return out


def finalize(rref32: torch.Tensor, pof: torch.Tensor, inconsistent: torch.Tensor,
             cols: int, mode: int):
    """Shared extraction tail of the solvers: None, the packed origin (W64,)
    uint64 (mode 0), or (origin, basis (dim, W64) uint64) (mode 1)."""
    return finalize_batch(rref32[None], pof[None], inconsistent.reshape(1), cols, mode)[0]

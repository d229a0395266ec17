"""Phase 2 of the blocked solver: the GF(2) rank-K panel update ``a ^= S·PF``.

Port of ``gf2bv_tpu/ops/pallas_update.py``.  Two TPU kernels are on the
main path, and each keeps its own wrapper, plain twin and launch count,
though one CUDA kernel (``csrc/panel_update.cu``) serves both:

* :func:`update_full` — the full-width update (``_mxu_kernel`` via
  ``panel_update_mxu`` with ``w0=None``); plain twin :func:`update_full_plain`.
* :func:`update_seg` — the segmented trailing update (``_mxu_kernel_seg`` via
  ``panel_update_mxu_seg``): 128-word tile 0 updates only its const word
  (word 0), tiles ``[1, dead_tiles)`` are not touched, tiles
  ``[dead_tiles, wp/128)`` get the full update; plain twin
  :func:`update_seg_plain`.
* :func:`update_trailing` — the trailing update with a runtime panel start
  ``w0`` (``_mxu_kernel_trailing`` via ``panel_update_mxu`` with ``w0``),
  the batched solver's phase 2 and the ``mxu_noseg`` engine's; plain twin
  :func:`update_trailing_plain`.
* :func:`update_scan` — the trailing (or full) update of panel t fused with
  the 1-pivot scan of panel t+1 (``_make_mxu_scan_kernel`` via
  ``panel_update_mxu_scan``, the ``mxu_la`` engine); plain twin
  :func:`update_scan_plain`.

All four update ``a`` IN PLACE and return it (the reference returns a new
array); callers that need the input afterwards pass a clone.  The words the
segmented update does not touch keep their input values here, where the
reference leaves them undefined; the trailing update's untouched words are
copied through by the reference too, so there the whole matrix is defined.
"""

from __future__ import annotations

import torch

from ..core.words import srl
from . import _cuda

SEG_TILE = 128  # words per trailing-mode tile (pallas_update's tw)
_TR = 256  # pallas_update's row tile, which sizes la_grid


def rank_k_xor_(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor) -> None:
    """``a ^= S·PF`` in place, plain torch: a (rows, n) (may be a column
    view), sel (rows, K/32), pf (K, n).  Eight selector bits at a time go
    through a 256-entry XOR table of the matching PF rows."""
    K, n = pf.shape
    for g8 in range(K // 8):
        idx = srl(sel[:, g8 // 4], 8 * (g8 % 4)) & 0xFF
        table = torch.zeros((1, n), dtype=a.dtype, device=a.device)
        for b in range(8):
            table = torch.cat([table, table ^ pf[8 * g8 + b]], dim=0)
        a ^= table[idx.long()]


def _check_shapes(a, sel, pf) -> tuple[int, int, int]:
    rows, wp = a.shape
    K = pf.shape[0]
    if K % 32 or tuple(sel.shape) != (rows, K // 32) or pf.shape[1] != wp:
        raise ValueError(
            f"shapes a{tuple(a.shape)} sel{tuple(sel.shape)} pf{tuple(pf.shape)}"
            " do not form a rank-K update"
        )
    return rows, wp, K // 32


def update_full_plain(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor):
    """Plain twin of :func:`update_full`."""
    _check_shapes(a, sel, pf)
    rank_k_xor_(a, sel, pf)
    return a


def update_full(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor):
    """``a[i] ^= XOR{pf[t] : bit t of sel[i]}`` over every word, in place.
    a (rows, wp), sel (rows, K/32), pf (K, wp) int32."""
    rows, wp, kw = _check_shapes(a, sel, pf)
    if not _cuda.on_cuda(a):
        return update_full_plain(a, sel, pf)
    dev = a.device
    for name, t, shape in (("a", a, (rows, wp)), ("sel", sel, (rows, kw)),
                           ("pf", pf, (32 * kw, wp))):
        _cuda.require(t, name, shape, dev)
    if kw > 8:
        raise ValueError(f"K={32 * kw} above the kernel's 256")
    rc = _cuda.lib().gf2_update_full(
        a.data_ptr(), sel.data_ptr(), pf.data_ptr(), rows, wp, kw,
        _cuda.stream_of(a),
    )
    _cuda.check(rc, "full panel update kernel")
    _cuda.LAUNCHES["update_full"] += 1
    return a


def _seg_range(wp: int, dead_tiles: int) -> int:
    nj = wp // SEG_TILE
    if wp % SEG_TILE or not 1 <= dead_tiles < nj:
        raise ValueError(
            f"segmented update needs wp % {SEG_TILE} == 0 and 1 <= dead_tiles "
            f"< {nj}; got wp={wp}, dead_tiles={dead_tiles}"
        )
    return dead_tiles * SEG_TILE


def update_seg_plain(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor,
                     dead_tiles: int):
    """Plain twin of :func:`update_seg`."""
    _, wp, _ = _check_shapes(a, sel, pf)
    lo = _seg_range(wp, dead_tiles)
    rank_k_xor_(a[:, :1], sel, pf[:, :1])
    rank_k_xor_(a[:, lo:], sel, pf[:, lo:])
    return a


def update_seg(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor,
               dead_tiles: int):
    """Segmented trailing rank-K update, in place: word 0 and the words of
    tiles ``[dead_tiles, wp/128)`` are updated, the rest is left as it is
    (callers in trailing mode never read it)."""
    rows, wp, kw = _check_shapes(a, sel, pf)
    _seg_range(wp, dead_tiles)
    if not _cuda.on_cuda(a):
        return update_seg_plain(a, sel, pf, dead_tiles)
    dev = a.device
    for name, t, shape in (("a", a, (rows, wp)), ("sel", sel, (rows, kw)),
                           ("pf", pf, (32 * kw, wp))):
        _cuda.require(t, name, shape, dev)
    if kw > 8:
        raise ValueError(f"K={32 * kw} above the kernel's 256")
    rc = _cuda.lib().gf2_update_seg(
        a.data_ptr(), sel.data_ptr(), pf.data_ptr(), rows, wp, kw,
        int(dead_tiles), _cuda.stream_of(a),
    )
    _cuda.check(rc, "segmented panel update kernel")
    _cuda.LAUNCHES["update_seg"] += 1
    return a


def _trailing_range(wp: int, w0: int) -> int:
    """First word of the live tiles, or 0 for a full update.  Tiles are
    ``tw = 128`` words (one tile of ``wp`` words when 128 does not divide
    wp); a tile ``j >= 1`` with ``(j+1)*tw <= w0`` is left as it is, and
    tile 0 updates only word 0 once ``tw <= w0``."""
    if not 0 <= w0 < wp:
        raise ValueError(f"w0={w0} outside the {wp}-word rows")
    tw = SEG_TILE if wp % SEG_TILE == 0 else wp
    return (w0 // tw) * tw if tw <= w0 else 0


def update_trailing_plain(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor,
                          w0: int):
    """Plain twin of :func:`update_trailing`."""
    _, wp, _ = _check_shapes(a, sel, pf)
    lo = _trailing_range(wp, w0)
    if lo:
        rank_k_xor_(a[:, :1], sel, pf[:, :1])
    rank_k_xor_(a[:, lo:], sel, pf[:, lo:])
    return a


def update_trailing(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor, w0: int):
    """Trailing rank-K update for a panel starting at word ``w0``, in place:
    tiles wholly left of ``w0`` keep their words, tile 0 then updates only
    its const word (word 0), every other tile gets the full update."""
    rows, wp, kw = _check_shapes(a, sel, pf)
    _trailing_range(wp, w0)
    if not _cuda.on_cuda(a):
        return update_trailing_plain(a, sel, pf, w0)
    dev = a.device
    for name, t, shape in (("a", a, (rows, wp)), ("sel", sel, (rows, kw)),
                           ("pf", pf, (32 * kw, wp))):
        _cuda.require(t, name, shape, dev)
    if kw > 8:
        raise ValueError(f"K={32 * kw} above the kernel's 256")
    rc = _cuda.lib().gf2_update_trailing(
        a.data_ptr(), sel.data_ptr(), pf.data_ptr(), rows, wp, kw, int(w0),
        _cuda.stream_of(a),
    )
    _cuda.check(rc, "trailing panel update kernel")
    _cuda.LAUNCHES["update_trailing"] += 1
    return a


def la_grid(rows: int, wp: int) -> tuple[int, int, int]:
    """(nj, ni, total grid steps) of the reference's look-ahead kernel
    (``pallas_update.la_grid``).  Its grid hosts one scan step per grid step
    (at most 32 per step), so the ``mxu_la`` engine runs only where
    ``la_grid(rows, wp)[2] * 32 >= K``; the port keeps that gate."""
    tw = SEG_TILE if wp % SEG_TILE == 0 else wp
    tr = min(_TR, rows)
    return wp // tw, rows // tr, (wp // tw) * (rows // tr)


def update_scan_plain(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor,
                      bTn: torch.Tensor, used: torch.Tensor, w0n: int, cols: int,
                      w0: int | None = None):
    """Plain twin of :func:`update_scan`: the update, then the 1-pivot scan
    of ``bTn``."""
    from .phase1 import scan_plain  # here: phase1 imports this module

    if w0 is None:
        update_full_plain(a, sel, pf)
    else:
        update_trailing_plain(a, sel, pf, w0)
    prow, used_o, cT = scan_plain(bTn, used, w0n, pf.shape[0], cols)
    return a, prow, cT, used_o


def update_scan(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor,
                bTn: torch.Tensor, used: torch.Tensor, w0n: int, cols: int,
                w0: int | None = None):
    """The rank-K update of panel t (trailing from word ``w0``, or full when
    ``w0`` is None) in place, and in the same launch the 1-pivot scan
    (``phase1.scan``) of ``bTn`` (kw, rows), the next panel's slice already
    carrying this update, at word ``w0n``.  Returns (a, prow (K,), cT
    (kw, rows), used' (1, rows)), the reference's order."""
    rows, wp, kw = _check_shapes(a, sel, pf)
    if w0 is not None:
        _trailing_range(wp, w0)
    if not _cuda.on_cuda(a):
        return update_scan_plain(a, sel, pf, bTn, used, w0n, cols, w0)
    dev = a.device
    for name, t, shape in (("a", a, (rows, wp)), ("sel", sel, (rows, kw)),
                           ("pf", pf, (32 * kw, wp)), ("bTn", bTn, (kw, rows)),
                           ("used", used, (1, rows))):
        _cuda.require(t, name, shape, dev)
    if kw > 8:
        raise ValueError(f"K={32 * kw} above the kernel's 256")
    prow = torch.empty((32 * kw,), dtype=torch.int32, device=dev)
    used_o = torch.empty_like(used)
    cT = torch.empty_like(bTn)
    work = torch.empty_like(bTn)
    rc = _cuda.lib().gf2_update_scan(
        a.data_ptr(), sel.data_ptr(), pf.data_ptr(), rows, wp, kw,
        -1 if w0 is None else int(w0), bTn.data_ptr(), used.data_ptr(),
        prow.data_ptr(), used_o.data_ptr(), cT.data_ptr(), work.data_ptr(),
        int(w0n), int(cols), _cuda.stream_of(a),
    )
    _cuda.check(rc, "fused update + scan kernel")
    _cuda.LAUNCHES["update_scan"] += 1
    return a, prow, cT, used_o

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

* :func:`update_pallas` — the full-width update of the ``pallas`` engine
  (``_panel_update_kernel`` via ``panel_update``); CUDA
  ``csrc/update_table.cu``, a Four-Russians table kernel; plain twin
  :func:`update_pallas_plain`, the TPU body's K mask-and-XOR steps.
* :func:`update_mxu2` / :func:`update_mxu4` — the update as a tensor-core
  product on bit planes (``_mxu2_kernel`` / ``_mxu4_kernel`` and their
  trailing forms via ``panel_update_mxu2`` / ``panel_update_mxu4``); CUDA
  ``csrc/update_mma.cu`` (one-bit ``mma.sync``; ``mxu4`` repacks with a
  second ``mma.sync``); plain twins :func:`update_mxu2_plain` /
  :func:`update_mxu4_plain`, which follow the TPU bodies (unpack to 0/1,
  integer product, parity, repack).  Their trailing rules differ: ``mxu2``
  only skips tiles wholly left of ``w0`` and always updates tile 0 in full;
  ``mxu4`` also cuts tile 0 to its const word once ``tw <= w0``.

All of them update ``a`` IN PLACE and return it (the reference returns a new
array); callers that need the input afterwards pass a clone.  The words the
segmented update does not touch keep their input values here, where the
reference leaves them undefined; the trailing update's untouched words are
copied through by the reference too, so there the whole matrix is defined.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.words import I32, srl
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


# -- the update engines pallas, mxu2, mxu4 ------------------------------------------


def pick_tw(wp: int) -> int:
    """Largest word tile (a multiple of 128) dividing ``wp``
    (``pallas_update.pick_tw``); ``wp`` itself below 128."""
    for tw in (640, 512, 384, 256, 128):
        if wp % tw == 0:
            return tw
    return wp


def unpack_sel_bits(sel: torch.Tensor) -> torch.Tensor:
    """(rows, kw) words -> (rows, K) int8 0/1, selector bit t in column t."""
    rows, kw = sel.shape
    shifts = torch.arange(32, dtype=I32, device=sel.device)
    return ((sel[:, :, None] >> shifts) & 1).reshape(rows, 32 * kw).to(torch.int8)


def unpack_pf_planes2(pf: torch.Tensor, tw: int) -> torch.Tensor:
    """(K, wp) words -> (K, 32*wp) int8 0/1, columns grouped per word tile as
    [plane b major, word minor]: column ``j*(32*tw) + b*tw + w_local``."""
    k, wp = pf.shape
    nj = wp // tw
    shifts = torch.arange(32, dtype=I32, device=pf.device)
    planes = ((pf[None, :, :] >> shifts[:, None, None]) & 1).to(torch.int8)  # (32, K, wp)
    return planes.reshape(32, k, nj, tw).permute(1, 2, 0, 3).reshape(k, nj * 32 * tw)


def _pack_weight_matrix(tw: int) -> np.ndarray:
    """Block-diagonal byte-pack weights (8*tw, tw) int8: ``W[b*tw + w, w] =
    2^b``, with b = 7 stored as -128 (the product's low byte is still 0x80,
    and bytes are masked before assembly)."""
    w = np.zeros((8 * tw, tw), np.int8)
    ar = np.arange(tw)
    for b in range(8):
        w[b * tw + ar, ar] = (1 << b) if b < 7 else -128
    return w


def _int_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product for the twins.  An integer matmul
    on the CPU; on the card, where torch has none, a float32 one (every sum
    here is below 2**24 in magnitude, so it is exact)."""
    if x.device.type == "cpu":
        return x.to(I32) @ y.to(I32)
    return (x.float() @ y.float()).to(I32)


def _i64_words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 words with the same low 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(I32)


def _mxu_tiles(wp: int, w0: int | None) -> tuple[int, int]:
    """(tw, number of word tiles) of the mxu2 / mxu4 engines; checks w0."""
    if w0 is not None and not 0 <= w0 < wp:
        raise ValueError(f"w0={w0} outside the {wp}-word rows")
    tw = SEG_TILE if wp % SEG_TILE == 0 else wp
    return tw, wp // tw


def update_pallas_plain(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor):
    """Plain twin of :func:`update_pallas`: the TPU body, one mask-and-XOR
    per selector bit on each (rows, ``pick_tw(wp)``) word tile."""
    _, wp, kw = _check_shapes(a, sel, pf)
    tw = pick_tw(wp)
    for j in range(wp // tw):
        acc = a[:, j * tw : (j + 1) * tw]
        for w in range(kw):
            sw = sel[:, w]
            for b in range(32):
                mask = -((sw >> b) & 1)  # 0 or all ones
                acc ^= mask[:, None] & pf[32 * w + b, j * tw : (j + 1) * tw][None, :]
    return a


def update_pallas(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor):
    """``a[i] ^= XOR{pf[t] : bit t of sel[i]}`` over every word, in place (the
    ``pallas`` engine: it takes no panel start, so it is full-width in
    trailing mode too).  On the card a table kernel: 256-entry XOR tables of
    each 8 pf rows in shared memory, one table read per 8 selector bits."""
    rows, wp, kw = _check_shapes(a, sel, pf)
    if not _cuda.on_cuda(a):
        return update_pallas_plain(a, sel, pf)
    dev = a.device
    for name, t, shape in (("a", a, (rows, wp)), ("sel", sel, (rows, kw)),
                           ("pf", pf, (32 * kw, wp))):
        _cuda.require(t, name, shape, dev)
    if kw > 8:
        raise ValueError(f"K={32 * kw} above the kernel's 256")
    rc = _cuda.lib().gf2_update_table(
        a.data_ptr(), sel.data_ptr(), pf.data_ptr(), rows, wp, kw, _cuda.stream_of(a),
    )
    _cuda.check(rc, "table panel update kernel")
    _cuda.LAUNCHES["update_pallas"] += 1
    return a


def _plane_counts(selbits: torch.Tensor, pfbits2: torch.Tensor, j: int, tw: int):
    """(rows, 32*tw) int32: tile j's product, plane-major."""
    return _int_matmul(selbits, pfbits2[:, j * 32 * tw : (j + 1) * 32 * tw])


def update_mxu2_plain(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor,
                      w0: int | None = None):
    """Plain twin of :func:`update_mxu2`, the TPU body per word tile: one
    (rows, K) x (K, 32*tw) integer product on bit planes, parity, shift/or
    repack.  Trailing: a tile ``j >= 1`` with ``(j+1)*tw <= w0`` is kept."""
    _, wp, _ = _check_shapes(a, sel, pf)
    tw, nj = _mxu_tiles(wp, w0)
    selbits = unpack_sel_bits(sel)
    pfbits2 = unpack_pf_planes2(pf, tw)
    for j in range(nj):
        if w0 is not None and j > 0 and (j + 1) * tw <= w0:
            continue
        counts = _plane_counts(selbits, pfbits2, j, tw)
        packed = torch.zeros((a.shape[0], tw), dtype=I32, device=a.device)
        for b in range(32):
            packed |= (counts[:, b * tw : (b + 1) * tw] & 1) << b
        a[:, j * tw : (j + 1) * tw] ^= packed
    return a


def _const_word_update_(a: torch.Tensor, selbits: torch.Tensor, pf: torch.Tensor) -> None:
    """The trailing kernels' tile-0 const-only path: word 0 alone, through a
    (rows, K) x (K, 32) product against the const word's bit planes."""
    shifts = torch.arange(32, dtype=I32, device=pf.device)
    pfconst = ((pf[:, 0:1] >> shifts[None, :]) & 1).to(torch.int8)  # (K, 32)
    counts = _int_matmul(selbits, pfconst)
    word0 = ((counts & 1).long() << shifts.long()[None, :]).sum(dim=1)
    a[:, 0] ^= _i64_words(word0)


def update_mxu4_plain(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor,
                      w0: int | None = None):
    """Plain twin of :func:`update_mxu4`, the TPU body per word tile: the
    bit-plane product, parity, and the 32-plane -> word repack as four
    (rows, 8*tw) x (8*tw, tw) products against power-of-two byte weights
    (bit 7 as int8 -128, each byte masked with 0xFF).  Trailing as the
    ``mxu`` engine: kept tiles, and tile 0 const-word-only once
    ``tw <= w0``."""
    _, wp, _ = _check_shapes(a, sel, pf)
    tw, nj = _mxu_tiles(wp, w0)
    selbits = unpack_sel_bits(sel)
    pfbits2 = unpack_pf_planes2(pf, tw)
    packw = torch.from_numpy(_pack_weight_matrix(tw)).to(a.device)
    for j in range(nj):
        if w0 is not None and j > 0 and (j + 1) * tw <= w0:
            continue
        if w0 is not None and j == 0 and tw <= w0:
            _const_word_update_(a, selbits, pf)
            continue
        counts = _plane_counts(selbits, pfbits2, j, tw)
        packed = torch.zeros((a.shape[0], tw), dtype=torch.int64, device=a.device)
        for g in range(4):
            cg = (counts[:, g * 8 * tw : (g + 1) * 8 * tw] & 1).to(torch.int8)
            packed |= (_int_matmul(cg, packw) & 0xFF).long() << (8 * g)
        a[:, j * tw : (j + 1) * tw] ^= _i64_words(packed)
    return a


def _launch_mma(fn_name: str, key: str, what: str, a, sel, pf, w0):
    rows, wp, kw = _check_shapes(a, sel, pf)
    dev = a.device
    for name, t, shape in (("a", a, (rows, wp)), ("sel", sel, (rows, kw)),
                           ("pf", pf, (32 * kw, wp))):
        _cuda.require(t, name, shape, dev)
    if kw > 8:
        raise ValueError(f"K={32 * kw} above the kernel's 256")
    pf_t = torch.empty((wp, 256), dtype=I32, device=dev)  # pf transposed at bit level
    rc = getattr(_cuda.lib(), fn_name)(
        a.data_ptr(), sel.data_ptr(), pf.data_ptr(), pf_t.data_ptr(), rows, wp, kw,
        -1 if w0 is None else int(w0), _cuda.stream_of(a),
    )
    _cuda.check(rc, what)
    _cuda.LAUNCHES[key] += 1
    return a


def update_mxu2(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor,
                w0: int | None = None):
    """The rank-K update as one tensor-core product (the ``mxu2`` engine), in
    place.  ``w0`` None: every word.  Else the trailing update for a panel
    starting at word ``w0``: with tiles of ``tw = 128`` words (``wp`` when 128
    does not divide it), a tile ``j >= 1`` with ``(j+1)*tw <= w0`` keeps its
    words; tile 0 always gets the whole update."""
    _, wp, _ = _check_shapes(a, sel, pf)
    _mxu_tiles(wp, w0)
    if not _cuda.on_cuda(a):
        return update_mxu2_plain(a, sel, pf, w0)
    return _launch_mma("gf2_update_mxu2", "update_mxu2", "mxu2 panel update kernel",
                       a, sel, pf, w0)


def update_mxu4(a: torch.Tensor, sel: torch.Tensor, pf: torch.Tensor,
                w0: int | None = None):
    """The ``mxu4`` engine: the product of :func:`update_mxu2` with the
    parity planes packed back into words by a second tensor-core product, in
    place.  Trailing (``w0`` given) as :func:`update_trailing`: tiles wholly
    left of ``w0`` keep their words and tile 0 then updates only word 0."""
    _, wp, _ = _check_shapes(a, sel, pf)
    _mxu_tiles(wp, w0)
    if not _cuda.on_cuda(a):
        return update_mxu4_plain(a, sel, pf, w0)
    return _launch_mma("gf2_update_mxu4", "update_mxu4", "mxu4 panel update kernel",
                       a, sel, pf, w0)

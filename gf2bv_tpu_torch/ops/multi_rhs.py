"""Multi-RHS solving: ONE elimination, thousands of instances.

Port of ``gf2bv_tpu/ops/multi_rhs.py``.  A captured or lazily traced model
has one coefficient matrix for every instance; only the affine column
differs.  So solving ``A x = b_k`` for many k needs ONE reduction of
``[A | b_0 .. b_{B-1}]``: the per-instance affine columns are appended as
extra 128-word tiles on the right of the packed matrix.  Nothing past
``cols`` can pivot (the panel loop stops at ``cols`` and the scan masks the
columns beyond it), so the rank-K updates simply carry the block along, at
full width in every panel.  Up to ``MAX_RHS`` = 32768 instances (8 appended
tiles) ride one blocked RREF; per-instance origins and unsatisfiability
fall out of the appended block, and in mode 1 all instances share one
kernel basis (same coefficient matrix, same null space).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.affine import AffineSpace
from ..core.words import I32, or_fold, resolve_device, torch_to_u32, u32_to_torch
from . import extract_device

_RHS_TILE = 128  # one appended tile = 4096 instances
MAX_RHS_TILES = 8  # a TPU value kept for parity, to be re-derived on the H100
MAX_RHS = 32 * _RHS_TILE * MAX_RHS_TILES  # 32768 instances per elimination

# instance-count buckets: the host packs, uploads and extracts only bw
# words; the device pads the appended block to whole _RHS_TILE tiles
_BW_BUCKETS = (
    1, 8, 32, _RHS_TILE, 2 * _RHS_TILE, 4 * _RHS_TILE,
    MAX_RHS_TILES * _RHS_TILE,
)


def _bw_for(nb: int) -> int:
    for bw in _BW_BUCKETS:
        if nb <= 32 * bw:
            return bw
    raise ValueError(f"multi-RHS supports at most {MAX_RHS} instances per call")


def _tiles_for(bw: int) -> int:
    return -(-bw // _RHS_TILE)


def _pack_rhs(rhs_bits: np.ndarray, rows_pad: int, bw: int) -> np.ndarray:
    """(B, rows) uint8 0/1 -> (rows_pad, bw) uint32: instance k's affine
    bit of row r lands at word k>>5, bit k&31 of row r.

    Packs along the instance axis first (np.packbits, in 512-instance
    chunks) and only then transposes, so the shuffled intermediate is B/8
    bytes per row."""
    nb, rows = rhs_bits.shape
    out8 = np.zeros((rows_pad, 4 * bw), dtype=np.uint8)
    for lo in range(0, nb, 512):
        pk = np.packbits(rhs_bits[lo : lo + 512], axis=0, bitorder="little")
        out8[:rows, lo // 8 : lo // 8 + pk.shape[0]] = pk.T
    # byte k>>3 bit k&7 == uint32 word k>>5 bit k&31 on a little-endian host
    return out8.view(np.uint32)


def _pack_rhs_affine_sweep(
    base_aff: np.ndarray, guess_bits: np.ndarray, rows_pad: int, bw: int
) -> np.ndarray:
    """Packed RHS for a guess-sweep chunk without the (B, rows) bit matrix:
    every instance shares ``base_aff`` except the last G rows, where
    instance k's bit is ``base ^ guess_bits[k, g]``.

    base_aff: (rows,) uint8 0/1; guess_bits: (nb, G) uint8.  Instances
    beyond nb in the last used word replicate the base column; they are
    phantom instances whose outputs the callers never read."""
    nb, G = guess_bits.shape
    rows = base_aff.shape[0]
    nwu = -(-nb // 32)
    out = np.zeros((rows_pad, bw), np.uint32)
    out[:rows, :nwu] = np.where(
        base_aff, np.uint32(0xFFFFFFFF), np.uint32(0)
    )[:, None]
    if G:
        pk = np.packbits(
            np.ascontiguousarray(guess_bits.T), axis=1, bitorder="little"
        )
        pad = nwu * 4 - pk.shape[1]
        if pad:
            pk = np.pad(pk, ((0, 0), (0, pad)))
        out[rows - G : rows, :nwu] ^= pk.view(np.uint32)
    return out


def _extract_multi(rref32: torch.Tensor, pof: torch.Tensor, cols: int, wp: int, bw: int):
    """(origins (32*bw, Wsol32) int32 words, unsat_words (bw,) int32) of the
    USED instance-word bucket.

    origin_k = the RHS-column-k bits of the pivot rows; unsat bit k = some
    row with an empty coefficient part still carries instance k's affine bit
    (0*x = 1).  The matrix's own affine bit (bit 0 of word 0) is inert.
    The reference sums distinct powers of two in uint32; here they are
    OR-folded, since in int32 the bit-31 term is negative and a sum would
    promote."""
    dev = rref32.device
    shifts = torch.arange(32, dtype=I32, device=dev)
    prow_safe = pof.clamp(min=0).long()
    # slice the RHS block before gathering: the gather touches (cols, bw) words
    r = rref32[:, wp : wp + bw][prow_safe]
    r = torch.where((pof >= 0)[:, None], r, 0)
    bits = ((r[:, :, None] >> shifts) & 1).to(torch.uint8)  # (cols, bw, 32)
    bits = bits.reshape(cols, 32 * bw).T  # (32*bw, cols)
    nw32 = 2 * packing.nwords64(cols)
    pad = nw32 * 32 - cols
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    origins = or_fold(bits.reshape(32 * bw, nw32, 32).to(I32) << shifts, dim=2)

    nonzero = (rref32[:, 0] & ~1) != 0  # ignore the inert bit-0 column
    if wp > 1:
        nonzero = nonzero | (rref32[:, 1:wp] != 0).any(dim=1)
    dead_rhs = torch.where(nonzero[:, None], 0, rref32[:, wp : wp + bw])
    return origins, or_fold(dead_rhs, dim=0)


def solve_multi_rhs_device(
    a_dev: torch.Tensor,
    cols: int,
    rhs_dev: torch.Tensor,
    bw: int,
    k_panel: int | None = None,
    phase1: str | None = None,
    phase2: str | None = None,
):
    """Device-side core: augmented elimination + multi-column extraction.

    a_dev: (rows_pad, wp) int32 matrix; rhs_dev: (rows_pad, bw) int32 packed
    per-instance affine columns (``_pack_rhs`` layout), on the same device.
    Returns tensors (rref32, pof, origins32, unsat_words) with no host
    synchronisation, so callers can time this apart from their transfers.
    ``a_dev`` is not modified: the elimination runs on the concatenation.
    """
    from .gauss_blocked import K_PANEL, _pick_engines, rref_blocked

    wp = a_dev.shape[1]
    want = _tiles_for(bw) * _RHS_TILE
    if rhs_dev.shape[1] < want:
        rhs_dev = torch.nn.functional.pad(rhs_dev, (0, want - rhs_dev.shape[1]))
    a_aug = torch.cat([a_dev, rhs_dev], dim=1)

    auto1, auto2 = _pick_engines(a_aug.shape[1])
    rref32, pof, _ = rref_blocked(
        a_aug, cols, k_panel or K_PANEL, False,
        phase1=phase1 or auto1, phase2=phase2 or auto2,
    )
    origins32, unsat_words = _extract_multi(rref32, pof, cols, wp, bw)
    return rref32, pof, origins32, unsat_words


def solve_multi_rhs(
    a32,
    cols: int,
    rhs_bits: np.ndarray | None,
    mode: int = 0,
    k_panel: int | None = None,
    phase1: str | None = None,
    phase2: str | None = None,
    basis_cache: dict | None = None,
    rhs_packed: np.ndarray | None = None,
    nb: int | None = None,
    device="cuda",
):
    """Solve the SAME coefficient matrix for many affine columns at once.

    a32: (rows_pad, wp) packed matrix, a uint32 host array (uploaded to
    ``device``) or an int32 tensor (solved where it lies; never modified);
    its own bit-0 affine column is inert.  rhs_bits: (B, rows) uint8 with
    instance k's affine bit per original row, B <= MAX_RHS.  Returns one
    entry per instance: a raw solution int or None (mode 0), or an
    AffineSpace (mode 1), all instances sharing one basis object.

    ``basis_cache``: a caller-held dict; mode-1 callers looping chunks of
    the same matrix pass the same dict so the kernel basis is built at most
    once, and not at all when every instance is unsatisfiable.

    ``rhs_packed`` / ``nb``: a pre-packed (rows_pad, bw) uint32 block in
    ``_pack_rhs`` layout carrying ``nb`` instances (pass ``rhs_bits=None``),
    for callers whose RHS has structure (``_pack_rhs_affine_sweep``).
    """
    if isinstance(a32, torch.Tensor):
        a_dev = a32
        resolve_device(a_dev.device)
    else:
        a_dev = u32_to_torch(np.asarray(a32, np.uint32), device)
    rows_pad = a_dev.shape[0]
    if rhs_packed is not None:
        if nb is None:
            raise ValueError("rhs_packed requires nb")
        bw = rhs_packed.shape[1]
        if bw != _bw_for(nb):
            raise ValueError(
                f"rhs_packed width {bw} != bucket {_bw_for(nb)} for nb={nb}"
            )
    else:
        nb = rhs_bits.shape[0]
        bw = _bw_for(nb)
        # upload only the used instance words; the device zero-pads the
        # block to whole tiles
        rhs_packed = _pack_rhs(np.asarray(rhs_bits, np.uint8), rows_pad, bw)
    rhs_dev = u32_to_torch(rhs_packed, a_dev.device)
    rref32, pof, origins_dev, unsat_dev = solve_multi_rhs_device(
        a_dev, cols, rhs_dev, bw, k_panel, phase1, phase2
    )
    origins32 = torch_to_u32(origins_dev)
    unsat_words = torch_to_u32(unsat_dev)

    bcache = basis_cache if basis_cache is not None else {}

    def _basis():
        if "basis" not in bcache:
            bcache["basis"] = extract_device._basis_host_orchestrated(
                rref32, pof.cpu().numpy(), cols
            )
        return bcache["basis"]

    out = []
    for k in range(nb):
        if (int(unsat_words[k >> 5]) >> (k & 31)) & 1:
            out.append(None)
            continue
        origin = packing.from_u32(origins32[k][None, :])[0]
        if mode == 0:
            out.append(packing.words_to_int(origin))
        else:
            out.append(AffineSpace(origin, _basis(), cols))
    return out

"""Panel-blocked Gauss-Jordan to RREF — the large-system path.

Port of ``gf2bv_tpu/ops/gauss_blocked.py`` for the split phase-1 engine
(``pallas_scan``) and the MXU phase-2 engine, including the segmented
trailing loop of the mode-0 fast path.  Per K-column panel:

* phase 1 (ops/phase1.py): scan the thin (rows, K/32) slice for pivots,
  gather the pivot rows, rebuild them at full width and back-eliminate
  them into the panel's intra-panel RREF rows PF;
* phase 2 (ops/panel_update.py): one rank-K update ``a ^= S·PF``, with the
  selector S taken from the SAVED original panel slice
  (:func:`selector_from_prow`).

The JAX package's portable jnp phase 1 and its engine switches are not
ported: a CUDA tensor runs the four Hopper kernels, a CPU tensor their
plain twins, and nothing chooses between them but the tensor's device.
The RREF is unique, so results are bit for bit those of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.words import (
    I32, bit_i32, or_fold, parity32, resolve_device, srl, torch_to_u32,
    u32_to_torch, xor_fold,
)
from . import extract_device
from .panel_update import SEG_TILE, update_full, update_seg
from .phase1 import phase1_panel_split

K_PANEL = 256  # panel width in bits
_ROW_BUCKET = 256


def selector_from_prow(b_orig: torch.Tensor, prow: torch.Tensor) -> torch.Tensor:
    """Phase-2 selector: the saved slice masked to pivot columns, with the
    diagonal flipped on each pivot's own row.  b_orig (rows, kw); prow (K,)
    (-1 = free column).  Writes for free columns go to an extra dump row,
    so duplicate scatter indices only ever write the same value."""
    rows, kw = b_orig.shape
    K = prow.shape[0]
    dev = b_orig.device
    bit_ids = torch.arange(K, dtype=I32, device=dev)
    piv = prow >= 0
    bitval = torch.where(piv, bit_i32(bit_ids & 31), 0)
    pm = or_fold(bitval.view(kw, 32), dim=1)  # pivot-column mask per word
    s_ext = torch.cat(
        [b_orig & pm[None, :], torch.zeros((1, kw), dtype=I32, device=dev)]
    )
    prow_safe = torch.where(piv, prow, rows).long()
    wordidx = (bit_ids >> 5).long()
    s_ext[prow_safe, wordidx] = s_ext[prow_safe, wordidx] ^ bitval
    return s_ext[:rows]


def rref_blocked(a: torch.Tensor, cols: int, k_panel: int = K_PANEL,
                 trailing: bool = False):
    """Blocked RREF of ``a`` (rows, wp) int32, ``wp % (k_panel//32) == 0``.

    Returns (rref, pivot_row_of_col (cols,), inconsistent 0-dim bool).  The
    input is not modified (the elimination runs on a clone).

    ``trailing=True`` (mode-0 fast path): with ``wp % 128 == 0`` panels are
    grouped by their count of dead 128-word tiles ``d = (t*kw) // 128``;
    panels with ``d >= 1`` use the segmented update, which keeps only word 0
    of tile 0 up to date and skips tiles [1, d).  The returned matrix is
    then not a full RREF left of the last panel and ``inconsistent`` is
    unreliable; mode 0 verifies its solution against the original system
    instead (:func:`rref_origin_blocked`).
    """
    K = k_panel
    kw = K // 32
    rows, wp = a.shape
    if wp % kw:
        raise ValueError(f"wp={wp} is not a multiple of {kw}")
    a = a.clone()
    dev = a.device
    panels = min(wp // kw, -(-(1 + cols) // (32 * kw)))
    bit_ids = torch.arange(K, dtype=I32, device=dev)
    used = torch.zeros((1, rows), dtype=I32, device=dev)
    pof = torch.full((cols + 1,), -1, dtype=I32, device=dev)  # + dump slot
    seg = trailing and wp % SEG_TILE == 0 and SEG_TILE % kw == 0
    for t in range(panels):
        w0 = t * kw
        b_orig = a[:, w0 : w0 + kw].clone()  # saved before the update
        pf, prow, used = phase1_panel_split(
            a, b_orig.T.contiguous(), used, w0, K, cols
        )
        dst = torch.where(prow >= 0, 32 * w0 + bit_ids - 1, cols).long()
        pof[dst] = prow
        s = selector_from_prow(b_orig, prow)
        dead = (w0 // SEG_TILE) if seg else 0
        if dead >= 1:
            update_seg(a, s, pf, dead)
        else:
            update_full(a, s, pf)
    pof = pof[:cols]
    return a, pof, extract_device.inconsistent_device(a)


def origin_parity_unsat(a: torch.Tensor, origin32: torch.Tensor) -> torch.Tensor:
    """Per-row parity of A & [1|x] over the ORIGINAL system; any odd row
    means the candidate origin does not satisfy it (0-dim bool tensor)."""
    wp = a.shape[1]
    ox = origin32
    if wp > ox.shape[0]:
        ox = torch.cat([ox, torch.zeros(wp - ox.shape[0], dtype=I32, device=ox.device)])
    # xfull = packed [const=1 | x]: the solution shifted up one bit
    lo = torch.cat([torch.ones(1, dtype=I32, device=ox.device), srl(ox[:-1], 31)])
    xfull = ((ox << 1) | lo)[:wp]
    row_words = xor_fold(a & xfull[None, :], dim=1)
    return (parity32(row_words) == 1).any()


def rref_origin_blocked(a: torch.Tensor, cols: int, k_panel: int = K_PANEL):
    """Trailing-mode RREF + mode-0 extraction.  Returns (origin32 (Wsol32,)
    int32, unsat 0-dim bool); the verdict checks the origin against ``a``."""
    rref32, pof, _ = rref_blocked(a, cols, k_panel, True)
    origin32 = extract_device.origin_device(rref32, pof, cols)
    return origin32, origin_parity_unsat(a, origin32)


def _pad(eqs: np.ndarray, k_panel: int, word_align: int = 1) -> np.ndarray:
    a32 = packing.to_u32(eqs)
    return packing.pad2d(
        a32, row_align=_ROW_BUCKET, word_align=max(k_panel // 32, word_align)
    )


def _pad_device(a32: torch.Tensor, k_panel: int, word_align: int = 1) -> torch.Tensor:
    """Zero-pad a (rows, W32) tensor to the solver's row bucket and word
    alignment on its own device."""
    rows, w32 = a32.shape
    walign = max(k_panel // 32, word_align)
    want_rows = max(_ROW_BUCKET, -(-rows // _ROW_BUCKET) * _ROW_BUCKET)
    want_w = -(-w32 // walign) * walign
    if want_rows == rows and want_w == w32:
        return a32
    return torch.nn.functional.pad(a32, (0, want_w - w32, 0, want_rows - rows))


def solve_on_device(a: torch.Tensor, cols: int, mode: int, k_panel: int = K_PANEL):
    """Solve a padded (rows, wp) int32 matrix where it lies.  Mode 0: the
    trailing solver and its parity check, returning the packed origin
    (W64,) uint64; mode 1: the full RREF, returning (origin, basis (dim, W64)
    uint64); None when unsatisfiable."""
    if mode == 0:
        origin32, unsat = rref_origin_blocked(a, cols, k_panel)
        if bool(unsat):
            return None
        return packing.from_u32(torch_to_u32(origin32)[None, :])[0]
    rref32, pof, inconsistent = rref_blocked(a, cols, k_panel, False)
    return extract_device.finalize(rref32, pof, inconsistent, cols, mode)


def solve_blocked(eqs: np.ndarray, cols: int, mode: int, k_panel: int = K_PANEL,
                  device="cuda"):
    """Solve packed (rows, W64) uint64 rows; results as :func:`solve_on_device`."""
    a = u32_to_torch(_pad(eqs, k_panel, word_align=128), resolve_device(device))
    return solve_on_device(a, cols, mode, k_panel)

"""Tournament-pivoting row-sharded elimination: ONE collective per panel.

Port of ``gf2bv_tpu/parallel/rowshard_tournament.py``.  The panel-blocked
sharded solver (rowshard_blocked.py) pays two latency-bound collectives per
column.  This one pays one ``all_gather`` per PANEL:

1. every shard runs the panel's pivot scan on its local row block
   (``phase1.phase1_scan_subset``: on the card the cluster scan kernel),
   electing up to K local rows whose strip span covers the shard's panel
   columns;
2. the K elected rows are all-gathered RAW (un-eliminated, straight out of
   the local block) with their global row ids as one extra int32 column:
   one round; a shard that elected fewer sends zero rows with id -1;
3. the full phase 1 (``phase1.phase1_panel_split``: scan and rebuild
   kernels) runs on the (N*K, wp) stack in shard order, then each shard's
   scan order, as JAX stacks it; its result is the same on every shard, so
   this process computes it once;
4. the rank-K update of each local block is local, as in rowshard_blocked:
   the full-width update (on the card ``update_full``), or under
   ``fused_origin`` the trailing one (``update_trailing``).

Exactness: the local scan's in-strip elimination is an invertible transform
among the elected rows, so the RAW rows span the same panel-strip space as
the reduced candidates and no pivot is missed; gathering RAW rows keeps the
bulk update's diagonal-flip replacement exact (the merged pivot rows are
combinations of elected rows only).  The reference's fourth round of
fuzzing caught the alternative, gathering locally ELIMINATED rows, dropping
rank on underdetermined systems.

``fused_origin`` (mode 0) ends in one ``psum`` of the origin words built
from the owned pivot rows and one ``pmax`` of each shard's parity verdict
against its ORIGINAL rows (``gauss_blocked.origin_parity_unsat``).  The
reference's ``interpret`` flag has no counterpart: the shards' devices
choose between the kernels and their plain twins.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.words import I32, or_fold, torch_to_u32
from ..ops.gauss_blocked import (
    apply_rank_k_update,
    engine,
    origin_parity_unsat,
    selector_from_prow,
)
from ..ops.phase1 import phase1_panel_split, phase1_scan_subset
from . import collectives, mesh as meshlib


def rref_rowsharded_tournament(a32: np.ndarray, cols: int, mesh, k_panel: int = 256,
                               phase2: str = "jnp", fused_origin: bool = False):
    """Sharded tournament RREF; rows a multiple of 256 * the rows axis and
    W32 of 128 are the caller's responsibility (see
    :func:`solve_rowsharded_tournament`).  Returns (rref (rows, W32) int32,
    pof (cols,) int32), or with ``fused_origin=True`` (origin32 (Wsol32,)
    int32, unsat 0-dim bool): trailing updates, the origin from the owned
    pivot rows and the parity check, the sharded rref_origin_blocked."""
    p2 = engine(phase2, "phase2")
    sh = meshlib.rows_sharding(mesh)
    blocks = sh.split(a32)
    a_in = [a.clone() for a in blocks] if fused_origin else None
    K, kw = k_panel, k_panel // 32
    naxis = sh.size
    rloc, wp = blocks[0].shape
    home = sh.home
    offs = [p * rloc for p in sh.positions]
    used = [torch.zeros((1, rloc), dtype=I32, device=a.device) for a in blocks]
    bit_ids = torch.arange(K, dtype=I32, device=home)
    pof = torch.full((cols + 1,), -1, dtype=I32, device=home)  # +1 dump slot
    # panels past the last column hold no pivot: they are skipped, as the
    # one-device solver skips them
    for t in range(min(wp // kw, -(-(1 + cols) // (32 * kw)))):
        w0 = t * kw
        b_orig = [a[:, w0:w0 + kw].clone() for a in blocks]
        # 1) the local scans: elect up to K rows of each block
        sends = []
        for a, b, u, off in zip(blocks, b_orig, used, offs):
            prow_l, _ = phase1_scan_subset(b.T.contiguous(), u, w0, K, cols)
            valid = prow_l >= 0
            raw = torch.where(valid[:, None], a[prow_l.clamp(min=0).long()], 0)
            ids = torch.where(valid, prow_l + off, -1)
            sends.append(torch.cat([raw, ids[:, None]], dim=1))
        # 2) ONE round: the raw rows with their global ids as a last column
        got = collectives.all_gather(sh, sends).reshape(naxis * K, wp + 1)
        stacked = got[:, :wp].contiguous()
        grow = got[:, wp].contiguous()
        # 3) the merged phase 1 on the stack (the same on every shard)
        sbT = stacked[:, w0:w0 + kw].T.contiguous()
        s_used = (grow < 0).to(I32)[None, :]  # an empty slot is a used row
        pf, prow_s, _ = phase1_panel_split(stacked, sbT, s_used, w0, K, cols)
        piv = prow_s >= 0
        gpiv = torch.where(piv, grow[prow_s.clamp(min=0).long()], -1)
        pof[torch.where(piv, 32 * w0 + bit_ids - 1, cols).long()] = gpiv
        # 4) the rank-K update of each local block
        for i, (a, off) in enumerate(zip(blocks, offs)):
            dev = a.device
            g = gpiv.to(dev)
            owned = piv.to(dev) & (g >= off) & (g < off + rloc)
            local_idx = torch.where(owned, g - off, 0)
            used_ext = torch.cat([used[i][0], torch.zeros(1, dtype=I32, device=dev)])
            used_ext[torch.where(owned, local_idx, rloc).long()] = 1
            used[i] = used_ext[None, :rloc].contiguous()
            s = selector_from_prow(b_orig[i], g, owned=owned, local_idx=local_idx)
            apply_rank_k_update(a, s, pf.to(dev), p2, w0 if fused_origin else None)
    pof = pof[:cols]
    if not fused_origin:
        return torch.cat(collectives.readout(sh, blocks)), pof

    # the fused mode-0 tail: the origin from the owned pivot rows (psum'd),
    # then each shard's parity check against its ORIGINAL rows (pmax'd)
    nw32 = 2 * ((cols + 63) // 64)  # u64-aligned like origin_device
    contrib = []
    for a, off in zip(blocks, offs):
        p = pof.to(a.device)
        mine = (p >= off) & (p < off + rloc)
        bits = torch.zeros(nw32 * 32, dtype=I32, device=a.device)
        bits[:cols] = (a[torch.where(mine, p - off, 0).long(), 0] & 1) & mine.to(I32)
        shifts = torch.arange(32, dtype=I32, device=a.device)
        contrib.append(or_fold(bits.view(nw32, 32) << shifts, dim=1))
    origin32 = collectives.psum(sh, contrib)
    bad = [origin_parity_unsat(a0, origin32.to(a0.device)).to(I32) for a0 in a_in]
    unsat = collectives.pmax(sh, bad) > 0
    return origin32, unsat


def solve_rowsharded_tournament(eqs: np.ndarray, cols: int, mode: int, mesh,
                                k_panel: int = 256, phase2: str | None = None):
    """Drop-in for rowshard_blocked.solve_rowsharded_blocked with one
    collective per panel."""
    from ..ops import extract_device
    from .rowshard_blocked import _pick_phase2

    naxis = meshlib.require_mesh(mesh).shape[meshlib.ROWS_AXIS]
    kw = k_panel // 32
    # the phase-1 kernels take 256-row local blocks like the single-device
    # solver; the width is a multiple of both kw (panel coverage) and 128
    word_align = 128 if 128 % kw == 0 else kw * 128
    a32 = packing.pad2d(packing.to_u32(eqs), row_align=256 * naxis, word_align=word_align)
    phase2 = phase2 or _pick_phase2(a32.shape[1], meshlib.rows_sharding(mesh).home)
    if mode == 0:
        origin32, unsat = rref_rowsharded_tournament(
            a32, cols, mesh, k_panel, phase2, fused_origin=True
        )
        if bool(unsat):
            return None
        return packing.from_u32(torch_to_u32(origin32)[None, :])[0]
    rref32, pof = rref_rowsharded_tournament(a32, cols, mesh, k_panel, phase2)
    inconsistent = extract_device.inconsistent_device(rref32)
    return extract_device.finalize(rref32, pof, inconsistent, cols, mode)

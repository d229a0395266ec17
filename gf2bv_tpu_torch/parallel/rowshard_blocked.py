"""Panel-blocked row-sharded elimination.

Port of ``gf2bv_tpu/parallel/rowshard_blocked.py``.  The per-pivot solver
(rowshard.py) pays two collectives per column AND a full-width local
elimination per column.  This is the multi-shard version of the
panel-blocked algorithm (ops/gauss_blocked.py); per K-column panel:

  phase 1 (thin, per pivot): the candidate scan and intra-slice elimination
    touch only the local (rloc, K/32)-word slice; the collectives per
    column are one ``pmin`` (global winner election on the row index) and
    one ``psum`` (the owner's rebuilt full-width forward pivot row, wp
    words), after which the pivot-row panel ``pf`` is the same on every
    shard: this process keeps it once.  A column past ``cols`` (or bit 0)
    has no candidate on any shard, so it takes no round.
  phase 2 (bulk): the rank-K update of each local row block, entirely
    local: ``selector_from_prow``'s ``owned`` / ``local_idx`` flip the
    diagonal only on the shard that owns each pivot row.  Through
    ``apply_rank_k_update``: on the card the table kernel (``mxu``) when
    the width is a multiple of 128 words (:func:`_pick_phase2`).

Same RREF/pof contract as gauss_blocked.rref_blocked, with ``pof`` holding
GLOBAL row indices (block layout: global = shard * rloc + local), so
extract_device works on the sharded result unchanged.  Phase 1 is plain
torch, as the reference's body is plain ``jnp``: it talks to the other
shards at every pivot.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import packing
from ..core.words import I32, srl, xor_fold
from ..ops.gauss_blocked import apply_rank_k_update, engine, selector_from_prow
from ..ops.phase1 import _bitval
from . import collectives, mesh as meshlib
from .rowshard import _BIG


def rref_rowsharded_blocked(a32: np.ndarray, cols: int, mesh, k_panel: int = 256,
                            phase2: str = "jnp"):
    """Sharded blocked RREF.  a32: (rows, W32) uint32; rows a multiple of the
    rows axis and W32 of k_panel // 32 are the caller's responsibility (see
    :func:`solve_rowsharded_blocked`).  Returns (rref (rows, W32) int32,
    pof (cols,) int32) on this process's first shard's device."""
    p2 = engine(phase2, "phase2")
    sh = meshlib.rows_sharding(mesh)
    blocks = sh.split(a32)
    K, kw = k_panel, k_panel // 32
    rloc, wp = blocks[0].shape
    home = sh.home
    offs = [p * rloc for p in sh.positions]
    row_ids = [torch.arange(rloc, dtype=I32, device=a.device) for a in blocks]
    used = [torch.zeros(rloc, dtype=torch.bool, device=a.device) for a in blocks]
    pf_ids = torch.arange(K, dtype=I32, device=home)
    bit_ids = [torch.arange(K, dtype=I32, device=a.device) for a in blocks]
    pof = torch.full((cols + 1,), -1, dtype=I32, device=home)  # +1 dump slot
    # panels past the last column hold no pivot: they are skipped, as the
    # one-device solver skips them
    for t in range(min(wp // kw, -(-(1 + cols) // (32 * kw)))):
        w0 = t * kw
        b_orig = [a[:, w0:w0 + kw].clone() for a in blocks]
        b = [x.clone() for x in b_orig]
        cmat = [torch.zeros((rloc, kw), dtype=I32, device=a.device) for a in blocks]
        pf = torch.zeros((K, wp), dtype=I32, device=home)
        prow_g = torch.full((K,), -1, dtype=I32, device=home)
        owned = [torch.zeros(K, dtype=torch.bool, device=a.device) for a in blocks]
        lidx = [torch.zeros(K, dtype=I32, device=a.device) for a in blocks]
        for jj in range(K):
            gbit = 32 * w0 + jj
            if not 1 <= gbit <= cols:
                continue
            word, shift = jj >> 5, jj & 31
            cands, gidx = [], []
            for bs, u, ids, off in zip(b, used, row_ids, offs):
                cand = ((srl(bs[:, word], shift) & 1) == 1) & ~u
                low = torch.where(cand, ids, rloc).amin()
                cands.append(cand)
                gidx.append(torch.where(low < rloc, low + off, _BIG))
            winner = collectives.pmin(sh, gidx)
            has = winner < _BIG
            owns, lwins, contrib = [], [], []
            for a, cm, bit, off in zip(blocks, cmat, bit_ids, offs):
                w = winner.to(a.device)
                i_own = (w >= off) & (w < off + rloc)
                lwin = torch.where(i_own, w - off, 0)
                # the owner rebuilds its full-width forward pivot row from its
                # row and the earlier pivot rows its coefficients select
                take = ((cm[lwin.long()][(bit >> 5).long()] >> (bit & 31)) & 1) == 1
                full = a[lwin.long()] ^ xor_fold(torch.where(take[:, None], pf.to(a.device), 0))
                owns.append(i_own)
                lwins.append(lwin)
                contrib.append(torch.where(i_own, full, 0))
            pivrow = collectives.psum(sh, contrib)
            pf[jj] = torch.where(has, pivrow, 0)
            bpiv = pivrow[w0:w0 + kw]
            for i, (bs, cm, u, ids) in enumerate(zip(b, cmat, used, row_ids)):
                me = owns[i] & (ids == lwins[i])
                elim = cands[i] & ~me
                bs ^= torch.where(elim[:, None], bpiv.to(bs.device)[None, :], 0)
                cm[:, word] ^= torch.where(elim, _bitval(shift), 0).to(I32)
                u |= me
                owned[i][jj] = owns[i]
                lidx[i][jj] = lwins[i]
            prow_g[jj] = torch.where(has, winner, -1)
            pof[torch.where(has, gbit - 1, cols).long()] = torch.where(has, winner, -1)
        # back-eliminate the pivot rows (the same on every shard): local
        for jj in range(K - 1, -1, -1):
            if not 1 <= 32 * w0 + jj <= cols:
                continue
            colb = srl(pf[:, w0 + (jj >> 5)], jj & 31) & 1
            elim = (colb == 1) & (pf_ids != jj) & (prow_g[jj] >= 0)
            pf ^= torch.where(elim[:, None], pf[jj][None, :], 0)
        # rank-K bulk update of each local block: local
        for i, a in enumerate(blocks):
            s = selector_from_prow(b_orig[i], prow_g.to(a.device), owned=owned[i],
                                   local_idx=lidx[i])
            apply_rank_k_update(a, s, pf.to(a.device), p2)
    return torch.cat(collectives.readout(sh, blocks)), pof[:cols]


def _pick_phase2(wp: int, device) -> str:
    """``GF2BV_TPU_PHASE2`` when set; else on the card with a width that is
    a multiple of 128 words the table kernel (``mxu``), the counterpart of
    the reference's MXU kernel on a TPU; else the plain ``jnp`` update."""
    if "GF2BV_TPU_PHASE2" in os.environ:
        return os.environ["GF2BV_TPU_PHASE2"]
    if wp % 128 == 0 and torch.device(device).type == "cuda":
        return "mxu"
    return "jnp"


def solve_rowsharded_blocked(eqs: np.ndarray, cols: int, mode: int, mesh,
                             k_panel: int = 256, phase2: str | None = None):
    """Drop-in replacement for rowshard.solve_rowsharded (same contract),
    using the panel-blocked elimination.  On the card the matrix is padded
    to 128-word rows and 256-row local blocks (the table kernel's tiles, as
    the reference pads for the MXU); elsewhere to whole panels and one row
    per shard, as the reference pads off the TPU."""
    from ..ops import extract_device

    naxis = meshlib.require_mesh(mesh).shape[meshlib.ROWS_AXIS]
    dev = meshlib.rows_sharding(mesh).home
    kw = k_panel // 32
    if dev.type == "cuda":
        word_align, row_align = 128 if (128 % kw == 0) else kw * 128, 256 * naxis
    else:
        word_align, row_align = kw, naxis
    a32 = packing.pad2d(
        packing.to_u32(eqs), row_align=row_align, word_align=max(kw, word_align)
    )
    phase2 = phase2 or _pick_phase2(a32.shape[1], dev)
    rref32, pof = rref_rowsharded_blocked(a32, cols, mesh, k_panel, phase2)
    inconsistent = extract_device.inconsistent_device(rref32)
    return extract_device.finalize(rref32, pof, inconsistent, cols, mode)

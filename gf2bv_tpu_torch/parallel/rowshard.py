"""Row-sharded Gauss-Jordan: one huge system across many shards.

Port of ``gf2bv_tpu/parallel/rowshard.py``, the multi-shard replacement for
the original library's single-core ``m4ri_solve``.  The packed matrix is
block-sharded by rows over the ``rows`` mesh axis; each pivot step takes
every shard's lowest candidate row, elects the global winner (``pmin`` on
the global row index), and broadcasts the winner's row (``psum`` of a
one-hot contribution).  The elimination XOR is purely local.

Two collectives per column make this latency-bound for wide systems; the
panel-blocked variant (rowshard_blocked.py) and the tournament
(rowshard_tournament.py) amortize them.  This module is the always-correct
multi-shard path and a dryrun target.  Plain torch: the reference's body is
plain ``jnp`` inside ``shard_map``, with no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.words import I32, srl
from . import collectives, mesh as meshlib

_BIG = 2**30  # "no candidate" in the int32 election


def rref_rowsharded(a32: np.ndarray, cols: int, mesh):
    """Sharded RREF.  a32: (rows, W32) uint32, rows a multiple of the rows
    axis.  Returns (rref (rows, W32) int32, pof (cols,) int32 of GLOBAL row
    indices) on this process's first shard's device."""
    sh = meshlib.rows_sharding(mesh)
    blocks = sh.split(a32)
    rloc = blocks[0].shape[0]
    offs = [p * rloc for p in sh.positions]
    row_ids = [torch.arange(rloc, dtype=I32, device=a.device) for a in blocks]
    used = [torch.zeros(rloc, dtype=torch.bool, device=a.device) for a in blocks]
    pof = torch.full((cols,), -1, dtype=I32, device=sh.home)
    for k in range(cols):
        j = k + 1
        colv = [(srl(a[:, j >> 5], j & 31) & 1) == 1 for a in blocks]
        gidx = []
        for c, u, ids, off in zip(colv, used, row_ids, offs):
            low = torch.where(c & ~u, ids, rloc).amin()
            gidx.append(torch.where(low < rloc, low + off, _BIG))
        winner = collectives.pmin(sh, gidx)  # lowest global row wins
        has = winner < _BIG
        owns, lwins, contrib = [], [], []
        for a, off in zip(blocks, offs):
            w = winner.to(a.device)
            i_own = (w >= off) & (w < off + rloc)  # implies has
            lwin = torch.where(i_own, w - off, 0)
            owns.append(i_own)
            lwins.append(lwin)
            contrib.append(torch.where(i_own, a[lwin.long()], 0))
        pivrow = collectives.psum(sh, contrib)  # broadcast the pivot row
        for a, c, u, ids, i_own, lwin in zip(blocks, colv, used, row_ids, owns, lwins):
            me = i_own & (ids == lwin)
            elim = c & has.to(a.device) & ~me
            a ^= torch.where(elim[:, None], pivrow.to(a.device)[None, :], 0)
            u |= me
        pof[k] = torch.where(has, winner, -1)
    return torch.cat(collectives.readout(sh, blocks)), pof


def solve_rowsharded(eqs: np.ndarray, cols: int, mode: int, mesh):
    """Drop-in replacement for gauss_jax.solve_jax across a mesh."""
    from ..ops import extract_device

    naxis = meshlib.require_mesh(mesh).shape[meshlib.ROWS_AXIS]
    a32 = packing.pad2d(packing.to_u32(eqs), row_align=naxis)
    rref32, pof = rref_rowsharded(a32, cols, mesh)
    inconsistent = extract_device.inconsistent_device(rref32)
    return extract_device.finalize(rref32, pof, inconsistent, cols, mode)

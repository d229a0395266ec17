"""Mesh-sharded multi-RHS serving: B instances of ONE trace structure over
the mesh's batch axis, ZERO collectives.

Port of ``gf2bv_tpu/parallel/multi_rhs_sharded.py``.  The multi-RHS trick
(ops/multi_rhs.py) amortizes one elimination over thousands of appended
per-instance affine columns; this module splits the INSTANCE axis over the
mesh.  The coefficient matrix is replicated on each batch shard's device
and each shard eliminates ``[A | its own block of RHS words]`` through
``multi_rhs.solve_multi_rhs_device`` (on the card: the scan, rebuild and
full-width update kernels).  Recomputing the elimination per shard is the
right trade: it is already amortized over that shard's instances, and
row-sharding one elimination would spend collectives to save less work
than they cost.  There are no collectives at all.

Elimination decisions depend only on the coefficient part (appended
columns can never pivot), so every shard computes the IDENTICAL
coefficient RREF; mode 1 builds the shared kernel basis once, from the
first shard's output.  The reference's compiled-function cache has nothing
to cache here and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.affine import AffineSpace
from ..core.words import torch_to_u32, u32_to_torch
from ..ops import multi_rhs
from ..ops.gauss_blocked import K_PANEL, _pick_engines
from . import collectives, mesh as meshlib


def shard_capacity(mesh=None) -> tuple:
    """Validate a batch-axis mesh; returns ``(mesh, n_dev, per-chunk
    instance capacity)`` (the mesh is defaulted/echoed so callers can pass
    None)."""
    mesh = meshlib.require_mesh(mesh if mesh is not None else meshlib.make_mesh())
    if mesh.shape[meshlib.ROWS_AXIS] > 1:
        raise ValueError(
            "multi-RHS sharding uses the batch axis; use a (batch, 1) mesh "
            "(row-shard one huge system with parallel.solve_sharded instead)"
        )
    n_dev = mesh.shape[meshlib.BATCH_AXIS]
    return mesh, n_dev, n_dev * multi_rhs.MAX_RHS


def pack_shard_blocks(instances, nb: int, n_dev: int, rows_pad: int,
                      pack_fn) -> tuple[np.ndarray, int]:
    """THE owner of the sharded-block layout: split ``nb`` instances into
    ``n_dev`` contiguous shards of ``nb_d = ceil(nb / n_dev)`` (instance g
    lives on shard ``g // nb_d``, the extractor's ``divmod`` mapping),
    pack each shard with ``pack_fn(slice, rows_pad, bw_d)``, zero-fill
    empty tail shards, and concatenate along the sharded word axis.
    Returns ``(packed (rows_pad, n_dev * bw_d) uint32, bw_d)``.  Both the
    generic bit-matrix path and the sweep's structured-RHS path build
    through here so the layout can never diverge from the extraction."""
    nb_d = -(-nb // n_dev)
    bw_d = multi_rhs._bw_for(nb_d)
    blocks = []
    for d in range(n_dev):
        sl = instances[d * nb_d : (d + 1) * nb_d]
        if sl.shape[0] == 0:  # trailing empty shard: phantom instances
            blocks.append(np.zeros((rows_pad, bw_d), np.uint32))
            continue
        blocks.append(pack_fn(sl, rows_pad, bw_d))
    return np.concatenate(blocks, axis=1), bw_d


def solve_multi_rhs_sharded(
    a32,
    cols: int,
    rhs_bits: np.ndarray | None,
    mode: int = 0,
    mesh=None,
    k_panel: int | None = None,
    phase1: str | None = None,
    phase2: str | None = None,
    basis_cache: dict | None = None,
    rhs_packed: np.ndarray | None = None,
    nb: int | None = None,
):
    """Solve the SAME coefficient matrix for many affine columns, instances
    sharded over the mesh batch axis (``ops/multi_rhs.solve_multi_rhs``
    contract: one entry per instance, a raw int / None in mode 0, a
    basis-sharing AffineSpace / None in mode 1).

    a32: (rows_pad, wp) packed matrix (a uint32 array or an int32 tensor,
    copied to each shard's device unless it lies there; its own bit-0
    affine column is inert); rhs_bits: (B, rows) uint8.  B may exceed
    n_dev * MAX_RHS only by chunking at the caller (as in
    ``LinearSystem._sweep_from_eqs``).

    ``rhs_packed`` / ``nb``: pre-packed alternative (pass ``rhs_bits=None``):
    a (rows_pad, n_dev * bw_d) uint32 block, shard d's instances in word
    columns [d*bw_d, (d+1)*bw_d) in ``_pack_rhs`` layout, bw_d the bucket
    for ceil(nb / n_dev).  Structured-RHS callers (the guess sweep) build
    this directly instead of materializing (B, rows) bits.
    """
    mesh, n_dev, _ = shard_capacity(mesh)
    rows_pad, wp = a32.shape
    if rhs_packed is not None:
        if nb is None:
            raise ValueError("rhs_packed requires nb")
        if nb == 0:
            return []
        nb_d = -(-nb // n_dev)
        bw_d, rem = divmod(rhs_packed.shape[1], n_dev)
        if rem or bw_d != multi_rhs._bw_for(nb_d):
            raise ValueError(
                f"rhs_packed width {rhs_packed.shape[1]} != n_dev * bucket "
                f"({n_dev} * {multi_rhs._bw_for(nb_d)}) for nb={nb}"
            )
    else:
        nb = rhs_bits.shape[0]
        if nb == 0:
            return []
        nb_d = -(-nb // n_dev)
        if nb_d > multi_rhs.MAX_RHS:
            raise ValueError(
                f"{nb} instances over {n_dev} devices is {nb_d}/device, "
                f"above MAX_RHS={multi_rhs.MAX_RHS}; chunk the batch"
            )
        rhs_packed, bw_d = pack_shard_blocks(
            np.asarray(rhs_bits, np.uint8), nb, n_dev, rows_pad,
            lambda sl, rp, bw: multi_rhs._pack_rhs(sl, rp, bw),
        )

    k_panel = k_panel or K_PANEL
    auto1, auto2 = _pick_engines(wp + multi_rhs._tiles_for(bw_d) * 128)
    phase1 = phase1 or auto1
    phase2 = phase2 or auto2

    sh = meshlib.batch_sharding(mesh)
    replicas: dict = {}  # device -> the matrix there, copied once
    outs = []
    for p, dev in zip(sh.positions, sh.devices):
        if dev not in replicas:
            replicas[dev] = (a32.to(dev) if isinstance(a32, torch.Tensor)
                             else u32_to_torch(np.asarray(a32, np.uint32), dev))
        rhs_d = u32_to_torch(rhs_packed[:, p * bw_d:(p + 1) * bw_d], dev)
        outs.append(multi_rhs.solve_multi_rhs_device(
            replicas[dev], cols, rhs_d, bw_d, k_panel, phase1, phase2))
    origins32 = torch_to_u32(torch.cat(collectives.readout(sh, [o[2] for o in outs])))
    unsat_words = torch_to_u32(torch.cat(collectives.readout(sh, [o[3] for o in outs])))
    rref_coeff, pof = outs[0][0][:, :wp], outs[0][1]

    bcache = basis_cache if basis_cache is not None else {}

    def _basis():
        if "basis" not in bcache:
            from ..ops import extract_device

            bcache["basis"] = extract_device._basis_host_orchestrated(
                rref_coeff, pof.cpu().numpy(), cols
            )
        return bcache["basis"]

    out = []
    slots = 32 * bw_d  # origin rows per shard block
    for g in range(nb):
        d, k = divmod(g, nb_d)
        if (int(unsat_words[d * bw_d + (k >> 5)]) >> (k & 31)) & 1:
            out.append(None)
            continue
        origin = packing.from_u32(origins32[d * slots + k][None, :])[0]
        if mode == 0:
            out.append(packing.words_to_int(origin))
        else:
            out.append(AffineSpace(origin, _basis(), cols))
    return out

"""The collectives of the sharded solvers, over one mesh axis.

The JAX package writes its sharded bodies inside ``shard_map`` and lets XLA
place ``lax.pmin`` / ``psum`` / ``pmax`` / ``all_gather`` on the
interconnect.  The port writes each body as steps between collectives, a
step being a loop over this process's shards of the axis
(``mesh.Sharding``), and provides exactly those four collectives.  Each
takes one tensor per local shard, reduces or stacks them on the first
local shard's device, then, when other processes own shards of the axis,
across processes through ``torch.distributed`` (NCCL on the card, gloo on
the CPU).  The result is the value every shard of the axis would hold
after the collective, kept once per process.

``COUNTS`` counts rounds by kind, as a test counts collective instructions
in the reference's compiled HLO.  ``readout`` is no round of an algorithm:
it reads a sharded result whole, as ``jax.device_get`` reads a global
array, and crosses processes only when the axis does (counted apart).
"""

from __future__ import annotations

import torch

from .mesh import Sharding, _mesh_key

COUNTS = {"pmin": 0, "psum": 0, "pmax": 0, "all_gather": 0, "readout": 0}

_GROUPS: dict = {}  # (mesh key, axis) -> {ranks: process group}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _process_group(sh: Sharding):
    """The process group of ``sh.ranks``; None without an initialised
    group, or when this process alone holds the line in a larger world.  A
    world of one still goes through ``torch.distributed``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    if len(sh.ranks) == dist.get_world_size():
        return dist.group.WORLD
    if len(sh.ranks) == 1:
        return None
    key = (_mesh_key(sh.mesh), sh.axis)
    if key not in _GROUPS:
        # new_group is itself collective: every process creates every line's
        # group, in the same order
        mesh = sh.mesh
        lines = ([mesh.procs[b] for b in range(mesh.shape["batch"])]
                 if sh.axis == "rows" else [mesh.procs])
        groups = {}
        for ranks in sorted({tuple(sorted(set(int(p) for p in ln.flat))) for ln in lines}):
            groups[ranks] = dist.new_group(list(ranks))
        _GROUPS[key] = groups
    return _GROUPS[key][tuple(sh.ranks)]


def _reduce(kind: str, sh: Sharding, xs: list, local_op, dist_op_name: str) -> torch.Tensor:
    import torch.distributed as dist

    COUNTS[kind] += 1
    home = xs[0].device
    t = local_op(torch.stack([x.to(home) for x in xs])) if len(xs) > 1 else xs[0].clone()
    pg = _process_group(sh)
    if pg is not None:
        dist.all_reduce(t, op=getattr(dist.ReduceOp, dist_op_name), group=pg)
    return t


def pmin(sh: Sharding, xs: list) -> torch.Tensor:
    """Elementwise minimum over every shard of the axis."""
    return _reduce("pmin", sh, xs, lambda s: s.amin(0), "MIN")


def pmax(sh: Sharding, xs: list) -> torch.Tensor:
    """Elementwise maximum over every shard of the axis."""
    return _reduce("pmax", sh, xs, lambda s: s.amax(0), "MAX")


def psum(sh: Sharding, xs: list) -> torch.Tensor:
    """Elementwise sum over every shard of the axis, in the tensors' dtype
    (int32 words wrap as the reference's uint32 do)."""
    return _reduce("psum", sh, xs, lambda s: s.sum(0, dtype=s.dtype), "SUM")


def all_gather(sh: Sharding, xs: list) -> torch.Tensor:
    """(size, *x.shape): every shard's tensor in axis order, in ONE round.
    Every shard sends the same shape."""
    import torch.distributed as dist

    COUNTS["all_gather"] += 1
    home = xs[0].device
    local = torch.stack([x.to(home) for x in xs])
    pg = _process_group(sh)
    if pg is None:
        return local
    parts = [torch.empty_like(local) for _ in sh.ranks]
    dist.all_gather(parts, local.contiguous(), group=pg)
    return torch.cat(parts)  # rank-major: the axis order


def readout(sh: Sharding, xs: list) -> list:
    """Every block of a sharded result, in axis order, on this process's
    home device: the local blocks, and the others' through
    ``torch.distributed`` when other processes hold some."""
    import torch.distributed as dist

    home = sh.home
    got = {p: x for p, x in zip(sh.positions, xs)}
    pg = _process_group(sh)
    if pg is not None and len(sh.ranks) > 1:  # every process of the line takes part
        COUNTS["readout"] += 1
        objs = [None] * len(sh.ranks)
        dist.all_gather_object(objs, {p: x.cpu() for p, x in got.items()}, group=pg)
        for part in objs:
            for p, x in part.items():
                got.setdefault(p, x)
    return [got[p].to(home) for p in range(sh.size)]

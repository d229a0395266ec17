"""Device meshes for the batched and row-sharded solvers.

Port of ``gf2bv_tpu/parallel/mesh.py``.  A :class:`Mesh` is a (batch, rows)
grid of shards, read through ``mesh.shape[BATCH_AXIS]`` /
``mesh.shape[ROWS_AXIS]`` as JAX's ``Mesh.shape`` is:

* ``"batch"`` — independent systems (data-parallel; the per-guess NLFSR
  subsystems of the original examples);
* ``"rows"``  — block row-sharding of one huge system (pivot election and
  pivot-row broadcast are collectives over this axis, parallel/
  collectives.py).

Each shard is a ``torch.device`` owned by one process.  Several shards may
name one device: each is then a slice of the work that the device runs in
turn, the counterpart of the JAX package's virtual CPU devices.  In a
multi-process run (parallel/distributed.py) the mesh is the world's grid,
rank-major, as JAX lays out the devices of its processes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.words import resolve_device
from .distributed import local_devices, rank_and_world

BATCH_AXIS = "batch"
ROWS_AXIS = "rows"


class Mesh:
    """A (batch, rows) grid of shards: ``devices[b, r]`` is the
    ``torch.device`` of shard (b, r) and ``procs[b, r]`` the rank of the
    process that owns it (all 0 in a single process)."""

    axis_names = (BATCH_AXIS, ROWS_AXIS)

    def __init__(self, devices: np.ndarray, procs: np.ndarray | None = None):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-D grid of devices, got shape {devices.shape}")
        self.devices = devices
        self.procs = (np.zeros(devices.shape, np.int64) if procs is None
                      else np.asarray(procs, np.int64).reshape(devices.shape))
        if np.any(np.diff(self.procs.flatten()) < 0):
            raise ValueError("the shards of a mesh are laid out rank-major")

    @property
    def shape(self) -> dict[str, int]:
        return {BATCH_AXIS: int(self.devices.shape[0]), ROWS_AXIS: int(self.devices.shape[1])}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}, "
                f"procs={self.procs.flatten().tolist()})")


def require_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a gf2bv_tpu_torch.parallel.mesh.Mesh (make_mesh), "
            f"got {type(mesh).__name__}"
        )
    return mesh


def make_mesh(batch: int | None = None, rows: int | None = None, devices=None) -> Mesh:
    """Build a (batch, rows) mesh.

    ``devices``: this process's devices, in order (default: every visible
    CUDA device, each once; in a multi-process run the process's own
    device, parallel/distributed.py).  Repeat a device to put several
    shards on it: ``devices=["cpu"] * 8`` is the CPU mesh of the tests,
    ``devices=["cuda:0"] * 4`` four shards on one card.  In a
    multi-process run every process passes its own devices and the mesh
    holds ``world * len(devices)`` shards, rank-major.  With only one knob
    given, the other absorbs the remaining shards; with none, all go on the
    batch axis."""
    world = rank_and_world()[1]
    if devices is None:
        devices = local_devices()
    local = [resolve_device(d) for d in devices]
    n = len(local) * world
    if batch is None and rows is None:
        batch, rows = n, 1
    elif batch is None:
        batch = n // rows
    elif rows is None:
        rows = n // batch
    if batch * rows != n or n == 0:
        raise ValueError(f"mesh {batch}x{rows} != {n} devices")
    devs = np.empty(n, dtype=object)
    for i in range(n):
        devs[i] = local[i % len(local)]
    procs = np.repeat(np.arange(world), len(local))
    return Mesh(devs.reshape(batch, rows), procs.reshape(batch, rows))


def _mesh_key(mesh: Mesh):
    """Value key of a mesh: its shape, its devices and their owners."""
    return (
        tuple(sorted(mesh.shape.items())),
        tuple(str(d) for d in mesh.devices.flat),
        tuple(int(p) for p in mesh.procs.flat),
    )


class Sharding:
    """One mesh axis as this process sees it.

    A tensor sharded over ``axis`` is split into ``size`` equal contiguous
    blocks of its leading dimension, block i on the shards at index i of the
    axis; the shards along the other axis hold copies, which this process
    computes once.  ``positions`` are the axis indices of the blocks this
    process holds and ``devices`` their devices (the first of its devices at
    that index).  ``ranks`` are the processes that take part in collectives
    over the axis: for the rows axis those owning the batch row this
    process computes in, for the batch axis every owner of a shard."""

    def __init__(self, mesh: Mesh, axis: str):
        mesh = require_mesh(mesh)
        if axis not in (BATCH_AXIS, ROWS_AXIS):
            raise ValueError(f"unknown mesh axis {axis!r}")
        rank, world = rank_and_world()
        mine = mesh.procs == rank
        if not mine.any():
            raise ValueError(f"process {rank} owns no shard of {mesh}")
        self.mesh, self.axis = mesh, axis
        self.size = mesh.shape[axis]
        if axis == ROWS_AXIS:
            # checked for every process alike, so that all of them raise
            if world > 1 and any(len(set(np.nonzero(mesh.procs == r)[0])) > 1
                                 for r in range(world)):
                raise ValueError(
                    f"a process owns shards in several batch rows of {mesh}; a "
                    "row-sharded solve needs each process's shards in one batch row"
                )
            line = int(np.nonzero(mine.any(axis=1))[0][0])
            self.positions = [r for r in range(self.size) if mine[line, r]]
            self.devices = [mesh.devices[line, r] for r in self.positions]
            line_procs = mesh.procs[line]
        else:
            self.positions = [b for b in range(self.size) if mine[b].any()]
            self.devices = [mesh.devices[b, int(np.argmax(mine[b]))] for b in self.positions]
            line_procs = mesh.procs
        self.ranks = sorted(set(int(p) for p in line_procs.flat))

    @property
    def home(self) -> torch.device:
        """Where this process keeps the values every shard of the axis holds
        alike (the pivot rows, the pivot map)."""
        return self.devices[0]

    def split(self, x) -> list[torch.Tensor]:
        """This process's blocks of ``x`` (a uint32 numpy array or an int32
        tensor, leading dimension a multiple of ``size``), each on its
        device."""
        from ..core.words import u32_to_torch

        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"leading dimension {n} is not a multiple of the {self.axis} "
                             f"axis ({self.size})")
        blk = n // self.size
        out = []
        for p, dev in zip(self.positions, self.devices):
            piece = x[p * blk:(p + 1) * blk]
            if isinstance(piece, torch.Tensor):  # a copy: the solvers work in place
                out.append(piece.to(dev, copy=True).contiguous())
            else:
                out.append(u32_to_torch(np.ascontiguousarray(piece), dev))
        return out


def batch_sharding(mesh: Mesh) -> Sharding:
    """Instances split over the batch axis (rows axis replicated)."""
    return Sharding(mesh, BATCH_AXIS)


def rows_sharding(mesh: Mesh) -> Sharding:
    """Rows of one system split over the rows axis (batch axis replicated)."""
    return Sharding(mesh, ROWS_AXIS)

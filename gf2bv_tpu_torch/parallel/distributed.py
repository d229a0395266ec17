"""Multi-process setup: one process per GPU (NCCL) or per CPU host (gloo),
glued by ``torch.distributed``.

Port of ``gf2bv_tpu/parallel/distributed.py``.  The reference lets XLA
compile the collectives of its ``shard_map`` bodies; here the sharded
solvers call parallel/collectives.py, which reduces over this process's
shards first and then across processes through ``torch.distributed``.

Usage (same program in every process):

    from gf2bv_tpu_torch.parallel import distributed, mesh as meshlib
    distributed.initialize()                    # reads env or explicit args
    mesh = meshlib.make_mesh(rows=distributed.world_size())
    ... parallel.solve_sharded(eqs, cols, mode, mesh) ...

``initialize`` takes ``coordinator_address`` / ``num_processes`` /
``process_id``, or ``GF2BV_TPU_COORD`` / ``GF2BV_TPU_NPROC`` /
``GF2BV_TPU_PROC_ID``; an address without a scheme is a TCP host:port.
Nothing tells a program of a cluster: every process names the same
address, the world size and its own rank (or, left unset, the world's
``env://`` variables, as ``torchrun`` sets them).  ``device="cuda"`` (the
default) uses NCCL and sets the process's card to ``cuda:{rank %
device_count}``; ``device="cpu"`` uses gloo.
"""

from __future__ import annotations

import os

import torch

_LOCAL_DEVICES: list = []  # this process's devices, set by initialize()


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> None:
    import torch.distributed as dist

    from ..core.words import resolve_device

    coordinator_address = coordinator_address or os.environ.get("GF2BV_TPU_COORD")
    if num_processes is None and "GF2BV_TPU_NPROC" in os.environ:
        num_processes = int(os.environ["GF2BV_TPU_NPROC"])
    if process_id is None and "GF2BV_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["GF2BV_TPU_PROC_ID"])

    dev = resolve_device(device)
    kwargs = {}
    if coordinator_address:
        kwargs["init_method"] = (coordinator_address if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kwargs)
    if dev.type == "cuda":
        # the rank is known only now when it came from the environment
        index = dev.index if dev.index is not None else (
            dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(index)
        _LOCAL_DEVICES[:] = [torch.device("cuda", index)]
    else:
        _LOCAL_DEVICES[:] = [torch.device("cpu")]


def shutdown() -> None:
    """Leave the process group (the counterpart of ``initialize``), with the
    sub-groups that the collectives made in it."""
    import torch.distributed as dist

    from . import collectives

    if dist.is_initialized():
        dist.destroy_process_group()
    collectives._GROUPS.clear()
    _LOCAL_DEVICES.clear()


def rank_and_world() -> tuple[int, int]:
    """(this process's rank, the world size); (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_size() -> int:
    return rank_and_world()[1]


def is_multi_process() -> bool:
    return world_size() > 1


def local_devices() -> list:
    """This process's devices for a mesh built without ``devices=``: the one
    that :func:`initialize` set, else every visible CUDA device once."""
    if _LOCAL_DEVICES:
        return list(_LOCAL_DEVICES)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device for a mesh; pass devices=... (for example ['cpu'] * 8, "
            "a mesh of CPU shards) to make_mesh"
        )
    return [torch.device("cuda", i) for i in range(n)]

"""The launch floor: what one kernel launch costs when it does nothing.

Port of the probe in ``scripts/bench_launch_floor.py`` (``_copy_kernel`` via
``tiny_call``): ``out = a ^ 1`` on a (256, 128)-word array in ONE launch of
a kernel that does no work worth the name (32 blocks of 256 threads, one
16-byte vector a thread: no single SM's bandwidth is in the way, as it was
when one block streamed the 256 KB).  A chain of such launches prices a
launch on this card; a solve makes some 400 of them, and the scan's
microseconds per pivot step are read against it.

* :func:`tiny_call` — the probe; CUDA ``csrc/launch_probe.cu``
  (``gf2_launch_probe``), plain twin :func:`tiny_call_plain`.
* :func:`measure` — microseconds per launch over ``n`` back-to-back launches
  (CUDA events) of three rungs: the probe, ``torch.bitwise_xor(a, 1)`` (the
  one PyTorch call that computes the same function) and the rank-256
  ``update_full`` on one (256-row, 128-word) tile.  The chain is replayed
  from a CUDA graph, so that no host work lies between the launches: that is
  the card's own floor.  The probe is also timed launched from Python, where
  the host's enqueue is the slower side, as it is in a solve.  The third
  rung is a kernel that does a tile's work: its time is that kernel's
  latency, read against the floor, and not a floor itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.words import I32, resolve_device, u32_to_torch
from . import _cuda
from .panel_update import update_full

PROBE_SHAPE = (256, 128)


def tiny_call_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`tiny_call`."""
    return a ^ 1


def tiny_call(a: torch.Tensor) -> torch.Tensor:
    """``a ^ 1`` as a new tensor, computed in one launch (16-byte accesses,
    one vector a thread; the ``numel % 4`` last words one by one)."""
    if not _cuda.on_cuda(a):
        return tiny_call_plain(a)
    _cuda.require(a, "a", tuple(a.shape), a.device)
    out = torch.empty_like(a)
    rc = _cuda.lib().gf2_launch_probe(
        out.data_ptr(), a.data_ptr(), a.numel(), _cuda.stream_of(a),
    )
    _cuda.check(rc, "launch probe kernel")
    _cuda.LAUNCHES["launch_probe"] += 1
    return out


def chain_us(step, x: torch.Tensor, n: int, graph: bool = False) -> float:
    """Microseconds per call of ``x = step(x)`` chained ``n`` times on a CUDA
    tensor (CUDA events).  ``graph``: the chain is captured into a CUDA graph
    once and a replay is timed, so no host work lies between the launches."""
    for _ in range(8):
        step(x)
    torch.cuda.synchronize(x.device)

    def run(y):
        for _ in range(n):
            y = step(y)
        return y

    if graph:
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cuda_graph):
            run(x)
        cuda_graph.replay()
        torch.cuda.synchronize(x.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        cuda_graph.replay()
    else:
        run(x)
    end.record()
    torch.cuda.synchronize(x.device)
    return 1000.0 * start.elapsed_time(end) / n


def measure(device="cuda", n: int = 256, seed: int = 7) -> dict:
    """Microseconds per launch on ``device`` (a CUDA device) over ``n``
    chained launches replayed from a CUDA graph: ``probe_us``
    (:func:`tiny_call`, the card's launch floor), ``bitwise_xor_us``
    (``torch.bitwise_xor(a, 1)``) and ``update_tile_us`` (``update_full`` at
    rank 256 on one (256, 128) tile: that kernel's latency, to read against
    the floor).  ``probe_python_us`` is the probe's chain launched from
    Python, the host's enqueue included."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the launch floor is a device time: measure() needs a CUDA device")
    rng = np.random.default_rng(seed)

    def rand(shape):
        return u32_to_torch(rng.integers(0, 2**32, size=shape, dtype=np.uint32), dev)

    a = rand(PROBE_SHAPE)
    sel, pf = rand((PROBE_SHAPE[0], 8)), rand((256, PROBE_SHAPE[1]))
    one = torch.ones((), dtype=I32, device=dev)
    return {
        "n": n,
        "probe_us": chain_us(tiny_call, a, n, graph=True),
        "probe_python_us": chain_us(tiny_call, a, n),
        "bitwise_xor_us": chain_us(lambda x: torch.bitwise_xor(x, one), a, n, graph=True),
        "update_tile_us": chain_us(lambda x: update_full(x, sel, pf), a.clone(), n, graph=True),
    }

"""Affine-space enumeration and the quadratic consistency filter on the device.

Port of ``gf2bv_tpu/ops/enumerate.py``, plain torch (the reference is plain
jnp, no Pallas kernel).  A whole chunk of points is computed as
``origin ^ (selector bits x basis)`` at once, in the reference's exact
enumeration order (Gray code for dim <= 64); the QuadraticSystem
consistency filter then runs over the chunk, so large candidate spaces are
filtered without a Python int per point.

The reference carries the enumeration index as a (hi, lo) uint32 pair
because the TPU lacks 64-bit integers.  Here it is one int64 holding the
uint64 bit pattern: additions wrap modulo 2^64 as the pair does, and the
Gray code's right shift is masked, since ``>>`` on int64 is arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.words import I32, torch_to_u32, u32_to_torch

_LOW63 = (1 << 63) - 1


def _as_int64(x: int) -> int:
    """The int64 with the bit pattern of ``x`` modulo 2^64."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


def enumerate_points(origin: torch.Tensor, basis: torch.Tensor, start: int, count: int,
                     gray: bool) -> torch.Tensor:
    """points[i] = origin ^ combo(bits(order(start + i))) for i < count.

    origin: (W32,) int32; basis: (dim, W32) int32 on the same device, dim <=
    64; the index runs modulo 2^64.  Returns (count, W32) int32."""
    dim = basis.shape[0]
    assert dim <= 64, "use the host iterator beyond 64 dims"
    idx = torch.arange(count, dtype=torch.int64, device=origin.device) + _as_int64(start)
    if gray:
        idx = idx ^ ((idx >> 1) & _LOW63)
    out = origin.expand(count, origin.shape[0]).clone()
    for j in range(dim):
        take = ((idx >> j) & 1).bool()
        out ^= torch.where(take[:, None], basis[j][None, :], 0)
    return out


def quad_consistency_mask(points: torch.Tensor, n: int) -> torch.Tensor:
    """For packed solutions over (n linear + n(n-1)/2 quad) bits, a bool mask
    of the points whose quad block equals the outer product of the linear
    block: the device form of ``QuadraticSystem.convert_sol``'s filter."""
    tri_i, tri_j = np.tril_indices(n, k=-1)
    nbits = n + tri_i.size
    j = torch.arange(nbits, device=points.device)
    # only bit 0 of each shifted word is kept, so the sign extension of >> is harmless
    bits = ((points[:, j >> 5] >> (j & 31).to(I32)) & 1).to(torch.uint8)
    ti = torch.from_numpy(tri_i).to(points.device)
    tj = torch.from_numpy(tri_j).to(points.device)
    expected = bits[:, ti] & bits[:, tj]
    return (expected == bits[:, n:nbits]).all(dim=1)


def enumerate_device(space, start: int, count: int, device="cuda") -> torch.Tensor:
    """A chunk of ``space`` in its canonical iteration order on ``device``.
    Spaces beyond 64 dims must use the host iterator (their order is the
    plain binary counter)."""
    gray = space.dimension <= 64
    origin32 = u32_to_torch(packing.to_u32(space._origin[None, :])[0], device)
    basis32 = u32_to_torch(packing.to_u32(space._basis), device)
    return enumerate_points(origin32, basis32, start, count, gray)


def iter_quad_filtered(space, lin_size: int, chunk: int = 4096, device="cuda"):
    """Yield the raw solution ints of ``space`` that pass the quadratic
    consistency filter, filtering whole chunks on ``device``."""
    total = 1 << space.dimension
    done = 0
    while done < total:
        nchunk = min(chunk, total - done)
        pts = enumerate_device(space, done, nchunk, device)
        mask = quad_consistency_mask(pts, lin_size)
        if bool(mask.any()):
            rows = packing.from_u32(torch_to_u32(pts[mask]))
            yield from packing.rows_to_ints(rows)
        done += nchunk

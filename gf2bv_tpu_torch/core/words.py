"""Packed 32-bit words as ``torch.int32`` tensors.

The port keeps the JAX package's device layout (``gf2bv_tpu/core/packing.py``):
bit ``j`` of a packed row lives in 32-bit word ``j >> 5`` at bit ``j & 31``,
and bit 0 is the affine term.  The reference stores words as ``uint32``;
PyTorch's ``uint32`` lacks shifts on the CPU, so the port stores the same bit
patterns as ``int32``.  Two consequences, handled here once:

* ``>>`` on int32 is arithmetic (sign-extending), so a logical right shift
  masks afterwards (:func:`srl`);
* integer sums promote to int64, so packed bits are combined with OR/XOR
  folds (:func:`or_fold`, :func:`xor_fold`), never with ``sum``.

CUDA kernels receive the same buffers as ``uint32_t*``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling

I32 = torch.int32


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device that is not present
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``; a copy to a CUDA device counts one
    ``h2d_copies`` (utils/profiling.count)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        profiling.count("h2d_copies")
    return t.to(dev)


def u32_to_torch(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor with the same bits on ``device``."""
    arr = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
    return to_device(torch.from_numpy(arr.copy()), resolve_device(device))


def torch_to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 array with the same bits (host copy)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32).copy()


def srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 words by a constant ``n`` (0..31)."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (32 - n)) - 1)


def bit_i32(shift: torch.Tensor) -> torch.Tensor:
    """int32 words with only bit ``shift`` set (bit 31 is -2**31)."""
    return torch.ones_like(shift, dtype=I32) << shift.to(I32)


def _fold(x: torch.Tensor, dim: int, op) -> torch.Tensor:
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        n = x.shape[0]
        h = n // 2
        y = op(x[:h], x[h : 2 * h])
        if n % 2:
            y[0] = op(y[0], x[2 * h])
        x = y
    return x[0]


def xor_fold(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """XOR-reduce ``x`` along ``dim`` (torch has no XOR reduction)."""
    return _fold(x, dim, torch.bitwise_xor)


def or_fold(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """OR-reduce ``x`` along ``dim``."""
    return _fold(x, dim, torch.bitwise_or)


def parity32(x: torch.Tensor) -> torch.Tensor:
    """Per-word GF(2) parity (0 or 1) of int32 words."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ srl(x, s)
    return x & 1

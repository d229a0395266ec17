"""Solver dispatch: route a packed GF(2) system to a backend.

Port of ``gf2bv_tpu/ops/solver.py``:

* mode 0 -> one particular solution as a raw int, or None if unsatisfiable;
* mode 1 -> the full affine solution space (:class:`AffineSpace`), or None.

Backends:

* ``blocked`` — panel-blocked elimination (ops/gauss_blocked.py), the
  Hopper kernels' path, with the engines of ``gauss_blocked._pick_engines``;
* ``jax`` — the per-pivot solver (ops/gauss_jax.py), plain torch;
* ``native`` — the host C engine (``_native``), built by gcc at first use;
* ``oracle`` — the slow host numpy reference (ops/gauss_ref.py).

``None`` and ``"auto"`` resolve by device and size.  On the card auto is
``blocked`` at every size: chip_smoke.py's routing sweep found the blocked
kernels faster than the per-pivot loop from 16 columns up (PERF.md §6).  On
the CPU it resolves as in the reference: ``blocked`` from
``_BLOCKED_THRESHOLD`` columns up, ``jax`` below, and in place of the
reference's probe of the JAX platform ``native`` when the C engine builds and
``GF2BV_TPU_CPU_NATIVE`` is not ``"0"``.  ``GF2BV_TPU_BACKEND`` names the
backend when no argument does.  Unknown names raise.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import packing
from ..core.affine import AffineSpace
from ..core.words import resolve_device, torch_to_u32
from . import gauss_blocked, gauss_jax

# Column count from which the panel-blocked solver replaces the per-pivot
# loop on the CPU: the reference's value, kept for parity.
_BLOCKED_THRESHOLD = 1024

_BACKENDS = ("jax", "blocked", "native", "oracle")
_HOST_BACKENDS = ("native", "oracle")


def _cpu_prefers_native(device) -> bool:
    if torch.device(device).type != "cpu":
        return False
    if os.environ.get("GF2BV_TPU_CPU_NATIVE", "1") == "0":
        return False
    from .. import _native

    return _native.available()


def _resolve_backend(backend: str | None, cols: int, device="cuda") -> str:
    """The backend that solves a system of ``cols`` columns on ``device``."""
    b = backend or os.environ.get("GF2BV_TPU_BACKEND")
    if not b or b == "auto":
        if torch.device(device).type == "cuda":
            return "blocked"
        if _cpu_prefers_native(device):
            return "native"
        return "blocked" if cols >= _BLOCKED_THRESHOLD else "jax"
    if b not in _BACKENDS:
        raise ValueError(
            f"unknown backend {b!r}; expected one of {('auto',) + _BACKENDS}"
        )
    return b


def _auto_backend(cols: int, device="cuda") -> str:
    """The default backend for ``cols`` columns on ``device``."""
    return _resolve_backend(None, cols, device)


def _result(raw, cols: int, mode: int):
    """A solver's packed result -> the public mode-0 int / mode-1 space."""
    if raw is None:
        return None
    if mode == 0:
        return packing.words_to_int(raw[0] if isinstance(raw, tuple) else raw)
    return AffineSpace(raw[0], raw[1], cols)


def solve(eqs: np.ndarray, cols: int, mode: int, backend: str | None = None,
          device="cuda"):
    """eqs: packed (rows, W64) uint64 over 1+cols bits (bit 0 = const)."""
    from ..utils import profiling

    backend = _resolve_backend(backend, cols, device)
    with profiling.phase(f"solve[{backend}]"):
        return _solve(eqs, cols, mode, backend, device)


def solve_packed(eqs, cols: int, mode: int, backend: str | None = None,
                 device="cuda"):
    """Like :func:`solve`, but also accepts a (rows, W32) int32 tensor (for
    example from ops/quad_device.py), which ``blocked`` and ``jax`` pad and
    solve on its own device without a host round trip; a host backend pulls
    it back once."""
    if isinstance(eqs, np.ndarray):
        eqs64 = eqs if eqs.dtype == np.uint64 else packing.from_u32(eqs)
        return solve(eqs64, cols, mode, backend, device=device)
    if not isinstance(eqs, torch.Tensor) or eqs.dtype != torch.int32:
        raise TypeError("eqs must be a numpy array or an int32 torch tensor")
    resolve_device(eqs.device)
    resolved = _resolve_backend(backend, cols, eqs.device)
    if resolved in _HOST_BACKENDS:
        return _solve(packing.from_u32(torch_to_u32(eqs)), cols, mode, resolved, device)
    if resolved == "blocked":
        a = gauss_blocked._pad_device(eqs, gauss_blocked.K_PANEL, 128)
        return _result(gauss_blocked.solve_on_device(a, cols, mode), cols, mode)
    bucket = gauss_jax._ROW_BUCKET
    want = max(bucket, -(-eqs.shape[0] // bucket) * bucket)
    a = torch.nn.functional.pad(eqs, (0, 0, 0, want - eqs.shape[0]))
    return _result(gauss_jax.solve_on_device(a, cols, mode), cols, mode)


def _solve(eqs: np.ndarray, cols: int, mode: int, backend: str, device):
    if backend == "oracle":
        from .gauss_ref import solve_oracle

        res = solve_oracle(eqs, cols, mode)
        raw = (res.origin, res.basis) if res.consistent else None
    elif backend == "native":
        from .._native import solve_native

        raw = solve_native(eqs, cols, mode)
    elif backend == "blocked":
        raw = gauss_blocked.solve_blocked(eqs, cols, mode, device=device)
    else:
        raw = gauss_jax.solve_jax(eqs, cols, mode, device=device)
    return _result(raw, cols, mode)

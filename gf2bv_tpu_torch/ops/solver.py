"""Solver dispatch: route a packed GF(2) system to a backend (mode 0).

Port of ``gf2bv_tpu/ops/solver.py``.  The port has one backend, the
panel-blocked solver (ops/gauss_blocked.py), which pads any system, so
``None``, ``"auto"`` and ``"blocked"`` resolve to it at every size.  The
reference's other backends are later slices and raise:

* ``jax`` (per-pivot small-system path) — ROADMAP queue 1 item 5;
* ``native`` (host C engine) — ROADMAP queue 1 item 5;
* ``oracle`` (host numpy reference) — ROADMAP queue 1 item 5.

Mode 1 (the affine solution space) is ROADMAP queue 1 item 2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.words import resolve_device, torch_to_u32
from .gauss_blocked import K_PANEL, _pad_device, rref_origin_blocked, solve_blocked

_LATER = {
    "jax": "ROADMAP queue 1 item 5 (per-pivot small-system solver)",
    "native": "ROADMAP queue 1 item 5 (host C engine routing)",
    "oracle": "ROADMAP queue 1 item 5 (host numpy oracle)",
}


def _resolve_backend(backend: str | None) -> str:
    if backend in (None, "auto", "blocked"):
        return "blocked"
    if backend in _LATER:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet: {_LATER[backend]}"
        )
    raise ValueError(
        f"unknown backend {backend!r}; expected one of "
        f"{('auto', 'blocked') + tuple(_LATER)}"
    )


def _check_mode(mode: int) -> None:
    if mode != 0:
        raise NotImplementedError(
            "mode 1 (affine solution space) is ROADMAP queue 1 item 2"
        )


def solve(eqs: np.ndarray, cols: int, mode: int, backend: str | None = None,
          device="cuda"):
    """eqs: packed (rows, W64) uint64 over 1+cols bits (bit 0 = const).
    Mode 0: one solution as a raw int, or None if unsatisfiable."""
    _resolve_backend(backend)
    _check_mode(mode)
    origin = solve_blocked(eqs, cols, mode, device=device)
    if origin is None:
        return None
    return packing.words_to_int(origin)


def solve_packed(eqs, cols: int, mode: int, backend: str | None = None,
                 device="cuda"):
    """Like :func:`solve`, but also accepts a (rows, W32) int32 tensor, which
    is padded and solved on its own device without a host round trip."""
    if isinstance(eqs, np.ndarray):
        eqs64 = eqs if eqs.dtype == np.uint64 else packing.from_u32(eqs)
        return solve(eqs64, cols, mode, backend, device=device)
    _resolve_backend(backend)
    _check_mode(mode)
    if not isinstance(eqs, torch.Tensor) or eqs.dtype != torch.int32:
        raise TypeError("eqs must be a numpy array or an int32 torch tensor")
    resolve_device(eqs.device)
    a = _pad_device(eqs, K_PANEL, 128)
    origin32, unsat = rref_origin_blocked(a, cols, K_PANEL)
    if bool(unsat):
        return None
    return packing.words_to_int(packing.from_u32(torch_to_u32(origin32)[None, :])[0])

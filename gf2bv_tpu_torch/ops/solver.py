"""Solver dispatch: route a packed GF(2) system to a backend.

Port of ``gf2bv_tpu/ops/solver.py``:

* mode 0 -> one particular solution as a raw int, or None if unsatisfiable;
* mode 1 -> the full affine solution space (:class:`AffineSpace`), or None.

Backends:

* ``blocked`` — panel-blocked elimination (ops/gauss_blocked.py), the
  Hopper kernels' path; ``None`` and ``"auto"`` resolve to it at every size;
* ``jax`` — the per-pivot solver (ops/gauss_jax.py), plain torch.

The reference's size-based auto routing and its host backends ``native``
(C engine) and ``oracle`` (numpy) are ROADMAP queue 1 item 5; the two
backends raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.affine import AffineSpace
from ..core.words import resolve_device
from . import gauss_blocked, gauss_jax

_LATER = {
    "native": "ROADMAP queue 1 item 5 (host C engine routing)",
    "oracle": "ROADMAP queue 1 item 5 (host numpy oracle)",
}


def _resolve_backend(backend: str | None) -> str:
    if backend in (None, "auto", "blocked"):
        return "blocked"
    if backend == "jax":
        return "jax"
    if backend in _LATER:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet: {_LATER[backend]}"
        )
    raise ValueError(
        f"unknown backend {backend!r}; expected one of "
        f"{('auto', 'blocked', 'jax') + tuple(_LATER)}"
    )


def _result(raw, cols: int, mode: int):
    """A solver's packed result -> the public mode-0 int / mode-1 space."""
    if raw is None:
        return None
    if mode == 0:
        return packing.words_to_int(raw)
    return AffineSpace(raw[0], raw[1], cols)


def solve(eqs: np.ndarray, cols: int, mode: int, backend: str | None = None,
          device="cuda"):
    """eqs: packed (rows, W64) uint64 over 1+cols bits (bit 0 = const)."""
    if _resolve_backend(backend) == "jax":
        return _result(gauss_jax.solve_jax(eqs, cols, mode, device=device), cols, mode)
    return _result(gauss_blocked.solve_blocked(eqs, cols, mode, device=device), cols, mode)


def solve_packed(eqs, cols: int, mode: int, backend: str | None = None,
                 device="cuda"):
    """Like :func:`solve`, but also accepts a (rows, W32) int32 tensor, which
    is padded and solved on its own device without a host round trip."""
    if isinstance(eqs, np.ndarray):
        eqs64 = eqs if eqs.dtype == np.uint64 else packing.from_u32(eqs)
        return solve(eqs64, cols, mode, backend, device=device)
    resolved = _resolve_backend(backend)
    if not isinstance(eqs, torch.Tensor) or eqs.dtype != torch.int32:
        raise TypeError("eqs must be a numpy array or an int32 torch tensor")
    resolve_device(eqs.device)
    if resolved == "blocked":
        a = gauss_blocked._pad_device(eqs, gauss_blocked.K_PANEL, 128)
        return _result(gauss_blocked.solve_on_device(a, cols, mode), cols, mode)
    bucket = gauss_jax._ROW_BUCKET
    want = max(bucket, -(-eqs.shape[0] // bucket) * bucket)
    a = torch.nn.functional.pad(eqs, (0, 0, 0, want - eqs.shape[0]))
    return _result(gauss_jax.solve_on_device(a, cols, mode), cols, mode)

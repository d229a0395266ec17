"""Trace-cache serialization.

The reference exploits that a system's symbolic trace is input-independent
and pickles traced zeros (``reference:examples/nlfsr_ex.py:28-48``);
everything here pickles too (BitVec/LinearSystem/AffineSpace carry packed
numpy arrays).  For large traces, the packed equation matrix itself is the
compact artifact — save/load it directly as compressed npz.

Port copy of ``gf2bv_tpu/utils/serialization.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
Change: :func:`solve_saved` solves on the system's device.
"""

from __future__ import annotations

import numpy as np

from ..core import packing


def save_eqs(path, eqs: np.ndarray, cols: int) -> None:
    """Save a packed (rows, W64) equation matrix (compressed)."""
    np.savez_compressed(path, eqs=eqs, cols=np.int64(cols))


def load_eqs(path) -> tuple[np.ndarray, int]:
    with np.load(path) as z:
        return z["eqs"].astype(np.uint64), int(z["cols"])


def save_zeros(path, system, zeros) -> None:
    """Flatten + save a zeros list as its packed equation matrix."""
    save_eqs(path, system.get_eqs_packed(zeros), system._cols)


def solve_saved(path, system, mode: int = 0):
    """Solve a saved equation matrix with the system's backend on the
    system's device."""
    from ..ops import solver

    eqs, cols = load_eqs(path)
    assert cols == system._cols, "system/cache column mismatch"
    raw = solver.solve(eqs, cols, mode, backend=system._backend, device=system._device)
    return raw

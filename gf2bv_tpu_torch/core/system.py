"""LinearSystem — the trace -> matrix -> solve API (mode 0 slice).

Port of ``gf2bv_tpu/core/system.py``.  Tracing and equation assembly are
the reference's numpy code; solving runs the blocked solver on ``device``
(CUDA by default; ``device="cpu"`` runs the plain PyTorch twins of the
kernels).  A CUDA device that is not present raises.

Ported: ``gens`` (lazy and eager), ``get_eqs_packed``, ``get_eqs``,
``solve_raw_one``, ``solve_one``, ``convert_sol``, ``solve_raw_packed`` and
``solve_one_packed`` (mode 0), ``evaluate``.  The rest of the reference
surface raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import packing
from .bitvec import BitVec
from .words import resolve_device

Zeros = Sequence["BitVec | int"]


def _later(what: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")

    method.__name__ = what
    method.__doc__ = f"Not ported yet (ROADMAP {item})."
    return method


class LinearSystem:
    def __init__(self, sizes, backend: str | None = None, device="cuda"):
        self._sizes = list(sizes)
        self._cols = sum(self._sizes)
        self._nbits = 1 + self._cols  # packed bit 0 = affine constant
        self._backend = backend
        self._device = resolve_device(device)

        nw = packing.nwords64(self._nbits)
        _vars: list[BitVec] = []
        i = 1
        for size in self._sizes:
            rows = packing.bit_rows(self._nbits, np.arange(i, i + size))
            _vars.append(BitVec(rows, self._nbits))
            i += size
        self._vars = tuple(_vars)
        self._lazy_vars: tuple[BitVec, ...] | None = None
        self._nw = nw

    # -- generators ---------------------------------------------------------

    def gens(self, *, lazy: bool = True) -> tuple[BitVec, ...]:
        """The symbolic variable blocks: lazy bitvecs by default (ops record
        a trace DAG, so the coefficient matrix is built and cached once per
        structure); ``lazy=False`` returns the eager packed variables."""
        if not lazy:
            return self._vars
        if self._lazy_vars is None:
            from .lazy import LazyBitVec, _digest, _ints

            sizes_digest = _digest(b"gens", _ints(*self._sizes, self._nbits))
            self._lazy_vars = tuple(
                LazyBitVec.from_eager(
                    v, structural_name=_digest(sizes_digest, _ints(k))
                )
                for k, v in enumerate(self._vars)
            )
        return self._lazy_vars

    def __reduce__(self):
        return (self.__class__, (self._sizes, self._backend, str(self._device)))

    @property
    def cols(self) -> int:
        return self._cols

    # -- equation assembly ----------------------------------------------------

    def get_eqs_packed(self, zeros: Zeros) -> np.ndarray:
        """Stack zeros into a packed (rows, W64) matrix, dropping zero rows."""
        from .lazy import materialize_pending, pad_mats_to_words

        materialize_pending(zeros)
        blocks = []
        for bv in zeros:
            if isinstance(bv, BitVec):
                blocks.append(bv.rows)
            elif bv:  # raw int mask; 0 is dropped
                blocks.append(packing.int_to_words(bv, self._nbits)[None, :])
        if not blocks:
            return np.zeros((0, self._nw), dtype=np.uint64)
        mat = np.concatenate(pad_mats_to_words(blocks, self._nw), axis=0)
        return mat[mat.any(axis=1)]

    def get_eqs(self, zeros: Zeros) -> list[int]:
        """Reference-compatible: the equations as big-int masks."""
        return packing.rows_to_ints(self.get_eqs_packed(zeros))

    # -- solving --------------------------------------------------------------

    def _solve_internal(self, zeros: Zeros, mode: int):
        from ..ops import lazy_solve, solver

        if lazy_solve.eligible(self, zeros):
            return lazy_solve.solve_lazy(self, list(zeros), mode)
        eqs = self.get_eqs_packed(zeros)
        # literal 1 == unsatisfiable 0*x = 1: the row has only the affine bit
        lit_one = (eqs[:, 0] == 1) & ~eqs[:, 1:].any(axis=1)
        if lit_one.any():
            return None
        return solver.solve(eqs, self._cols, mode, self._backend, device=self._device)

    def _convert_sol(self, s: int) -> tuple[int, ...]:
        sol = []
        for size in self._sizes:
            sol.append(s & ((1 << size) - 1))
            s >>= size
        assert s == 0, "Invalid solution"
        return tuple(sol)

    def convert_sol(self, s: int) -> Optional[tuple[int, ...]]:
        return self._convert_sol(s)

    def solve_raw_one(self, zeros: Zeros) -> Optional[int]:
        return self._solve_internal(zeros, 0)

    def solve_one(self, zeros: Zeros):
        sol = self._solve_internal(zeros, 0)
        if sol is None:
            return None
        return self.convert_sol(sol)

    def solve_raw_packed(self, eqs, mode: int):
        """Solve a PRE-PACKED matrix: (rows, W64) uint64 or (rows, W32)
        uint32 host rows, or a (rows, W32) int32 tensor solved where it
        lies.  Mode 0 only."""
        from ..ops import solver

        return solver.solve_packed(eqs, self._cols, mode, self._backend,
                                   device=self._device)

    def solve_one_packed(self, eqs):
        sol = self.solve_raw_packed(eqs, 0)
        if sol is None:
            return None
        return self.convert_sol(sol)

    def evaluate(self, bv: BitVec, sol: tuple[int, ...]) -> int:
        s = 0
        for v, sz in zip(reversed(sol), reversed(self._sizes)):
            s <<= sz
            s |= v
        return bv.evaluate(s)

    # -- later slices --------------------------------------------------------

    solve_raw_space = _later("solve_raw_space", "queue 1 item 2 (mode 1)")
    solve_all = _later("solve_all", "queue 1 item 2 (mode 1)")
    solve_all_packed = _later("solve_all_packed", "queue 1 item 2 (mode 1)")
    capture = _later("capture", "queue 1 item 6 (core/capture.py)")
    solve_one_sweep = _later("solve_one_sweep", "queue 1 item 7 (sweeps)")
    solve_all_sweep = _later("solve_all_sweep", "queue 1 item 7 (sweeps)")
    solve_one_batch = _later("solve_one_batch", "queue 1 item 9 (batches)")
    solve_all_batch = _later("solve_all_batch", "queue 1 item 9 (batches)")
    get_mat_numpy = _later("get_mat_numpy", "queue 1 item 6 (interop)")
    get_mat_scipy = _later("get_mat_scipy", "queue 1 item 6 (interop)")


class QuadraticSystem(LinearSystem):
    """Not ported yet (ROADMAP queue 1 item 8)."""

    def __init__(self, sizes, backend: str | None = None, device="cuda"):
        raise NotImplementedError(
            "QuadraticSystem is not ported yet: ROADMAP queue 1 item 8"
        )

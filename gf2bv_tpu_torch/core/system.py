"""LinearSystem — the trace -> matrix -> solve API.

Port of ``gf2bv_tpu/core/system.py``.  Tracing and equation assembly are
the reference's numpy code; solving runs the blocked solver on ``device``
(CUDA by default; ``device="cpu"`` runs the plain PyTorch twins of the
kernels).  A CUDA device that is not present raises.

Ported: ``gens`` (lazy and eager), ``get_eqs_packed``, ``get_eqs``,
``solve_raw_one``, ``solve_one``, ``solve_raw_space``, ``solve_all`` (a lazy
generator raising :class:`DimensionTooLargeError` past ``max_dimension``),
``convert_sol``, ``solve_raw_packed``, ``solve_one_packed``,
``solve_all_packed``, ``solve_one_batch``, ``solve_all_batch`` and
``evaluate``.  The rest of the reference surface raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import packing
from .affine import AffineSpace
from .bitvec import BitVec
from .words import resolve_device

Zeros = Sequence["BitVec | int"]


class DimensionTooLargeError(Exception):
    def __init__(self, message: str, space: AffineSpace):
        super().__init__(message)
        self.space = space


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

    def solve_raw_space(self, zeros: Zeros) -> Optional[AffineSpace]:
        return self._solve_internal(zeros, 1)

    def _enumerate_space(self, space: AffineSpace, max_dimension: int):
        if space.dimension > max_dimension:
            raise DimensionTooLargeError(
                f"solution space has dimension {space.dimension} "
                f"(2**{space.dimension} points), above the max_dimension="
                f"{max_dimension} enumeration guard; raise it or pin bits "
                f"via the attached .space",
                space=space,
            )
        for s in space:
            ret = self.convert_sol(s)
            if ret is not None:
                yield ret

    def solve_all(self, zeros: Zeros, *, max_dimension: int = 16):
        space = self.solve_raw_space(zeros)
        if space is None:
            return
        yield from self._enumerate_space(space, max_dimension)

    def solve_one(self, zeros: Zeros):
        sol = self._solve_internal(zeros, 0)
        if sol is None:
            return None
        return self.convert_sol(sol)

    def solve_raw_packed(self, eqs, mode: int):
        """Solve a PRE-PACKED matrix: (rows, W64) uint64 or (rows, W32)
        uint32 host rows, or a (rows, W32) int32 tensor solved where it
        lies.  Same mode contract as solve_raw_one / solve_raw_space."""
        from ..ops import solver

        return solver.solve_packed(eqs, self._cols, mode, self._backend,
                                   device=self._device)

    def solve_all_packed(self, eqs, *, max_dimension: int = 16):
        space = self.solve_raw_packed(eqs, 1)
        if space is None:
            return
        yield from self._enumerate_space(space, max_dimension)

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

    # -- batched solving --------------------------------------------------------

    def solve_one_batch(self, zeros_batch, mesh=None):
        """Solve many independent zero-lists; one solution tuple or None per
        list.  ``mesh`` (sharding) is not ported and must be None."""
        from ..parallel.batch import solve_batch_systems

        raws = solve_batch_systems(self, zeros_batch, mode=0, mesh=mesh)
        return [None if r is None else self.convert_sol(r) for r in raws]

    def solve_all_batch(self, zeros_batch, *, max_dimension: int = 16, mesh=None):
        """Batched solve_all: one generator per zeros list (None when
        unsatisfiable); each raises DimensionTooLargeError lazily."""
        from ..parallel.batch import solve_batch_systems

        spaces = solve_batch_systems(self, zeros_batch, mode=1, mesh=mesh)
        return [
            None if sp is None else self._enumerate_space(sp, max_dimension)
            for sp in spaces
        ]

    # -- later slices --------------------------------------------------------

    capture = _later("capture", "queue 1 item 6 (core/capture.py)")
    solve_one_sweep = _later("solve_one_sweep", "queue 1 item 7 (sweeps)")
    solve_all_sweep = _later("solve_all_sweep", "queue 1 item 7 (sweeps)")
    get_mat_numpy = _later("get_mat_numpy", "queue 1 item 6 (interop)")
    get_mat_scipy = _later("get_mat_scipy", "queue 1 item 6 (interop)")


class QuadraticSystem(LinearSystem):
    """Not ported yet (ROADMAP queue 1 item 8)."""

    def __init__(self, sizes, backend: str | None = None, device="cuda"):
        raise NotImplementedError(
            "QuadraticSystem is not ported yet: ROADMAP queue 1 item 8"
        )

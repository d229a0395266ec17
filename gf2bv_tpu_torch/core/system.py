"""LinearSystem — the trace -> matrix -> solve API.

Port of ``gf2bv_tpu/core/system.py``.  Tracing and equation assembly are
the reference's numpy code; solving runs the blocked solver on ``device``
(CUDA by default; ``device="cpu"`` runs the plain PyTorch twins of the
kernels).  A CUDA device that is not present raises.

Ported: ``gens`` (lazy and eager), ``get_eqs_packed``, ``get_eqs``,
``solve_raw_one``, ``solve_one``, ``solve_raw_space``, ``solve_all`` (a lazy
generator raising :class:`DimensionTooLargeError` past ``max_dimension``),
``convert_sol``, ``solve_raw_packed``, ``solve_one_packed``,
``solve_all_packed``, ``solve_one_batch``, ``solve_all_batch``,
``evaluate``, ``capture`` (core/capture.py), the guess sweeps
``solve_one_sweep`` / ``solve_all_sweep`` (every candidate one extra RHS
column of a single elimination, ops/multi_rhs.py) and the interop exports
``get_mat_numpy`` / ``get_mat_scipy``.  ``QuadraticSystem`` and every
``mesh=`` argument raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np

from . import packing
from .affine import AffineSpace
from .bitvec import BitVec
from .words import resolve_device

Zeros = Sequence["BitVec | int"]

# Padded coefficient matrices of recent sweeps, kept on their device and
# keyed by content hash and device (an LRU of this many): a repeated sweep
# of the same system, or a captured trace bound to new values, uploads
# nothing but its RHS block.  Each entry is one device buffer.
_SWEEP_ADEV_MAX = 2
_sweep_adev_cache: dict = {}


class DimensionTooLargeError(Exception):
    def __init__(self, message: str, space: AffineSpace):
        super().__init__(message)
        self.space = space


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: ROADMAP queue 1 item 11 (sharded solvers)"
        )


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

    def capture(self, fn):
        """Record ``fn(gens, params)`` once; re-solve for new per-instance
        constants with no Python re-trace (core/capture.py)."""
        from .capture import capture as _capture

        return _capture(self, fn)

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

    def _convert_sols_batch(self, raws):
        """``convert_sol`` over many raw mode-0 solutions (None passes
        through).  When neither ``convert_sol`` nor ``_convert_sol`` is
        overridden, the split is vectorized (packing.split_rows_by_sizes):
        the per-int ``s >>= size`` chain costs O(cols^2/64) bigint word ops
        per solution, which dominates large sweep and batch conversions."""
        if (type(self).convert_sol is not LinearSystem.convert_sol
                or type(self)._convert_sol is not LinearSystem._convert_sol):
            return [None if r is None else self.convert_sol(r) for r in raws]
        idx = [i for i, r in enumerate(raws) if r is not None]
        if not idx:
            return [None] * len(raws)
        rows = packing.ints_to_rows([raws[i] for i in idx], sum(self._sizes))
        tuples = packing.split_rows_by_sizes(rows, self._sizes)
        out: list = [None] * len(raws)
        for i, t in zip(idx, tuples):
            out[i] = t
        return out

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

    # -- guess sweeps: every candidate rides ONE elimination ------------------

    def _solve_sweep_raw(self, zeros, guesses, candidates, mode: int, mesh=None):
        """Shared core of the sweep API (see :meth:`solve_one_sweep`).

        Pinning the SAME bit expressions to different values changes only
        the affine column, so every candidate assignment is one extra RHS
        column of a single multi-RHS elimination (ops/multi_rhs.py), where
        a guess loop would re-solve the whole system per guess."""
        from .lazy import materialize_pending

        zeros = list(zeros)
        guesses = list(guesses)
        # one shared-memo materialization walk for zeros + guesses
        materialize_pending((*zeros, *guesses))
        return self._sweep_from_eqs(
            self.get_eqs_packed(zeros), guesses, candidates, mode, mesh=mesh
        )

    def _sweep_from_eqs(self, base, guesses, candidates, mode: int, mesh=None):
        """Sweep core over an already-packed base matrix ``base`` (its
        affine column carries the bound constants); shared by the zeros
        path above and CapturedTrace.solve_one_sweep."""
        from ..ops import multi_rhs
        from ..ops.gauss_blocked import K_PANEL, _pad
        from ..ops.solver import _resolve_backend
        from .lazy import materialize_pending, pad_mats_to_words
        from .words import u32_to_torch

        _no_mesh(mesh)
        _resolve_backend(self._backend)  # a host backend raises here
        guesses = list(guesses)
        if not guesses:
            raise ValueError("at least one guess expression required")
        for g in guesses:
            if not isinstance(g, BitVec):
                raise TypeError(
                    "guesses must be BitVec expressions over the system's "
                    "variables (got %r)" % type(g).__name__
                )
        materialize_pending(guesses)
        # Bit expressions such as (x >> i) & 1 are FULL-width BitVecs most
        # of whose bits are identically zero; only each guess's LIVE
        # (nonzero-row) bits enter the matrix and the enumeration.  Dead
        # bits only admit the value 0: an explicit candidate pinning one to
        # 1 is decided unsatisfiable on the host.
        gmats, widths, live = [], [], []
        for g in guesses:
            rows_g = pad_mats_to_words([g.rows], self._nw)[0]
            nz = np.nonzero(rows_g.any(axis=1))[0]
            gmats.append(rows_g[nz])
            widths.append(len(g))
            live.append(nz)
        G = sum(len(nz) for nz in live)
        gmat = np.concatenate(
            gmats + [np.zeros((0, self._nw), np.uint64)], axis=0
        )
        eqs = np.concatenate([base, gmat], axis=0)

        if candidates is None:
            # eliminations chunk at MAX_RHS, so any B works; the cap only
            # guards against accidentally enumerating a wide expression
            if G > 17:
                raise ValueError(
                    f"full enumeration of {G} live guess bits is 2**{G} "
                    f"candidates; pass an explicit candidates list"
                )
            B = 1 << G
            ks = np.arange(B, dtype=np.uint64)
            bits = (
                (ks[:, None] >> np.arange(G, dtype=np.uint64)[None, :]) & 1
            ).astype(np.uint8)
            forced_unsat = np.zeros(B, bool)
        else:
            cand = [
                tuple(c) if isinstance(c, (tuple, list)) else (c,)
                for c in candidates
            ]
            if not cand:
                return []
            B = len(cand)
            bits = np.zeros((B, G), np.uint8)
            forced_unsat = np.zeros(B, bool)
            for bi, tup in enumerate(cand):
                if len(tup) != len(guesses):
                    raise ValueError(
                        f"candidate {bi} has {len(tup)} values for "
                        f"{len(guesses)} guesses"
                    )
                off = 0
                for v, wd, nz in zip(tup, widths, live):
                    v = int(v)
                    if v >> wd:
                        raise ValueError(
                            f"candidate {bi}: value {v} exceeds the "
                            f"{wd}-bit guess width"
                        )
                    dead = v
                    for j, p in enumerate(nz):
                        b = (v >> int(p)) & 1
                        bits[bi, off + j] = b
                        dead &= ~(1 << int(p))
                    if dead:  # pins an identically-0 bit to 1
                        forced_unsat[bi] = True
                    off += len(nz)

        # The padded coefficient matrix goes to the device ONCE per
        # structure, not per call: its own affine bit is inert in the
        # multi-RHS elimination (the per-candidate affine columns ride the
        # appended block), so it is zeroed and the rest content-hashed.
        coeff0 = eqs[:, 0] & ~np.uint64(1)
        h = hashlib.blake2b(digest_size=16)
        h.update(repr((eqs.shape, self._cols)).encode())
        h.update(coeff0.tobytes())
        h.update(np.ascontiguousarray(eqs[:, 1:]).tobytes())
        a_key = (h.hexdigest(), str(self._device))
        a_dev = _sweep_adev_cache.pop(a_key, None)
        if a_dev is None:
            eqs0 = eqs.copy()
            eqs0[:, 0] = coeff0
            a_dev = u32_to_torch(_pad(eqs0, K_PANEL, word_align=128), self._device)
            while len(_sweep_adev_cache) >= _SWEEP_ADEV_MAX:
                _sweep_adev_cache.pop(next(iter(_sweep_adev_cache)))
        _sweep_adev_cache[a_key] = a_dev  # newest last
        bcache: dict = {}  # the mode-1 basis is candidate- and chunk-invariant

        # per-candidate affine column: the traced affine bits, with the
        # guess rows' constants flipped by the candidate's values, packed
        # directly from (base column, guess bits)
        base_aff = (eqs[:, 0] & np.uint64(1)).astype(np.uint8)
        out: list = []
        for c0 in range(0, B, multi_rhs.MAX_RHS):
            nb = min(multi_rhs.MAX_RHS, B - c0)
            packed = multi_rhs._pack_rhs_affine_sweep(
                base_aff, bits[c0 : c0 + nb], a_dev.shape[0], multi_rhs._bw_for(nb)
            )
            out.extend(
                multi_rhs.solve_multi_rhs(
                    a_dev, self._cols, None, mode,
                    basis_cache=bcache, rhs_packed=packed, nb=nb,
                )
            )
        return [None if bad else r for bad, r in zip(forced_unsat, out)]

    def solve_one_sweep(self, zeros, guesses, candidates=None, *, mesh=None):
        """Guess-and-solve sweep: pin the bit expressions in ``guesses`` to
        every candidate assignment and solve ALL of them with ONE
        elimination.

        ``guesses``: BitVec expressions (any widths; bits above each
        expression's last LIVE bit are identically zero and only admit the
        value 0).  ``candidates``: iterable of value tuples (one int per
        guess, validated against the full expression width), or None to
        enumerate all ``2**G`` assignments of the G live bits; candidate
        ``k`` then assigns guess ``i`` its live bits from
        ``k >> sum(live_widths[:i])`` (first guess in the low bits).

        Returns a list aligned with the candidates: a solution tuple, or
        None where that assignment is unsatisfiable.  ``mesh`` (candidates
        sharded over devices) is not ported and must be None."""
        raws = self._solve_sweep_raw(zeros, guesses, candidates, 0, mesh=mesh)
        return self._convert_sols_batch(raws)

    def solve_all_sweep(self, zeros, guesses, candidates=None, *,
                        max_dimension: int = 16, mesh=None):
        """Sweep returning one solution generator per candidate (or None
        where unsatisfiable); all candidates share one kernel basis."""
        spaces = self._solve_sweep_raw(zeros, guesses, candidates, 1, mesh=mesh)
        return [
            None if sp is None else self._enumerate_space(sp, max_dimension)
            for sp in spaces
        ]

    # -- interop ------------------------------------------------------------------

    def get_mat_numpy(self, zeros: Zeros) -> tuple[np.ndarray, np.ndarray]:
        """Dense (rows, cols) uint8 matrix A and RHS vector b with Ax = b."""
        eqs = self.get_eqs_packed(zeros)
        bits = packing.unpack_rows(eqs, self._nbits)
        return bits[:, 1:], bits[:, 0]

    def get_mat_scipy(self, zeros: Zeros):
        """Sparse CSR export: ``(A, b)`` with ``A`` a scipy.sparse csr_matrix
        of uint8 over GF(2) and ``b`` the numpy RHS vector (through the
        dense unpack: a transient ``rows x cols`` uint8 array)."""
        import scipy.sparse as sp

        a, b = self.get_mat_numpy(zeros)
        return sp.csr_matrix(a), b


class QuadraticSystem(LinearSystem):
    """Not ported yet (ROADMAP queue 1 item 8)."""

    def __init__(self, sizes, backend: str | None = None, device="cuda"):
        raise NotImplementedError(
            "QuadraticSystem is not ported yet: ROADMAP queue 1 item 8"
        )

"""LinearSystem / QuadraticSystem — the trace -> matrix -> solve API.

Port of ``gf2bv_tpu/core/system.py``.  Tracing and equation assembly are
the reference's numpy code; solving runs on ``device`` through the backend
that ``ops/solver._resolve_backend`` picks (CUDA by default; ``device="cpu"``
runs the plain PyTorch twins of the kernels, or the host C engine).  A CUDA
device that is not present raises.

``LinearSystem``: ``gens`` (lazy and eager), ``get_eqs_packed``,
``get_eqs``, ``solve_raw_one``, ``solve_one``, ``solve_raw_space``,
``solve_all`` (a lazy generator raising :class:`DimensionTooLargeError` past
``max_dimension``), ``convert_sol``, ``solve_raw_packed``,
``solve_one_packed``, ``solve_all_packed``, ``solve_one_batch``,
``solve_all_batch``, ``evaluate``, ``capture`` (core/capture.py), the guess
sweeps ``solve_one_sweep`` / ``solve_all_sweep`` (every candidate one extra
RHS column of a single elimination, ops/multi_rhs.py, or of the host
engine's under ``native``) and the exports ``get_mat_numpy`` /
``get_mat_scipy``.  ``QuadraticSystem``: linearization with n(n-1)/2 extra
monomial columns, ``mul_bit`` / ``mul_bits`` / ``bit_assert``, and the
consistency filter (on the system's device past 8 dimensions,
ops/enumerate.py).  ``mesh=`` (parallel/mesh.py) splits the batches over
the mesh's batch axis and the sweeps' candidates over its shards.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Sequence

import numpy as np

from ..utils import profiling
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

    def gens(self, *, lazy: bool | None = None) -> tuple[BitVec, ...]:
        """The symbolic variable blocks: lazy bitvecs by default (ops record
        a trace DAG, so the coefficient matrix is built and cached once per
        structure); ``lazy=False`` (or ``GF2BV_TPU_LAZY=0`` when ``lazy`` is
        not given) returns the eager packed variables."""
        if lazy is None:
            lazy = os.environ.get("GF2BV_TPU_LAZY", "1") != "0"
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
        list.  ``mesh``: split the systems over its batch axis
        (parallel/batch.py)."""
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

        base_aff = (eqs[:, 0] & np.uint64(1)).astype(np.uint8)
        rows = eqs.shape[0]
        out: list = []
        native = _resolve_backend(self._backend, self._cols, self._device) == "native"
        if mesh is not None and native:
            import warnings

            warnings.warn(
                "solve_one_sweep: this system resolved to the native host "
                "backend, so the mesh is not used (candidates run on the "
                "host multi-RHS engine); set GF2BV_TPU_CPU_NATIVE=0 or "
                "pass backend='blocked' to shard over devices",
                stacklevel=4,
            )
        n_shards = 1
        if mesh is not None and not native:
            from ..parallel.multi_rhs_sharded import shard_capacity

            mesh, n_shards, _ = shard_capacity(mesh)
        if native:
            # the host multi-RHS engine takes the (B, rows) affine bits as-is
            from .. import _native

            if not _native.available():
                raise RuntimeError("native backend unavailable (no gcc?)")
            ncache: dict = {}  # the mode-1 basis is candidate- and chunk-invariant
            for c0 in range(0, B, multi_rhs.MAX_RHS):
                nb = min(multi_rhs.MAX_RHS, B - c0)
                rhs = np.broadcast_to(base_aff, (nb, rows)).copy()
                if G:
                    rhs[:, rows - G:] ^= bits[c0 : c0 + nb]
                out.extend(_native.solve_multi_rhs_native(
                    eqs, self._cols, rhs, mode, basis_cache=ncache))
            return [None if bad else r for bad, r in zip(forced_unsat, out)]

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
        for c0 in range(0, B, multi_rhs.MAX_RHS * n_shards):
            nb = min(multi_rhs.MAX_RHS * n_shards, B - c0)
            if n_shards > 1:
                # candidates split over the mesh's batch axis: one
                # direct-packed block per shard, the matrix replicated; the
                # block layout is owned by pack_shard_blocks
                from ..parallel.multi_rhs_sharded import (
                    pack_shard_blocks,
                    solve_multi_rhs_sharded,
                )

                packed, _ = pack_shard_blocks(
                    bits[c0 : c0 + nb], nb, n_shards, a_dev.shape[0],
                    lambda sl, rp, bw: multi_rhs._pack_rhs_affine_sweep(
                        base_aff, sl, rp, bw
                    ),
                )
                out.extend(
                    solve_multi_rhs_sharded(
                        a_dev, self._cols, None, mode, mesh=mesh,
                        basis_cache=bcache, rhs_packed=packed, nb=nb,
                    )
                )
                continue
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
        None where that assignment is unsatisfiable.  ``mesh``: split the
        candidates over the shards of its batch axis, the matrix replicated
        (parallel/multi_rhs_sharded.py)."""
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

    def get_sage_mat(self, zeros: Zeros, *, _sage=None):
        """Sage interop kept by name: ``(matrix(GF(2), A), vector(GF(2), b))``
        built from :meth:`get_mat_numpy`.

        ``_sage`` injects the module providing ``GF/matrix/vector`` (a
        testing hook, so this path runs without a Sage install); it defaults
        to ``sage.all``, which raises the usual ImportError when absent."""
        if _sage is None:
            import sage.all as _sage  # type: ignore

        a, b = self.get_mat_numpy(zeros)
        return _sage.matrix(_sage.GF(2), a), _sage.vector(_sage.GF(2), b)

    def get_sage_mat_slow(self, zeros: Zeros, *, tqdm=lambda x, desc: x, _sage=None):
        """The reference's slow path by name: the packed build makes it
        :meth:`get_sage_mat`; the tqdm hook is accepted for the signature."""
        del tqdm
        return self.get_sage_mat(zeros, _sage=_sage)


class QuadraticSystem(LinearSystem):
    def __init__(self, sizes, backend: str | None = None, device="cuda"):
        n = sum(sizes)
        quad_terms = n * (n - 1) // 2
        super().__init__(list(sizes) + [quad_terms], backend=backend, device=device)
        self._quad_sizes = list(sizes)
        self._lin_size = n
        self._quad_size = quad_terms
        # lower-triangle (i > j) index pairs in the reference's monomial order
        # (i outer, j inner — _internal.c:583-599)
        self._tri_i, self._tri_j = np.tril_indices(n, k=-1)

    def gens(self, *, lazy: bool | None = None):
        """Lazy by default, like LinearSystem: ``mul_bit``/``bit_assert`` on
        lazy bits RECORD ``mulq`` nodes, so the reference's own idiom — a
        Python loop multiplying state bits per output
        (``reference:examples/nlfsr.py:49-57``) — is evaluated in ONE
        shared walk at solve time instead of re-walking the trace prefix
        per produced bit (O(steps^2) in all).  Lazy generators
        are NARROW (linear columns only); quad columns enter the DAG
        exclusively through mulq nodes and linear rows are zero-padded on
        materialization (core/lazy._promote)."""
        if lazy is None:
            lazy = os.environ.get("GF2BV_TPU_LAZY", "1") != "0"
        if not lazy:
            return self._vars[:-1]
        if self._lazy_vars is None:
            from .lazy import LazyBitVec, _digest, _ints

            nb = 1 + self._lin_size
            sizes_digest = _digest(
                b"qgens", _ints(*self._quad_sizes, self._nbits)
            )
            out = []
            i = 1
            for k, size in enumerate(self._quad_sizes):
                rows = packing.bit_rows(nb, np.arange(i, i + size))
                out.append(
                    LazyBitVec.from_eager(
                        BitVec(rows, nb),
                        structural_name=_digest(sizes_digest, _ints(k)),
                    )
                )
                i += size
            self._lazy_vars = tuple(out)
        return self._lazy_vars

    def __reduce__(self):
        return (self.__class__, (self._quad_sizes, self._backend, str(self._device)))

    # -- degree-2 ops ----------------------------------------------------------

    def _mul_bit_rows(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Packed product of two affine bit rows; reference semantics
        (ref :334-338 + _internal.c:538-604): constant & x_i^2=x_i terms from
        (a & const_lin_mask) & b, cross terms (a_i b_j ^ a_j b_i) x_i x_j."""
        n = self._lin_size
        abits = packing.unpack_rows(a[None, :], 1 + n)[0]
        bbits = packing.unpack_rows(b[None, :], 1 + n)[0]
        # v = (a & const_lin_mask) & b, i.e. elementwise AND on bits 0..n
        out = np.zeros(self._nbits, dtype=np.uint8)
        out[: 1 + n] = abits & bbits
        al, bl = abits[1:], bbits[1:]
        cross = (al[self._tri_i] & bl[self._tri_j]) ^ (al[self._tri_j] & bl[self._tri_i])
        out[1 + n :] = cross
        return packing.pack_bits(out[None, :], self._nbits)[0]

    def mul_bit(self, a: BitVec, b: BitVec) -> BitVec:
        if len(a) != 1 or len(b) != 1:
            raise ValueError("mul_bit operands must be 1-bit BitVecs")
        from .lazy import Expr, LazyBitVec, _ints

        if isinstance(a, LazyBitVec) or isinstance(b, LazyBitVec):
            # record instead of materializing: the whole zeros list then
            # evaluates in one shared walk at solve time (ref idiom
            # examples/nlfsr.py:49-57 without the O(steps^2) re-walks)
            expr = Expr(
                "mulq",
                (LazyBitVec._as_expr(a), LazyBitVec._as_expr(b)),
                self,
                1,
                self._nbits,
                _ints(self._lin_size, self._nbits),
            )
            return LazyBitVec(expr)
        row = self._mul_bit_rows(a.rows[0], b.rows[0])
        return BitVec(row[None, :], self._nbits)

    def _mul_bit_slow(self, a: BitVec, b: BitVec) -> BitVec:
        """Obviously-correct big-int cross-check for :meth:`mul_bit`, kept
        in-library like the reference keeps its slow path
        (``reference:gf2bv/__init__.py:306-332``): per-monomial
        Python-int arithmetic, no packing tricks shared with the fast
        path.  ``mul_bit(a, b).rows == _mul_bit_slow(a, b).rows`` always."""
        n = self._lin_size
        (am,) = a._bits
        (bm,) = b._bits
        mask = (am & ((1 << (1 + n)) - 1)) & bm  # const + x_i^2 = x_i terms
        mono = 1 + n
        for i in range(n):
            ai = (am >> (1 + i)) & 1
            bi = (bm >> (1 + i)) & 1
            for j in range(i):
                aj = (am >> (1 + j)) & 1
                bj = (bm >> (1 + j)) & 1
                if (ai & bj) ^ (aj & bi):
                    mask |= 1 << mono
                mono += 1
        return BitVec([mask], self._nbits)

    def lift(self, bv: BitVec) -> BitVec:
        """Embed a purely-linear BitVec (e.g. traced against a plain
        ``LinearSystem([n])`` with the same variable layout) into this
        system's full monomial width by zero-padding the quad columns."""
        pad = self._nw - bv.rows.shape[1]
        if pad < 0:
            raise ValueError("BitVec is wider than this system")
        if pad == 0:
            return BitVec(bv.rows, self._nbits)
        rows = np.pad(bv.rows, ((0, 0), (0, pad)))
        return BitVec(rows, self._nbits)

    def mul_bits(self, a: BitVec, b: BitVec) -> BitVec:
        """Vectorized elementwise product of two equal-width BitVecs (new
        capability: batches what the reference can only do bit-by-bit).
        Inputs may be narrow (linear-columns-only) rows — e.g. collected
        from a trace against ``LinearSystem([n])`` — since only the linear
        monomials participate; the result always has full monomial width."""
        if len(a) != len(b):
            raise ValueError("Widths must match")
        n = self._lin_size
        abits = packing.unpack_rows(a.rows, 1 + n)
        bbits = packing.unpack_rows(b.rows, 1 + n)
        out = np.zeros((len(a), self._nbits), dtype=np.uint8)
        out[:, : 1 + n] = abits & bbits
        al, bl = abits[:, 1:], bbits[:, 1:]
        # cross terms written per monomial row-block: for fixed i the
        # monomials x_i*x_j (j < i) are contiguous columns, so slice writes
        # beat the O(rows * n^2 / 2) fancy gathers by ~15x at NLFSR size
        base = 1 + n
        for i in range(1, n):
            out[:, base : base + i] = (al[:, i : i + 1] & bl[:, :i]) ^ (
                bl[:, i : i + 1] & al[:, :i]
            )
            base += i
        return BitVec(packing.pack_bits(out, self._nbits), self._nbits)

    def _bit_assert_rows(self, a: np.ndarray, v: int) -> list[np.ndarray]:
        n = self._lin_size
        assert v in (0, 1), "Invalid bit"
        abits = packing.unpack_rows(a[None, :], self._nbits)[0]
        assert abits[1:].any(), "a should not be a constant"
        assert not abits[1 + n :].any(), "Not a linear term"
        const = np.zeros_like(a)
        const[0] = np.uint64(v)
        zeros = [a ^ const]
        for i in range(1, 1 + n):
            brow = packing.bit_rows(self._nbits, np.array([i]))[0]
            if abits[i] and abits.sum() == 1:  # a == basis bit i
                continue
            prod = self._mul_bit_rows(a, brow)
            zeros.append(prod if v == 0 else prod ^ brow)
        return zeros

    def bit_assert(self, a: BitVec, v: int) -> list[BitVec]:
        """Consistency equations pinning bit ``a`` to constant ``v``
        (ref :345-368): a ^ v plus a*b_i = v*b_i for every linear basis bit.
        Lazy targets stay lazy: the products are recorded mulq nodes, so a
        guess sweep (nlfsr_ex) keeps the device-cached solve path."""
        if len(a) != 1:
            raise ValueError("bit_assert target must be a 1-bit BitVec")
        from .lazy import LazyBitVec

        if isinstance(a, LazyBitVec):
            return self._bit_assert_lazy(a, v)
        rows = self._bit_assert_rows(a.rows[0], v)
        return [BitVec(r[None, :], self._nbits) for r in rows]

    def _bit_assert_lazy(self, a, v: int) -> list[BitVec]:
        from .lazy import affine_many, materialize_many

        n = self._lin_size
        assert v in (0, 1), "Invalid bit"
        # the checks need only the COEFFICIENT mask, which is well-defined
        # even when the trace carries unbound Params (capture idiom)
        (mat,) = materialize_many([a._expr], strip_consts=True)
        am = packing.words_to_int(mat[0])
        assert am >> 1 != 0, "a should not be a constant"
        assert am >> (1 + n) == 0, "Not a linear term"
        if a._expr.aff0:
            aff = 0
        else:
            try:
                aff = affine_many([a._expr])[0]  # no Params: exact
            except ValueError:
                # Param-dependent affine: the mask-AND product formula
                # (reference semantics, _internal.c:538-604) is only sound
                # for a fixed affine part, so the consistency rows would be
                # wrong for some bound values.  Refuse loudly.
                raise ValueError(
                    "bit_assert target's affine part depends on unbound "
                    "Params; for captured guess sweeps assert a "
                    "constant-free bit and put the guess in v (one "
                    "captured structure per guess value)"
                ) from None
        zeros = [a ^ v]
        for i in range(1, 1 + n):
            # eager semantics: skip when a's FULL mask equals basis bit i
            if aff == 0 and am == (1 << i):
                continue
            brow = BitVec(
                packing.bit_rows(1 + n, np.array([i])), 1 + n
            )
            prod = self.mul_bit(a, brow)
            zeros.append(prod if v == 0 else prod ^ brow)
        return zeros

    # -- solution filtering ------------------------------------------------------

    def _check_lin_match_quad(self, lin: int, quad: int) -> bool:
        n = self._lin_size
        lin_bits = packing.mask_bits(n, lin)
        assert lin >> n == 0, "Invalid linear part"
        expected = lin_bits[self._tri_i] & lin_bits[self._tri_j]
        quad_bits = packing.mask_bits(self._quad_size, quad) if self._quad_size else (
            np.zeros(0, dtype=np.uint8)
        )
        assert quad >> self._quad_size == 0, "Invalid quadratic part"
        return bool(np.array_equal(expected, quad_bits))

    def convert_sol(self, s: int) -> Optional[tuple[int, ...]]:
        lin = s & ((1 << self._lin_size) - 1)
        s >>= self._lin_size
        quad = s & ((1 << self._quad_size) - 1)
        s >>= self._quad_size
        assert s == 0, "Invalid solution"
        if self._check_lin_match_quad(lin, quad):
            return super()._convert_sol(lin)[:-1]
        return None

    def _enumerate_space(self, space: AffineSpace, max_dimension: int):
        """Quadratic variant: the consistency filter runs on device over
        whole enumeration chunks (ops/enumerate.py) for larger spaces
        instead of per-point in Python.  Shared by solve_all and
        solve_all_packed.  Span ``quad.filter``, one a point taken."""
        if space.dimension > max_dimension:
            raise DimensionTooLargeError(
                f"solution space has dimension {space.dimension} "
                f"(2**{space.dimension} points), above the max_dimension="
                f"{max_dimension} enumeration guard; raise it or pin bits "
                f"via the attached .space",
                space=space,
            )
        if space.dimension > 8:
            from ..ops.enumerate import iter_quad_filtered

            points = iter_quad_filtered(space, self._lin_size, device=self._device)
        else:
            points = iter(space)
        while True:
            # a span may not stay open across a yield
            with profiling.span("quad.filter"):
                s = next(points, None)
                ret = None if s is None else self.convert_sol(s)
            if s is None:
                return
            if ret is not None:
                yield ret

    def solve_one(self, zeros: Zeros):
        # A raw one-solution solve might not pass the consistency filter
        # (ref :395-398): route through solve_all.
        for sol in self.solve_all(zeros):
            return sol

    def solve_one_packed(self, eqs):
        # same consistency-filter routing for pre-packed systems
        for sol in self.solve_all_packed(eqs):
            return sol

    def select_rows(self, eqs):
        """A template of systems whose rows are picked per request from the
        device-resident rows ``eqs`` ((rows, W32) int32, e.g. from
        ``ops/quad_device.quad_rows``): an
        :class:`~gf2bv_tpu_torch.ops.quad_device.RowSelection`, whose
        ``solve_one(keep)`` solves the rows a host mask keeps and returns
        the first consistent point, as :meth:`solve_one_packed` does."""
        from ..ops.quad_device import RowSelection

        return RowSelection(self, eqs)

    def solve_one_batch(self, zeros_batch, mesh=None, *,
                        max_dimension: int = 16):
        """Batched one-point solving.  A raw mode-0 particular solution can
        fail the quadratic consistency filter (the same pitfall solve_one
        avoids by routing through solve_all), so each instance solves its
        space and takes the first CONSISTENT point.

        An instance whose solution space exceeds ``max_dimension`` raises
        DimensionTooLargeError annotated with the instance index (and the
        usual ``.space``) instead of silently discarding the batch — raise
        ``max_dimension`` or pin bits via ``.space`` to recover, exactly as
        with :meth:`solve_all`."""
        from ..parallel.batch import solve_batch_systems

        spaces = solve_batch_systems(self, zeros_batch, mode=1, mesh=mesh)
        out = []
        for i, sp in enumerate(spaces):
            if sp is None:
                out.append(None)
                continue
            try:
                out.append(
                    next(self._enumerate_space(sp, max_dimension), None)
                )
            except DimensionTooLargeError as e:
                raise DimensionTooLargeError(
                    f"batch instance {i}: {e}", space=e.space
                ) from None
        return out

    def solve_one_sweep(self, zeros, guesses, candidates=None, *,
                        max_dimension: int = 16, mesh=None):
        """Guess-and-solve sweep (see :meth:`LinearSystem.solve_one_sweep`),
        consistency-filtered: a raw mode-0 point can violate the monomial
        consistency relations, so each candidate's solution space enumerates
        to its first CONSISTENT point — the same routing as solve_one /
        solve_one_batch.  ``guesses`` may be quadratic expressions (mul_bit
        products linearize into monomial rows like any other equation).

        Scope note: this pins ``expr ^ v`` only.  ``bit_assert``'s extra
        consistency products (``a*b_i = v*b_i``) have candidate-DEPENDENT
        coefficients, so they cannot ride a shared elimination — when the
        attack needs their rank (e.g. examples/nlfsr_ex.py's 2-bit
        bruteforce), sweep with the batched per-system solver
        (parallel.batch.solve_batch_systems) instead."""
        spaces = self._solve_sweep_raw(zeros, guesses, candidates, 1,
                                       mesh=mesh)
        return self._first_consistent_per_candidate(spaces, max_dimension)

    def _first_consistent_per_candidate(self, spaces, max_dimension: int):
        """Per-candidate first CONSISTENT point, annotating oversized
        spaces with the candidate index (shared with the captured-trace
        sweep, core/capture.py)."""
        out = []
        for i, sp in enumerate(spaces):
            if sp is None:
                out.append(None)
                continue
            try:
                out.append(
                    next(self._enumerate_space(sp, max_dimension), None)
                )
            except DimensionTooLargeError as e:
                raise DimensionTooLargeError(
                    f"sweep candidate {i}: {e}", space=e.space
                ) from None
        return out

    def evaluate(self, bv: BitVec, sol: tuple[int, ...]) -> int:
        s = 0
        for v, sz in zip(reversed(sol), reversed(self._quad_sizes)):
            s <<= sz
            s |= v
        return bv.evaluate(s)

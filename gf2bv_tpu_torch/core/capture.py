"""Capture/bind: run the symbolic model ONCE, re-solve for new instances
without re-executing any user Python.

Port of ``gf2bv_tpu/core/capture.py``.  Every new instance of a traced
model would re-run the Python model to rebuild its trace DAG before the
cached structure is even consulted.  This module removes that re-trace:

* ``LinearSystem.capture(fn)`` runs ``fn(gens, params)`` one time; the
  per-instance constants are ``core.lazy.Param`` placeholders (``params[i]``)
  instead of literal ints.
* The recorded DAG is input-independent by construction (XOR constants only
  touch the affine column — the lazy engine's founding invariant), so a
  ``CapturedTrace`` re-solve is just: interpret the affine column with the
  new constants bound (~one int op per constant-reachable node), ship the
  (rows,) delta, run the fused device solve.
* Captured traces pickle (iteratively: a 2^14-deep trace chain must not
  recurse), so a trace can be cached on disk and reloaded.
* ``solve_raw_batch`` / ``solve_one_batch`` solve many instances, and
  ``solve_one_sweep`` many guess assignments of one instance, with ONE
  elimination (ops/multi_rhs.py).

Semantics are identical to tracing with literal constants: Params hash like
literals, so a captured trace shares the device coefficient-matrix cache
with direct ``solve_one`` calls of the same model.  Under the ``native``
backend the cached matrix stays on the host and a batch is one elimination
of the host engine; a quadratic system's one-point solves go through its
consistency filter.  ``solve_raw_batch(..., mesh=)`` splits the instances
over the mesh's batch axis (parallel/multi_rhs_sharded.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from ..utils import profiling
from . import lazy, packing
from .affine import AffineSpace
from .lazy import LazyBitVec, ParamSpace


class CapturedTrace:
    """A recorded zeros list with per-instance constant slots.

    Solve entry points mirror LinearSystem's, taking the instance's constant
    values (one int per ``params[i]`` slot) instead of a zeros list.
    """

    def __init__(self, system, zeros, nparams: int):
        bad = [i for i, z in enumerate(zeros) if not isinstance(z, LazyBitVec)]
        if bad:
            raise TypeError(
                f"capture() model returned non-lazy zeros at {bad[:4]}; "
                "build zeros from system.gens() (lazy by default) so the "
                "trace records instead of materializing"
            )
        self.system = system
        self.zeros = list(zeros)
        self.nparams = nparams

    # -- solving -----------------------------------------------------------

    def _check(self, values: Sequence[int]):
        if len(values) < self.nparams:
            raise ValueError(
                f"captured trace has {self.nparams} param slots; "
                f"got {len(values)} values"
            )
        return values

    def _solve_internal(self, values: Sequence[int], mode: int):
        from ..ops import lazy_solve, solver

        with profiling.span("capture.solve"):
            values = self._check(values)
            if lazy_solve.eligible(self.system, self.zeros):
                return lazy_solve.solve_lazy(
                    self.system, self.zeros, mode, env=values
                )
            # the oracle backend: materialize coefficients once and patch the
            # affine column per instance
            eqs = self._eqs_with_env(values)
            lit_one = (eqs[:, 0] == 1) & ~eqs[:, 1:].any(axis=1)
            if lit_one.any():
                return None
            eqs = eqs[eqs.any(axis=1)]
            return solver.solve(
                eqs, self.system._cols, mode, backend=self.system._backend,
                device=self.system._device,
            )

    def _eqs_with_env(self, values) -> np.ndarray:
        exprs = [z._expr for z in self.zeros]
        if not hasattr(self, "_coeff"):
            mats = lazy.materialize_many(exprs, strip_consts=True)
            # quadratic traces: pure-linear rows materialize at the narrow
            # linear-columns width — zero-extend to the full word count
            nw = packing.nwords64(1 + self.system._cols)
            self._coeff = np.concatenate(
                lazy.pad_mats_to_words(mats, nw), axis=0
            )
            self._widths = [e.width for e in exprs]
        from ..ops.lazy_solve import _affine_vector

        aff = _affine_vector(exprs, self._widths, values)
        eqs = self._coeff.copy()
        eqs[:, 0] = (eqs[:, 0] & ~np.uint64(1)) | aff.astype(np.uint64)
        return eqs

    def solve_raw_one(self, values: Sequence[int]) -> Optional[int]:
        return self._solve_internal(values, 0)

    def solve_raw_space(self, values: Sequence[int]) -> Optional[AffineSpace]:
        return self._solve_internal(values, 1)

    def solve_one(self, values: Sequence[int]):
        # Quadratic systems route through solve_all: a raw mode-0 particular
        # solution (free vars = 0) can fail the lin/quad consistency filter,
        # the pitfall QuadraticSystem.solve_one avoids.
        if getattr(self.system, "_quad_size", None) is not None:
            return next(self.solve_all(values), None)
        sol = self._solve_internal(values, 0)
        if sol is None:
            return
        return self.system.convert_sol(sol)

    def solve_all(self, values: Sequence[int], *, max_dimension: int = 16):
        space = self._solve_internal(values, 1)
        if space is None:
            return
        yield from self.system._enumerate_space(space, max_dimension)

    def solve_one_sweep(self, values: Sequence[int], guesses,
                        candidates=None, *, max_dimension: int = 16):
        """Guess-and-solve sweep over ONE bound instance: bind ``values``
        (no Python re-trace), pin the ``guesses`` bit expressions to every
        candidate assignment, and solve all candidates with ONE elimination
        (same semantics as :meth:`LinearSystem.solve_one_sweep`; guesses
        must be Param-free expressions over the system's variables).  The
        shape for truncated-observation attacks: bound outputs + swept
        unknown bits."""
        values = self._check(values)
        eqs = self._eqs_with_env(values)
        # keep const-only 0=1 rows: per-candidate dead-row detection then
        # marks every candidate unsatisfiable, as it should
        eqs = eqs[eqs.any(axis=1)]
        sys = self.system
        if getattr(sys, "_quad_size", None) is not None:
            spaces = sys._sweep_from_eqs(eqs, guesses, candidates, 1)
            return sys._first_consistent_per_candidate(spaces, max_dimension)
        raws = sys._sweep_from_eqs(eqs, guesses, candidates, 0)
        return sys._convert_sols_batch(raws)

    # -- multi-RHS batch: ONE elimination for many instances ---------------

    def solve_raw_batch(self, values_batch, mode: int = 0, mesh=None):
        """Solve many instances with ONE device elimination (ops/multi_rhs):
        the captured coefficient matrix is shared, so every instance is one
        extra RHS column.  Up to 32768 instances (8 appended 128-word
        tiles) per elimination; larger batches chunk transparently.
        Returns one entry per instance: raw int / AffineSpace (mode 1
        shares a single basis) / None.

        ``mesh``: shard instances over the mesh's batch axis with the
        coefficient matrix replicated (parallel/multi_rhs_sharded.py: zero
        collectives; per-chunk capacity becomes n_shards * 32768)."""
        from ..ops import lazy_solve, multi_rhs

        values_batch = [self._check(v) for v in values_batch]
        if not values_batch:
            return []
        if not lazy_solve.eligible(self.system, self.zeros):
            return [self._solve_internal(v, mode) for v in values_batch]

        cs = lazy_solve.cached_system(self.system, self.zeros)
        exprs = [z._expr for z in self.zeros]
        out = []
        # the mode-1 basis is chunk-invariant; under native it is shared with
        # the single solves of the same cached structure
        basis_cache: dict = cs.basis_cache if cs.backend == "native" else {}
        chunk_cap = multi_rhs.MAX_RHS
        if mesh is not None and cs.backend == "native":
            import warnings

            warnings.warn(
                "solve_raw_batch: this system resolved to the native host "
                "backend, so the mesh is not used (instances run on the "
                "host multi-RHS engine); set GF2BV_TPU_CPU_NATIVE=0 or "
                "pass backend='blocked' to shard over devices",
                stacklevel=2,
            )
        sharded = mesh is not None and cs.backend != "native"
        if sharded:
            from ..parallel.multi_rhs_sharded import (
                shard_capacity,
                solve_multi_rhs_sharded,
            )

            mesh, _, chunk_cap = shard_capacity(mesh)  # validates the mesh shape
        for c0 in range(0, len(values_batch), chunk_cap):
            chunk = values_batch[c0 : c0 + chunk_cap]
            affs = self._affine_matrix(exprs, cs.widths, chunk)
            # literal-1 early-out per instance: a dropped (zero-coefficient)
            # row whose affine bit is set makes that instance unsatisfiable
            lit_one = (affs & ~cs.kept_mask[None, :]).any(axis=1)
            if sharded:
                res = solve_multi_rhs_sharded(
                    cs.a_dev, self.system._cols, affs[:, cs.kept], mode, mesh=mesh,
                    basis_cache=basis_cache,
                )
            elif cs.backend == "native":
                from .._native import solve_multi_rhs_native

                res = solve_multi_rhs_native(
                    cs.a_host, self.system._cols, affs[:, cs.kept], mode,
                    basis_cache=basis_cache,
                )
            else:
                res = multi_rhs.solve_multi_rhs(
                    cs.a_dev, self.system._cols, affs[:, cs.kept], mode,
                    basis_cache=basis_cache,
                )
            out.extend(
                None if lit else r for lit, r in zip(lit_one, res)
            )
        return out

    def _affine_matrix(self, exprs, widths, chunk) -> np.ndarray:
        """(B, total_rows) uint8 affine columns for a batch of instances.

        Fast path: when every Param sits in a root-level XOR chain over a
        Param-free subtree (the natural ``traced_output ^ p[i]`` shape),
        the whole affine column is base ^ bound-values — one vectorized
        numpy pass for the batch instead of B interpreter walks (~3 ms
        each at MT19937 scale)."""
        from ..ops.lazy_solve import _affine_vector

        plan = getattr(self, "_aff_plan", "?")
        if plan == "?":
            plan = self._aff_plan = _root_xor_plan(exprs)
        if plan is None:
            return np.stack(
                [_affine_vector(exprs, widths, v) for v in chunk]
            )
        bases, param_lists, ws = plan
        vals = np.tile(bases, (len(chunk), 1))  # (B, nroots) uint64
        m64 = (1 << 64) - 1
        for r, ps in enumerate(param_lists):
            if not ps:
                continue
            wmask = np.uint64((1 << ws[r]) - 1)
            for pi in ps:
                col = np.fromiter(
                    ((int(env[pi]) & m64) for env in chunk),
                    dtype=np.uint64,
                    count=len(chunk),
                )
                vals[:, r] ^= col & wmask
        bits = np.unpackbits(
            # pin little-endian like core/packing.py's views (LE hosts:
            # no-op; keeps the fast path byte-order-correct everywhere)
            vals.astype("<u8", copy=False).view(np.uint8).reshape(
                len(chunk), len(ws), 8
            ),
            axis=2,
            bitorder="little",
        )
        return np.concatenate(
            [bits[:, r, :w] for r, w in enumerate(ws)], axis=1
        )

    def solve_one_batch(self, values_batch, *, max_dimension: int = 16):
        """Batched solve_one.  Quadratic systems route each instance's
        space through the consistency filter (first consistent point);
        linear systems convert all raw points in one vectorized split."""
        quad = getattr(self.system, "_quad_size", None) is not None
        raws = self.solve_raw_batch(values_batch, mode=1 if quad else 0)
        if not quad:
            return self.system._convert_sols_batch(raws)
        return [
            None if r is None
            else next(self.system._enumerate_space(r, max_dimension), None)
            for r in raws
        ]

    # -- pickling (a trace cached on disk) ---------------------------------

    def __getstate__(self):
        return {
            "system": self.system,
            "dag": lazy.dag_to_state([z._expr for z in self.zeros]),
            "nparams": self.nparams,
        }

    def __setstate__(self, state):
        self.system = state["system"]
        self.zeros = [LazyBitVec(e) for e in lazy.dag_from_state(state["dag"])]
        self.nparams = state["nparams"]

    def __repr__(self) -> str:
        return (
            f"CapturedTrace(zeros={len(self.zeros)}, "
            f"nparams={self.nparams}, cols={self.system._cols})"
        )


def _root_xor_plan(exprs):
    """Detect the vectorizable shape: every Param reached ONLY through
    root-level xorc chains over Param-free subtrees, all roots <= 64 bits
    wide.  Returns (bases (nroots,) uint64, per-root param-index lists,
    widths) or None (general per-instance interpretation needed)."""
    hasp: dict[int, bool] = {}
    for n in lazy.postorder(exprs):
        hasp[id(n)] = (
            n.op == "xorc" and isinstance(n.aux, lazy.Param)
        ) or any(hasp[id(a)] for a in n.args)
    plan, base_nodes = [], []
    for e in exprs:
        if e.width > 64:
            return None
        node, params, const = e, [], 0
        while node.op == "xorc":
            if isinstance(node.aux, lazy.Param):
                params.append(node.aux.index)
            else:
                const ^= node.aux
            node = node.args[0]
        if hasp[id(node)]:
            return None
        plan.append((const, params, e.width))
        base_nodes.append(node)
    base_affs = lazy.affine_many(base_nodes)  # Param-free by construction
    bases = np.array(
        [
            (b ^ c) & ((1 << w) - 1)
            for b, (c, _, w) in zip(base_affs, plan)
        ],
        dtype=np.uint64,
    )
    return bases, [ps for _, ps, _ in plan], [w for _, _, w in plan]


def capture(system, fn: Callable) -> CapturedTrace:
    """Record ``fn(gens, params)``'s zeros list as a reusable trace.

    ``gens`` are the system's lazy generators; ``params[i]`` produces the
    placeholder for the i-th per-instance constant — XOR it where the
    concrete output word would go:

        tmpl = lin.capture(lambda ws, p:
            [trace_word(ws, k) ^ p[k] for k in range(n)])
        sol  = tmpl.solve_one(observed_words)      # no Python re-trace
    """
    params = ParamSpace()
    gens = system.gens(lazy=True)
    zeros = list(fn(gens, params))
    return CapturedTrace(system, zeros, params.count)

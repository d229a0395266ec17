"""Multi-instance and distribution layer of the port: device meshes
(mesh.py), their collectives (collectives.py), multi-process setup
(distributed.py), batched solving (batch.py), three row-sharded
eliminations with decreasing communication (rowshard.py,
rowshard_blocked.py, rowshard_tournament.py) and mesh-sharded multi-RHS
(multi_rhs_sharded.py)."""

from __future__ import annotations


def solve_sharded(eqs, cols: int, mode: int, mesh, k_panel: int = 256):
    """Solve one system row-sharded over ``mesh``, picking the algorithm by
    mesh shape: tournament pivoting (one collective per panel) when the
    rows axis has more than one shard, the plain panel-blocked elimination
    on a one-shard rows axis (where the tournament's extra merge pass buys
    nothing)."""
    from . import mesh as meshlib
    from .rowshard_blocked import solve_rowsharded_blocked
    from .rowshard_tournament import solve_rowsharded_tournament

    if meshlib.require_mesh(mesh).shape[meshlib.ROWS_AXIS] > 1:
        return solve_rowsharded_tournament(eqs, cols, mode, mesh, k_panel)
    return solve_rowsharded_blocked(eqs, cols, mode, mesh, k_panel)


def solve_multi_rhs_sharded(a32, cols, rhs_bits, mode=0, mesh=None, **kw):
    """Many instances of ONE coefficient matrix, instances sharded over
    the mesh batch axis with the matrix replicated: zero collectives
    (parallel/multi_rhs_sharded.py).  The serving-scale face of
    ops/multi_rhs; also reachable as
    ``CapturedTrace.solve_raw_batch(values, mode, mesh=mesh)``."""
    from .multi_rhs_sharded import solve_multi_rhs_sharded as _impl

    return _impl(a32, cols, rhs_bits, mode, mesh=mesh, **kw)

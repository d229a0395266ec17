"""The port's tournament row-sharded solver
(gf2bv_tpu_torch/parallel/rowshard_tournament.py) against the JAX package's,
on the CPU, as tests/test_torch_rowshard.py holds the other two: the JAX
side on its virtual CPU mesh with its Pallas scan and rebuild in interpret
mode, the port on a mesh of CPU shards of the same shape with the plain
twins of its kernels.  Tolerance 0: mode 1's RREF and pivot map bit for bit,
the fused mode-0 tail's origin words and verdict.
"""

import numpy as np
import pytest
import torch

from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import solver
from gf2bv_tpu.parallel import rowshard_tournament as rt_jax
from gf2bv_tpu_torch import torch_to_u32
from gf2bv_tpu_torch.parallel import collectives, solve_sharded
from gf2bv_tpu_torch.parallel import mesh as meshlib
from gf2bv_tpu_torch.parallel.rowshard_tournament import (
    rref_rowsharded_tournament,
    solve_rowsharded_tournament,
)

from test_solver import random_system
from test_torch_rowshard import COLS, _meshes, _mode1_equal, _same_rref, eqs, rows8  # noqa: F401

torch.set_num_threads(2)


TOURNAMENT = [((1, 8), 64), ((2, 4), 128), ((1, 2), 256), ((8, 1), 64), ((1, 4), 64)]


@pytest.mark.parametrize("shape,k_panel", TOURNAMENT)
def test_tournament_rref_matches_jax(eqs, shape, k_panel):
    """One gather per panel that holds a column, nothing else."""
    mj, mt = _meshes(*shape)
    a32 = packing.pad2d(packing.to_u32(eqs), row_align=256 * shape[1], word_align=128)
    collectives.reset_counts()
    got = rref_rowsharded_tournament(a32, COLS, mt, k_panel, "jnp")
    panels = -(-(1 + COLS) // k_panel)
    assert collectives.COUNTS == {"pmin": 0, "psum": 0, "pmax": 0, "all_gather": panels,
                                  "readout": 0}
    _same_rref(got, rt_jax.rref_rowsharded_tournament(a32, COLS, mj, k_panel, "jnp", True))


@pytest.mark.parametrize("unsat", [False, True])
@pytest.mark.parametrize("shape,k_panel", TOURNAMENT[:3])
def test_tournament_fused_tail_matches_jax(shape, k_panel, unsat):
    """Origin words and verdict of the fused mode-0 tail: the loop's gathers,
    then exactly one psum and one pmax."""
    rng = np.random.default_rng(3000 + k_panel + unsat)
    eqs, _ = random_system(rng, 96, COLS, rank_deficit=5, inconsistent=unsat)
    mj, mt = _meshes(*shape)
    a32 = packing.pad2d(packing.to_u32(eqs), row_align=256 * shape[1], word_align=128)
    collectives.reset_counts()
    origin, bad = rref_rowsharded_tournament(a32, COLS, mt, k_panel, "jnp", fused_origin=True)
    panels = -(-(1 + COLS) // k_panel)
    assert collectives.COUNTS == {"pmin": 0, "psum": 1, "pmax": 1, "all_gather": panels,
                                  "readout": 0}
    o_j, u_j = rt_jax.rref_rowsharded_tournament(a32, COLS, mj, k_panel, "jnp", True,
                                                 fused_origin=True)
    assert bool(bad) == bool(u_j) == unsat
    assert np.array_equal(torch_to_u32(origin), np.asarray(o_j))


@pytest.mark.parametrize("rows,cols,deficit", [(64, 48, 0), (48, 60, 5), (200, 150, 7)])
def test_tournament_matches_single(rows8, rows, cols, deficit):
    eqs, _ = random_system(np.random.default_rng(2000 + rows + cols), rows, cols,
                           rank_deficit=deficit)
    _mode1_equal(solve_rowsharded_tournament(eqs, cols, 1, rows8, k_panel=64),
                 solver.solve(eqs, cols, 1, "jax"))


def test_tournament_cross_shard_pivots(rows8):
    """Columns whose only nonzero rows live in late shards force the merged
    scan to pick pivots across shard boundaries."""
    rng = np.random.default_rng(9)
    cols = 96
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = np.zeros((2048, cols), dtype=np.uint8)
    for i in range(8):  # shard i (256 rows) covers only columns [12 i, 96)
        coeff[256 * i: 256 * i + 32, 12 * i:] = rng.integers(0, 2, size=(32, cols - 12 * i))
    rhs = (coeff @ secret) % 2
    eqs = packing.pack_bits(np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols)
    _mode1_equal(solve_rowsharded_tournament(eqs, cols, 1, rows8, k_panel=64),
                 solver.solve(eqs, cols, 1, "oracle"))


def test_solve_sharded_facade(rows8):
    eqs, _ = random_system(np.random.default_rng(12), 64, 48)
    want = solver.solve(eqs, 48, 0, "oracle")
    collectives.reset_counts()
    assert packing.words_to_int(solve_sharded(eqs, 48, 0, rows8, k_panel=64)) == want
    assert collectives.COUNTS["all_gather"] == 1  # the tournament
    # a one-shard rows axis takes the blocked elimination
    mesh1 = meshlib.make_mesh(batch=8, rows=1, devices=["cpu"] * 8)
    collectives.reset_counts()
    assert packing.words_to_int(solve_sharded(eqs, 48, 0, mesh1, k_panel=64)) == want
    assert collectives.COUNTS["all_gather"] == 0 and collectives.COUNTS["pmin"] == 48


@pytest.mark.parametrize("deficit,unsat", [(0, False), (5, False), (0, True)])
def test_tournament_fused_mode0(rows8, deficit, unsat):
    eqs, _ = random_system(np.random.default_rng(3000 + deficit + unsat), 96, 70,
                           rank_deficit=deficit, inconsistent=unsat)
    got = solve_rowsharded_tournament(eqs, 70, 0, rows8, k_panel=64)
    want = solver.solve(eqs, 70, 0, "oracle")
    assert (got is None) == (want is None)
    if want is not None:
        assert packing.words_to_int(got) == want


@pytest.mark.parametrize("mode", [0, 1])
def test_tournament_underdetermined_multishard_pivots(rows8, mode):
    """The reference's round-4 regression shape: rows < cols, several panels,
    pivots owned across all 8 shards (gathering eliminated rows instead of
    raw ones dropped rank here)."""
    rng = np.random.default_rng(11)
    cols, rows = 1700, 1636
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    rhs = (coeff @ secret) % 2
    eqs = packing.pack_bits(np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols)
    want = solver.solve(eqs, cols, mode, "oracle")
    got = solve_rowsharded_tournament(eqs, cols, mode, rows8)
    assert want is not None and got is not None
    if mode == 0:
        assert packing.words_to_int(got) == want
    else:
        _mode1_equal(got, want)



"""The port's row-sharded solvers (gf2bv_tpu_torch/parallel/rowshard*.py)
against the JAX package's, on the CPU: the per-pivot and blocked ones here,
the tournament's own cases in test_torch_tournament.py.

The JAX side runs on its 8-device virtual CPU mesh (tests/conftest.py), the
tournament's Pallas kernels in interpret mode; the port side on a mesh of
CPU shards of the same shape.  Inputs are made from numpy seeds.  Tolerance
0: the RREF is unique, and every solver keeps the reference's pivot rule,
so the sharded RREF and its pivot map (global row ids) are equal bit for
bit in mode 1, and the fused tail's origin and verdict in mode 0.  The
collective counts pin the communication, as tests/test_collectives_hlo.py
pins the reference's compiled HLO.
"""

import numpy as np
import pytest
import torch

import jax

from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import solver
from gf2bv_tpu.parallel import mesh as mesh_jax
from gf2bv_tpu.parallel import rowshard as rs_jax
from gf2bv_tpu.parallel import rowshard_blocked as rb_jax
from gf2bv_tpu_torch import torch_to_u32
from gf2bv_tpu_torch.parallel import collectives
from gf2bv_tpu_torch.parallel import mesh as meshlib
from gf2bv_tpu_torch.parallel.rowshard import rref_rowsharded, solve_rowsharded
from gf2bv_tpu_torch.parallel.rowshard_blocked import (
    _pick_phase2,
    rref_rowsharded_blocked,
    solve_rowsharded_blocked,
)
from gf2bv_tpu_torch.parallel.rowshard_tournament import solve_rowsharded_tournament

from test_solver import random_system

torch.set_num_threads(2)

SHAPES = [(1, 8), (8, 1), (2, 4), (1, 2), (1, 4)]
COLS = 70


def _meshes(batch, rows):
    devs = jax.devices()[: batch * rows]
    return (mesh_jax.make_mesh(batch=batch, rows=rows, devices=devs),
            meshlib.make_mesh(batch=batch, rows=rows, devices=["cpu"] * (batch * rows)))


@pytest.fixture(scope="module")
def eqs():
    """96 rows over 70 columns, rank deficit 5: free columns and pivots on
    every shard."""
    return random_system(np.random.default_rng(5), 96, COLS, rank_deficit=5)[0]


def _same_rref(got, want):
    (r_t, p_t), (r_j, p_j) = got, want
    assert np.array_equal(torch_to_u32(r_t), np.asarray(r_j))
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("shape", SHAPES)
def test_per_pivot_rref_matches_jax(eqs, shape):
    mj, mt = _meshes(*shape)
    a32 = packing.pad2d(packing.to_u32(eqs), row_align=shape[1])
    collectives.reset_counts()
    got = rref_rowsharded(a32, COLS, mt)
    assert collectives.COUNTS == {"pmin": COLS, "psum": COLS, "pmax": 0, "all_gather": 0,
                                  "readout": 0}
    _same_rref(got, rs_jax.rref_rowsharded(a32, COLS, mj))


@pytest.mark.parametrize("k_panel", [64, 128, 256])
@pytest.mark.parametrize("shape", SHAPES)
def test_blocked_rref_matches_jax(eqs, shape, k_panel):
    """The CPU padding branch (whole panels, one row per shard), as the
    reference pads off the TPU; two reductions per column and no gather."""
    mj, mt = _meshes(*shape)
    a32 = packing.pad2d(packing.to_u32(eqs), row_align=shape[1], word_align=k_panel // 32)
    collectives.reset_counts()
    got = rref_rowsharded_blocked(a32, COLS, mt, k_panel, "jnp")
    assert collectives.COUNTS == {"pmin": COLS, "psum": COLS, "pmax": 0, "all_gather": 0,
                                  "readout": 0}
    _same_rref(got, rb_jax.rref_rowsharded_blocked(a32, COLS, mj, k_panel, "jnp"))


# -- the reference's cases (tests/test_parallel.py, test_rowshard_blocked.py,
# test_rowshard_tournament.py), held against the JAX package's solvers ------

def _mode1_equal(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        origin, basis = got
        assert packing.words_to_int(origin) == want.origin
        assert packing.rows_to_ints(basis) == list(want.basis)


@pytest.fixture(scope="module")
def rows8():
    return meshlib.make_mesh(batch=1, rows=8, devices=["cpu"] * 8)


@pytest.mark.parametrize("rows,cols,deficit", [(64, 48, 0), (48, 60, 5), (96, 33, 2)])
def test_per_pivot_matches_single(rows8, rows, cols, deficit):
    eqs, _ = random_system(np.random.default_rng(rows + cols), rows, cols,
                           rank_deficit=deficit)
    _mode1_equal(solve_rowsharded(eqs, cols, 1, rows8), solver.solve(eqs, cols, 1, "jax"))


@pytest.mark.parametrize("rows,cols,deficit",
                         [(64, 48, 0), (48, 60, 5), (96, 33, 2), (256, 140, 0), (200, 150, 7)])
def test_blocked_matches_single(rows8, rows, cols, deficit):
    eqs, _ = random_system(np.random.default_rng(1000 + rows + cols), rows, cols,
                           rank_deficit=deficit)
    _mode1_equal(solve_rowsharded_blocked(eqs, cols, 1, rows8),
                 solver.solve(eqs, cols, 1, "oracle"))


@pytest.mark.parametrize("k_panel", [64, 128])
def test_blocked_k_panel(rows8, k_panel):
    eqs, _ = random_system(np.random.default_rng(7), 96, 80)
    got = solve_rowsharded_blocked(eqs, 80, 0, rows8, k_panel=k_panel)
    assert packing.words_to_int(got) == solver.solve(eqs, 80, 0, "oracle")


@pytest.mark.parametrize("which", ["per_pivot", "blocked", "tournament"])
def test_inconsistent(rows8, which):
    eqs, _ = random_system(np.random.default_rng(5), 40, 32, inconsistent=True)
    fn = {"per_pivot": lambda: solve_rowsharded(eqs, 32, 0, rows8),
          "blocked": lambda: solve_rowsharded_blocked(eqs, 32, 0, rows8),
          "tournament": lambda: solve_rowsharded_tournament(eqs, 32, 0, rows8, k_panel=64)}
    assert fn[which]() is None


@pytest.mark.parametrize("which", ["blocked", "tournament"])
def test_two_d_mesh(which):
    """Every batch row of a (2, 4) mesh holds the same answer; the port
    computes it once."""
    mesh = meshlib.make_mesh(batch=2, rows=4, devices=["cpu"] * 8)
    eqs, _ = random_system(np.random.default_rng(11), 64, 50, rank_deficit=3)
    solve = solve_rowsharded_blocked if which == "blocked" else solve_rowsharded_tournament
    _mode1_equal(solve(eqs, 50, 1, mesh), solver.solve(eqs, 50, 1, "jax"))


def test_pick_phase2(monkeypatch):
    monkeypatch.delenv("GF2BV_TPU_PHASE2", raising=False)
    assert _pick_phase2(128, "cpu") == "jnp"
    assert _pick_phase2(256, "cuda") == "mxu"
    assert _pick_phase2(130, "cuda") == "jnp"
    monkeypatch.setenv("GF2BV_TPU_PHASE2", "pallas")
    assert _pick_phase2(256, "cuda") == "pallas"

"""The port's blocked solver (gf2bv_tpu_torch.ops.gauss_blocked) against the
JAX package's, on the CPU.

The JAX side runs the main path's engines in interpret mode
(``pallas_scan_interpret`` + ``mxu_interpret``); the port runs the plain
twins of its kernels on CPU tensors.  Inputs come from seeded numpy and
cross with u32_to_torch / torch_to_u32.  Tolerance 0: RREF is unique.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import extract_device as ed_jax
from gf2bv_tpu.ops import gauss_blocked as gb_jax
from gf2bv_tpu.ops import solver as solver_jax
from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import extract_device as ed_torch
from gf2bv_tpu_torch.ops import gauss_blocked as gb_torch
from gf2bv_tpu_torch.ops import solver

torch.set_num_threads(2)

P1, P2 = "pallas_scan_interpret", "mxu_interpret"


def _system(seed, rows, cols, dep=0, k_panel=256, unsat=False):
    """Padded (rows', wp) uint32 matrix of a consistent random system with
    ``dep`` duplicated rows; ``unsat`` flips the RHS of one duplicate."""
    rng = np.random.default_rng(seed)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    if dep:
        coeff[rows - dep :] = coeff[:dep]
    rhs = (coeff @ secret) % 2
    bits = np.concatenate([rhs[:, None], coeff], axis=1)
    if unsat:
        bits[-1] = bits[0]
        bits[-1, 0] ^= 1
    eqs = packing.pack_bits(bits, 1 + cols)
    return eqs, gb_jax._pad(eqs, k_panel, word_align=128)


def t32(a):
    return u32_to_torch(a, "cpu")


def test_selector_from_prow_matches_jax():
    rng = np.random.default_rng(4)
    rows, K = 512, 256
    b_orig = rng.integers(0, 2**32, size=(rows, K // 32), dtype=np.uint32)
    prow = rng.permutation(rows)[:K].astype(np.int32)
    prow[rng.random(K) < 0.3] = -1  # free columns -> dump row
    prow[K - 1] = rows - 1  # a pivot on the last real row, next to the dump row
    want = np.asarray(gb_jax.selector_from_prow(jnp.asarray(b_orig), jnp.asarray(prow)))
    got = gb_torch.selector_from_prow(t32(b_orig), torch.from_numpy(prow))
    assert np.array_equal(torch_to_u32(got), want)


@pytest.mark.parametrize(
    "rows,cols,k_panel,dep", [(300, 200, 128, 6), (700, 700, 256, 9), (256, 1500, 256, 0)]
)
def test_rref_blocked_matches_jax(rows, cols, k_panel, dep):
    """Non-trailing mode: the whole RREF, the pivot map and the flag."""
    _, a32 = _system(rows + cols, rows, cols, dep, k_panel)
    r_j, p_j, i_j = gb_jax.rref_blocked(jnp.asarray(a32), cols, k_panel, P2, P1, False)
    a_t = t32(a32)
    r_t, p_t, i_t = gb_torch.rref_blocked(a_t, cols, k_panel, False)
    assert np.array_equal(torch_to_u32(r_t), np.asarray(r_j))
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))
    assert bool(i_t) == bool(i_j)
    assert np.array_equal(torch_to_u32(a_t), a32)  # input not mutated


@pytest.mark.parametrize("rows,cols,extra", [(256, 64, 128), (512, 100, 128), (256, 300, 3)])
def test_rref_blocked_unaligned_width_matches_jax(rows, cols, extra):
    """A width that is not a multiple of K/32 words (a per-pivot cached
    matrix, 2 * nwords64(1 + cols) words, beside ``extra`` RHS words) is
    taken as the reference takes it: padded inside, sliced back."""
    eqs, _ = _system(rows + cols + extra, rows, cols, dep=3)
    raw = packing.to_u32(eqs)
    rng = np.random.default_rng(extra)
    a32 = np.zeros((rows, raw.shape[1] + extra), np.uint32)
    a32[: raw.shape[0], : raw.shape[1]] = raw
    a32[: raw.shape[0], raw.shape[1] :] = rng.integers(0, 2**32, size=(raw.shape[0], extra),
                                                       dtype=np.uint32)
    assert a32.shape[1] % 8
    # the reference's Pallas engines need 128-word widths; its jnp engines,
    # the ones it picks here, give the same RREF
    r_j, p_j, i_j = gb_jax.rref_blocked(jnp.asarray(a32), cols, 256, "jnp", "jnp", False)
    a_t = t32(a32)
    r_t, p_t, i_t = gb_torch.rref_blocked(a_t, cols, 256, False)
    assert r_t.shape == a32.shape and r_t.is_contiguous()
    assert np.array_equal(torch_to_u32(r_t), np.asarray(r_j))
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))
    assert bool(i_t) == bool(i_j)
    assert np.array_equal(torch_to_u32(a_t), a32)  # input not mutated


@pytest.mark.parametrize(
    "rows,cols,dep",
    [(320, 12300, 0), (760, 700, 5)],
    ids=["wide-dead-tiles", "determined"],
)
def test_rref_origin_blocked_matches_jax(rows, cols, dep):
    """Trailing mode: the origin and the unsat verdict.  ``wide-dead-tiles``
    is test_trailing_solve_e2e_interpret's shape (wp 512: dead_tiles 1-2)."""
    eqs, a32 = _system(3 if cols == 12300 else 8, rows, cols, dep)
    o_j, u_j = gb_jax.rref_origin_blocked(jnp.asarray(a32), cols, 256, P2, P1)
    a_t = t32(a32)
    o_t, u_t = gb_torch.rref_origin_blocked(a_t, cols)
    assert not bool(u_t) and not bool(u_j)
    assert np.array_equal(torch_to_u32(o_t), np.asarray(o_j))
    assert np.array_equal(torch_to_u32(a_t), a32)  # the parity check read it


def test_planted_unsat_returns_unsat():
    eqs, a32 = _system(12, 300, 8190, unsat=True)
    _, unsat = gb_torch.rref_origin_blocked(t32(a32), 8190)
    assert bool(unsat)
    assert solver.solve(eqs, 8190, 0, device="cpu") is None


def test_extraction_matches_jax():
    """origin_device / inconsistent_device / origin_parity_unsat on the same
    RREF, including a system that reduces to 0 = 1."""
    for unsat in (False, True):
        _, a32 = _system(21, 200, 150, dep=4, unsat=unsat)
        cols = 150
        r_j, p_j, _ = gb_jax.rref_blocked(jnp.asarray(a32), cols, 256, "jnp", "jnp")
        r_t, p_t = t32(np.asarray(r_j)), torch.from_numpy(np.asarray(p_j).copy())
        o_j = np.asarray(ed_jax.origin_device(r_j, p_j, cols))
        o_t = ed_torch.origin_device(r_t, p_t, cols)
        assert np.array_equal(torch_to_u32(o_t), o_j)
        assert bool(ed_torch.inconsistent_device(r_t)) == bool(
            ed_jax.inconsistent_device(r_j)
        ) == unsat
        assert bool(gb_torch.origin_parity_unsat(t32(a32), o_t)) == bool(
            gb_jax.origin_parity_unsat(jnp.asarray(a32), jnp.asarray(o_j))
        ) == unsat


def test_pad_device_matches_pad():
    eqs, a32 = _system(2, 300, 200)
    raw = packing.to_u32(eqs)
    got = gb_torch._pad_device(t32(raw), 256, 128)
    assert np.array_equal(torch_to_u32(got), a32)
    assert gb_torch._pad_device(t32(a32), 256, 128).shape == a32.shape


def test_solve_packed_tensor_and_host_agree():
    eqs, _ = _system(6, 400, 300, dep=3)
    sol_host = solver.solve(eqs, 300, 0, device="cpu")
    sol_tensor = solver.solve_packed(t32(packing.to_u32(eqs)), 300, 0, device="cpu")
    want = gb_jax.solve_blocked(eqs, 300, 0, phase1=P1, phase2=P2)
    assert sol_host == sol_tensor == packing.words_to_int(want)


@pytest.mark.parametrize("backend", ["native", "oracle"])
def test_unported_backends_raise(backend):
    """The host backends, which used to raise as not ported, solve as the
    blocked solver and the reference's same backend do."""
    eqs, _ = _system(6, 40, 30)
    got = solver.solve(eqs, 30, 0, backend=backend, device="cpu")
    assert got == solver.solve(eqs, 30, 0, backend="blocked", device="cpu")
    assert got == solver_jax.solve(eqs, 30, 0, backend=backend) is not None


def test_mode1_raises():
    """Mode 1 runs on every backend: the host ones, which used to raise,
    give the blocked solver's space."""
    eqs, _ = _system(6, 40, 30)
    want = solver.solve(eqs, 30, 1, backend="blocked", device="cpu")
    assert want.dimension == 0
    for backend in ("native", "oracle", "jax", None):
        got = solver.solve(eqs, 30, 1, backend=backend, device="cpu")
        assert (got.dimension, got.origin) == (want.dimension, want.origin)

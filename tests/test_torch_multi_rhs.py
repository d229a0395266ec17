"""The port's multi-RHS solver (ops/multi_rhs.py) against the JAX package's,
on the CPU: many affine columns of one coefficient matrix ride ONE
elimination.

The same seeded numpy inputs go through ``gf2bv_tpu.ops.multi_rhs`` (its
portable engines on the CPU) and through the port (the default engines'
plain twins).  Tolerance 0: integer GF(2) arithmetic, and the RREF is unique.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import multi_rhs as mr_jax
from gf2bv_tpu.ops.gauss_blocked import K_PANEL, _pad
from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import extract_device, multi_rhs

torch.set_num_threads(2)


def t32(a):
    return u32_to_torch(a, "cpu")


def _coeff_matrix(coeff):
    """Packed, padded matrix of a coefficient block (affine bit 0 inert)."""
    rows, cols = coeff.shape
    eqs = packing.pack_bits(
        np.concatenate([np.zeros((rows, 1), np.uint8), coeff], axis=1), 1 + cols)
    return _pad(eqs, K_PANEL, word_align=128)


def _instances(seed, rows=180, cols=150, nb=37, free=3):
    """A coefficient matrix with a ``free``-dimensional kernel and a dependent
    last row, ``nb`` right-hand sides, every third one contradictory."""
    rng = np.random.default_rng(seed)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    perm = rng.permutation(cols)
    coeff[:, perm[perm != 31][:free]] = 0  # variable 31 (origin bit 31) stays pivoted
    coeff[rows - 1] = coeff[0] ^ coeff[1]
    secrets = rng.integers(0, 2, size=(nb, cols)).astype(np.uint8)
    rhs = ((secrets @ coeff.T) % 2).astype(np.uint8)
    bad = np.arange(nb) % 3 == 2
    rhs[bad, rows - 1] ^= 1
    return coeff, rhs, bad


def _same(got, want, mode):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, k
        elif mode == 0:
            assert g == w, k
        else:
            assert g.origin == w.origin and g.basis == w.basis, k
            assert g.dimension == w.dimension


# -- buckets and packers ----------------------------------------------------------------


@pytest.mark.parametrize("nb", [1, 32, 33, 256, 257, 1024, 1025, 4096, 4097, 16385, 32768])
def test_bw_for_matches_jax(nb):
    bw = multi_rhs._bw_for(nb)
    assert bw == mr_jax._bw_for(nb)
    assert multi_rhs._tiles_for(bw) == mr_jax._tiles_for(bw)


def test_constants_and_limit_match_jax():
    assert multi_rhs._RHS_TILE == mr_jax._RHS_TILE
    assert multi_rhs.MAX_RHS_TILES == mr_jax.MAX_RHS_TILES
    assert multi_rhs.MAX_RHS == mr_jax.MAX_RHS == 32768
    assert multi_rhs._BW_BUCKETS == mr_jax._BW_BUCKETS
    with pytest.raises(ValueError, match="at most"):
        multi_rhs._bw_for(multi_rhs.MAX_RHS + 1)


@pytest.mark.parametrize("nb,rows,bw", [(37, 50, 8), (600, 90, 32), (1, 10, 1)])
def test_pack_rhs_matches_jax(nb, rows, bw):
    rng = np.random.default_rng(nb)
    bits = rng.integers(0, 2, size=(nb, rows)).astype(np.uint8)
    got = multi_rhs._pack_rhs(bits, 256, bw)
    assert got.dtype == np.uint32 and got.shape == (256, bw)
    assert np.array_equal(got, mr_jax._pack_rhs(bits, 256, bw))
    k, r = nb - 1, rows - 1  # instance k's bit of row r: word k >> 5, bit k & 31
    assert (got[r, k >> 5] >> (k & 31)) & 1 == bits[k, r]


@pytest.mark.parametrize("nb,G", [(37, 5), (64, 3), (10, 0), (4096, 12)])
def test_pack_rhs_affine_sweep_matches_jax(nb, G):
    rng = np.random.default_rng(nb + G)
    rows = 70
    base = rng.integers(0, 2, size=rows).astype(np.uint8)
    guess = rng.integers(0, 2, size=(nb, G)).astype(np.uint8)
    bw = multi_rhs._bw_for(nb)
    got = multi_rhs._pack_rhs_affine_sweep(base, guess, 256, bw)
    assert np.array_equal(got, mr_jax._pack_rhs_affine_sweep(base, guess, 256, bw))
    # the materialized form: every instance the base column, the last G rows flipped
    full = np.broadcast_to(base, (nb, rows)).copy()
    if G:
        full[:, rows - G :] ^= guess
    want = multi_rhs._pack_rhs(full, 256, bw)
    nwu = -(-nb // 32)
    tail = (1 << (nb - 32 * (nwu - 1))) - 1  # the real instances of the last word
    assert np.array_equal(got[:, : nwu - 1], want[:, : nwu - 1])
    assert np.array_equal(got[:, nwu - 1] & np.uint32(tail), want[:, nwu - 1])


# -- extraction ---------------------------------------------------------------------------


@pytest.mark.parametrize("cols,bw", [(200, 8), (64, 1), (95, 32)])
def test_extract_multi_matches_jax(cols, bw):
    """A random "RREF" (dense words, so bit 31 is set everywhere), random
    pivot map with free columns; some rows have an empty coefficient part."""
    rng = np.random.default_rng(cols + bw)
    rows, wp = 256, 128
    r = rng.integers(0, 2**32, size=(rows, wp + 128), dtype=np.uint32)
    r[::5, :wp] = 0
    r[::10, 0] = 1  # only the inert affine bit: still an empty coefficient part
    pof = rng.integers(-1, rows, size=cols).astype(np.int32)
    pof[31] = 7  # solution bit 31 of word 0 has a pivot row
    o_j, u_j = mr_jax._extract_multi(jnp.asarray(r), jnp.asarray(pof), cols, wp, bw)
    o_t, u_t = multi_rhs._extract_multi(t32(r), torch.from_numpy(pof), cols, wp, bw)
    assert o_t.dtype == torch.int32 and u_t.dtype == torch.int32
    assert np.array_equal(torch_to_u32(o_t), np.asarray(o_j))
    assert np.array_equal(torch_to_u32(u_t), np.asarray(u_j))
    assert (np.asarray(o_j)[:, 0] >> 31).any()  # an origin with bit 31 of a word set
    assert np.asarray(u_j).any()


# -- solve_multi_rhs ------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [0, 1])
def test_solve_multi_rhs_matches_jax(mode):
    coeff, rhs, bad = _instances(60 + mode)
    a32 = _coeff_matrix(coeff)
    want = mr_jax.solve_multi_rhs(a32, coeff.shape[1], rhs, mode)
    got = multi_rhs.solve_multi_rhs(a32, coeff.shape[1], rhs, mode, device="cpu")
    _same(got, want, mode)
    assert [g is None for g in got] == list(bad)
    if mode == 0:
        assert any(g is not None and (g >> 31) & 1 for g in got)  # origin bit 31
    else:
        live = [g for g in got if g is not None]
        assert live[0].dimension == 3
        # one shared basis array
        assert all(np.shares_memory(g._basis, live[0]._basis) for g in live)


def test_rhs_packed_and_nb():
    coeff, rhs, _ = _instances(5, nb=45)
    cols = coeff.shape[1]
    a32 = _coeff_matrix(coeff)
    want = multi_rhs.solve_multi_rhs(a32, cols, rhs, 0, device="cpu")
    packed = multi_rhs._pack_rhs(rhs, a32.shape[0], multi_rhs._bw_for(45))
    got = multi_rhs.solve_multi_rhs(a32, cols, None, 0, rhs_packed=packed, nb=45, device="cpu")
    assert got == want and len(got) == 45  # the phantom instances 45..63 are never returned
    _same(got, mr_jax.solve_multi_rhs(a32, cols, None, 0, rhs_packed=packed, nb=45), 0)
    with pytest.raises(ValueError, match="requires nb"):
        multi_rhs.solve_multi_rhs(a32, cols, None, 0, rhs_packed=packed, device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        multi_rhs.solve_multi_rhs(a32, cols, None, 0, rhs_packed=packed, nb=20, device="cpu")


@pytest.mark.parametrize("mode", [0, 1])
def test_rhs_block_at_a_panel_boundary(mode):
    """1 + cols = 256 = one panel, and the matrix is exactly one panel wide,
    so the first RHS word starts a panel boundary: the panel loop must stop
    at cols and no RHS column may pivot."""
    rng = np.random.default_rng(17)
    rows, cols, nb = 256, 255, 40
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    coeff[:, 100] = 0  # one free column
    coeff[rows - 1] = coeff[3] ^ coeff[4]
    secrets = rng.integers(0, 2, size=(nb, cols)).astype(np.uint8)
    rhs = ((secrets @ coeff.T) % 2).astype(np.uint8)
    rhs[7, rows - 1] ^= 1
    a32 = packing.to_u32(packing.pack_bits(
        np.concatenate([np.zeros((rows, 1), np.uint8), coeff], axis=1), 1 + cols))
    assert a32.shape == (256, 8)  # kw words: word 8 is the first RHS word
    want = mr_jax.solve_multi_rhs(a32, cols, rhs, mode)
    got = multi_rhs.solve_multi_rhs(a32, cols, rhs, mode, device="cpu")
    _same(got, want, mode)
    assert got[7] is None and sum(g is None for g in got) == 1

    rref32, pof, _, _ = multi_rhs.solve_multi_rhs_device(
        t32(a32), cols, t32(multi_rhs._pack_rhs(rhs, rows, 8)), 8)
    assert rref32.shape == (256, 8 + 128) and pof.shape == (cols,)
    assert int(pof[100]) == -1 and int((pof >= 0).sum()) == cols - 1


def test_cached_matrix_is_never_eliminated():
    """The caller's device matrix is concatenated before the in-place
    elimination: solving twice from one tensor gives the same answers and
    leaves it as it was."""
    coeff, rhs, _ = _instances(9)
    cols = coeff.shape[1]
    a_dev = t32(_coeff_matrix(coeff))
    before = a_dev.clone()
    first = multi_rhs.solve_multi_rhs(a_dev, cols, rhs, 0)
    assert torch.equal(a_dev, before)
    assert multi_rhs.solve_multi_rhs(a_dev, cols, rhs, 0) == first
    assert torch.equal(a_dev, before)


def test_own_affine_bit_is_inert():
    """The matrix's own affine column (bit 0) changes nothing: every
    instance's affine bits come from the appended block."""
    coeff, rhs, _ = _instances(13, nb=12)
    cols = coeff.shape[1]
    a32 = _coeff_matrix(coeff)
    noisy = a32.copy()
    noisy[: coeff.shape[0], 0] |= np.uint32(1)
    want = multi_rhs.solve_multi_rhs(a32, cols, rhs, 0, device="cpu")
    assert multi_rhs.solve_multi_rhs(noisy, cols, rhs, 0, device="cpu") == want


@pytest.mark.parametrize("p1,p2", [
    ("pallas_scan", "pallas"), ("pallas_scan", "mxu2"), ("pallas_scan", "mxu4"),
    ("pallas_scan2", "mxu_la"), ("jnp", "jnp"),
])
def test_multi_rhs_under_each_update_engine(p1, p2):
    coeff, rhs, _ = _instances(21, rows=140, cols=100, nb=20)
    a32 = _coeff_matrix(coeff)
    want = multi_rhs.solve_multi_rhs(a32, 100, rhs, 1, device="cpu")
    got = multi_rhs.solve_multi_rhs(a32, 100, rhs, 1, phase1=p1, phase2=p2, device="cpu")
    _same(got, want, 1)


def test_k_panel_argument():
    coeff, rhs, _ = _instances(23, rows=140, cols=100, nb=9)
    a32 = _coeff_matrix(coeff)
    want = multi_rhs.solve_multi_rhs(a32, 100, rhs, 0, device="cpu")
    assert multi_rhs.solve_multi_rhs(a32, 100, rhs, 0, k_panel=64, device="cpu") == want


def test_basis_cache_is_shared_and_lazy(monkeypatch):
    """Mode 1: one basis build for all instances and chunks that pass the
    same dict, and none at all when every instance is unsatisfiable."""
    coeff, rhs, bad = _instances(31, nb=12)
    cols = coeff.shape[1]
    a32 = _coeff_matrix(coeff)
    builds = []
    real = extract_device._basis_host_orchestrated

    def spy(*args):
        builds.append(1)
        return real(*args)

    monkeypatch.setattr(extract_device, "_basis_host_orchestrated", spy)
    cache: dict = {}
    first = multi_rhs.solve_multi_rhs(a32, cols, rhs[:6], 1, basis_cache=cache, device="cpu")
    second = multi_rhs.solve_multi_rhs(a32, cols, rhs[6:], 1, basis_cache=cache, device="cpu")
    assert len(builds) == 1 and "basis" in cache
    live = [g for g in first + second if g is not None]
    assert all(np.shares_memory(g._basis, live[0]._basis) for g in live)
    builds.clear()
    cache = {}
    only_bad = multi_rhs.solve_multi_rhs(a32, cols, rhs[bad], 1, basis_cache=cache, device="cpu")
    assert only_bad == [None] * int(bad.sum()) and not builds and not cache


def test_multitile_bucket():
    """More than 4096 instances ride one elimination through two appended
    tiles (bw = 256); instances on both sides of the tile boundary equal
    the JAX package's, a planted unsat among them."""
    rng = np.random.default_rng(83)
    rows, cols, nb = 96, 80, 4100
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    coeff[rows - 1] = coeff[0] ^ coeff[2]
    secrets = rng.integers(0, 2, size=(nb, cols)).astype(np.uint8)
    rhs = ((secrets @ coeff.T) % 2).astype(np.uint8)
    for k in (1, 4096, 4099):
        rhs[k, rows - 1] ^= 1
    a32 = _coeff_matrix(coeff)
    assert multi_rhs._bw_for(nb) == 256
    got = multi_rhs.solve_multi_rhs(a32, cols, rhs, 0, device="cpu")
    want = mr_jax.solve_multi_rhs(a32, cols, rhs, 0)
    assert got == want and len(got) == nb
    assert [k for k, g in enumerate(got) if g is None] == [1, 4096, 4099]

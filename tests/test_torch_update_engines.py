"""The update engines pallas, mxu2, mxu4, skip and jnp of the port against
the JAX package's, on the CPU.

Each plain PyTorch twin is held against its Pallas kernel in interpret mode
on the same seeded numpy inputs (whole matrices, so a wrong trailing rule
shows at once), then each engine runs through the blocked solver against the
JAX package under ``<name>_interpret`` and against the port's default
engine.  Tolerance 0: integer GF(2) arithmetic, and the RREF is unique.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import gauss_batched as gbat_jax
from gf2bv_tpu.ops import gauss_blocked as gb_jax
from gf2bv_tpu.ops import pallas_update as pu_jax
from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import gauss_batched, panel_update
from gf2bv_tpu_torch.ops import gauss_blocked as gb_torch

torch.set_num_threads(2)

WPS = [256, 384, 200]  # two tiles, three tiles, one ragged tile
TWINS = {
    "mxu2": (panel_update.update_mxu2, panel_update.update_mxu2_plain, pu_jax.panel_update_mxu2),
    "mxu4": (panel_update.update_mxu4, panel_update.update_mxu4_plain, pu_jax.panel_update_mxu4),
}


def t32(a):
    return u32_to_torch(a, "cpu")


def _update_inputs(wp, k=64, rows=256, seed=0):
    rng = np.random.default_rng(1000 + wp + k + seed)
    a = rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32)
    sel = rng.integers(0, 2**32, size=(rows, k // 32), dtype=np.uint32)
    pf = rng.integers(0, 2**32, size=(k, wp), dtype=np.uint32)
    return a, sel, pf


def _system(seed, rows, cols, dep=0, k_panel=128, flip=False):
    """Padded (rows', wp) uint32 matrix of a random system with ``dep``
    duplicated rows; consistent unless ``flip``."""
    rng = np.random.default_rng(seed)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    if dep:
        coeff[rows - dep :] = coeff[:dep]
    rhs = (coeff @ secret) % 2
    if flip:
        rhs[rows - 1] ^= 1  # a duplicated row with the other constant
    bits = np.concatenate([rhs[:, None], coeff], axis=1)
    return gb_jax._pad(packing.pack_bits(bits, 1 + cols), k_panel, word_align=128)


# -- helpers of the twins ------------------------------------------------------------


def test_unpack_sel_bits_matches_jax():
    _, sel, _ = _update_inputs(256, k=96)
    got = panel_update.unpack_sel_bits(t32(sel))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(pu_jax.unpack_sel_bits(jnp.asarray(sel))))


@pytest.mark.parametrize("wp,tw", [(256, 128), (384, 128), (200, 200)])
def test_unpack_pf_planes2_matches_jax(wp, tw):
    _, _, pf = _update_inputs(wp)
    got = panel_update.unpack_pf_planes2(t32(pf), tw)
    assert np.array_equal(got.numpy(), np.asarray(pu_jax.unpack_pf_planes2(jnp.asarray(pf), tw)))


@pytest.mark.parametrize("tw", [8, 128])
def test_pack_weight_matrix_matches_jax(tw):
    assert np.array_equal(panel_update._pack_weight_matrix(tw), pu_jax._pack_weight_matrix(tw))


@pytest.mark.parametrize("wp", [8, 100, 128, 256, 384, 640, 768, 1152, 1280])
def test_pick_tw_matches_jax(wp):
    assert panel_update.pick_tw(wp) == pu_jax.pick_tw(wp)


# -- kernel 8: the pallas engine's update ------------------------------------------------


@pytest.mark.parametrize("wp", WPS)
def test_update_pallas_matches_pallas(wp):
    a, sel, pf = _update_inputs(wp)
    want = np.asarray(pu_jax.panel_update(
        jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), interpret=True))
    for fn in (panel_update.update_pallas, panel_update.update_pallas_plain):
        a_t = t32(a)
        got = fn(a_t, t32(sel), t32(pf))
        assert got is a_t  # in place
        assert np.array_equal(torch_to_u32(got), want)
    # a second derivation: the table scheme of the default engine's twin
    full = panel_update.update_full_plain(t32(a), t32(sel), t32(pf))
    assert np.array_equal(torch_to_u32(full), want)


def test_update_pallas_k256():
    a, sel, pf = _update_inputs(128, k=256)
    want = np.asarray(pu_jax.panel_update(
        jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), interpret=True))
    got = panel_update.update_pallas(t32(a), t32(sel), t32(pf))
    assert np.array_equal(torch_to_u32(got), want)


# -- kernels 10 and 11: the mxu2 and mxu4 engines' updates -------------------------------


def _w0_cases(wp):
    """full, the first word, inside tile 0, a tile boundary, the last tile."""
    return [None, 0, 72, 128 if wp % 128 == 0 else wp // 2, wp - 2]


@pytest.mark.parametrize(
    "case", range(5), ids=["full", "w0=0", "in-tile-0", "boundary", "last-tile"])
@pytest.mark.parametrize("wp", WPS)
@pytest.mark.parametrize("name", ["mxu2", "mxu4"])
def test_mxu_twin_matches_pallas(name, wp, case):
    """The whole updated matrix, under each trailing rule: mxu2 keeps tiles
    j >= 1 wholly left of w0 and always updates tile 0 in full; mxu4 also
    cuts tile 0 to its const word once tw <= w0."""
    wrapper, twin, kernel = TWINS[name]
    w0 = _w0_cases(wp)[case]
    a, sel, pf = _update_inputs(wp, seed=case)
    want = np.asarray(kernel(
        jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), interpret=True,
        w0=None if w0 is None else jnp.asarray(w0, jnp.int32),
    ))
    for fn in (wrapper, twin):
        a_t = t32(a)
        got = fn(a_t, t32(sel), t32(pf), w0)
        assert got is a_t
        assert np.array_equal(torch_to_u32(got), want)


def test_trailing_rules_differ_where_they_should():
    """w0 = 2 tiles in: mxu2 updates all of tile 0 and tile 2, mxu4 word 0
    and tile 2, both keep tile 1; the update engine mxu's rule is mxu4's."""
    a, sel, pf = _update_inputs(384)
    full = torch_to_u32(panel_update.update_full_plain(t32(a), t32(sel), t32(pf)))
    m2 = torch_to_u32(panel_update.update_mxu2(t32(a), t32(sel), t32(pf), 260))
    m4 = torch_to_u32(panel_update.update_mxu4(t32(a), t32(sel), t32(pf), 260))
    tr = torch_to_u32(panel_update.update_trailing(t32(a), t32(sel), t32(pf), 260))
    assert np.array_equal(m2[:, :128], full[:, :128])
    assert np.array_equal(m4[:, :1], full[:, :1]) and np.array_equal(m4[:, 1:128], a[:, 1:128])
    for got in (m2, m4):
        assert np.array_equal(got[:, 128:256], a[:, 128:256])
        assert np.array_equal(got[:, 256:], full[:, 256:])
    assert np.array_equal(m4, tr)
    assert not np.array_equal(m2, m4)


@pytest.mark.parametrize("name", ["mxu2", "mxu4"])
def test_mxu_k256_and_bit31(name):
    """K = 256 (the solver's panel) with bit 31 set everywhere in pf."""
    wrapper, _, kernel = TWINS[name]
    a, sel, pf = _update_inputs(128, k=256)
    pf |= np.uint32(0x80000000)
    want = np.asarray(kernel(jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), interpret=True))
    assert np.array_equal(torch_to_u32(wrapper(t32(a), t32(sel), t32(pf))), want)


def test_update_wrappers_check_their_arguments():
    a, sel, pf = (t32(x) for x in _update_inputs(256))
    for fn in (panel_update.update_mxu2, panel_update.update_mxu4):
        with pytest.raises(ValueError, match="w0="):
            fn(a, sel, pf, 256)
        with pytest.raises(ValueError, match="rank-K"):
            fn(a, sel[:, :1], pf)
    with pytest.raises(ValueError, match="rank-K"):
        panel_update.update_pallas(a, sel, pf[:, :8])


# -- the engines through the blocked solver ------------------------------------------------


@pytest.mark.parametrize("flip", [False, True], ids=["sat", "unsat"])
@pytest.mark.parametrize("p2", ["pallas", "mxu2", "mxu4"])
def test_phase2_engine_matches_jax(p2, flip):
    """Whole RREF (trailing=False) against the JAX package under
    <name>_interpret and against the port's default engine; in trailing
    mode the origin and the verdict.  4400 columns: two 128-word tiles, and
    the last two panels start in the second, so the trailing rules have a
    tile to cut or keep."""
    cols, k = 4400, 256
    a32 = _system(31, 300, cols, dep=4, k_panel=k, flip=flip)
    assert a32.shape[1] == 256
    a_t = t32(a32)
    r_j, p_j, i_j = gb_jax.rref_blocked(
        jnp.asarray(a32), cols, k, p2 + "_interpret", "pallas_scan_interpret", False)
    r_t, p_t, i_t = gb_torch.rref_blocked(a_t, cols, k, False, phase2=p2)
    assert np.array_equal(torch_to_u32(r_t), np.asarray(r_j))
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))
    assert bool(i_t) == bool(i_j) == flip
    r_d, p_d, i_d = gb_torch.rref_blocked(a_t, cols, k, False)
    assert torch.equal(r_t, r_d) and torch.equal(p_t, p_d) and bool(i_d) == flip

    o_j, u_j = gb_jax.rref_origin_blocked(
        jnp.asarray(a32), cols, k, p2 + "_interpret", "pallas_scan_interpret")
    o_t, u_t = gb_torch.rref_origin_blocked(a_t, cols, k, phase2=p2 + "_interpret")
    assert np.array_equal(torch_to_u32(o_t), np.asarray(o_j))
    assert bool(u_t) == bool(u_j) == flip
    assert np.array_equal(torch_to_u32(a_t), a32)  # input not mutated


def test_skip_leaves_the_matrix_as_phase1_left_it():
    """phase2="skip" (the phase-1-only diagnostic): no update at all, so the
    matrix comes back as it went in and only the pivot map is made; equal to
    the reference's skip."""
    cols, k = 200, 128
    a32 = _system(8, 300, cols, dep=3, k_panel=k)
    r_j, p_j, _ = gb_jax.rref_blocked(
        jnp.asarray(a32), cols, k, "skip", "pallas_scan_interpret", False)
    r_t, p_t, _ = gb_torch.rref_blocked(t32(a32), cols, k, False, phase2="skip")
    assert np.array_equal(torch_to_u32(r_t), a32)
    assert np.array_equal(torch_to_u32(r_t), np.asarray(r_j))
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))
    assert (p_t >= 0).any()


@pytest.mark.parametrize("p1,p2", [("jnp", "jnp"), ("jnp", "mxu"), ("pallas_scan", "jnp")])
def test_jnp_engines_match_jax(p1, p2):
    """The portable engines against the reference's jnp engines (whole RREF,
    then origin and verdict in trailing mode) and the port's default."""
    cols, k = 200, 64
    a32 = _system(12, 150, cols, dep=5, k_panel=k)
    a_t = t32(a32)
    r_j, p_j, i_j = gb_jax.rref_blocked(jnp.asarray(a32), cols, k, "jnp", "jnp", False)
    r_t, p_t, i_t = gb_torch.rref_blocked(a_t, cols, k, False, phase1=p1, phase2=p2)
    assert np.array_equal(torch_to_u32(r_t), np.asarray(r_j))
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))
    assert bool(i_t) == bool(i_j)
    r_d, p_d, _ = gb_torch.rref_blocked(a_t, cols, k, False)
    assert torch.equal(r_t, r_d) and torch.equal(p_t, p_d)
    o_j, u_j = gb_jax.rref_origin_blocked(jnp.asarray(a32), cols, k, "jnp", "jnp")
    o_t, u_t = gb_torch.rref_origin_blocked(a_t, cols, k, phase1=p1, phase2=p2)
    assert np.array_equal(torch_to_u32(o_t), np.asarray(o_j))
    assert bool(u_t) == bool(u_j)


def test_phase1_panel_jnp_matches_the_split_engine():
    """One panel with rows already used: the per-pivot loop gives the split
    engine's pf, pivots and used rows."""
    from gf2bv_tpu_torch.ops import phase1

    rng = np.random.default_rng(5)
    rows, wp, K, w0, cols = 256, 128, 64, 2, 3000
    a = t32(rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32))
    used = torch.from_numpy((rng.random((1, rows)) < 0.2).astype(np.int32))
    b_orig = a[:, w0 : w0 + K // 32].clone()
    got = gb_torch.phase1_panel_jnp(a, b_orig, used, w0, K, cols)
    want = phase1.phase1_panel_split(a, b_orig.T.contiguous(), used, w0, K, cols)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1] >= 0).any()


def test_engine_table_is_complete():
    """Every engine name of the reference's dispatch is an engine of the
    port; nothing is left to port."""
    for name in ("mxu", "mxu_noseg", "mxu_la", "pallas", "mxu2", "mxu4", "skip", "jnp"):
        assert gb_torch.engine(name, "phase2") == name
        assert gb_torch.engine(name + "_interpret", "phase2") == name
    for name in ("pallas_scan", "pallas_scan2", "pallas_scanm", "pallas", "pallas_sub", "jnp"):
        assert gb_torch.engine(name + "_interpret", "phase1") == name
    with pytest.raises(ValueError, match="unknown phase2 engine"):
        gb_torch.engine("mxu3", "phase2")


# -- the batched solver under an update engine ----------------------------------------------


@pytest.mark.parametrize("mode", [0, 1])
def test_solve_batched_under_mxu2(mode):
    cols = 190
    mats = []
    for i in range(3):
        rng = np.random.default_rng(40 + i)
        bits = rng.integers(0, 2, size=(160 + 10 * i, 1 + cols)).astype(np.uint8)
        bits[:, 0] = (bits[:, 1:] @ rng.integers(0, 2, size=cols)) % 2
        if i == 1:
            bits[5] = bits[4]
            bits[5, 0] ^= 1  # unsat
        mats.append(packing.pack_bits(bits, 1 + cols))
    got = gauss_batched.solve_batched(mats, cols, mode, phase2="mxu2", device="cpu")
    want = gbat_jax.solve_batched(mats, cols, mode, phase2="mxu2_interpret")
    default = gauss_batched.solve_batched(mats, cols, mode, device="cpu")
    assert got[1] is None and want[1] is None and default[1] is None
    for g, w, d in zip(got, want, default):
        if g is None:
            continue
        if mode == 0:
            assert np.array_equal(g, w) and np.array_equal(g, d)
        else:
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
            assert np.array_equal(g[0], d[0]) and np.array_equal(g[1], d[1])

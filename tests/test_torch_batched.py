"""The port's batch path against the JAX package, on the CPU.

* Plain twins of the batched scan, the batched rebuild and the trailing
  update against the Pallas kernels (``_scan_batched``,
  ``_reconstruct_batched``, ``panel_update_mxu(w0=...)``) in interpret mode;
* the batched blocked solver (``ops/gauss_batched``), the batched per-pivot
  solver and ``parallel/batch`` against the same JAX functions;
* ``LinearSystem.solve_one_batch`` / ``solve_all_batch`` against the JAX
  package's LinearSystem.

Inputs are seeded numpy arrays crossing with u32_to_torch / torch_to_u32.
Tolerance 0: integer GF(2) arithmetic, and the RREF is unique.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gf2bv_tpu
from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import gauss_batched as gbat_jax
from gf2bv_tpu.ops.gauss_blocked import _pad
from gf2bv_tpu.ops.pallas_update import panel_update_mxu
from gf2bv_tpu.parallel import batch as pbatch_jax
from gf2bv_tpu_torch import DimensionTooLargeError, LinearSystem, torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.crypto import mt_torch
from gf2bv_tpu_torch.crypto.mt import MT19937
from gf2bv_tpu_torch.ops import gauss_batched, gauss_jax, panel_update
from gf2bv_tpu_torch.parallel import batch as pbatch

torch.set_num_threads(2)

B = 3
ROWS = 512
# (K, w0, cols): a first panel, a panel crossing ``cols`` and one wholly
# inside a wide system
PANELS = [(64, 0, 5000), (64, 2, 80), (256, 0, 5000), (256, 8, 300), (256, 16, 100000)]


def t32(a):
    return u32_to_torch(a, "cpu")


def _batch_panel(K, w0, seed):
    """B random (ROWS, 640) matrices, their panel slices and pre-used rows."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(B, ROWS, 640), dtype=np.uint32)
    bT = np.ascontiguousarray(a[:, :, w0 : w0 + K // 32].transpose(0, 2, 1))
    used = (rng.random((B, ROWS)) < 0.3).astype(np.int32)
    return rng, a, bT, used


def _jax_scan(bT, used, w0, K, cols):
    out = gbat_jax._scan_batched(jnp.asarray(bT), jnp.asarray(used), w0, K, cols, True)
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("K,w0,cols", PANELS)
def test_scan_batched_matches_pallas(K, w0, cols):
    _, _, bT, used = _batch_panel(K, w0, seed=K + w0)
    prow_j, used_j, cT_j = _jax_scan(bT, used, w0, K, cols)
    prow_t, used_t, cT_t = gauss_batched.scan_batched(t32(bT), torch.from_numpy(used), w0, K, cols)
    assert prow_j.shape == (B, K) and (prow_j >= 0).any()
    assert np.array_equal(prow_t.numpy(), prow_j)
    assert np.array_equal(used_t.numpy(), used_j)
    assert np.array_equal(torch_to_u32(cT_t), cT_j)


@pytest.mark.parametrize("consistent", [True, False], ids=["solver", "arbitrary"])
@pytest.mark.parametrize("K,w0,cols", PANELS)
def test_reconstruct_batched_matches_pallas(K, w0, cols, consistent):
    """``solver``: the pivot rows carry the scanned slice, as in the solver;
    ``arbitrary``: unrelated rows, which reach the triangular window."""
    rng, a, bT, used = _batch_panel(K, w0, seed=K + w0)
    prow, _, cT = _jax_scan(bT, used, w0, K, cols)
    src = a if consistent else rng.integers(0, 2**32, size=a.shape, dtype=np.uint32)
    ps = np.maximum(prow, 0)
    arows = np.ascontiguousarray(np.take_along_axis(src, ps[:, :, None], axis=1))
    coeff = np.ascontiguousarray(np.take_along_axis(cT, ps[:, None, :], axis=2).transpose(0, 2, 1))
    want = np.asarray(gbat_jax._reconstruct_batched(
        jnp.asarray(arows), jnp.asarray(coeff), jnp.asarray(prow), w0, K, True))
    got = gauss_batched.reconstruct_batched(t32(arows), t32(coeff), torch.from_numpy(prow.copy()), w0)
    assert np.array_equal(torch_to_u32(got), want)


@pytest.mark.parametrize("wp,w0s", [(384, [0, 8, 120, 128, 160, 256, 376]), (200, [0, 96, 192])])
def test_update_trailing_matches_pallas(wp, w0s):
    """The whole matrix: the reference copies its dead tiles through, so
    every word of its output is defined.  wp=200 is one tile of wp words."""
    rng = np.random.default_rng(wp)
    rows, K = 256, 64
    a = rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32)
    sel = rng.integers(0, 2**32, size=(rows, K // 32), dtype=np.uint32)
    pf = rng.integers(0, 2**32, size=(K, wp), dtype=np.uint32)
    for w0 in w0s:
        want = np.asarray(panel_update_mxu(
            jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), interpret=True, w0=w0))
        got = panel_update.update_trailing(t32(a), t32(sel), t32(pf), w0)
        assert np.array_equal(torch_to_u32(got), want), w0


def test_update_trailing_rejects_w0_outside_rows():
    a, sel, pf = (torch.zeros(s, dtype=torch.int32) for s in ((256, 128), (256, 2), (64, 128)))
    for w0 in (-1, 128):
        with pytest.raises(ValueError, match="outside"):
            panel_update.update_trailing(a, sel, pf, w0)


def _systems(rng, nb, rows, cols, with_unsat=False):
    """Packed (rows, W64) consistent random systems with a rank deficiency;
    with ``with_unsat`` one more holding a contradictory pair of rows."""
    mats = []
    for i in range(nb + with_unsat):
        coeff = rng.integers(0, 2, size=(rows, cols), dtype=np.uint8)
        coeff[rows - 4 :] = coeff[:4]
        rhs = (coeff.astype(np.int64) @ rng.integers(0, 2, size=cols)) % 2
        bits = np.concatenate([rhs[:, None].astype(np.uint8), coeff], axis=1)
        if i == nb:
            bits[10] = bits[11]
            bits[10, 0] ^= 1
        mats.append(packing.pack_bits(bits, 1 + cols))
    return mats


def _same_results(got, want, mode):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        if mode == 0:
            assert np.array_equal(g, w)
        else:
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


@pytest.mark.parametrize("rows,cols", [(300, 200), (200, 300)])
def test_rref_device_batched_matches_vmapped(rows, cols):
    rng = np.random.default_rng(rows)
    mats = _systems(rng, B, rows, cols, with_unsat=True)
    a = pbatch_jax.pack_batch(mats, cols)
    assert np.array_equal(pbatch.pack_batch(mats, cols), a)
    r_j, p_j, i_j = pbatch_jax._rref_batched(jnp.asarray(a), cols)
    r_t, p_t, i_t = gauss_jax.rref_device_batched(t32(a), cols)
    assert np.array_equal(torch_to_u32(r_t), np.asarray(r_j))
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))
    assert np.array_equal(i_t.numpy(), np.asarray(i_j))
    assert i_t.numpy().tolist() == [False] * B + [True]


@pytest.mark.parametrize("trailing", [False, True], ids=["full", "trailing"])
@pytest.mark.parametrize("rows,cols", [(300, 200), (280, 4000)])
def test_rref_blocked_batched_matches_jax(rows, cols, trailing):
    """The whole matrix in both modes: the reference's trailing update
    (``mxu_interpret`` with w0) defines every word, as the port's does."""
    rng = np.random.default_rng(rows + cols)
    mats = _systems(rng, B, rows, cols)
    a = np.stack([_pad(m, 256, word_align=128) for m in mats])
    r_j, p_j, i_j = gbat_jax.rref_blocked_batched(
        jnp.asarray(a), cols, 256, "mxu_interpret", trailing, True)
    a_t = t32(a)
    r_t, p_t, i_t = gauss_batched.rref_blocked_batched(a_t, cols, 256, trailing)
    assert np.array_equal(torch_to_u32(r_t), np.asarray(r_j))
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))
    assert np.array_equal(i_t.numpy(), np.asarray(i_j))
    assert np.array_equal(torch_to_u32(a_t), a)  # input not mutated


def test_rref_origin_batched_matches_jax():
    rng = np.random.default_rng(17)
    mats = _systems(rng, 2, 280, 190, with_unsat=True)
    a = np.stack([_pad(m, 256, word_align=128) for m in mats])
    o_j, u_j = gbat_jax.rref_origin_batched(jnp.asarray(a), 190, 256, "mxu_interpret", True)
    o_t, u_t = gauss_batched.rref_origin_batched(t32(a), 190)
    assert np.array_equal(torch_to_u32(o_t), np.asarray(o_j))
    assert u_t.numpy().tolist() == np.asarray(u_j).tolist() == [False, False, True]


@pytest.mark.parametrize("mode", [0, 1])
def test_solve_batched_matches_jax(mode):
    rng = np.random.default_rng(29)
    mats = _systems(rng, 3, 280, 190, with_unsat=True)
    got = gauss_batched.solve_batched(mats, 190, mode, device="cpu")
    _same_results(got, gbat_jax.solve_batched(mats, 190, mode), mode)
    assert got[-1] is None


@pytest.mark.parametrize("mode", [0, 1])
def test_solve_batched_chunks(monkeypatch, mode):
    """Batches above BATCH_CHUNK_MAX run chunk by chunk (4 + 2 here); the
    tail chunk is not padded."""
    monkeypatch.setattr(gauss_batched, "BATCH_CHUNK_MAX", 4)
    seen = []
    real = gauss_batched.rref_blocked_batched

    def spy(a, *args, **kw):
        seen.append(a.shape[0])
        return real(a, *args, **kw)

    monkeypatch.setattr(gauss_batched, "rref_blocked_batched", spy)
    rng = np.random.default_rng(41)
    mats = _systems(rng, 5, 200, 120, with_unsat=True)
    got = gauss_batched.solve_batched(mats, 120, mode, device="cpu")
    _same_results(got, gbat_jax.solve_batched(mats, 120, mode), mode)
    assert seen == [4, 2]


def test_solve_batched_takes_a_tensor():
    rng = np.random.default_rng(43)
    mats = _systems(rng, 2, 200, 150, with_unsat=True)
    a = np.stack([_pad(m, 256, word_align=128) for m in mats])
    got = gauss_batched.solve_batched(t32(a), 150, 0, device="cpu")
    _same_results(got, gbat_jax.solve_batched(mats, 150, 0), 0)


def test_solve_chained_matches_jax():
    rng = np.random.default_rng(31)
    mats = _systems(rng, 3, 280, 190, with_unsat=True)
    got = gauss_batched.solve_chained(mats, 190, device="cpu")
    _same_results(got, gbat_jax.solve_chained(mats, 190), 0)
    assert got[-1] is None


@pytest.mark.parametrize("mode", [0, 1])
def test_solve_batch_wide_routes(monkeypatch, mode):
    """Wide batches (``_PER_PIVOT_MAX_COLS`` patched down to CI size, in
    both packages) go to solve_chained in mode 0, solve_batched in mode 1."""
    monkeypatch.setattr(pbatch, "_PER_PIVOT_MAX_COLS", 190)
    monkeypatch.setattr(pbatch_jax, "_PER_PIVOT_MAX_COLS", 190)
    called = []
    for name in ("solve_chained", "solve_batched"):
        real = getattr(gauss_batched, name)

        def spy(*args, _real=real, _name=name, **kw):
            called.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(gauss_batched, name, spy)
    rng = np.random.default_rng(37)
    mats = _systems(rng, 2, 250, 190, with_unsat=True)
    got = pbatch.solve_batch(mats, 190, mode, device="cpu")
    assert called == ["solve_chained" if mode == 0 else "solve_batched"]
    _same_results(got, pbatch_jax.solve_batch(mats, 190, mode), mode)


def test_solve_batch_guard_solves_one_by_one(monkeypatch):
    monkeypatch.setattr(pbatch, "_PER_PIVOT_MAX_COLS", 190)
    monkeypatch.setattr(pbatch, "_GUARD_BYTES", 1)
    monkeypatch.setattr(gauss_batched, "solve_batched", None)  # must not be reached
    rng = np.random.default_rng(39)
    mats = _systems(rng, 2, 250, 190, with_unsat=True)
    got = pbatch.solve_batch(mats, 190, 1, device="cpu")
    _same_results(got, pbatch_jax.solve_batch(mats, 190, 1), 1)


@pytest.mark.parametrize("mode", [0, 1])
def test_solve_batch_narrow_matches_jax(mode):
    rng = np.random.default_rng(47 + mode)
    mats = _systems(rng, 3, 120, 100, with_unsat=True)
    mats.append(packing.pack_bits(np.zeros((0, 101), np.uint8), 101))  # no rows
    got = pbatch.solve_batch(mats, 100, mode, device="cpu")
    _same_results(got, pbatch_jax.solve_batch(mats, 100, mode), mode)
    assert pbatch.solve_batch([], 100, mode, device="cpu") == []


def test_solve_batch_mesh_raises():
    """A mesh that is not a parallel.mesh.Mesh raises; batches over real
    meshes are tests/test_torch_multi_rhs_sharded.py's."""
    with pytest.raises(TypeError, match="Mesh"):
        pbatch.solve_batch([np.zeros((1, 2), np.uint64)], 8, 0, mesh=object(), device="cpu")
    lin = LinearSystem([8], device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        lin.solve_one_batch([[]], mesh=object())


def _lfsr_batch(lin_cls, n, taps, seeds, nout, **kw):
    """A Fibonacci LFSR recovery per seed: zeros lists of one system."""
    lin = lin_cls([n], **kw)
    zeros_batch = []
    for seed in seeds:
        (s,) = lin.gens()
        st, outs = seed, []
        for _ in range(nout):
            fb = 0
            for t in taps:
                fb ^= (st >> t) & 1
            outs.append(st & 1)
            st = (st >> 1) | (fb << (n - 1))
        zs, sym = [], s
        for o in outs:
            fb = 0
            for t in taps:
                fb ^= (sym >> t) & 1
            zs.append((sym & 1) ^ o)
            sym = (sym >> 1) | (fb << (n - 1))
        zeros_batch.append(zs)
    return lin, zeros_batch


@pytest.mark.parametrize("n,nout", [(64, 64), (128, 60)], ids=["determined", "underdetermined"])
def test_linear_system_batches_match_jax(n, nout):
    """solve_one_batch / solve_all_batch on LFSR recoveries; with fewer
    outputs than state bits the spaces have a dimension above 0."""
    taps = [0, 1, 3, 4] if n == 64 else [0, 1, 2, 7]
    seeds = [random.Random(n + i).getrandbits(n) | 1 for i in range(3)]
    lin, zb = _lfsr_batch(LinearSystem, n, taps, seeds, nout, device="cpu")
    lin_j, zb_j = _lfsr_batch(gf2bv_tpu.LinearSystem, n, taps, seeds, nout)
    assert lin.solve_one_batch(zb) == lin_j.solve_one_batch(zb_j)
    got = lin.solve_all_batch(zb, max_dimension=8)
    want = lin_j.solve_all_batch(zb_j, max_dimension=8)
    for g, w, seed in zip(got, want, seeds):
        if n == 64:
            assert list(g) == list(w) == [(seed,)]
        else:
            with pytest.raises(gf2bv_tpu.DimensionTooLargeError) as ej:
                next(w)
            with pytest.raises(DimensionTooLargeError) as et:
                next(g)
            sp_t, sp_j = et.value.space, ej.value.space
            assert sp_t.dimension == sp_j.dimension == n - nout
            assert sp_t.origin == sp_j.origin and sp_t.basis == sp_j.basis


def test_linear_system_batch_literal_one_is_unsat():
    lin = LinearSystem([8], device="cpu")
    (x,) = lin.gens(lazy=False)
    assert lin.solve_one_batch([[x ^ 5], [x ^ x ^ 1]]) == [(5,), None]
    got = lin.solve_all_batch([[x ^ 5], [x ^ x ^ 1]])
    assert list(got[0]) == [(5,)] and got[1] is None


def test_u32_round_trip_takes_batches():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, size=(3, 5, 7), dtype=np.uint32)
    t = u32_to_torch(a, "cpu")
    assert t.shape == (3, 5, 7) and t.dtype == torch.int32
    assert np.array_equal(torch_to_u32(t), a)


@pytest.mark.slow
def test_flagship_mt19937_batch_cpu():
    """solve_mt19937_batch and solve_one_batch at the flagship width (slow on
    the CPU: each solve is a full 19968-column elimination)."""
    states, outs_b = [], []
    for seed in (5, 6):
        rand = random.Random(seed)
        states.append(tuple(rand.getstate()[1][:-1]))
        outs_b.append([rand.getrandbits(32) for _ in range(624)])
    bad = list(outs_b[1])
    bad[0] ^= 1
    got = mt_torch.solve_mt19937_batch(outs_b + [bad], 32, device="cpu")
    assert got == states + [None]
    lin = LinearSystem([32] * 624, device="cpu")
    mt = lin.gens()
    zb = []
    for outs in outs_b:
        gen = MT19937(list(mt))
        zb.append([gen.getrandbits(32) ^ o for o in outs] + [mt[0] ^ 0x80000000])
    assert lin.solve_one_batch(zb) == states

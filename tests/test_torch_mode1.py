"""The port's mode 1 (the affine solution space) against the JAX package, on
the CPU.

* the basis extraction (``ops/extract_device``: ``_basis_partial``,
  ``_basis_device`` with its pivot chunking, ``finalize``,
  ``finalize_batch``) on the same RREFs;
* the per-pivot solver (``ops/gauss_jax``) and mode 1 of the blocked solver
  and of ``ops/solver``;
* ``LinearSystem.solve_raw_space`` / ``solve_all`` / ``solve_all_packed``,
  eager and lazy.

The JAX side runs the main path's engines in interpret mode where it
reaches a Pallas kernel.  Tolerance 0: integer GF(2) arithmetic, and the
RREF is unique.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gf2bv_tpu
from gf2bv_tpu.core import packing
from gf2bv_tpu.ops import extract_device as ed_jax
from gf2bv_tpu.ops import gauss_blocked as gb_jax
from gf2bv_tpu.ops import gauss_jax as gj_jax
from gf2bv_tpu.ops import solver as solver_jax
from gf2bv_tpu_torch import DimensionTooLargeError, LinearSystem, torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.crypto import mt_torch
from gf2bv_tpu_torch.crypto.mt import MT19937, MersenneTwister
from gf2bv_tpu_torch.ops import extract_device as ed_torch
from gf2bv_tpu_torch.ops import gauss_blocked as gb_torch
from gf2bv_tpu_torch.ops import gauss_jax as gj_torch
from gf2bv_tpu_torch.ops import solver

torch.set_num_threads(2)

P1, P2 = "pallas_scan_interpret", "mxu_interpret"


def t32(a):
    return u32_to_torch(a, "cpu")


def _system(seed, rows, cols, dep=0, unsat=False):
    """Packed (rows, W64) consistent random system with ``dep`` duplicated
    rows (the space has dimension >= cols - rows + dep); ``unsat`` flips
    the RHS of one duplicate."""
    rng = np.random.default_rng(seed)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    if dep:
        coeff[rows - dep :] = coeff[:dep]
    rhs = (coeff.astype(np.int64) @ secret) % 2
    bits = np.concatenate([rhs[:, None].astype(np.uint8), coeff], axis=1)
    if unsat:
        bits[-1] = bits[0]
        bits[-1, 0] ^= 1
    return packing.pack_bits(bits, 1 + cols)


def _jax_rref(eqs, cols):
    a32 = gb_jax._pad(eqs, 256, word_align=128)
    r, p, i = gb_jax.rref_blocked(jnp.asarray(a32), cols, 256, "jnp", "jnp")
    return r, p, i


def _pivot_args(pof, cols):
    """The (prow, pcol, fcol) arguments _basis_host_orchestrated builds."""
    mask = pof >= 0
    rank = int(mask.sum())
    rankb, dimb = ed_jax._bucket(max(rank, 1)), ed_jax._bucket(cols - rank)
    pcol = np.full(rankb, -1, np.int32)
    prow = np.zeros(rankb, np.int32)
    pc = np.nonzero(mask)[0].astype(np.int32) + 1
    pcol[:rank], prow[:rank] = pc, pof[pc - 1]
    fcol = np.full(dimb, -1, np.int32)
    fcol[: cols - rank] = np.nonzero(~mask)[0].astype(np.int32) + 1
    return prow, pcol, fcol


@pytest.mark.parametrize("n", [0, 1, 16, 17, 64, 65, 5000, 2**20, 2**20 + 1])
def test_bucket_matches_jax(n):
    assert ed_torch._bucket(n) == ed_jax._bucket(n)


@pytest.mark.parametrize("rows,cols,dep", [(150, 200, 3), (90, 1100, 0)])
def test_basis_partial_matches_jax(rows, cols, dep):
    """Pivot columns at bit 31 of their word are among the sums: the trap
    where an int32 add of 1 << 31 would carry."""
    r, p, _ = _jax_rref(_system(rows, rows, cols, dep), cols)
    prow, pcol, fcol = _pivot_args(np.asarray(p), cols)
    assert ((pcol - 1) % 32 == 31).any()
    want = np.asarray(ed_jax._basis_partial(
        r, jnp.asarray(prow), jnp.asarray(pcol), jnp.asarray(fcol), cols))
    got = ed_torch._basis_partial(
        t32(np.asarray(r)), torch.from_numpy(prow), torch.from_numpy(pcol),
        torch.from_numpy(fcol), cols)
    assert np.array_equal(torch_to_u32(got), want)


@pytest.mark.parametrize("chunk", [7, 64, 4096])
def test_basis_device_chunked_matches_jax(monkeypatch, chunk):
    monkeypatch.setattr(ed_jax, "_PCHUNK", chunk)
    monkeypatch.setattr(ed_torch, "_PCHUNK", chunk)
    cols = 300
    r, p, _ = _jax_rref(_system(5, 200, cols, dep=4), cols)
    prow, pcol, fcol = _pivot_args(np.asarray(p), cols)
    want = np.asarray(ed_jax._basis_device(
        r, jnp.asarray(prow), jnp.asarray(pcol), jnp.asarray(fcol), cols))
    got = ed_torch._basis_device(
        t32(np.asarray(r)), torch.from_numpy(prow), torch.from_numpy(pcol),
        torch.from_numpy(fcol), cols)
    assert np.array_equal(torch_to_u32(got), want)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("rows,cols,dep,unsat", [
    (150, 200, 3, False), (260, 250, 5, False), (200, 150, 4, True), (0, 40, 0, False),
])
def test_finalize_matches_jax(rows, cols, dep, unsat, mode):
    """Including a full-rank system (dimension 0), an unsatisfiable one and
    one without equations (dimension == cols)."""
    if rows:
        eqs = _system(rows + cols, rows, cols, dep, unsat)
    else:
        eqs = np.zeros((0, packing.nwords64(1 + cols)), np.uint64)
    r, p, i = _jax_rref(eqs, cols)
    want = ed_jax.finalize(r, p, i, cols, mode)
    got = ed_torch.finalize(
        t32(np.asarray(r)), torch.from_numpy(np.asarray(p).copy()),
        torch.tensor(bool(i)), cols, mode)
    assert (got is None) == (want is None) == unsat
    if want is None:
        return
    if mode == 0:
        assert np.array_equal(got, want)
    else:
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[1].dtype == np.uint64 and got[1].shape[1] == packing.nwords64(cols)


@pytest.mark.parametrize("mode", [0, 1])
def test_finalize_batch_matches_jax(mode):
    cols = 180
    eqs = [_system(60 + b, 150, cols, dep=3, unsat=(b == 1)) for b in range(3)]
    rs, ps, incs = zip(*(_jax_rref(e, cols) for e in eqs))
    r_b, p_b, i_b = jnp.stack(rs), jnp.stack(ps), jnp.stack(incs)
    want = ed_jax.finalize_batch(r_b, p_b, i_b, cols, mode)
    got = ed_torch.finalize_batch(
        t32(np.asarray(r_b)), torch.from_numpy(np.asarray(p_b).copy()),
        torch.from_numpy(np.asarray(i_b).copy()), cols, mode)
    assert [g is None for g in got] == [w is None for w in want] == [False, True, False]
    for g, w in zip(got, want):
        if w is not None and mode == 0:
            assert np.array_equal(g, w)
        elif w is not None:
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


@pytest.mark.parametrize("rows,cols,dep,unsat", [
    (120, 100, 4, False), (80, 150, 0, False), (120, 100, 4, True),
])
def test_rref_device_matches_jax(rows, cols, dep, unsat):
    eqs = _system(rows * cols, rows, cols, dep, unsat)
    a32 = gj_jax._pad_rows(packing.to_u32(eqs), cols)
    assert np.array_equal(gj_torch._pad_rows(packing.to_u32(eqs), cols), a32)
    r_j, p_j, i_j = gj_jax.rref_device(jnp.asarray(a32), cols)
    r_t, p_t, i_t = gj_torch.rref_device(t32(a32), cols)
    assert np.array_equal(torch_to_u32(r_t), np.asarray(r_j))
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))
    assert bool(i_t) == bool(i_j) == unsat
    o_j, u_j = gj_jax.rref_origin_device(jnp.asarray(a32), cols)
    o_t, u_t = gj_torch.rref_origin_device(t32(a32), cols)
    assert np.array_equal(torch_to_u32(o_t), np.asarray(o_j))
    assert bool(u_t) == bool(u_j)


def _same_space(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        assert got.dimension == want.dimension
        assert got.origin == want.origin
        assert got.basis == want.basis


@pytest.mark.parametrize("backend", ["jax", "blocked"])
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("unsat", [False, True])
def test_solver_matches_jax(monkeypatch, backend, mode, unsat):
    """ops.solver.solve and solve_packed (host rows and a tensor) against
    the JAX package's solver with the same backend."""
    monkeypatch.setenv("GF2BV_TPU_PHASE1", P1)
    monkeypatch.setenv("GF2BV_TPU_PHASE2", P2)
    cols = 220
    eqs = _system(cols + mode + 2 * unsat, 200, cols, dep=6, unsat=unsat)
    want = solver_jax.solve(eqs, cols, mode, backend=backend)
    got = solver.solve(eqs, cols, mode, backend=backend, device="cpu")
    got_t = solver.solve_packed(t32(packing.to_u32(eqs)), cols, mode, backend=backend,
                                device="cpu")
    got_h = solver.solve_packed(packing.to_u32(eqs), cols, mode, backend=backend, device="cpu")
    assert (want is None) == unsat
    if mode == 0:
        assert got == got_t == got_h == want
    else:
        for g in (got, got_t, got_h):
            _same_space(g, want)
        assert unsat or want.dimension >= 26  # 200 rows, 6 of them repeats


@pytest.mark.parametrize("cols", [300, 8190])
def test_solve_blocked_mode1_matches_jax(cols):
    """8190 columns: two 128-word tiles, 32 panels of full-width updates."""
    eqs = _system(cols, 290, cols, dep=4)
    want = gb_jax.solve_blocked(eqs, cols, 1, phase1=P1, phase2=P2)
    got = gb_torch.solve_blocked(eqs, cols, 1, device="cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[1].shape[0] == cols - 286


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        solver.solve(_system(6, 40, 30), 30, 0, backend="nope", device="cpu")


def _xorshift_zeros(lin, outs, nout):
    """A 64-bit xorshift (13, 7, 17) traced over ``nout`` 64-bit outputs."""
    (x,) = lin.gens()
    zeros = []
    for o in outs[:nout]:
        x = x ^ (x << 13)
        x = x ^ (x >> 7)
        x = x ^ (x << 17)
        zeros.append(x ^ o)
    return zeros


def _xorshift_outs(seed, n):
    m = (1 << 64) - 1
    x, outs = seed, []
    for _ in range(n):
        x ^= (x << 13) & m
        x ^= x >> 7
        x ^= (x << 17) & m
        outs.append(x)
    return outs


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
def test_linear_system_space_matches_jax(lazy):
    """One 64-bit output pins an xorshift state completely: dimension 0,
    and solve_all yields exactly the seed."""
    seed = 0x0123456789ABCDEF
    outs = _xorshift_outs(seed, 1)
    lin = LinearSystem([64], device="cpu")
    lin_j = gf2bv_tpu.LinearSystem([64])
    if lazy:
        zeros, zeros_j = _xorshift_zeros(lin, outs, 1), _xorshift_zeros(lin_j, outs, 1)
    else:
        (x,) = lin.gens(lazy=False)
        (xj,) = lin_j.gens(lazy=False)
        zeros, zeros_j = [x ^ seed], [xj ^ seed]
    space = lin.solve_raw_space(zeros)
    _same_space(space, lin_j.solve_raw_space(zeros_j))
    assert space.dimension == 0
    assert list(lin.solve_all(zeros)) == list(lin_j.solve_all(zeros_j)) == [(seed,)]


def _mt_space_systems(n=40, m=17, pin_msb=False):
    params = dict(MT19937.PARAMS, n=n, m=m)
    rnd = random.Random(n)
    state = [rnd.getrandbits(32) for _ in range(n)]
    state[0] = 0x80000000
    gen = MersenneTwister(list(state), **params)
    outs = [gen() for _ in range(n)]

    def zeros_of(lin, cls):
        v = lin.gens()
        g = cls(list(v), **params)
        z = [g() ^ o for o in outs]
        return z + [v[0] ^ 0x80000000] if pin_msb else z

    return state, zeros_of


def test_mt_space_without_msb_pin_matches_jax():
    """A short-state Mersenne Twister: without the known-MSB equations the
    low 31 bits of state[0] are never read, so the space has dimension 31;
    the true state is in it, and the DimensionTooLargeError of solve_all is
    raised lazily with the space attached."""
    from gf2bv_tpu.crypto.mt import MersenneTwister as MTJax

    state, zeros_of = _mt_space_systems()
    lin = LinearSystem([32] * 40, device="cpu")
    lin_j = gf2bv_tpu.LinearSystem([32] * 40, backend="blocked")
    zeros = zeros_of(lin, MersenneTwister)
    space = lin.solve_raw_space(zeros)
    _same_space(space, lin_j.solve_raw_space(zeros_of(lin_j, MTJax)))
    assert space.dimension == 31
    raw = sum(v << (32 * i) for i, v in enumerate(state))
    assert _in_span(space, raw)
    assert not _in_span(space, raw ^ (1 << 40))
    gen = lin.solve_all(zeros)  # nothing raised yet: the guard is lazy
    with pytest.raises(DimensionTooLargeError) as ei:
        next(gen)
    _same_space(ei.value.space, space)


def _in_span(space, raw):
    """True iff raw = origin ^ (a combination of the basis)."""
    basis = {}
    for v in space.basis:
        while v:
            top = v.bit_length() - 1
            if top not in basis:
                basis[top] = v
                break
            v ^= basis[top]
    r = raw ^ space.origin
    while r:
        top = r.bit_length() - 1
        if top not in basis:
            return False
        r ^= basis[top]
    return True


def test_solve_all_packed_matches_jax():
    cols = 150
    eqs = _system(3, 140, cols, dep=0)
    lin = LinearSystem([cols], device="cpu")
    lin_j = gf2bv_tpu.LinearSystem([cols])
    got = list(lin.solve_all_packed(eqs, max_dimension=10))
    assert got == list(lin_j.solve_all_packed(eqs, max_dimension=10))
    assert len(got) == 2**10
    with pytest.raises(DimensionTooLargeError):
        next(lin.solve_all_packed(eqs, max_dimension=9))
    got_t = list(lin.solve_all_packed(t32(packing.to_u32(eqs)), max_dimension=10))
    assert got_t == got
    bad = _system(3, 140, cols, dep=2, unsat=True)
    assert list(lin.solve_all_packed(bad)) == []


@pytest.mark.slow
def test_flagship_mt19937_mode1_cpu():
    rand = random.Random(99)
    state = tuple(rand.getstate()[1][:-1])
    outs = [rand.getrandbits(32) for _ in range(624)]
    space = mt_torch.solve_mt19937(outs, 32, mode=1, device="cpu")
    assert space.dimension == 0
    assert space.origin == sum(v << (32 * i) for i, v in enumerate(state))

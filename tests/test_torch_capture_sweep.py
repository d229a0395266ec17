"""Captured traces, multi-instance batches and guess sweeps of the port
against the JAX package, on the CPU.

The same model functions (written on bitvector operators, so they trace under
either package) and the same seeded instances go through
``gf2bv_tpu.LinearSystem(backend="blocked")`` and the port's
``LinearSystem(device="cpu")``.  Tolerance 0: solutions, spaces and verdicts
are equal.
"""

import pickle
import random

import numpy as np
import pytest
import torch

import gf2bv_tpu
from gf2bv_tpu.crypto.mt import MersenneTwister as MTJax
from gf2bv_tpu_torch import CapturedTrace, LinearSystem
from gf2bv_tpu_torch.core import system as system_torch
from gf2bv_tpu_torch.crypto.mt import MT19937, MersenneTwister
from gf2bv_tpu_torch.ops import lazy_solve, multi_rhs

torch.set_num_threads(2)

M32 = 0xFFFFFFFF
NOUT = 10  # truncated outputs of the xorshift model: 160 equations, 64 unknowns


def _xs_step(x, y, mask=None):
    """One step of a two-word xorshift generator; works on ints (``mask``)
    and on 32-bit bitvectors (whose ``<<`` truncates)."""
    t = x ^ (x << 11)
    if mask is not None:
        t &= mask
    x, y = y, y ^ (y >> 19) ^ t ^ (t >> 8)
    return x, y


def xs_outputs(x, y, n=NOUT):
    out = []
    for _ in range(n):
        x, y = _xs_step(x, y, M32)
        out.append(y >> 16)  # only the top 16 bits are observed
    return out


def xs_model(g, p, n=NOUT):
    x, y = g
    zs = []
    for i in range(n):
        x, y = _xs_step(x, y)
        zs.append((y >> 16) ^ p[i])
    return zs


def xs_zeros(lin, outs):
    x, y = lin.gens()
    zs = []
    for o in outs:
        x, y = _xs_step(x, y)
        zs.append((y >> 16) ^ o)
    return zs


def _pair(sizes):
    """The same system under the JAX package and under the port."""
    return gf2bv_tpu.LinearSystem(sizes, backend="blocked"), LinearSystem(sizes, device="cpu")


def _xs_instances(seed, n):
    rnd = random.Random(seed)
    states = [(rnd.getrandbits(32), rnd.getrandbits(32) | 1) for _ in range(n)]
    return states, [xs_outputs(*s) for s in states]


MT_PARAMS = dict(MT19937.PARAMS, n=8, m=3)


def mt_model(cls):
    def model(ws, p):
        gen = cls(list(ws), **MT_PARAMS)
        return [gen() ^ p[k] for k in range(8)] + [ws[0] ^ 0x80000000]
    return model


def _mt_instances(seed, n):
    rnd = random.Random(seed)
    states = [[0x80000000] + [rnd.getrandbits(32) for _ in range(7)] for _ in range(n)]
    outs = []
    for s in states:
        gen = MersenneTwister(list(s), **MT_PARAMS)
        outs.append([gen() for _ in range(8)])
    return states, outs


def _same_space(got, want):
    if want is None:
        assert got is None
        return
    assert got.dimension == want.dimension
    assert got.origin == want.origin and got.basis == want.basis


# -- capture ------------------------------------------------------------------------------


def test_capture_solve_one_matches_jax():
    lin_j, lin = _pair([32, 32])
    tmpl_j, tmpl = lin_j.capture(xs_model), lin.capture(xs_model)
    assert isinstance(tmpl, CapturedTrace) and tmpl.nparams == NOUT
    assert repr(tmpl) == repr(tmpl_j)
    states, outs = _xs_instances(1, 4)
    for s, o in zip(states, outs):
        assert tmpl.solve_one(o) == tmpl_j.solve_one(o) == s
        assert tmpl.solve_raw_one(o) == tmpl_j.solve_raw_one(o)
    bad = list(outs[0])
    bad[3] ^= 1
    assert tmpl.solve_one(bad) is None and tmpl_j.solve_one(bad) is None
    # a captured trace shares the cached device matrix with direct solves
    assert lin.solve_one(xs_zeros(lin, outs[1])) == states[1]
    assert lazy_solve.cached_system(lin, tmpl.zeros) is lazy_solve.cached_system(
        lin, xs_zeros(lin, outs[2]))


def test_capture_cut_down_mt_matches_jax():
    lin_j, lin = _pair([32] * 8)
    tmpl_j, tmpl = lin_j.capture(mt_model(MTJax)), lin.capture(mt_model(MersenneTwister))
    states, outs = _mt_instances(2, 3)
    for s, o in zip(states, outs):
        assert tmpl.solve_one(o) == tmpl_j.solve_one(o) == tuple(s)
    assert tmpl.solve_one_batch(outs) == tmpl_j.solve_one_batch(outs) == [tuple(s) for s in states]


def test_capture_space_and_solve_all_match_jax():
    """Fewer outputs than unknowns: a space of positive dimension."""
    def short(g, p):
        return xs_model(g, p, 5)

    lin_j, lin = _pair([32, 32])
    tmpl_j, tmpl = lin_j.capture(short), lin.capture(short)
    states, outs = _xs_instances(3, 2)
    for s, o in zip(states, outs):
        sp_j, sp = tmpl_j.solve_raw_space(o[:5]), tmpl.solve_raw_space(o[:5])
        assert sp.dimension == 5
        _same_space(sp, sp_j)
        sols = sorted(tmpl.solve_all(o[:5]))
        assert sols == sorted(tmpl_j.solve_all(o[:5])) and len(sols) == 32 and s in sols
    with pytest.raises(system_torch.DimensionTooLargeError):
        next(tmpl.solve_all(outs[0][:5], max_dimension=4))


def _trap_model(g, p):
    """xorshift outputs, two parity rows (a contradiction when they differ)
    and a zero-coefficient row (the literal 1 when its param is set)."""
    x, y = g
    zs = xs_model(g, p)
    zs.append(x.sum() ^ p[NOUT])
    zs.append(x.sum() ^ p[NOUT + 1])
    zs.append(x[0] ^ x[0] ^ p[NOUT + 2])
    return zs


def _trap_batch(seed, n):
    states, outs = _xs_instances(seed, n)
    batch = []
    for k, ((x, _), o) in enumerate(zip(states, outs)):
        par = bin(x).count("1") & 1
        kind = k % 3  # 0 sat, 1 contradictory parity, 2 literal 1
        batch.append(o + [par, par ^ (kind == 1), int(kind == 2)])
    return states, batch


@pytest.mark.parametrize("mode", [0, 1])
def test_solve_raw_batch_matches_jax(mode):
    lin_j, lin = _pair([32, 32])
    tmpl_j, tmpl = lin_j.capture(_trap_model), lin.capture(_trap_model)
    states, batch = _trap_batch(4, 23)
    got = tmpl.solve_raw_batch(batch, mode=mode)
    want = tmpl_j.solve_raw_batch(batch, mode=mode)
    assert len(got) == 23
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (k % 3 != 0)
        if mode == 0:
            assert g == w == tmpl.solve_raw_one(batch[k])
        else:
            _same_space(g, w)
    assert tmpl.solve_raw_batch([]) == []
    sols = tmpl.solve_one_batch(batch)
    assert sols == tmpl_j.solve_one_batch(batch)
    assert [s for s in sols if s is not None] == states[::3]


def test_solve_raw_batch_chunks_past_max_rhs(monkeypatch):
    lin = LinearSystem([32, 32], device="cpu")
    tmpl = lin.capture(xs_model)
    states, outs = _xs_instances(5, 7)
    want = tmpl.solve_one_batch(outs)
    monkeypatch.setattr(multi_rhs, "MAX_RHS", 3)  # force the chunk loop
    assert tmpl.solve_one_batch(outs) == want == states


def test_affine_matrix_fast_path_matches_the_general_one():
    """Params in root-level XOR chains take the vectorized plan; a Param
    under a shift does not, and both give the per-instance affine columns."""
    lin_j, lin = _pair([32, 32])
    tmpl_j, tmpl = lin_j.capture(xs_model), lin.capture(xs_model)
    _, outs = _xs_instances(6, 5)
    exprs = [z._expr for z in tmpl.zeros]
    widths = [e.width for e in exprs]
    fast = tmpl._affine_matrix(exprs, widths, outs)
    assert tmpl._aff_plan is not None
    general = np.stack([lazy_solve._affine_vector(exprs, widths, o) for o in outs])
    assert np.array_equal(fast, general)
    exprs_j = [z._expr for z in tmpl_j.zeros]
    assert np.array_equal(fast, tmpl_j._affine_matrix(exprs_j, widths, outs))

    def nested(g, p):
        return [((g[0] ^ p[0]) >> 3) ^ g[1], g[0] ^ p[1]]

    t2, t2_j = lin.capture(nested), lin_j.capture(nested)
    vals = [[5, 9], [0xFFFF, 1]]
    e2 = [z._expr for z in t2.zeros]
    m2 = t2._affine_matrix(e2, [32, 32], vals)
    assert t2._aff_plan is None
    assert np.array_equal(
        m2, t2_j._affine_matrix([z._expr for z in t2_j.zeros], [32, 32], vals))
    assert t2.solve_one_batch(vals) == t2_j.solve_one_batch(vals)


def test_eqs_with_env_matches_jax():
    lin_j, lin = _pair([32, 32])
    tmpl_j, tmpl = lin_j.capture(_trap_model), lin.capture(_trap_model)
    _, batch = _trap_batch(7, 3)
    for vals in batch:
        assert np.array_equal(tmpl._eqs_with_env(vals), tmpl_j._eqs_with_env(vals))


def test_captured_trace_pickles():
    lin = LinearSystem([32, 32], device="cpu")
    tmpl = lin.capture(xs_model)
    states, outs = _xs_instances(8, 2)
    again = pickle.loads(pickle.dumps(tmpl))
    assert again.nparams == tmpl.nparams and len(again.zeros) == len(tmpl.zeros)
    assert str(again.system._device) == "cpu"
    assert again.solve_one(outs[0]) == states[0]
    assert again.solve_one_batch(outs) == states


def test_capture_errors():
    lin = LinearSystem([32, 32], device="cpu")
    tmpl = lin.capture(xs_model)
    with pytest.raises(ValueError, match="param slots"):
        tmpl.solve_one([1, 2])
    with pytest.raises(TypeError, match="non-lazy zeros"):
        lin.capture(lambda g, p: [5])
    _, outs = _xs_instances(9, 1)
    with pytest.raises(TypeError, match="Mesh"):
        tmpl.solve_raw_batch(outs, mesh=object())


def test_capture_under_the_per_pivot_backend():
    """backend="jax" takes the cached path as in the reference: single solves
    run the per-pivot solver on the cached matrix, a batch the multi-RHS
    elimination; both give the JAX package's answers."""
    lin = LinearSystem([32, 32], backend="jax", device="cpu")
    tmpl = lin.capture(xs_model)
    states, outs = _xs_instances(10, 2)
    assert lazy_solve.eligible(lin, tmpl.zeros)
    assert tmpl.solve_one(outs[0]) == states[0]
    assert lazy_solve.cached_system(lin, tmpl.zeros).backend == "jax"
    assert tmpl.solve_one_batch(outs) == states
    lin_j = gf2bv_tpu.LinearSystem([32, 32], backend="jax")
    assert lin_j.capture(xs_model).solve_one_batch(outs) == states


# -- guess sweeps -------------------------------------------------------------------------


def _mask_workload(seed, lin, n_eqs):
    """A secret and XOR-mask observations of it (eager bitvectors)."""
    rnd = random.Random(seed)
    (x,) = lin.gens(lazy=False)
    w = len(x)
    secret = rnd.getrandbits(w) | 1
    zeros = []
    for _ in range(n_eqs):
        mask = rnd.getrandbits(w)
        zeros.append((x & mask).sum() ^ (bin(secret & mask).count("1") & 1))
    return secret, zeros


def _sweep_pair(width, seed, n_eqs):
    lin_j, lin = _pair([width])
    secret, zeros_j = _mask_workload(seed, lin_j, n_eqs)
    _, zeros = _mask_workload(seed, lin, n_eqs)
    (x_j,) = lin_j.gens(lazy=False)
    (x,) = lin.gens(lazy=False)
    return lin_j, lin, secret, zeros_j, zeros, x_j, x


def test_sweep_enumerated_matches_jax():
    lin_j, lin, secret, zeros_j, zeros, x_j, x = _sweep_pair(48, 11, 44)

    def guesses(v):
        return [(v >> 5).sum(), ((v >> 9) & 1) ^ ((v >> 30) & 1), (v >> 2) & 3]

    got = lin.solve_one_sweep(zeros, guesses(x))
    want = lin_j.solve_one_sweep(zeros_j, guesses(x_j))
    assert got == want and len(got) == 16
    for k in (0, 5, 15):  # the per-guess re-solve gives the same
        pins = [g ^ ((k >> i) & 1) for i, g in enumerate(guesses(x)[:2])]
        pins.append(guesses(x)[2] ^ ((k >> 2) & 3))
        assert got[k] == lin.solve_one(list(zeros) + pins)
    true_k = (bin(secret >> 5).count("1") & 1) | (
        (((secret >> 9) ^ (secret >> 30)) & 1) << 1) | (((secret >> 2) & 3) << 2)
    assert got[true_k] is not None


def test_sweep_explicit_candidates_match_jax():
    lin_j, lin, secret, zeros_j, zeros, x_j, x = _sweep_pair(40, 5, 52)
    cands = [(v,) for v in range(8)]
    got = lin.solve_one_sweep(zeros, [(x >> 12) & 0b111], cands)
    assert got == lin_j.solve_one_sweep(zeros_j, [(x_j >> 12) & 0b111], cands)
    assert [v for v, s in enumerate(got) if s is not None] == [(secret >> 12) & 0b111]
    assert got[(secret >> 12) & 0b111] == (secret,) == lin.solve_one(zeros)
    assert lin.solve_one_sweep(zeros, [(x >> 12) & 0b111], []) == []
    with pytest.raises(ValueError, match="exceeds"):
        lin.solve_one_sweep(zeros, [(x >> 12) & 0b111], [(1 << 40,)])
    with pytest.raises(ValueError, match="values for"):
        lin.solve_one_sweep(zeros, [(x >> 12) & 0b111], [(0, 1)])
    with pytest.raises(TypeError, match="BitVec"):
        lin.solve_one_sweep(zeros, [42], None)
    with pytest.raises(ValueError, match="at least one guess"):
        lin.solve_one_sweep(zeros, [])
    with pytest.raises(TypeError, match="Mesh"):
        lin.solve_one_sweep(zeros, [x & 1], mesh=object())


def test_sweep_dead_guess_bits_and_forced_unsat():
    """A guess with interior dead bits enumerates only its live ones; an
    explicit candidate that pins a dead bit to 1 is unsatisfiable, and a
    constant-0 guess row is kept (pinned to 1: unsat; to 0: a no-op)."""
    lin_j, lin, secret, zeros_j, zeros, x_j, x = _sweep_pair(32, 3, 36)
    got = lin.solve_one_sweep(zeros, [x & 0b10100])  # live bits 2 and 4
    assert got == lin_j.solve_one_sweep(zeros_j, [x_j & 0b10100]) and len(got) == 4
    live_true = ((secret >> 2) & 1) | (((secret >> 4) & 1) << 1)
    assert [k for k, s in enumerate(got) if s is not None] == [live_true]
    cands = [(secret & 0b10100,), ((secret & 0b10100) | 0b1000,), (0b10100 ^ (secret & 0b10100),)]
    exp = lin.solve_one_sweep(zeros, [x & 0b10100], cands)
    assert exp == lin_j.solve_one_sweep(zeros_j, [x_j & 0b10100], cands)
    assert exp[0] == (secret,) and exp[1] is None and exp[2] is None
    const = lin.solve_one_sweep(zeros, [(x ^ x) & 1], [(0,), (1,)])
    assert const == lin_j.solve_one_sweep(zeros_j, [(x_j ^ x_j) & 1], [(0,), (1,)])
    assert const == [(secret,), None]


def test_sweep_enumeration_cap_and_unsat_base():
    lin = LinearSystem([32], device="cpu")
    (x,) = lin.gens(lazy=False)
    with pytest.raises(ValueError, match="2\\*\\*18"):
        lin.solve_one_sweep([x ^ 5], [x & 0x3FFFF])
    assert len(lin.solve_one_sweep([(x >> 17) ^ 1], [x & 0x1FFFF], [(3,)])) == 1
    contradictory = [(x & 1) ^ 0, (x & 1) ^ 1]
    assert lin.solve_one_sweep(contradictory, [(x >> 1) & 1]) == [None, None]


def test_solve_all_sweep_matches_jax():
    lin_j, lin, secret, zeros_j, zeros, x_j, x = _sweep_pair(32, 21, 29)  # underdetermined
    gens = lin.solve_all_sweep(zeros, [x & 3], max_dimension=8)
    gens_j = lin_j.solve_all_sweep(zeros_j, [x_j & 3], max_dimension=8)
    sols = [None if g is None else sorted(g) for g in gens]
    assert sols == [None if g is None else sorted(g) for g in gens_j]
    assert len(sols) == 4 and any(s for s in sols)
    for v, s in enumerate(sols):
        assert all((sol[0] & 3) == v for sol in s or [])
    union = sorted(sum((s for s in sols if s), []))
    assert union == sorted(lin.solve_all(zeros, max_dimension=10))


def test_sweep_chunks_past_max_rhs(monkeypatch):
    lin = LinearSystem([24], device="cpu")
    secret, zeros = _mask_workload(9, lin, 26)
    (x,) = lin.gens(lazy=False)
    guesses = [(x >> i).sum() for i in (1, 2, 3)]
    want = lin.solve_one_sweep(zeros, guesses)
    monkeypatch.setattr(multi_rhs, "MAX_RHS", 3)  # chunks of 3, 3 and 2
    assert lin.solve_one_sweep(zeros, guesses) == want and len(want) == 8


def test_sweep_on_lazy_zeros_and_captured_trace_match_jax():
    """The sweep over a truncated-output model: through lazy zeros, and
    through a captured trace bound to the outputs."""
    lin_j, lin = _pair([32, 32])
    states, outs = _xs_instances(12, 2)
    x0, y0 = states[0]

    def run(system):
        x, y = system.gens()
        direct = system.solve_one_sweep(xs_zeros(system, outs[0][:3]), [x & 0xF, y & 0x3])
        tmpl = system.capture(lambda g, p: xs_model(g, p, 3))
        bound = tmpl.solve_one_sweep(outs[0][:3], [x & 0xF, y & 0x3])
        cands = [(x0 & 0xF, y0 & 0x3), ((x0 & 0xF) ^ 1, y0 & 0x3)]
        picked = tmpl.solve_one_sweep(outs[0][:3], [x & 0xF, y & 0x3], cands)
        return direct, bound, picked

    direct, bound, picked = run(lin)
    direct_j, bound_j, picked_j = run(lin_j)
    assert direct == bound == direct_j == bound_j and len(direct) == 64
    assert picked == picked_j and picked[0] == direct[(x0 & 0xF) | ((y0 & 0x3) << 4)]
    assert picked[0] is not None and picked[0][0] & 0xF == x0 & 0xF


def test_sweep_device_cache_is_an_lru(monkeypatch):
    """The padded coefficient matrix stays on the device, keyed by content
    and device; a rebound affine column hits it, a third structure evicts
    the oldest, and a sweep never modifies the cached tensor."""
    monkeypatch.setattr(system_torch, "_sweep_adev_cache", {})
    cache = system_torch._sweep_adev_cache
    lin = LinearSystem([32, 32], device="cpu")
    x, y = lin.gens()
    _, outs = _xs_instances(13, 2)

    def sweep(o, n):
        return lin.solve_one_sweep(xs_zeros(lin, o[:n]), [x & 0x7])

    first = sweep(outs[0], 4)
    assert len(cache) == 1
    (key_a, a_dev), = cache.items()
    assert key_a[1] == "cpu" and a_dev.dtype == torch.int32
    assert not bool((a_dev[:, 0] & 1).any())  # the inert affine bit is zeroed
    before = a_dev.clone()
    assert sweep(outs[0], 4) == first  # same system: a hit, same answers
    sweep(outs[1], 4)  # other outputs, same coefficients: still one entry
    assert len(cache) == 1 and cache[key_a] is a_dev and torch.equal(a_dev, before)
    sweep(outs[0], 5)
    assert len(cache) == 2 and list(cache)[0] == key_a
    sweep(outs[0], 4)  # a hit moves it to the newest end
    assert list(cache)[1] == key_a
    sweep(outs[0], 6)  # a third structure evicts the oldest (the 5-output one)
    assert len(cache) == system_torch._SWEEP_ADEV_MAX == 2 and key_a in cache


def test_convert_sols_batch_matches_per_point():
    lin_j, lin = _pair([7, 32, 1, 24])
    rnd = random.Random(2)
    raws = [rnd.getrandbits(64), None, 0, (1 << 64) - 1, rnd.getrandbits(64)]
    want = [None if r is None else lin.convert_sol(r) for r in raws]
    assert lin._convert_sols_batch(raws) == want == lin_j._convert_sols_batch(raws)
    assert lin._convert_sols_batch([None, None]) == [None, None]

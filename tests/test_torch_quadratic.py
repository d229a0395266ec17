"""The port's QuadraticSystem against the JAX package, on the CPU.

* ``mul_bit`` (lazy and eager, and ``_mul_bit_slow``), ``mul_bits``,
  ``lift``, ``bit_assert`` (lazy and eager), ``convert_sol``, ``evaluate``,
  pickling;
* ``solve_all`` / ``solve_one`` / ``solve_one_batch`` / ``solve_one_sweep``
  and the packed entry points, with the consistency filter on the device
  past 8 dimensions;
* the captured-trace quadratic routes (``CapturedTrace.solve_one``,
  ``solve_one_batch``, ``solve_one_sweep``);
* the NLFSR annihilator attack at test scale (a 16-bit register traced
  lazily, and the 24-bit register of tests/test_examples_e2e.py) on
  ``device="cpu"``, and the port's copy of ``crypto/lfsr.py``.

Both packages get the same inputs from seeds.  Tolerance 0: integer GF(2)
arithmetic, and the RREF is unique, so the spaces and the order of their
points are the reference's.
"""

import pickle
import random

import numpy as np
import pytest
import torch

import gf2bv_tpu
from gf2bv_tpu.crypto import lfsr as lfsr_jax
from gf2bv_tpu_torch import BitVec, DimensionTooLargeError, LinearSystem, QuadraticSystem
from gf2bv_tpu_torch.core import packing
from gf2bv_tpu_torch.core.lazy import LazyBitVec
from gf2bv_tpu_torch.crypto import lfsr
from gf2bv_tpu_torch.ops import enumerate as enum_torch
from gf2bv_tpu_torch.ops import lazy_solve

torch.set_num_threads(2)


def _pair(sizes, backend=None):
    return (QuadraticSystem(sizes, backend=backend, device="cpu"),
            gf2bv_tpu.QuadraticSystem(sizes, backend=backend))


def _rows(bvs):
    return [bv.rows for bv in bvs]


# -- degree-2 operations ------------------------------------------------------------------


@pytest.mark.parametrize("n", [4, 9, 32, 65])
def test_mul_bit_matches_the_reference(n):
    q, q_j = _pair([n])
    rng = np.random.default_rng(n)
    nbits = q._nbits
    for _ in range(12):
        a, b = (int(rng.integers(0, 1 << 62)) & ((1 << (1 + n)) - 1) for _ in range(2))
        got = q.mul_bit(BitVec([a], nbits), BitVec([b], nbits))
        want = q_j.mul_bit(gf2bv_tpu.BitVec([a], nbits), gf2bv_tpu.BitVec([b], nbits))
        assert got._bits == want._bits
        assert np.array_equal(got.rows, q._mul_bit_slow(BitVec([a], nbits),
                                                       BitVec([b], nbits)).rows)


def test_mul_bit_lazy_records_and_matches_eager():
    q, q_j = _pair([6, 3])
    (xl, yl), (xe, ye) = q.gens(lazy=True), q.gens(lazy=False)
    (xj, yj) = q_j.gens(lazy=False)
    lazy_p = q.mul_bit(xl[2] ^ yl[1] ^ 1, xl[4])
    assert isinstance(lazy_p, LazyBitVec) and lazy_p._expr.op == "mulq"
    eager_p = q.mul_bit(xe[2] ^ ye[1] ^ 1, xe[4])
    want = q_j.mul_bit(xj[2] ^ yj[1] ^ 1, xj[4])
    assert np.array_equal(q.get_eqs_packed([lazy_p]), q.get_eqs_packed([eager_p]))
    assert eager_p._bits == want._bits
    with pytest.raises(ValueError, match="1-bit"):
        q.mul_bit(xe, xe)


@pytest.mark.parametrize("n,rows", [(8, 6), (40, 25)])
def test_mul_bits_and_lift(n, rows):
    q, q_j = _pair([n])
    lin, lin_j = LinearSystem([n], device="cpu"), gf2bv_tpu.LinearSystem([n])
    rng = np.random.default_rng(n)
    masks = [int(rng.integers(0, 1 << 62)) for _ in range(rows)]
    (v,), (v_j,) = lin.gens(lazy=False), lin_j.gens(lazy=False)

    def stack(x, bv_cls):
        return bv_cls.stack([(x & m).sum() ^ (m & 1) for m in masks])

    a, a_j = stack(v, BitVec), stack(v_j, gf2bv_tpu.BitVec)
    b, b_j = stack(v >> 1, BitVec), stack(v_j >> 1, gf2bv_tpu.BitVec)
    assert np.array_equal(q.mul_bits(a, b).rows, q_j.mul_bits(a_j, b_j).rows)
    assert np.array_equal(q.lift(a).rows, q_j.lift(a_j).rows)
    with pytest.raises(ValueError, match="Widths must match"):
        q.mul_bits(a, b[:3])


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("v", [0, 1])
def test_bit_assert_matches_the_reference(lazy, v):
    q, q_j = _pair([5, 3])
    (x, y), (x_j, y_j) = q.gens(lazy=lazy), q_j.gens(lazy=lazy)
    for target, target_j in ((x[0] ^ y[2], x_j[0] ^ y_j[2]), (x[1], x_j[1]),
                             (x[3] ^ x[4] ^ 1, x_j[3] ^ x_j[4] ^ 1)):
        got = q.bit_assert(target, v)
        assert all(isinstance(z, LazyBitVec) == lazy for z in got)
        assert np.array_equal(q.get_eqs_packed(got), q_j.get_eqs_packed(q_j.bit_assert(target_j,
                                                                                       v)))
    with pytest.raises(ValueError, match="1-bit"):
        q.bit_assert(x, v)


def test_convert_sol_gens_pickle_evaluate():
    q, q_j = _pair([4, 4])
    assert len(q.gens()) == 2 and q._lin_size == 8 and q._quad_size == 28
    q3 = QuadraticSystem([3], device="cpu")
    assert q3.convert_sol(0b001_011) == (0b011,) and q3.convert_sol(0b000_011) is None
    q2 = pickle.loads(pickle.dumps(q))
    assert (q2._quad_sizes, q2._quad_size, q2._device) == ([4, 4], 28, torch.device("cpu"))
    lo, hi = q.gens(lazy=False)
    assert q.evaluate(lo.concat(hi), (5, 9)) == 5 | (9 << 4)
    assert q_j.evaluate(q_j.gens(lazy=False)[0].concat(q_j.gens(lazy=False)[1]), (5, 9)) == 0x95


# -- solving ------------------------------------------------------------------------------


def _product_zeros(q, secret, n, lazy=True):
    """x_i x_j = s_i s_j for every pair, and x = s: one solution."""
    (x,) = q.gens(lazy=lazy)
    sb = [(secret >> i) & 1 for i in range(n)]
    zeros = [q.mul_bit(x[i], x[j]) ^ (sb[i] & sb[j]) for i in range(n) for j in range(i)]
    return zeros + [x ^ secret]


@pytest.mark.parametrize("backend", [None, "jax", "blocked", "oracle"])
@pytest.mark.parametrize("lazy", [False, True])
def test_solve_small(backend, lazy):
    n, secret = 6, 0b101101
    q, q_j = _pair([n], backend)
    zeros, zeros_j = _product_zeros(q, secret, n, lazy), _product_zeros(q_j, secret, n, lazy)
    assert q.solve_one(zeros) == q_j.solve_one(zeros_j) == (secret,)
    assert list(q.solve_all(zeros)) == list(q_j.solve_all(zeros_j)) == [(secret,)]
    eqs = q.get_eqs_packed(zeros)
    assert q.solve_one_packed(eqs) == (secret,)
    assert list(q.solve_all_packed(eqs)) == [(secret,)]


def _rank_deficient(q, n, seed, nzeros):
    """Random linear constraints on the monomials, all satisfied by the
    lifted secret (model: tests/test_quadratic.py)."""
    rng = np.random.default_rng(seed)
    secret = int(rng.integers(1, 1 << n))
    (x,) = q.gens()
    sbits = [(secret >> i) & 1 for i in range(n)]
    mono = sbits + [sbits[i] & sbits[j] for i in range(n) for j in range(i)]
    parts = [x[i] for i in range(n)] + [q.mul_bit(x[i], x[j]) for i in range(n)
                                        for j in range(i)]
    zeros = []
    while len(zeros) < nzeros:
        sel = rng.integers(0, 2, size=len(mono))
        if not sel.any():
            continue
        acc = None
        for s, p in zip(sel, parts):
            if s:
                acc = p if acc is None else acc ^ p
        zeros.append(acc ^ int(np.dot(sel, mono) % 2))
    return secret, x, zeros


@pytest.mark.parametrize("nzeros,dim", [(19, 17), (27, 9), (30, 6)])
def test_consistency_filter_on_the_device(monkeypatch, nzeros, dim):
    """Past 8 dimensions the filter runs through ops/enumerate on the
    system's device; the points and their order are the reference's."""
    q, q_j = _pair([8])
    secret, x, zeros = _rank_deficient(q, 8, 17, nzeros)
    _, _, zeros_j = _rank_deficient(q_j, 8, 17, nzeros)
    calls = []
    real = enum_torch.iter_quad_filtered
    monkeypatch.setattr(enum_torch, "iter_quad_filtered",
                        lambda *a, **k: calls.append(k["device"]) or real(*a, **k))
    assert q.solve_raw_space(zeros).dimension == dim
    got = list(q.solve_all(zeros, max_dimension=17))
    assert got == list(q_j.solve_all(zeros_j, max_dimension=17))
    assert calls == ([torch.device("cpu")] if dim > 8 else [])
    assert any(q.evaluate(x, s) == secret for s in got)


def test_solve_one_batch_threads_max_dimension():
    q, q_j = _pair([8])
    secret, x, zeros = _rank_deficient(q, 8, 17, 19)
    _, _, zeros_j = _rank_deficient(q_j, 8, 17, 19)
    with pytest.raises(DimensionTooLargeError, match="batch instance 1") as ei:
        q.solve_one_batch([_product_zeros(q, 5, 8), zeros])
    assert ei.value.space.dimension == 17
    got = q.solve_one_batch([_product_zeros(q, 5, 8), zeros], max_dimension=17)
    want = q_j.solve_one_batch([_product_zeros(q_j, 5, 8), zeros_j], max_dimension=17)
    assert got == want and got[0] == (5,) and q.evaluate(x, got[1]) == secret


@pytest.mark.parametrize("backend", [None, "oracle"])
def test_solve_one_batch_takes_the_first_consistent_point(backend):
    q, q_j = _pair([6], backend)
    rng = np.random.default_rng(9)
    secrets_ = [int(rng.integers(1, 1 << 6)) for _ in range(3)]
    got = q.solve_one_batch([_product_zeros(q, s, 6, False) for s in secrets_])
    want = q_j.solve_one_batch([_product_zeros(q_j, s, 6, False) for s in secrets_])
    assert got == want == [(s,) for s in secrets_]


def test_solve_one_sweep():
    """The quadratic sweep enumerates each candidate's space to its first
    consistent point, as the reference does."""
    n = 7
    q, q_j = _pair([n])

    def zeros_of(qs, secret):
        (x,) = qs.gens()
        sb = [(secret >> i) & 1 for i in range(n)]
        zeros = [qs.mul_bit(x[i], x[j]) ^ (sb[i] & sb[j]) for i in range(n) for j in range(i)]
        return x, zeros + [x[i] ^ sb[i] for i in range(2, n)]

    secret = 0b1011010
    (x, zeros), (x_j, zeros_j) = zeros_of(q, secret), zeros_of(q_j, secret)
    got = q.solve_one_sweep(zeros, [x[0], x[1]])
    assert got == q_j.solve_one_sweep(zeros_j, [x_j[0], x_j[1]])
    assert [g for g in got if g is not None] == [(secret,)]
    got = q.solve_one_sweep(zeros, [x & 3], candidates=[0, 1, 2, 3])
    assert got == q_j.solve_one_sweep(zeros_j, [x_j & 3], candidates=[0, 1, 2, 3])


# -- captured traces --------------------------------------------------------------------------


def _pairs(n):
    return [(i, j) for i in range(n) for j in range(i)]


def _capture_model(q, n, with_linear):
    def model(gens, p):
        (x,) = gens
        zeros = [q.mul_bit(x[i], x[j]) ^ p[k] for k, (i, j) in enumerate(_pairs(n))]
        if with_linear:
            zeros.append(x ^ p[len(_pairs(n))])
        return zeros

    return model


def _values(secret, n, with_linear):
    sb = [(secret >> i) & 1 for i in range(n)]
    vals = [sb[i] & sb[j] for i, j in _pairs(n)]
    return vals + [secret] if with_linear else vals


@pytest.mark.parametrize("backend", [None, "oracle", "blocked"])
def test_captured_quadratic_routes(backend):
    """CapturedTrace.solve_one routes through the filter (the raw mode-0
    origin of an underdetermined space can fail it), solve_one_batch takes
    each instance's first consistent point, solve_one_sweep each
    candidate's; all as the reference."""
    lazy_solve.clear_cache()
    n = 5
    q, q_j = _pair([n], backend)
    tmpl = q.capture(_capture_model(q, n, False))
    tmpl_j = q_j.capture(_capture_model(q_j, n, False))
    rnd = random.Random(6)
    batch = [_values(rnd.getrandbits(n) | 1, n, False) for _ in range(3)]
    got = tmpl.solve_one(batch[0])
    assert got == tmpl_j.solve_one(batch[0]) and got is not None
    (s,) = got
    for (i, j), v in zip(_pairs(n), batch[0]):
        assert ((s >> i) & 1) & ((s >> j) & 1) == v
    assert tmpl.solve_one_batch(batch) == tmpl_j.solve_one_batch(batch)
    assert list(tmpl.solve_all(batch[1])) == list(tmpl_j.solve_all(batch[1]))

    full = q.capture(_capture_model(q, n, True))
    full_j = q_j.capture(_capture_model(q_j, n, True))
    secret = 0b10110
    vals = _values(secret, n, True)
    assert full.solve_one(vals) == full_j.solve_one(vals) == (secret,)
    (x,), (x_j,) = q.gens(lazy=False), q_j.gens(lazy=False)
    swept = full.solve_one_sweep(vals[:-1] + [0], [x[0]], max_dimension=12)
    assert swept == full_j.solve_one_sweep(vals[:-1] + [0], [x_j[0]], max_dimension=12)
    lazy_solve.clear_cache()


# -- the NLFSR attack at test scale ------------------------------------------------------------


def _combiner(x0, x1, x2, x3, x4):
    return (x0 * x1) ^ (x0 * x1 * x3 * x4) ^ x0 ^ x1 ^ x2


def _nlfsr_zeros(q, lfsr_cls, n, mask, select, init, nout, lazy):
    reg = lfsr_cls(n, mask, init)
    out = []
    for _ in range(nout):
        reg()
        out.append(_combiner(*((reg.state >> i) & 1 for i in select)))
    (x,) = q.gens(lazy=lazy)
    sym = lfsr_cls(n, mask, x)
    zeros = []
    for o in out:
        sym()
        if o == 1:
            x0, x1, x2 = (sym.state[i] for i in select[:3])
            zeros.append(q.mul_bit(x0, x1) ^ x0 ^ q.mul_bit(x1, x2) ^ x1 ^ x2 ^ 1)
    return zeros


@pytest.mark.parametrize("kind", ["GaloisLFSR", "FibonacciLFSR"])
def test_lazy_nlfsr_recovery(kind):
    """The reference's own idiom (a Python loop of per-bit mul_bit over lazy
    gens) recovers a 16-bit register through solve_all and solve_one; the
    lazy matrix is the eager one and the reference's."""
    n, mask, select = 16, 0xD295, (1, 3, 6, 10, 12)
    init = int(np.random.default_rng(int(kind[0] == "F")).integers(1, 1 << n))
    q, q_j = _pair([n])
    zeros = _nlfsr_zeros(q, getattr(lfsr, kind), n, mask, select, init, 600, True)
    zeros_j = _nlfsr_zeros(q_j, getattr(lfsr_jax, kind), n, mask, select, init, 600, True)
    eager = _nlfsr_zeros(q, getattr(lfsr, kind), n, mask, select, init, 600, False)
    assert all(isinstance(z, LazyBitVec) for z in zeros)
    eqs = q.get_eqs_packed(zeros)
    assert np.array_equal(eqs, q.get_eqs_packed(eager))
    assert np.array_equal(eqs, q_j.get_eqs_packed(zeros_j))
    sols = list(q.solve_all(zeros))
    assert sols == list(q_j.solve_all(zeros_j)) and (init,) in sols
    assert q.solve_one(zeros) in sols


def test_mini_nlfsr_24_bits():
    """tests/test_examples_e2e.py's scaled-down examples/nlfsr.py: a 24-bit
    Galois LFSR, 2^12 outputs, solved through the consistency filter."""
    n, mask, select = 24, 0xE10000, (3, 7, 11, 15, 19)
    init = random.Random(24).getrandbits(n) | 1
    q, q_j = _pair([n])
    zeros = _nlfsr_zeros(q, lfsr.GaloisLFSR, n, mask, select, init, 1 << 12, True)
    zeros_j = _nlfsr_zeros(q_j, lfsr_jax.GaloisLFSR, n, mask, select, init, 1 << 12, True)
    sols = list(q.solve_all(zeros, max_dimension=12))
    assert sols == list(q_j.solve_all(zeros_j, max_dimension=12)) and (init,) in sols


@pytest.mark.parametrize("kind", ["GaloisLFSR", "FibonacciLFSR"])
def test_lfsr_copy(kind):
    """crypto/lfsr.py is the reference's: the same outputs on ints and the same
    symbolic rows on bitvectors."""
    n, taps = 128, 0xD670201BAC7515352A273372B2A95B23
    state = random.Random(kind).getrandbits(n)
    reg, reg_j = getattr(lfsr, kind)(n, taps, state), getattr(lfsr_jax, kind)(n, taps, state)
    assert [reg() for _ in range(300)] == [reg_j() for _ in range(300)]
    lin, lin_j = LinearSystem([n], device="cpu"), gf2bv_tpu.LinearSystem([n])
    sym = getattr(lfsr, kind)(n, taps, lin.gens(lazy=False)[0])
    sym_j = getattr(lfsr_jax, kind)(n, taps, lin_j.gens(lazy=False)[0])
    outs = [sym() for _ in range(200)]
    outs_j = [sym_j() for _ in range(200)]
    assert [packing.words_to_int(o.rows[0]) for o in outs] == [
        packing.words_to_int(o.rows[0]) for o in outs_j]
    assert np.array_equal(sym.state.rows, sym_j.state.rows)

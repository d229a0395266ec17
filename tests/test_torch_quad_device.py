"""The port's quadratic row construction and affine-space enumeration
(``ops/quad_device``, ``ops/enumerate``) against the JAX package, on the CPU.

* ``quad_rows`` and ``mul_bits_batch`` on the same narrow operands, and
  against ``QuadraticSystem.mul_bits``;
* ``enumerate_points`` at dimensions 0 to 64, with starts that cross 2^32,
  2^63 and 2^64, Gray and binary; ``enumerate_device`` and
  ``iter_quad_filtered`` against the host ``AffineSpace`` order;
* ``quad_consistency_mask`` against the reference's and the host filter;
* the lazy trace's batched products (numpy's ``mul_bits``) against either
  route of the reference's.

Every input is made from a seed with numpy.  Tolerance 0: integer GF(2)
arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gf2bv_tpu
from gf2bv_tpu.core.affine import AffineSpace as AffineSpaceJax
from gf2bv_tpu.core.bitvec import BitVec as BitVecJax
from gf2bv_tpu.ops import enumerate as enum_jax
from gf2bv_tpu.ops import quad_device as qd_jax
from gf2bv_tpu_torch import LinearSystem, QuadraticSystem, torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.core import packing
from gf2bv_tpu_torch.core.affine import AffineSpace
from gf2bv_tpu_torch.core.bitvec import BitVec
from gf2bv_tpu_torch.ops import enumerate as enum_torch
from gf2bv_tpu_torch.ops import quad_device as qd_torch

torch.set_num_threads(2)


def _narrow_rows(rng, rows, n):
    """Random narrow (linear-columns-only) packed rows over 1+n bits."""
    raw = rng.integers(0, 1 << 63, size=(rows, packing.nwords64(1 + n)), dtype=np.uint64)
    return packing.pack_bits(packing.unpack_rows(raw, 1 + n), 1 + n)


@pytest.mark.parametrize("n,rows", [(1, 5), (24, 40), (31, 17), (64, 33), (70, 9)])
@pytest.mark.parametrize("const_kind", ["int", "array"])
def test_quad_rows_matches_the_reference(n, rows, const_kind):
    rng = np.random.default_rng(n * 100 + rows)
    a, b, c = (_narrow_rows(rng, rows, n) for _ in range(3))
    cbits = rng.integers(0, 2, size=rows).astype(np.uint8)
    const = int(sum(int(v) << i for i, v in enumerate(cbits))) if const_kind == "int" else (
        cbits.astype(bool))
    q, q_j = QuadraticSystem([n], device="cpu"), gf2bv_tpu.QuadraticSystem([n])

    def bv(x, kind):
        return kind(x, 1 + n)

    got = qd_torch.quad_rows(q, pairs=[(bv(a, BitVec), bv(b, BitVec)),
                                       (bv(b, BitVec), bv(c, BitVec))],
                             linear=[bv(a, BitVec), bv(c, BitVec)], const=const)
    want = qd_jax.quad_rows(q_j, pairs=[(bv(a, BitVecJax), bv(b, BitVecJax)),
                                        (bv(b, BitVecJax), bv(c, BitVecJax))],
                            linear=[bv(a, BitVecJax), bv(c, BitVecJax)], const=const)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(torch_to_u32(got), np.asarray(want))
    host = (q.mul_bits(bv(a, BitVec), bv(b, BitVec)) ^ q.mul_bits(bv(b, BitVec), bv(c, BitVec))
            ^ q.lift(bv(a, BitVec)) ^ q.lift(bv(c, BitVec))).rows.copy()
    host[:, 0] ^= cbits.astype(np.uint64)
    got64 = packing.from_u32(torch_to_u32(got))
    assert np.array_equal(got64[:, : host.shape[1]], host)
    assert not got64[:, host.shape[1]:].any()


def test_quad_rows_width_checks():
    rng = np.random.default_rng(1)
    q = QuadraticSystem([8], device="cpu")
    a, b = BitVec(_narrow_rows(rng, 5, 8), 9), BitVec(_narrow_rows(rng, 6, 8), 9)
    with pytest.raises(ValueError, match="Widths must match"):
        qd_torch.quad_rows(q, [(a, b)])
    with pytest.raises(ValueError, match="Widths must match"):
        qd_torch.quad_rows(q, [(a, a)], linear=[b])


@pytest.mark.parametrize("n,rows", [(16, 50), (63, 40), (64, 33), (128, 300)])
def test_mul_bits_batch_matches_the_reference(n, rows):
    rng = np.random.default_rng(n + rows)
    a, b = _narrow_rows(rng, rows, n), _narrow_rows(rng, rows, n)
    q, q_j = QuadraticSystem([n], device="cpu"), gf2bv_tpu.QuadraticSystem([n])
    got = qd_torch.mul_bits_batch(q, a, b)
    assert np.array_equal(got, qd_jax.mul_bits_batch(q_j, a, b))
    assert np.array_equal(got, q.mul_bits(BitVec(a, 1 + n), BitVec(b, 1 + n)).rows)


def test_mul_bits_batch_chunks(monkeypatch):
    """A batch larger than one host chunk is expanded chunk by chunk."""
    monkeypatch.setattr(qd_torch, "_HOST_CHUNK_BYTES", 4096)
    n, rows = 20, 103
    rng = np.random.default_rng(3)
    a, b = _narrow_rows(rng, rows, n), _narrow_rows(rng, rows, n)
    q = QuadraticSystem([n], device="cpu")
    calls = []
    real = qd_torch._expand
    monkeypatch.setattr(qd_torch, "_expand", lambda *x: calls.append(1) or real(*x))
    got = qd_torch.mul_bits_batch(q, a, b)
    assert len(calls) > 1
    assert np.array_equal(got, q.mul_bits(BitVec(a, 1 + n), BitVec(b, 1 + n)).rows)


@pytest.mark.parametrize("mulbits", ["batch", "host"])
def test_lazy_products_route_by_work(monkeypatch, mulbits):
    """The reference routes a lazy trace's batched products by work (its
    mul_bits_batch from _XLA_MULBITS_MIN_WORK on, unless
    GF2BV_TPU_MULBITS=host); the port always takes numpy's mul_bits.  Either
    route of the reference's materializes the port's matrix."""
    import gf2bv_tpu.core.lazy as lazy_jax

    n = 48
    q, q_j = QuadraticSystem([n], device="cpu"), gf2bv_tpu.QuadraticSystem([n])

    def zeros_of(qs):
        (x,) = qs.gens()
        return [qs.mul_bit(x[i], x[(i + 5) % n]) ^ x[(i + 1) % n] ^ (i & 1) for i in range(n)]

    monkeypatch.setattr(lazy_jax, "_XLA_MULBITS_MIN_WORK", 1)
    if mulbits == "host":
        monkeypatch.setenv("GF2BV_TPU_MULBITS", "host")
    else:
        monkeypatch.delenv("GF2BV_TPU_MULBITS", raising=False)
    calls = []
    real = qd_jax.mul_bits_batch
    monkeypatch.setattr(qd_jax, "mul_bits_batch", lambda *x: calls.append(1) or real(*x))
    got = q.get_eqs_packed(zeros_of(q))
    assert np.array_equal(got, q_j.get_eqs_packed(zeros_of(q_j)))
    assert bool(calls) == (mulbits == "batch")  # the reference took the route named


def test_quad_rows_solve_equals_the_zeros_path():
    """The device-built matrix solves where it lies and gives the space of
    the same equations built by mul_bits, and the reference's."""
    rng = np.random.default_rng(9)
    n, rows = 16, 200
    q, q_j = QuadraticSystem([n], device="cpu"), gf2bv_tpu.QuadraticSystem([n])
    a, b, c = (_narrow_rows(rng, rows, n) for _ in range(3))
    ones = (1 << rows) - 1
    eqs = qd_torch.quad_rows(q, [(BitVec(a, 1 + n), BitVec(b, 1 + n))],
                             linear=[BitVec(c, 1 + n)], const=ones)
    zeros = [q.mul_bits(BitVec(a, 1 + n), BitVec(b, 1 + n)) ^ q.lift(BitVec(c, 1 + n)) ^ ones]
    want = q.solve_raw_space(zeros)
    got = q.solve_raw_packed(eqs, 1)
    eqs_j = qd_jax.quad_rows(q_j, [(BitVecJax(a, 1 + n), BitVecJax(b, 1 + n))],
                             linear=[BitVecJax(c, 1 + n)], const=ones)
    ref = q_j.solve_raw_packed(eqs_j, 1)
    keys = [None if s is None else (s.dimension, s.origin, s.basis) for s in (got, want, ref)]
    assert keys[0] == keys[1] == keys[2]


def test_solve_packed_takes_host_and_tensor_rows():
    lin = LinearSystem([12], device="cpu")
    (v,) = lin.gens()
    zeros = [v ^ 0xABC]
    eqs = lin.get_eqs_packed(zeros)
    want = lin.solve_raw_one(zeros)
    assert lin.solve_raw_packed(eqs, 0) == want
    assert lin.solve_raw_packed(packing.to_u32(eqs), 0) == want
    assert lin.solve_raw_packed(u32_to_torch(packing.to_u32(eqs), "cpu"), 0) == want
    assert list(lin.solve_all_packed(eqs)) == [lin.convert_sol(want)]
    assert lin.solve_one_packed(eqs) == lin.convert_sol(want) == (0xABC,)


# -- enumeration -------------------------------------------------------------------------


_STARTS = [0, (1 << 32) - 3, (1 << 63) - 5, (1 << 64) - 7]


@pytest.mark.parametrize("dim", [0, 5, 31, 32, 33, 40, 64])
@pytest.mark.parametrize("gray", [True, False])
def test_enumerate_points_matches_the_reference(dim, gray):
    """The int64 index gives the reference's (hi, lo) pair order at every
    dimension, across 2^32, 2^63 (the Gray code's masked shift) and the wrap
    at 2^64."""
    rng = np.random.default_rng(dim + 1000 * gray)
    w32 = 5
    origin = rng.integers(0, 1 << 32, size=w32, dtype=np.uint64).astype(np.uint32)
    basis = rng.integers(0, 1 << 32, size=(dim, w32), dtype=np.uint64).astype(np.uint32)
    for start in _STARTS:
        got = enum_torch.enumerate_points(u32_to_torch(origin, "cpu"), u32_to_torch(basis, "cpu"),
                                          start, 16, gray)
        want = enum_jax.enumerate_points(jnp.asarray(origin), jnp.asarray(basis),
                                         jnp.uint32(start & 0xFFFFFFFF), jnp.uint32(start >> 32),
                                         16, gray)
        assert np.array_equal(torch_to_u32(got), np.asarray(want)), start


def _space(seed, cols, dim):
    rng = np.random.default_rng(seed)
    origin = packing.pack_bits(rng.integers(0, 2, (1, cols)).astype(np.uint8), cols)[0]
    basis = packing.pack_bits(rng.integers(0, 2, (dim, cols)).astype(np.uint8), cols)
    return AffineSpace(origin, basis, cols), AffineSpaceJax(origin, basis, cols)


@pytest.mark.parametrize("dim,start,count", [(0, 0, 1), (9, 0, 512), (9, 100, 64),
                                             (40, (1 << 33) - 8, 16), (64, (1 << 63) - 4, 8)])
def test_enumerate_device_matches_the_host_order(dim, start, count):
    sp, sp_j = _space(dim + start % 97, 80, dim)
    got = torch_to_u32(enum_torch.enumerate_device(sp, start, count, device="cpu"))
    assert np.array_equal(got, np.asarray(enum_jax.enumerate_device(sp_j, start, count)))
    want = packing.to_u32(sp.enumerate_packed(start, count, gray=True))
    assert np.array_equal(got[:, : want.shape[1]], want)


def _quad_points(n, seed, count=48):
    q = QuadraticSystem([n], device="cpu")
    rng = np.random.default_rng(seed)
    raws = []
    for _ in range(count):
        lin = int(rng.integers(0, 1 << n))
        bits = [(lin >> i) & 1 for i in range(n)]
        quad, mi = 0, 0
        for i in range(n):
            for j in range(i):
                quad |= (bits[i] & bits[j]) << mi
                mi += 1
        if rng.integers(0, 2):
            quad ^= 1 << int(rng.integers(0, max(1, q._quad_size)))
        raws.append(lin | (quad << n))
    return q, raws, packing.to_u32(packing.ints_to_rows(raws, q._cols))


@pytest.mark.parametrize("n", [2, 8, 33])
def test_quad_consistency_mask_matches_the_reference(n):
    q, raws, pts = _quad_points(n, n)
    got = enum_torch.quad_consistency_mask(u32_to_torch(pts, "cpu"), n)
    assert got.dtype == torch.bool
    assert got.tolist() == np.asarray(enum_jax.quad_consistency_mask(jnp.asarray(pts), n)).tolist()
    assert got.tolist() == [q._check_lin_match_quad(r & ((1 << n) - 1), r >> n) for r in raws]
    assert 0 < int(got.sum()) < len(raws)


def test_iter_quad_filtered_equals_the_host_filter():
    n = 6
    q, q_j = QuadraticSystem([n], device="cpu"), gf2bv_tpu.QuadraticSystem([n])
    rng = np.random.default_rng(11)
    cols = q._cols
    origin = packing.int_to_words(int(rng.integers(0, 1 << cols)), cols)
    basis = packing.ints_to_rows([int(rng.integers(1, 1 << cols)) for _ in range(10)], cols)
    sp = AffineSpace(origin, basis, cols)
    got = list(enum_torch.iter_quad_filtered(sp, n, chunk=128, device="cpu"))
    want = [s for s in sp if q._check_lin_match_quad(s & ((1 << n) - 1), s >> n)]
    assert got == want == list(enum_jax.iter_quad_filtered(AffineSpaceJax(origin, basis, cols),
                                                           n, chunk=128))
    assert q_j._quad_size == q._quad_size

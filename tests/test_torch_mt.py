"""The port's MT19937 path and public API against the JAX package, on the CPU.

* ``crypto.mt_torch.mt19937_system_device`` builds the same packed matrix
  as ``gf2bv_tpu.crypto.mt_jax`` (byte for byte).
* ``LinearSystem.solve_one`` recovers a Mersenne Twister state through the
  lazy trace path, equal to the JAX package's blocked solve run with the
  main path's engines in interpret mode.
* The flagship 624-word recovery runs on the CPU too (marked slow).
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gf2bv_tpu
from gf2bv_tpu.crypto import mt_jax
from gf2bv_tpu.crypto.mt import MersenneTwister as MTJax
from gf2bv_tpu_torch import LinearSystem, QuadraticSystem, torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.core import packing
from gf2bv_tpu_torch.crypto import mt_torch
from gf2bv_tpu_torch.crypto.mt import MT19937, MersenneTwister
from gf2bv_tpu_torch.ops import lazy_solve

torch.set_num_threads(2)


def _outs_words(out, bs):
    wpc = -(-bs // 32)
    arr = np.zeros((len(out), wpc), np.uint32)
    for i, v in enumerate(out):
        for j in range(wpc):
            arr[i, j] = (v >> (32 * j)) & 0xFFFFFFFF
    return arr[:, 0] if wpc == 1 else arr


@pytest.mark.parametrize("bs,samples", [(32, 624), (9, 2218), (1337, 14)])
def test_system_device_matches_jax(bs, samples):
    rand = random.Random(3142 + bs)
    arr = _outs_words([rand.getrandbits(bs) for _ in range(samples)], bs)
    want = np.asarray(mt_jax.mt19937_system_device(jnp.asarray(arr), bs, samples))
    got = mt_torch.mt19937_system_device(u32_to_torch(arr, "cpu"), bs, samples)
    assert np.array_equal(torch_to_u32(got), want)


def _small_mt(n=140, m=63, seed=7):
    """MT19937's constants with a short (n, m) state: 32*n columns (4480 at
    the default, padding to (4608, 256): the trailing loop reaches its
    second segment).  state[0] = 0x80000000 as CPython seeds it."""
    params = dict(MT19937.PARAMS, n=n, m=m)
    rng = np.random.default_rng(seed)
    state = [int(v) for v in rng.integers(0, 2**32, size=n, dtype=np.uint64)]
    state[0] = 0x80000000
    gen = MersenneTwister(list(state), **params)
    outs = [gen() for _ in range(n)]
    return params, state, outs


def _zeros(lin, cls, params, outs):
    v = lin.gens()
    gen = cls(list(v), **params)
    return [gen() ^ o for o in outs] + [v[0] ^ 0x80000000]


def test_small_mt_solve_one_matches_jax(monkeypatch):
    params, state, outs = _small_mt()
    n = params["n"]
    lin = LinearSystem([32] * n, device="cpu")
    zeros = _zeros(lin, MersenneTwister, params, outs)
    got = lin.solve_one(zeros)

    monkeypatch.setenv("GF2BV_TPU_PHASE1", "pallas_scan_interpret")
    monkeypatch.setenv("GF2BV_TPU_PHASE2", "mxu_interpret")
    lin_j = gf2bv_tpu.LinearSystem([32] * n, backend="blocked")
    want = lin_j.solve_one(_zeros(lin_j, MTJax, params, outs))
    assert got == want == tuple(state)


def test_lazy_cache_survives_solves():
    """The cached device matrix is not modified by a solve, a second solve
    with other outputs reuses it, and an inconsistent instance is unsat."""
    params, state, outs = _small_mt(n=40, m=17, seed=3)
    lin = LinearSystem([32] * 40, device="cpu")
    zeros = _zeros(lin, MersenneTwister, params, outs)
    assert lin.solve_one(zeros) == tuple(state)
    cs = lazy_solve.cached_system(lin, zeros)
    before = cs.a_dev.clone()

    params2, state2, outs2 = _small_mt(n=40, m=17, seed=4)
    zeros2 = _zeros(lin, MersenneTwister, params2, outs2)
    assert lazy_solve.cached_system(lin, zeros2) is cs
    assert lin.solve_one(zeros2) == tuple(state2)
    assert torch.equal(cs.a_dev, before)

    bad = list(outs)
    bad[0] ^= 1
    assert lin.solve_one(_zeros(lin, MersenneTwister, params, bad)) is None


def test_eager_and_lazy_paths_agree_with_jax_eqs():
    params, state, outs = _small_mt(n=24, m=11, seed=5)
    lin = LinearSystem([32] * 24, device="cpu")
    eager = _zeros_eager(lin, params, outs)
    lin_j = gf2bv_tpu.LinearSystem([32] * 24)
    v = lin_j.gens(lazy=False)
    gen = MTJax(list(v), **params)
    eager_j = [gen() ^ o for o in outs] + [v[0] ^ 0x80000000]
    assert lin.get_eqs(eager) == lin_j.get_eqs(eager_j)
    lazy = _zeros(lin, MersenneTwister, params, outs)
    assert np.array_equal(lin.get_eqs_packed(lazy), lin.get_eqs_packed(eager))
    assert lin.solve_one(eager) == lin.solve_one(lazy)
    raw = lin.solve_raw_one(eager)
    assert lin.convert_sol(raw) == lin.solve_one(eager)
    packed = lin.get_eqs_packed(eager)
    assert lin.solve_one_packed(packed) == lin.solve_one(eager)
    assert lin.solve_raw_packed(u32_to_torch(packing.to_u32(packed), "cpu"), 0) == raw


def _zeros_eager(lin, params, outs):
    v = lin.gens(lazy=False)
    gen = MersenneTwister(list(v), **params)
    return [gen() ^ o for o in outs] + [v[0] ^ 0x80000000]


def test_literal_one_is_unsat():
    lin = LinearSystem([8], device="cpu")
    (x,) = lin.gens(lazy=False)
    assert lin.solve_one([x ^ x ^ 1]) is None


@pytest.mark.parametrize(
    "name", ["capture", "solve_one_sweep", "solve_all_sweep", "get_mat_numpy", "get_mat_scipy"]
)
def test_later_surfaces_raise(name):
    """The surfaces that used to raise as not ported now return the JAX
    package's answer on a small system; QuadraticSystem still raises."""
    secret = 0xB7
    lin, lin_j = LinearSystem([8], device="cpu"), gf2bv_tpu.LinearSystem([8], backend="blocked")

    def zeros_of(system, lazy):
        (x,) = system.gens(lazy=lazy)
        masks = (0x1D, 0xE3, 0x5A, 0x96, 0x0F, 0x71)  # rank 6: a 2-dimensional space
        return x, [(x & m).sum() ^ (bin(secret & m).count("1") & 1) for m in masks]

    if name == "capture":
        def model(g, p):
            return [(g[0] ^ (g[0] >> 3)) ^ p[0], (g[0] << 2) ^ p[1]]

        vals = [secret ^ (secret >> 3), (secret << 2) & 0xFF]
        got = lin.capture(model).solve_one(vals)
        assert got == lin_j.capture(model).solve_one(vals) == (secret,)
    elif name == "solve_one_sweep":
        (x, zeros), (x_j, zeros_j) = zeros_of(lin, False), zeros_of(lin_j, False)
        got = lin.solve_one_sweep(zeros, [x & 3])
        assert got == lin_j.solve_one_sweep(zeros_j, [x_j & 3]) and len(got) == 4
        assert got[secret & 3] is not None
    elif name == "solve_all_sweep":
        (x, zeros), (x_j, zeros_j) = zeros_of(lin, False), zeros_of(lin_j, False)
        got = [None if g is None else sorted(g) for g in lin.solve_all_sweep(zeros, [x & 3])]
        want = [None if g is None else sorted(g) for g in lin_j.solve_all_sweep(zeros_j, [x_j & 3])]
        assert got == want and any((secret,) in (g or []) for g in got)
    else:
        (_, zeros), (_, zeros_j) = zeros_of(lin, True), zeros_of(lin_j, True)
        a, b = getattr(lin, name)(zeros)
        a_j, b_j = getattr(lin_j, name)(zeros_j)
        if name == "get_mat_scipy":
            a, a_j = a.toarray(), a_j.toarray()
        assert a.shape == (6, 8) and np.array_equal(a, a_j) and np.array_equal(b, b_j)
        assert np.array_equal((a @ [(secret >> i) & 1 for i in range(8)]) % 2, b)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        QuadraticSystem([8], device="cpu")


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LinearSystem([32] * 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mt_torch.solve_mt19937([0] * 624)


@pytest.mark.slow
def test_flagship_mt19937_cpu():
    rand = random.Random(777)
    state = tuple(rand.getstate()[1][:-1])
    outs = [rand.getrandbits(32) for _ in range(624)]
    assert mt_torch.solve_mt19937(outs, 32, device="cpu") == state
    lin = LinearSystem([32] * 624, device="cpu")
    mt = lin.gens()
    gen = MT19937(list(mt))
    zeros = [gen.getrandbits(32) ^ o for o in outs] + [mt[0] ^ 0x80000000]
    assert lin.solve_one(zeros) == state
    bad = list(outs)
    bad[0] ^= 1
    assert mt_torch.solve_mt19937(bad, 32, device="cpu") is None

"""The examples' workloads on both packages: the port's answers equal the JAX
package's, and both are right.

Modelled on tests/test_examples_e2e.py, whose fast variants run here against
``gf2bv_tpu`` and ``gf2bv_tpu_torch`` (on ``device="cpu"``) side by side:
simple.py, lfsr.py, xoshiro.py, the mini MT, the mini NLFSR and its
bit_assert brute force, geffe.py's guess sweep (scaled down), the LFSR-128
loop of incremental_online.py, and toy-size sfmt.py, taus.py,
xorshift_crc.py, v8_math_random.py, gcm_forgery.py and bm_recover.py.
Secrets come from seeded ``random.Random`` streams.
"""

import importlib
import itertools
import random
import sys
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch


def api(pkg: str) -> SimpleNamespace:
    """The public surface of one package; the port's systems on the CPU."""
    g = importlib.import_module(pkg)
    kw = {"device": "cpu"} if pkg == "gf2bv_tpu_torch" else {}
    return SimpleNamespace(
        name=pkg, LinearSystem=partial(g.LinearSystem, **kw),
        QuadraticSystem=partial(g.QuadraticSystem, **kw),
        IncrementalSolver=g.IncrementalSolver,
        DimensionTooLargeError=g.DimensionTooLargeError,
        crypto=lambda m: importlib.import_module(f"{pkg}.crypto.{m}"),
    )


APIS = (api("gf2bv_tpu"), api("gf2bv_tpu_torch"))


def on_both(run):
    """``run(api)`` on each package; the two answers must be equal."""
    ref, port = (run(a) for a in APIS)
    assert port == ref
    return port


# ---------------------------------------------------------------- simple.py


def magic(x, y):
    m64 = (1 << 64) - 1
    z1 = ((x ^ (y >> 22) ^ (x << 13)) & m64) >> 3
    z2 = ((y ^ (x >> 7) ^ (y << 5)) & m64) >> 3
    z3 = (x ^ y) & 0b101101
    return z1, z2, z3


@pytest.mark.parametrize("affine", [False, True])
def test_simple(affine):
    inp = (random.Random(1).getrandbits(64), random.Random(2).getrandbits(64))
    expected = magic(*inp) if affine else (0, 0, 0)

    def run(a):
        lin = a.LinearSystem((64, 64))
        xs, ys = lin.gens()
        zeros = [s ^ v for s, v in zip(magic(xs, ys), expected)]
        sols = sorted(lin.solve_all(zeros))
        one = lin.solve_one(zeros)
        assert all(magic(*s) == expected for s in sols) and magic(*one) == expected
        assert all(lin.evaluate(z, one) == 0 for z in zeros)
        return sols, one

    on_both(run)


# ------------------------------------------------------------------ lfsr.py


@pytest.mark.parametrize("form,mask", [("GaloisLFSR", 0x5C2B76970103D4EEFCD4A2C681CC400D),
                                       ("FibonacciLFSR", 0x6D6AC812F52A212D5A0B9F3117801FD5)])
def test_lfsr_recovery(form, mask):
    init = random.Random(3).getrandbits(128)

    def run(a):
        cls = getattr(a.crypto("lfsr"), form)
        reg = cls(128, mask, init)
        out = [reg() for _ in range(256)]
        lin = a.LinearSystem([128])
        (sym,) = lin.gens()
        reg2 = cls(128, mask, sym)
        return [s for (s,) in lin.solve_all([reg2() ^ o for o in out])]

    assert on_both(run) == [init]


# --------------------------------------------------------------- xoshiro.py


def test_xoshiro256starstar_recovery():
    state = [random.Random(4 + i).getrandbits(64) for i in range(4)]

    def run(a):
        xo = a.crypto("xoshiro").Xoshiro256starstar
        src = xo(list(state))
        out = [src() for _ in range(10)]
        lin = a.LinearSystem([64] * 4)
        sym = xo(lin.gens())
        sols = sorted(lin.solve_all([sym.step() ^ xo.untemper(o) for o in out]))
        for sol in sols:
            rep = xo(list(sol))
            assert [rep() for _ in range(10)] == out
        return sols

    assert tuple(state) in on_both(run)


# ------------------------------------------------------------------- mt.py


def test_mini_mt_recovery():
    def run(a):
        mt = a.crypto("mt")

        def mini(state):
            return mt.MersenneTwister(state, 16, 24, 13, 7, 0x9908, 7, 0xFFFF, 5, 0x9D2C, 4,
                                      0xEFC6, 9)

        rand = random.Random(1337)
        secret = [rand.getrandbits(16) for _ in range(24)]
        rng = mini(list(secret))
        out = [rng() for _ in range(48)]
        lin = a.LinearSystem([16] * 24)
        sym = mini(list(lin.gens()))
        sol = lin.solve_one([sym() ^ o for o in out])
        rng2 = mini(list(sol))
        assert [rng2() for _ in range(48)] == out
        return sol

    on_both(run)


# ----------------------------------------------------------------- nlfsr.py


def _combiner(x0, x1, x2, x3, x4):
    return (x0 * x1) ^ (x0 * x1 * x3 * x4) ^ x0 ^ x1 ^ x2


def _mini_nlfsr(a, n, mask, select, steps, init):
    lfsr_cls = a.crypto("lfsr").GaloisLFSR
    reg = lfsr_cls(n, mask, init)
    out = []
    for _ in range(steps):
        reg()
        out.append(_combiner(*[(reg.state >> i) & 1 for i in select]))
    qsys = a.QuadraticSystem([n])
    (x,) = qsys.gens()
    reg_sym = lfsr_cls(n, mask, x)
    zeros = []
    for o in out:
        reg_sym()
        x0, x1, x2, _, _ = [reg_sym.state[i] for i in select]
        if o == 1:  # annihilator of the combiner (examples/nlfsr.py)
            zeros.append(qsys.mul_bit(x0, x1) ^ x0 ^ qsys.mul_bit(x1, x2) ^ x1 ^ x2 ^ 1)
    return qsys, x, zeros


def test_mini_nlfsr_quadratic():
    init = random.Random(5).getrandbits(24) | 1

    def run(a):
        qsys, _, zeros = _mini_nlfsr(a, 24, 0xE10000, (3, 7, 11, 15, 19), 2**12, init)
        return sorted(qsys.solve_all(zeros, max_dimension=12))

    assert (init,) in on_both(run)


def test_mini_nlfsr_bit_assert_bruteforce():
    init = random.Random(6).getrandbits(24) | 1

    def run(a):
        qsys, x, zeros = _mini_nlfsr(a, 24, 0xC20000, (3, 7, 11, 15, 19), 2**12, init)
        found = []
        try:
            return ["direct"] + sorted(qsys.solve_all(zeros, max_dimension=12))
        except a.DimensionTooLargeError:
            pass
        for b0, b1 in itertools.product([0, 1], repeat=2):
            extra = qsys.bit_assert(x[0], b0) + qsys.bit_assert(x[1] ^ x[2] ^ x[20], b1)
            try:
                sols = list(qsys.solve_all(zeros + extra))
            except a.DimensionTooLargeError:
                continue
            found += sorted(qsys.evaluate(x, s) for s in sols)
        return found

    got = on_both(run)
    assert init in got or (init,) in got


# ----------------------------------------------------------------- geffe.py


def _port_geffe_attack(geffe, keystream):
    """geffe.py's attack on the port: the 2^N1 candidate streams of register
    1 condition the keystream into linear systems over registers 2 and 3,
    all eliminated at once by the batched per-pivot solver."""
    from gf2bv_tpu_torch import BitVec, LinearSystem
    from gf2bv_tpu_torch.core import packing
    from gf2bv_tpu_torch.core.words import torch_to_u32, u32_to_torch
    from gf2bv_tpu_torch.crypto.lfsr import GaloisLFSR
    from gf2bv_tpu_torch.ops import extract_device
    from gf2bv_tpu_torch.ops.gauss_jax import rref_device_batched

    t = geffe.T

    def trace_rows(reg):
        return BitVec.stack([reg()[0] for _ in range(t)]).rows

    lin = LinearSystem([geffe.N2, geffe.N3], device="cpu")
    g2, g3 = lin.gens(lazy=False)
    z = np.asarray(keystream, dtype=np.uint64)
    a2 = trace_rows(GaloisLFSR(geffe.N2, geffe.T2, g2))
    a3 = trace_rows(GaloisLFSR(geffe.N3, geffe.T3, g3))
    a2[:, 0] ^= z
    a3[:, 0] ^= z
    lin1 = LinearSystem([geffe.N1], device="cpu")
    (g1,) = lin1.gens(lazy=False)
    s_bits = packing.unpack_rows(trace_rows(GaloisLFSR(geffe.N1, geffe.T1, g1)),
                                 1 + geffe.N1)[:, 1:]
    guesses = np.arange(1 << geffe.N1, dtype=np.uint32)
    gbits = ((guesses[:, None] >> np.arange(geffe.N1)[None, :]) & 1).astype(np.int64)
    x1 = torch.from_numpy((gbits @ s_bits.T.astype(np.int64)) & 1)
    a2d = u32_to_torch(packing.to_u32(a2), "cpu")
    a3d = u32_to_torch(packing.to_u32(a3), "cpu")
    eqs = torch.where(x1[:, :, None] == 1, a2d[None], a3d[None])
    eqs = torch.nn.functional.pad(eqs, (0, 0, 0, 256 - t))
    rref32, pof, bad = rref_device_batched(eqs, lin.cols)
    origins = torch_to_u32(extract_device._origin_batch(rref32, pof, lin.cols))
    hits = []
    for g in np.flatnonzero(~bad.numpy()):
        raw = packing.words_to_int(packing.from_u32(origins[g][None, :])[0])
        s2, s3 = lin.convert_sol(raw)
        if geffe.geffe_stream(int(guesses[g]), s2, s3, t) == keystream:
            hits.append((int(guesses[g]), s2, s3))
    return hits


def test_geffe_guess_sweep_batch():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
    import geffe

    old = (geffe.N1, geffe.T1, geffe.T)
    geffe.N1, geffe.T1, geffe.T = 9, 0x110, 96
    try:
        s1, s2, s3 = 0x1A5, 0x2B3C7, 0x5D1E33
        ks = geffe.geffe_stream(s1, s2, s3, geffe.T)
        hits = _port_geffe_attack(geffe, ks)
        assert hits == geffe.attack(ks) == [(s1, s2, s3)]
    finally:
        geffe.N1, geffe.T1, geffe.T = old


# ---------------------------------------------------- incremental_online.py


def test_incremental_online_lfsr128():
    width, taps = 128, 0xE1000000000000000000000000000000 | 0b10010011
    secret = random.Random(7).getrandbits(width) | 1

    def run(a):
        lfsr_cls = a.crypto("lfsr").GaloisLFSR
        reg = lfsr_cls(width, taps, secret)
        stream = [reg() for _ in range(width + 16)]
        lin = a.LinearSystem([width])
        (x,) = lin.gens(lazy=False)
        sym = lfsr_cls(width, taps, x)
        sym_stream = [sym() for _ in range(width + 16)]
        inc = a.IncrementalSolver(lin)
        dims = [inc.dimension]
        for lo in range(0, len(stream), 24):
            inc.add([s ^ o for s, o in zip(sym_stream[lo : lo + 24], stream[lo : lo + 24])])
            dims.append(inc.dimension)
            if inc.dimension == 0:
                break
        assert not inc.unsat
        return dims, inc.solve_one()

    dims, sol = on_both(run)
    assert dims[0] == 128 and dims[-1] == 0 and sol == (secret,)


# ------------------------------------------------------- the newer models


class _Toy:
    """ToySFMT's parameters (tests/test_sfmt.py): a 512-bit state."""

    N32, POS1, SL1, SL2, SR1, SR2 = 16, 2, 11, 1, 7, 1
    PARITY = (0x00000001, 0, 0, 0)


def test_toy_sfmt_truncated_recovery():
    state = [random.Random(20).getrandbits(32) for _ in range(16)]

    def run(a):
        sfmt = a.crypto("sfmt")
        toy = type("ToySFMT", (sfmt.SFMT,), dict(vars(_Toy), MSK=sfmt.SFMT19937.MSK))
        victim = toy(list(state))
        observed = [victim() & 0xFFFF for _ in range(64)]
        lin = a.LinearSystem([32] * 16)
        sym = toy(list(lin.gens()))
        sol = lin.solve_one([(sym() & 0xFFFF) ^ o for o in observed])
        clone = toy(list(sol))
        assert [clone() & 0xFFFF for _ in range(64)] == observed
        assert [clone() for _ in range(32)] == [victim() for _ in range(32)]
        return sol

    on_both(run)


def test_taus_dimension_and_prediction():
    def run(a):
        taus = a.crypto("taus")
        rnd, out = random.Random(8), []
        for cls, mins, params in ((taus.Taus88, (2, 8, 16), taus.TAUS88_PARAMS),
                                  (taus.LFSR113, (2, 8, 16, 128), taus.LFSR113_PARAMS)):
            victim = cls([rnd.getrandbits(32) | m for m in mins])
            observed = [victim() for _ in range(6)]
            lin = a.LinearSystem([32] * len(mins))
            sym = cls(list(lin.gens()))
            space = lin.solve_raw_space([sym() ^ o for o in observed])
            assert space.dimension == taus.dont_care_dims(params)
            clone = cls(list(lin.convert_sol(space.origin)))
            assert [clone() for _ in range(22)] == observed + [victim() for _ in range(16)]
            out.append((space.dimension, space.origin, sorted(space.basis)))
        return out

    on_both(run)


def test_xorshift_and_crc():
    seed = [random.Random(1337 + i).getrandbits(32) for i in range(4)]

    def run(a):
        xs, crc = a.crypto("xorshift"), a.crypto("crc")
        ref = xs.Xorshift128(list(seed))
        outs = [ref() >> 16 for _ in range(12)]
        lin = a.LinearSystem([32] * 4)
        sym = xs.Xorshift128(list(lin.gens()))
        rec = lin.solve_one([(sym() >> 16) ^ o for o in outs])
        prefix, target = b"gimme ", 0x1337C0DE
        lin = a.LinearSystem([32])
        (x,) = lin.gens()
        msg = x.lshift_ext(8 * len(prefix)) ^ int.from_bytes(prefix, "little")
        (found,) = lin.solve_one([crc.CRC32().process(msg) ^ target])
        import binascii

        assert binascii.crc32(prefix + found.to_bytes(4, "little")) == target
        return rec, found

    rec, _ = on_both(run)
    assert list(rec) == seed


def test_v8_math_random():
    seed0, seed1 = random.Random(9).getrandbits(64), random.Random(10).getrandbits(64)

    def run(a):
        xs = a.crypto("xorshift")
        victim = xs.V8MathRandom(seed0, seed1)
        observed = [victim.random() for _ in range(5)]
        lin = a.LinearSystem([64, 64])
        sym = xs.Xorshift128Plus(*lin.gens())
        outs = [sym.step() for _ in range(xs.V8MathRandom.CACHE_SIZE)]
        rec = lin.solve_one([outs[63 - i][12:] ^ xs.V8MathRandom.mantissa(d)
                             for i, d in enumerate(observed)])
        clone = xs.V8MathRandom(*rec)
        assert [clone.random() for _ in range(8)] == observed + [victim.random() for _ in range(3)]
        return rec

    assert on_both(run) == (seed0, seed1)


def test_gcm_forgery():
    rnd = random.Random(11)
    h, ej0 = rnd.getrandbits(128), rnd.getrandbits(128)
    ciphertext = bytes(rnd.getrandbits(8) for _ in range(64))
    aad, evil = b"from: alice", b"pay mallory $999"

    def run(a):
        gf2m = a.crypto("gf2m")
        g = gf2m.GHASH(h)
        tag = g.tag(aad, ciphertext, ej0)
        lin = a.LinearSystem([128])
        (b2,) = lin.gens()
        blocks = (gf2m.GHASH.bytes_to_blocks(aad) + gf2m.GHASH.bytes_to_blocks(ciphertext)
                  + [gf2m.GHASH.length_block(8 * len(aad), 8 * len(ciphertext))])
        forged = list(blocks)
        forged[2] = int.from_bytes(evil, "big")
        forged[3] = b2
        (fix,) = lin.solve_one([g.process(forged) ^ g.process(blocks)])
        forged_ct = ciphertext[:16] + evil + fix.to_bytes(16, "big") + ciphertext[48:]
        assert g.tag(aad, forged_ct, ej0) == tag
        return fix

    on_both(run)


def test_bm_recover():
    width, taps_secret = 128, 0x6D6AC812F52A212D5A0B9F3117801FD5
    rnd = random.Random(12)
    seed1, seed2 = rnd.getrandbits(width) | 1, rnd.getrandbits(width) | 1

    def run(a):
        bm, lfsr = a.crypto("bm"), a.crypto("lfsr")

        def keystream(reg, n):
            return [reg() for _ in range(n)]

        leak = keystream(lfsr.FibonacciLFSR(width, taps_secret, seed1), 2 * width + 32)
        n, taps = bm.fibonacci_taps(leak)
        assert keystream(bm.lfsr_from_stream(leak), len(leak)) == leak
        assert keystream(bm.galois_lfsr_from_stream(leak), len(leak)) == leak
        session = keystream(lfsr.FibonacciLFSR(width, taps_secret, seed2), 3 * width)
        lin = a.LinearSystem([width])
        (s0,) = lin.gens()
        sym = keystream(lfsr.FibonacciLFSR(width, taps, s0), 3 * width)
        sol = lin.solve_one([sym[i] ^ b for i, b in enumerate(session) if i % 3 == 0])
        return n, taps, sol

    assert on_both(run) == (width, taps_secret, (seed2,))

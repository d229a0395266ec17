"""The port's model library (gf2bv_tpu_torch/crypto) against the JAX package's.

For each of the nine models copied into the port (xoshiro, xorshift, crc,
well, taus, gf2m, bm, php, sfmt): the concrete streams are equal between the
packages, the symbolic trace's ``get_eqs_packed`` is byte-equal, and the
port solves the system on the CPU to the generator's true state or
preimage.  The reference's own checks run on the port too: SFMT's published
check vector, the CRC check values, V8's cache order, Berlekamp-Massey's
fuzz (as in tests/test_crypto_extra.py, test_sfmt.py, test_taus.py,
test_gf2m.py, test_bm.py, test_mt64_php.py).  Secrets come from seeded
``random.Random`` streams.
"""

import importlib
import random

import numpy as np
import pytest

from gf2bv_tpu import LinearSystem as JaxLinearSystem
from gf2bv_tpu_torch import LinearSystem, _native
from gf2bv_tpu_torch.ops import lazy_solve

MODELS = ("xoshiro", "xorshift", "crc", "well", "taus", "gf2m", "bm", "php", "sfmt")


def both(name):
    """(the JAX package's module, the port's) for crypto model ``name``."""
    return tuple(importlib.import_module(f"{p}.crypto.{name}")
                 for p in ("gf2bv_tpu", "gf2bv_tpu_torch"))


def _toy_sfmt(mod):
    class ToySFMT(mod.SFMT):
        """512-bit state, the same code paths (tests/test_sfmt.py)."""

        N32, POS1, SL1, SL2, SR1, SR2 = 16, 2, 11, 1, 7, 1
        MSK = mod.SFMT19937.MSK
        PARITY = (0x00000001, 0, 0, 0)

    return ToySFMT


# -- concrete streams ------------------------------------------------------------------

R = random.Random(20261017)
S64 = [R.getrandbits(64) for _ in range(4)]
S32 = [R.getrandbits(32) for _ in range(16)]
DATA = bytes(R.getrandbits(8) for _ in range(37))
H128, X128 = R.getrandbits(128), R.getrandbits(128)


def _stream(gen, n):
    return [gen() for _ in range(n)]


CONCRETE = {
    "xoshiro256": ("xoshiro", lambda m: _stream(m.Xoshiro256starstar(list(S64)), 12)
                   + [m.Xoshiro256starstar(list(S64)).step() for _ in range(3)]),
    "xoroshiro128": ("xoshiro", lambda m: _stream(m.Xoroshiro128starstar(S64[:2]), 12)),
    "xorshift32": ("xorshift", lambda m: _stream(m.Xorshift32(S32[0] | 1), 20)),
    "xorshift64": ("xorshift", lambda m: _stream(m.Xorshift64(S64[0] | 1), 20)),
    "xorshift128": ("xorshift", lambda m: _stream(m.Xorshift128(S32[:4]), 20)),
    "xorshift64star": ("xorshift", lambda m: _stream(m.Xorshift64star(S64[1] | 1), 20)),
    "xorshift128plus": ("xorshift", lambda m: _stream(m.Xorshift128Plus(*S64[:2]), 20)),
    "v8_math_random": ("xorshift", lambda m: _stream(m.V8MathRandom(*S64[2:]).random, 70)),
    "crc": ("crc", lambda m: [f().process(int.from_bytes(d, "little"), 8 * len(d))
                              for f in (m.CRC32, m.CRC32C, m.CRC16_MODBUS,
                                        m.CRC16_CCITT_KERMIT, m.CRC64_XZ)
                              for d in (b"", b"123456789", DATA)]),
    "well512": ("well", lambda m: _stream(m.Well512(list(S32)), 40)),
    "taus88": ("taus", lambda m: _stream(m.Taus88([S32[0] | 2, S32[1] | 8, S32[2] | 16]), 40)),
    "lfsr113": ("taus", lambda m: _stream(
        m.LFSR113([S32[0] | 2, S32[1] | 8, S32[2] | 16, S32[3] | 128]), 40)),
    "gf2m": ("gf2m", lambda m: [m.GF2m(128, m.GCM_MODULUS).mul(H128, X128),
                                m.GF2m(128, m.GCM_MODULUS).inv(X128),
                                m.GF2m(128, m.GCM_MODULUS).pow(H128, 12345),
                                m.GF2m(8, 0x11B).mul(0x57, 0x83)]),
    "ghash": ("gf2m", lambda m: [m.GHASH(H128).mul_h(X128),
                                 m.GHASH(H128).process([X128, 0xDEADBEEF, H128]),
                                 m.GHASH(H128).tag(b"aad", DATA, 0xFFFF)]),
    "bm": ("bm", lambda m: [m.berlekamp_massey(s) for s in _bm_streams()]
           + [m.linear_complexity_profile(_bm_streams()[0])]),
    "php_mt19937": ("php", lambda m: _stream(m.PHPMtRand.from_seed(31337, m.MT_RAND_MT19937), 700)
                    + [m.PHPMtRand.from_seed(7, 0).mt_rand(1, 6) for _ in range(4)]),
    "php_legacy": ("php", lambda m: _stream(m.PHPMtRand.from_seed(31337, m.MT_RAND_PHP), 700)),
    "sfmt19937": ("sfmt", lambda m: _stream(m.SFMT19937.from_seed(4321), 1300)),
}


def _bm_streams():
    rng = random.Random(0xB31)
    return [[rng.getrandbits(1) for _ in range(n)] for n in (0, 1, 17, 200)]


@pytest.mark.parametrize("case", sorted(CONCRETE))
def test_concrete_streams_equal(case):
    name, run = CONCRETE[case]
    ref, port = both(name)
    want = run(ref)
    assert run(port) == want and len(want) > 0


def test_reference_check_values_on_the_port():
    """Published check values: SFMT19937's check stream (init_gen_rand(1234)),
    the CRCs' '123456789', the AES field's {57}·{83} = {c1}."""
    _, sfmt = both("sfmt")
    g = sfmt.SFMT19937.from_seed(1234)
    assert [g() for _ in range(4)] == [3440181298, 1564997079, 1510669302, 2930277156]
    h = sfmt.SFMT19937([0] * 624, index=624)
    h._certify_period()
    assert h.s[0] == 1 and all(w == 0 for w in h.s[1:])
    _, crc = both("crc")
    data = int.from_bytes(b"123456789", "little")
    for factory, expect in [(crc.CRC32, 0xCBF43926), (crc.CRC32C, 0xE3069283),
                            (crc.CRC16_MODBUS, 0x4B37), (crc.CRC16_CCITT_KERMIT, 0x2189),
                            (crc.CRC64_XZ, 0x995DC9BBDF1939FA)]:
        assert factory().process(data, 72) == expect, factory.__name__
    _, gf2m = both("gf2m")
    assert gf2m.GF2m(8, 0x11B).mul(0x57, 0x83) == 0xC1


def test_v8_cache_is_consumed_in_reverse_on_the_port():
    _, xs = both("xorshift")
    s0, s1 = S64[:2]
    v8 = xs.V8MathRandom(s0, s1)
    eng = xs.Xorshift128Plus(s0, s1)
    gen = [xs.V8MathRandom.to_double(eng.step()) for _ in range(64)]
    assert [v8.random() for _ in range(64)] == gen[::-1]
    assert all(xs.V8MathRandom.mantissa(xs.V8MathRandom.to_double(m << 12)) == m
               for m in (0, 1, (1 << 52) - 1, 0xDEADBEEF))


@pytest.mark.parametrize("trial", range(8))
def test_bm_fuzz_matches_and_reproduces(trial):
    """tests/test_bm.py's fuzz on both packages: random taps and state, both
    register forms; the same complexity and taps, and the port's rebuilt
    register replays the stream."""
    ref, port = both("bm")
    from gf2bv_tpu_torch.crypto.lfsr import FibonacciLFSR, GaloisLFSR

    rng = random.Random(0xB31 + trial)
    n = rng.randrange(2, 48)
    mask = rng.getrandbits(n) | (1 << (n - 1))
    state = rng.getrandbits(n) | 1
    for cls in (FibonacciLFSR, GaloisLFSR):
        bits = _stream(cls(n, mask, state), 3 * n)
        for fn in ("berlekamp_massey", "fibonacci_taps", "galois_taps"):
            assert getattr(port, fn)(bits) == getattr(ref, fn)(bits), fn
        for fn in ("lfsr_from_stream", "galois_lfsr_from_stream"):
            reg = getattr(port, fn)(bits)
            assert _stream(reg, len(bits)) == bits, fn


# -- symbolic traces -------------------------------------------------------------------


def _xoshiro_zeros(m, gens):
    src = m.Xoshiro256starstar(list(S64))
    outs = [src() for _ in range(10)]
    sym = m.Xoshiro256starstar(list(gens))
    return [sym.step() ^ m.Xoshiro256starstar.untemper(o) for o in outs]


def _xoroshiro_zeros(m, gens):
    src = m.Xoroshiro128starstar(S64[:2])
    outs = [src() for _ in range(3)]
    sym = m.Xoroshiro128starstar(list(gens))
    return [sym.step() ^ m.Xoroshiro128starstar.untemper(o) for o in outs]


def _xorshift128_zeros(m, gens):
    src = m.Xorshift128(S32[:4])
    outs = [src() >> 16 for _ in range(12)]
    sym = m.Xorshift128(list(gens))
    return [(sym() >> 16) ^ o for o in outs]


def _xorshift64star_zeros(m, gens):
    src = m.Xorshift64star(S64[1] | 1)
    outs = [src() for _ in range(2)]
    sym = m.Xorshift64star(gens[0])
    return [sym.step() ^ m.Xorshift64star.untemper(o) for o in outs]


def _v8_zeros(m, gens):
    victim = m.V8MathRandom(*S64[2:])
    observed = [victim.random() for _ in range(5)]
    sym = m.Xorshift128Plus(*gens)
    outs = [sym.step() for _ in range(m.V8MathRandom.CACHE_SIZE)]
    return [outs[m.V8MathRandom.CACHE_SIZE - 1 - i][12:] ^ m.V8MathRandom.mantissa(d)
            for i, d in enumerate(observed)]


def _crc32_zeros(m, gens):
    prefix = b"gf2bv:"
    target = m.CRC32().process(int.from_bytes(prefix + b"\xde\xad\xbe\xef", "little"), 80)
    msg = gens[0].lshift_ext(8 * len(prefix)) ^ int.from_bytes(prefix, "little")
    return [m.CRC32().process(msg) ^ target]


def _crc64_zeros(m, gens):
    target = m.CRC64_XZ().process(int.from_bytes(b"\x13\x37\xc0\xde\xfa\xce\xb0\x0c", "little"),
                                  64)
    return [m.CRC64_XZ().process(gens[0]) ^ target]


def _well_zeros(m, gens):
    src = m.Well512(list(S32))
    outs = [src() >> 24 for _ in range(80)]
    sym = m.Well512(list(gens))
    return [(sym() >> 24) ^ o for o in outs]


def _taus_zeros(cls_name, mins):
    def build(m, gens):
        cls = getattr(m, cls_name)
        src = cls([s | k for s, k in zip(S32, mins)])
        outs = [src() for _ in range(6)]
        sym = cls(list(gens))
        return [sym() ^ o for o in outs]

    return build


def _ghash_zeros(m, gens):
    g = m.GHASH(H128)
    return [g.process([X128, gens[0], 0xDEADBEEF]) ^ g.process([X128, S64[0], 0xDEADBEEF])]


def _toy_sfmt_zeros(m, gens):
    toy = _toy_sfmt(m)
    src = toy(S32[: toy.N32])
    outs = [src() & 0xFFFF for _ in range(4 * toy.N32)]
    sym = toy(list(gens))
    return [(sym() & 0xFFFF) ^ o for o in outs]


def _sfmt19937_zeros(m, gens):
    victim = m.SFMT19937.from_seed(20260819)
    outs = [victim() & 0xFFFF for _ in range(64)]
    sym = m.SFMT19937(list(gens), index=624)
    return [(sym() & 0xFFFF) ^ o for o in outs]


def _php_zeros(mode):
    def build(m, gens):
        src = m.PHPMtRand.from_seed(31337, mode)
        outs = [src() for _ in range(4)]
        sym = m.PHPMtRand(list(gens), mode)
        return [sym() ^ o for o in outs]

    return build


def _bm_sparse_zeros(m, gens):
    from gf2bv_tpu_torch.crypto.lfsr import FibonacciLFSR

    lfsr = importlib.import_module(m.__name__.rsplit(".", 1)[0] + ".lfsr")
    secret = S64[3] | 1
    session = _stream(FibonacciLFSR(64, (1 << 63) | (1 << 61) | (1 << 60) | 1, secret), 192)
    _, taps = m.fibonacci_taps(session[:160])
    sym = _stream(lfsr.FibonacciLFSR(64, taps, gens[0]), 192)
    return [sym[i] ^ b for i, b in enumerate(session) if i % 3 == 0]


# name -> (model, sizes, build(module, gens) -> zeros, the port's answer's check)
SYMBOLIC = {
    "xoshiro256": ("xoshiro", [64] * 4, _xoshiro_zeros, lambda sols: tuple(S64) in sols),
    "xoroshiro128": ("xoshiro", [64, 64], _xoroshiro_zeros, lambda sols: sols == [tuple(S64[:2])]),
    "xorshift128_truncated": ("xorshift", [32] * 4, _xorshift128_zeros,
                              lambda sols: sols == [tuple(S32[:4])]),
    "xorshift64star": ("xorshift", [64], _xorshift64star_zeros,
                       lambda sols: sols == [(S64[1] | 1,)]),
    "v8_math_random": ("xorshift", [64, 64], _v8_zeros, lambda sols: sols == [tuple(S64[2:])]),
    "crc32_preimage": ("crc", [32], _crc32_zeros,
                       lambda sols: sols == [(int.from_bytes(b"\xde\xad\xbe\xef", "little"),)]),
    "crc64_preimage": ("crc", [64], _crc64_zeros, lambda sols: sols == [
        (int.from_bytes(b"\x13\x37\xc0\xde\xfa\xce\xb0\x0c", "little"),)]),
    "well512_truncated": ("well", [32] * 16, _well_zeros, lambda sols: len(sols) >= 1),
    "taus88": ("taus", [32] * 3, _taus_zeros("Taus88", (2, 8, 16)), lambda sols: len(sols) == 256),
    "lfsr113": ("taus", [32] * 4, _taus_zeros("LFSR113", (2, 8, 16, 128)), None),
    "ghash_preimage": ("gf2m", [128], _ghash_zeros, lambda sols: sols == [(S64[0],)]),
    "toy_sfmt": ("sfmt", [32] * 16, _toy_sfmt_zeros, lambda sols: len(sols) >= 1),
    "sfmt19937_trace": ("sfmt", [32] * 624, _sfmt19937_zeros, None),
    "php_mt19937_trace": ("php", [32] * 624, _php_zeros(0), None),
    "php_legacy_trace": ("php", [32] * 624, _php_zeros(1), None),
    "bm_sparse": ("bm", [64], _bm_sparse_zeros, lambda sols: sols == [(S64[3] | 1,)]),
}


@pytest.mark.parametrize("case", sorted(SYMBOLIC))
def test_symbolic_eqs_equal_and_port_solves(case):
    """Byte-equal packed equations; the port (CPU) finds the true answer.
    Replays: every solution the port returns satisfies every equation."""
    name, sizes, build, check = SYMBOLIC[case]
    ref, port = both(name)
    jlin, lin = JaxLinearSystem(sizes), LinearSystem(sizes, device="cpu")
    want = jlin.get_eqs_packed(build(ref, jlin.gens()))
    zeros = build(port, lin.gens())
    got = lin.get_eqs_packed(zeros)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if check is None:
        return
    sols = list(lin.solve_all(zeros, max_dimension=8))
    assert check(sols), sols[:4]
    for sol in sols[:4]:
        assert all(lin.evaluate(z, sol) == 0 for z in zeros)


def test_taus_dont_care_dims_on_the_port():
    """The recovery is a space of dimension ``dont_care_dims``; any member
    predicts the generator (examples/taus.py)."""
    _, taus = both("taus")
    for cls, mins, params in ((taus.Taus88, (2, 8, 16), taus.TAUS88_PARAMS),
                              (taus.LFSR113, (2, 8, 16, 128), taus.LFSR113_PARAMS)):
        lin = LinearSystem([32] * len(mins), device="cpu")
        zeros = _taus_zeros(cls.__name__, mins)(taus, lin.gens())
        space = lin.solve_raw_space(zeros)
        assert space.dimension == taus.dont_care_dims(params)
        victim = cls([s | k for s, k in zip(S32, mins)])
        clone = cls(list(lin.convert_sol(space.origin)))
        assert _stream(clone, 22) == _stream(victim, 22)


@pytest.fixture
def cpu_native(monkeypatch):
    monkeypatch.setenv("GF2BV_TPU_CPU_NATIVE", "1")
    lazy_solve.clear_cache()
    yield
    lazy_solve.clear_cache()


@pytest.mark.skipif(not _native.available(), reason="no native engine (gcc missing)")
@pytest.mark.parametrize("mode", [0, 1])
def test_php_full_recovery_on_the_port(cpu_native, mode):
    """PHP mt_rand at full width (19968 unknowns) on the port's CPU route
    (the host C engine), as tests/test_mt64_php.py runs the reference:
    1300 draws pin the future."""
    _, php = both("php")
    victim = php.PHPMtRand.from_seed(0xC0FFEE + mode, mode)
    observed = [victim() for _ in range(1300)]
    lin = LinearSystem([32] * 624, device="cpu")
    sym = php.PHPMtRand(list(lin.gens()), mode)
    sol = lin.solve_one([sym() ^ o for o in observed])
    clone = php.PHPMtRand(list(sol), mode)
    assert _stream(clone, 1300) == observed
    assert _stream(clone, 8) == _stream(victim, 8)


def test_every_model_is_in_the_port():
    for name in MODELS:
        ref, port = both(name)
        public = {k for k in vars(ref) if not k.startswith("_")}
        assert public <= set(vars(port)), name

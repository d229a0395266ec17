"""The port's exports against the JAX package's, on the CPU: ``__all__``,
``m4ri_solve`` in modes 0 and 1, the Sage export through an injected fake
Sage (as tests/test_sage_export.py), trace serialization and pickling
round trips, and the matrix PNG (byte-equal between the packages)."""

import inspect
import pickle
import random

import numpy as np
import pytest

import gf2bv_tpu
import gf2bv_tpu_torch
from gf2bv_tpu import LinearSystem as JaxLinearSystem
from gf2bv_tpu.utils import matviz as jax_matviz
from gf2bv_tpu.utils import serialization as jax_serialization
from gf2bv_tpu_torch import LinearSystem, QuadraticSystem
from gf2bv_tpu_torch.ops import solver
from gf2bv_tpu_torch.utils import matviz, serialization


def test_all_contains_every_reference_name():
    assert set(gf2bv_tpu.__all__) <= set(gf2bv_tpu_torch.__all__)
    for name in gf2bv_tpu_torch.__all__:
        assert hasattr(gf2bv_tpu_torch, name), name
    ref = inspect.signature(gf2bv_tpu.m4ri_solve).parameters
    got = inspect.signature(gf2bv_tpu_torch.m4ri_solve).parameters
    assert list(got)[:3] == list(ref) == ["equations", "cols", "mode"]
    assert got["device"].default == "cuda"  # the card, the port's default device


def _random_masks(rng, rows, cols, consistent=True):
    secret = rng.getrandbits(cols)
    masks = []
    for _ in range(rows):
        m = rng.getrandbits(cols)
        bit = bin(m & secret).count("1") & 1
        masks.append((m << 1) | (bit ^ (0 if consistent else rng.getrandbits(1))))
    return secret, masks


@pytest.mark.parametrize("cols,rows", [(2, 2), (40, 30), (40, 60), (300, 310)])
def test_m4ri_solve_modes_match_reference(cols, rows):
    rng = random.Random(cols * 1000 + rows)
    secret, masks = _random_masks(rng, rows, cols)
    got0 = gf2bv_tpu_torch.m4ri_solve(masks, cols, 0, device="cpu")
    want0 = gf2bv_tpu.m4ri_solve(masks, cols, 0)
    assert got0 == want0
    sp, ref = (gf2bv_tpu_torch.m4ri_solve(masks, cols, 1, device="cpu"),
               gf2bv_tpu.m4ri_solve(masks, cols, 1))
    assert sp.dimension == ref.dimension
    assert sp.origin == ref.origin and sorted(sp.basis) == sorted(ref.basis)
    if rows > cols + 5:
        assert sp.dimension == 0 and got0 == secret


def test_m4ri_solve_unsat_and_reference_corner():
    """tests/test_reference_corners.py's shim cases on the port."""
    eqs = [0b010 ^ 1, 0b100]  # x0 = 1, x1 = 0
    assert gf2bv_tpu_torch.m4ri_solve(eqs, 2, 0, device="cpu") == 1
    space = gf2bv_tpu_torch.m4ri_solve(eqs, 2, 1, device="cpu")
    assert space.dimension == 0 and space.get(0) == 1
    assert gf2bv_tpu_torch.m4ri_solve([0b010, 0b010 ^ 1], 2, 0, device="cpu") is None
    assert gf2bv_tpu_torch.m4ri_solve([0b010, 0b010 ^ 1], 2, 1, device="cpu") is None


class FakeSage:
    """Duck-typed stand-in for sage.all: records GF/matrix/vector calls."""

    def __init__(self):
        self.calls = []

    def GF(self, p):
        self.calls.append(("GF", p))
        return ("GF", p)

    def matrix(self, field, arr):
        self.calls.append(("matrix", field))
        return ("matrix", field, np.asarray(arr, dtype=np.uint8))

    def vector(self, field, arr):
        self.calls.append(("vector", field))
        return ("vector", field, np.asarray(arr, dtype=np.uint8))


def _toy(cls, **kw):
    lin = cls([4, 3], **kw)
    a, b = lin.gens(lazy=False)
    return lin, [a ^ 0b1010, b ^ 0b010, a[:3] ^ b]


@pytest.mark.parametrize("slow", [False, True])
def test_get_sage_mat_matches_reference(slow):
    lin, zeros = _toy(LinearSystem, device="cpu")
    jlin, jzeros = _toy(JaxLinearSystem)
    fake, jfake = FakeSage(), FakeSage()
    if slow:
        mat, vec = lin.get_sage_mat_slow(zeros, tqdm=lambda x, desc: x, _sage=fake)
        jmat, jvec = jlin.get_sage_mat_slow(jzeros, tqdm=lambda x, desc: x, _sage=jfake)
    else:
        mat, vec = lin.get_sage_mat(zeros, _sage=fake)
        jmat, jvec = jlin.get_sage_mat(jzeros, _sage=jfake)
    assert fake.calls == jfake.calls
    assert mat[:2] == ("matrix", ("GF", 2)) and vec[:2] == ("vector", ("GF", 2))
    assert np.array_equal(mat[2], jmat[2]) and np.array_equal(vec[2], jvec[2])
    a_np, b_np = lin.get_mat_numpy(zeros)
    assert np.array_equal(mat[2], a_np) and np.array_equal(vec[2], b_np)
    sol = lin.solve_one(zeros)
    assert sol == (0b1010, 0b010)
    bits = np.array([(sol[0] >> i) & 1 for i in range(4)] + [(sol[1] >> i) & 1 for i in range(3)],
                    np.uint8)
    assert np.array_equal((mat[2] @ bits) % 2, vec[2])


def test_get_sage_mat_without_sage_raises_importerror():
    lin, zeros = _toy(LinearSystem, device="cpu")
    with pytest.raises(ImportError):
        lin.get_sage_mat(zeros)


def test_serialization_round_trip_matches_reference(tmp_path):
    lin = LinearSystem([16, 8], device="cpu")
    jlin = JaxLinearSystem([16, 8])
    (x, y), (jx, jy) = lin.gens(), jlin.gens()
    zeros, jzeros = [x ^ 0xBEEF, y ^ x[:8]], [jx ^ 0xBEEF, jy ^ jx[:8]]
    p, jp = tmp_path / "port.npz", tmp_path / "jax.npz"
    serialization.save_zeros(p, lin, zeros)
    jax_serialization.save_zeros(jp, jlin, jzeros)
    eqs, cols = serialization.load_eqs(p)
    jeqs, jcols = jax_serialization.load_eqs(jp)
    assert cols == jcols == 24 and np.array_equal(eqs, jeqs)
    assert eqs.dtype == np.uint64 and np.array_equal(eqs, lin.get_eqs_packed(zeros))
    # each package reads the other's file
    assert np.array_equal(serialization.load_eqs(jp)[0], eqs)
    raw = serialization.solve_saved(p, lin, mode=0)
    assert lin.convert_sol(raw) == (0xBEEF, 0xEF)
    space = serialization.solve_saved(p, lin, mode=1)
    assert space.dimension == 0 and space.get(0) == raw


def test_solve_saved_solves_on_the_system_device(tmp_path, monkeypatch):
    """The system's device reaches the solver (the reference passes only the
    backend, which would solve on the default device, the card)."""
    lin = LinearSystem([8], backend="jax", device="cpu")
    (x,) = lin.gens()
    p = tmp_path / "t.npz"
    serialization.save_zeros(p, lin, [x ^ 0x5A])
    seen = []
    real = solver.solve

    def spy(eqs, cols, mode, backend=None, device="cuda"):
        seen.append((backend, str(device)))
        return real(eqs, cols, mode, backend, device=device)

    monkeypatch.setattr(solver, "solve", spy)
    assert lin.convert_sol(serialization.solve_saved(p, lin)) == (0x5A,)
    assert seen == [("jax", "cpu")]


def test_pickle_round_trips():
    q = QuadraticSystem([6], device="cpu")
    (x,) = q.gens()
    zeros = [q.mul_bit(x[0], x[1]) ^ 1, x ^ 0b111111]
    q2, z2 = pickle.loads(pickle.dumps((q, zeros)))
    assert q2.solve_one(z2) == (0b111111,)
    lin = LinearSystem([12], device="cpu")
    (y,) = lin.gens()
    lin2, zl = pickle.loads(pickle.dumps((lin, [y ^ 0xABC])))
    assert lin2.solve_one(zl) == (0xABC,) and lin2._device == lin._device


def test_matrix_png_bytes_equal_reference(tmp_path):
    lin, jlin = LinearSystem([8, 8], device="cpu"), JaxLinearSystem([8, 8])
    (x, y), (jx, jy) = lin.gens(), jlin.gens()
    png = matviz.system_matrix_png(lin, [x ^ 0xA5, y ^ 0x3C, x ^ y])
    assert png == jax_matviz.system_matrix_png(jlin, [jx ^ 0xA5, jy ^ 0x3C, jx ^ jy])
    assert png.startswith(b"\x89PNG\r\n\x1a\n")
    bits = (np.random.default_rng(3).random((37, 53)) < 0.5).astype(np.uint8)
    assert matviz.bits_to_png(bits) == jax_matviz.bits_to_png(bits)
    path = tmp_path / "m.png"
    matviz.save_matrix_png(lin, [x ^ 0xA5, y ^ 0x3C, x ^ y], str(path))
    assert path.read_bytes() == png

"""The port's backend routing and host backends against the JAX package, on
the CPU.

* ``ops/solver``: ``_resolve_backend`` / ``_auto_backend`` (the 1024-column
  split between ``jax`` and ``blocked``, ``GF2BV_TPU_BACKEND``, the argument,
  and ``native`` for a CPU system when ``GF2BV_TPU_CPU_NATIVE`` allows it);
  the ``oracle`` and ``native`` backends in modes 0 and 1; ``solve_packed``
  pulling an int32 tensor back for a host backend;
* ``ops/lazy_solve`` under ``jax`` and ``native`` (the cached structure);
* the host loop of ``parallel.batch.solve_batch_systems``;
* the native branches of ``core/capture``, the sweeps and
  ``AffineSpace.enumerate_packed``;
* the copies ``ops/gauss_ref``, ``ops/extract`` and ``_native``.

The JAX side runs with ``GF2BV_TPU_CPU_NATIVE=0`` (tests/conftest.py), so its
auto routing is by size alone.  Tolerance 0: integer GF(2) arithmetic, and
the RREF is unique.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import gf2bv_tpu
from gf2bv_tpu import _native as native_jax
from gf2bv_tpu.core.affine import AffineSpace as AffineSpaceJax
from gf2bv_tpu.ops import extract as extract_jax
from gf2bv_tpu.ops import gauss_ref as gauss_ref_jax
from gf2bv_tpu.ops import solver as solver_jax
from gf2bv_tpu_torch import LinearSystem, u32_to_torch
from gf2bv_tpu_torch import _native
from gf2bv_tpu_torch.core import affine as affine_torch
from gf2bv_tpu_torch.core import packing
from gf2bv_tpu_torch.core.affine import AffineSpace
from gf2bv_tpu_torch.ops import extract, gauss_blocked, gauss_jax, gauss_ref, lazy_solve, solver
from gf2bv_tpu_torch.parallel import batch

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(2)

needs_native = pytest.mark.skipif(
    not (_native.available() and native_jax.available()),
    reason="no native engine (gcc missing)",
)


def _system(seed, rows, cols, deficit=0, unsat=False):
    """Packed (rows, W64) random system, consistent unless ``unsat``, with
    ``deficit`` duplicated rows."""
    rng = np.random.default_rng(seed)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    if deficit:
        coeff[rows - deficit:] = coeff[:deficit]
    bits = np.concatenate([((coeff.astype(np.int64) @ secret) % 2)[:, None].astype(np.uint8),
                           coeff], axis=1)
    if unsat:
        bits[-1] = bits[0]
        bits[-1, 0] ^= 1
    return packing.pack_bits(bits, 1 + cols)


def _space_key(sp):
    return None if sp is None else (sp.dimension, sp.origin, sorted(sp.basis))


@pytest.fixture
def cpu_native(monkeypatch):
    monkeypatch.setenv("GF2BV_TPU_CPU_NATIVE", "1")
    lazy_solve.clear_cache()
    yield
    lazy_solve.clear_cache()


# -- routing ---------------------------------------------------------------------------


@pytest.mark.parametrize("cols", [4, 1023, 1024, 4096])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_auto_backend_table(monkeypatch, cols, device):
    """auto on a CPU system (GF2BV_TPU_CPU_NATIVE=0) splits at
    _BLOCKED_THRESHOLD = 1024 as the reference does; on the card it takes
    the blocked kernels at every size (from the card's routing sweep)."""
    monkeypatch.delenv("GF2BV_TPU_BACKEND", raising=False)
    ref = "blocked" if cols >= 1024 else "jax"
    want = "blocked" if device == "cuda" else ref
    assert solver._BLOCKED_THRESHOLD == solver_jax._BLOCKED_THRESHOLD == 1024
    assert solver._auto_backend(cols, device) == want
    assert solver_jax._auto_backend(cols) == ref
    assert solver._resolve_backend("auto", cols, device) == want
    assert solver._resolve_backend(None, cols, device) == want


@pytest.mark.parametrize("name", ["oracle", "native", "jax", "blocked"])
def test_backend_from_env_and_argument(monkeypatch, name):
    """GF2BV_TPU_BACKEND names the backend when no argument does; an argument
    wins over it; both packages agree at either side of the split."""
    monkeypatch.setenv("GF2BV_TPU_BACKEND", name)
    for cols in (4, 4096):
        assert solver._auto_backend(cols) == solver_jax._auto_backend(cols) == name
        assert solver._resolve_backend(None, cols, "cpu") == name
    other = "oracle" if name != "oracle" else "jax"
    assert solver._resolve_backend(other, 4) == solver_jax._resolve_backend(other, 4) == other


def test_unknown_backend_raises(monkeypatch):
    monkeypatch.delenv("GF2BV_TPU_BACKEND", raising=False)
    for resolve in (solver._resolve_backend, solver_jax._resolve_backend):
        with pytest.raises(ValueError, match="unknown backend 'orcale'"):
            resolve("orcale", 8)
    lin = LinearSystem([8], backend="orcale", device="cpu")
    (v,) = lin.gens(lazy=False)
    with pytest.raises(ValueError, match="unknown backend"):
        lin.solve_one([v ^ 3])
    lin2 = LinearSystem([8], backend="auto", device="cpu")
    (w,) = lin2.gens(lazy=False)
    assert lin2.solve_one([w ^ 3]) == (3,)


@needs_native
def test_cpu_system_prefers_native(cpu_native, monkeypatch):
    """In place of the reference's JAX-platform probe the system's device
    decides: a CPU system routes to native at every size, a CUDA one by
    size; explicit backends are never overridden; the knob at 0 turns it
    off.  The reference, pinned to the CPU here, routes the same."""
    monkeypatch.delenv("GF2BV_TPU_BACKEND", raising=False)
    for cols in (50, 50_000):
        assert solver._resolve_backend(None, cols, "cpu") == "native"
        assert solver_jax._resolve_backend(None, cols) == "native"
    assert solver._resolve_backend("auto", 50, "cpu") == "native"
    assert solver._resolve_backend(None, 50, "cuda") == "blocked"
    assert solver._resolve_backend(None, 50_000, "cuda") == "blocked"
    assert solver._resolve_backend("jax", 50, "cpu") == "jax"
    assert solver._resolve_backend("blocked", 50, "cpu") == "blocked"
    monkeypatch.setenv("GF2BV_TPU_CPU_NATIVE", "0")
    assert solver._resolve_backend(None, 50, "cpu") == "jax"
    assert solver._resolve_backend(None, 50_000, "cpu") == "blocked"


def test_native_unavailable_is_never_auto(cpu_native, monkeypatch):
    monkeypatch.setattr(_native, "available", lambda: False)
    assert solver._resolve_backend(None, 50, "cpu") == "jax"
    assert solver._resolve_backend(None, 5000, "cpu") == "blocked"


def test_auto_default_solve_runs_the_per_pivot_solver(monkeypatch):
    """Below 1024 columns a system that names no backend takes the per-pivot
    solver; at 1024 and above the blocked one (both on the CPU twins)."""
    monkeypatch.delenv("GF2BV_TPU_BACKEND", raising=False)
    calls = []
    for name, mod in (("jax", gauss_jax), ("blocked", gauss_blocked)):
        real = getattr(mod, "solve_" + name)
        monkeypatch.setattr(mod, "solve_" + name,
                            lambda *a, _n=name, _r=real, **k: calls.append(_n) or _r(*a, **k))
    for cols, want in ((1023, "jax"), (1024, "blocked")):
        eqs = _system(cols, 40, cols)
        got = solver.solve(eqs, cols, 0, device="cpu")
        assert got == solver_jax.solve(eqs, cols, 0, backend="oracle")
        assert calls[-1] == want


# -- the host backends -----------------------------------------------------------------


_CASES = [(48, 40, 0, False), (40, 48, 0, False), (64, 50, 6, False), (40, 30, 2, True)]


@pytest.mark.parametrize("backend", ["oracle", pytest.param("native", marks=needs_native)])
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("case", range(len(_CASES)))
def test_host_backends_match_the_reference(backend, mode, case):
    rows, cols, deficit, unsat = _CASES[case]
    eqs = _system(100 + case, rows, cols, deficit, unsat)
    got = solver.solve(eqs, cols, mode, backend=backend, device="cpu")
    want = solver_jax.solve(eqs, cols, mode, backend=backend)
    blocked = solver_jax.solve(eqs, cols, mode, backend="blocked")
    if mode == 0:
        assert got == want == blocked
    else:
        assert _space_key(got) == _space_key(want) == _space_key(blocked)
    assert (got is None) == unsat


@pytest.mark.parametrize("backend", ["oracle", pytest.param("native", marks=needs_native)])
@pytest.mark.parametrize("mode", [0, 1])
def test_solve_packed_pulls_a_tensor_back_for_host_backends(monkeypatch, backend, mode):
    """An int32 tensor sent to a host backend comes back once and solves as
    the numpy rows do."""
    eqs = _system(7, 70, 60, deficit=3)
    a32 = u32_to_torch(packing.to_u32(eqs), "cpu")
    pulls = []
    real = solver.torch_to_u32
    monkeypatch.setattr(solver, "torch_to_u32", lambda t: pulls.append(1) or real(t))
    got = solver.solve_packed(a32, 60, mode, backend=backend, device="cpu")
    assert pulls == [1]
    want = solver_jax.solve_packed(eqs, 60, mode, backend=backend)
    if mode == 0:
        assert got == want is not None
    else:
        assert _space_key(got) == _space_key(want)


def test_env_oracle_above_the_threshold(monkeypatch):
    """GF2BV_TPU_BACKEND=oracle overrides auto above the blocked threshold."""
    monkeypatch.setenv("GF2BV_TPU_BACKEND", "oracle")
    eqs = _system(1, 1100, 1030)
    calls = []
    real = gauss_ref.solve_oracle
    monkeypatch.setattr(gauss_ref, "solve_oracle", lambda *a: calls.append(1) or real(*a))
    got = solver.solve(eqs, 1030, 0, device="cpu")
    assert calls == [1]
    assert got == packing.words_to_int(gauss_ref_jax.solve_oracle(eqs, 1030).origin)


@pytest.mark.parametrize("deficit,unsat", [(0, False), (4, False), (0, True)])
def test_gauss_ref_copy(deficit, unsat):
    eqs = _system(77 + deficit, 120, 90, deficit, unsat)
    mine, ref = gauss_ref.solve_oracle(eqs, 90), gauss_ref_jax.solve_oracle(eqs, 90)
    assert mine.consistent == ref.consistent
    assert np.array_equal(mine.origin, ref.origin) and np.array_equal(mine.basis, ref.basis)
    rref_p, piv_p = gauss_ref.rref_packed(eqs, 91)
    rref_j, piv_j = gauss_ref_jax.rref_packed(eqs, 91)
    assert piv_p == piv_j and np.array_equal(rref_p, rref_j)
    bits = packing.unpack_rows(eqs, 91)
    assert gauss_ref.rref_bits(bits)[1] == gauss_ref_jax.rref_bits(bits)[1]
    if not unsat:
        prows = rref_p[: len(piv_p)]
        pcols = np.asarray(piv_p, np.int64)
        assert np.array_equal(extract.build_origin(prows, pcols, 90),
                              extract_jax.build_origin(prows, pcols, 90))
        assert np.array_equal(extract.build_basis(prows, pcols, 90),
                              extract_jax.build_basis(prows, pcols, 90))


@needs_native
@pytest.mark.parametrize("rows,cols,deficit", [(50, 40, 0), (300, 280, 5), (200, 4200, 0)])
def test_native_copy(rows, cols, deficit):
    """The port's copy of the C engine: rref_native and solve_native equal the
    reference's and the oracle, on both engine variants (NSUB 2 below 4096
    columns, 8 from there)."""
    eqs = _system(rows + cols, rows, cols, deficit)
    r_p, pof_p, inc_p = _native.rref_native(eqs, cols)
    r_j, pof_j, inc_j = native_jax.rref_native(eqs, cols)
    assert np.array_equal(r_p, r_j) and np.array_equal(pof_p, pof_j) and inc_p == inc_j
    ref = gauss_ref.solve_oracle(eqs, cols)
    o, b = _native.solve_native(eqs, cols, 1)
    assert np.array_equal(o, ref.origin) and np.array_equal(b, ref.basis)
    assert packing.words_to_int(_native.solve_native(eqs, cols, 0)) == packing.words_to_int(
        ref.origin)


@needs_native
def test_native_builds_into_the_build_directory():
    assert (REPO / "gf2bv_tpu_torch" / "_native" / "native.c").read_bytes() == (
        REPO / "gf2bv_tpu" / "_native" / "native.c").read_bytes()
    for nsub in (_native._NSUB_SMALL, _native._NSUB_LARGE):
        so = _native._build(nsub)
        assert so.parent == REPO / "build" and so.name.startswith(f"libgf2native_n{nsub}_")


@needs_native
def test_native_inconsistent_and_multi_rhs():
    eqs = _system(3, 40, 30, unsat=True)
    assert _native.solve_native(eqs, 30, 0) is None
    assert _native.solve_native(eqs, 30, 1) is None
    base = _system(4, 60, 50, deficit=4)
    rng = np.random.default_rng(4)
    rhs = rng.integers(0, 2, size=(70, base.shape[0])).astype(np.uint8)
    rhs[:3] = packing.unpack_rows(base, 51)[:, 0]  # three satisfiable instances
    for mode in (0, 1):
        got = _native.solve_multi_rhs_native(base, 50, rhs, mode)
        want = native_jax.solve_multi_rhs_native(base, 50, rhs, mode)
        if mode == 0:
            assert got == want
        else:
            assert [_space_key(s) for s in got] == [_space_key(s) for s in want]
        assert all(g is not None for g in got[:3])


# -- lazy traces, batches, captures, sweeps ---------------------------------------------


def _trace(system):
    x, y = system.gens()
    return [
        (x ^ (x >> 7) ^ (x << 13) ^ y.zeroext(31)) ^ 0xDEADBEEF12345,
        (y ^ (y << 3) ^ (y >> 11)) ^ 0x1CE,
    ]


@pytest.mark.parametrize("backend", ["jax", pytest.param("native", marks=needs_native)])
def test_lazy_trace_uses_the_cached_matrix(backend):
    """A lazy trace under jax or native is eligible for the cached path: the
    structure is built once, and the answers equal the reference's."""
    lazy_solve.clear_cache()
    lin = LinearSystem([64, 33], backend=backend, device="cpu")
    lin_j = gf2bv_tpu.LinearSystem([64, 33], backend=backend)
    zeros, zeros_j = _trace(lin), _trace(lin_j)
    assert lazy_solve.eligible(lin, zeros) and lazy_solve._backend_for(lin) == backend
    assert lin.solve_raw_one(zeros) == lin_j.solve_raw_one(zeros_j) is not None
    cs = lazy_solve.cached_system(lin, zeros)
    assert cs.backend == backend and (cs.a_dev is None) == (backend == "native")
    assert _space_key(lin.solve_raw_space(zeros)) == _space_key(lin_j.solve_raw_space(zeros_j))
    assert lazy_solve.cached_system(lin, zeros) is cs and len(lazy_solve._CACHE) == 1
    if backend == "native":
        assert "basis" in cs.basis_cache
    (x, _) = lin.gens()
    assert lin.solve_one(zeros + [(x ^ x) ^ 1]) is None  # the literal 1
    lazy_solve.clear_cache()


def test_oracle_is_not_eligible_for_the_cache():
    lin = LinearSystem([64, 33], backend="oracle", device="cpu")
    lin_j = gf2bv_tpu.LinearSystem([64, 33], backend="oracle")
    zeros = _trace(lin)
    assert not lazy_solve.eligible(lin, zeros)
    assert lin.solve_one(zeros) == lin_j.solve_one(_trace(lin_j)) is not None


def _batch(system, n, seed):
    (x,) = system.gens(lazy=False)
    rng = np.random.default_rng(seed)
    masks = [int(rng.integers(1, 1 << 40)) for _ in range(36)]
    out = []
    for k in range(n):
        secret = int(rng.integers(0, 1 << 40))
        zeros = [(x & m).sum() ^ (bin(secret & m).count("1") & 1) for m in masks]
        if k == n - 1:
            zeros.append((x ^ x) ^ 1)  # the literal 1: unsatisfiable
        out.append(zeros)
    return out


@pytest.mark.parametrize("backend", ["oracle", pytest.param("native", marks=needs_native)])
def test_batch_host_loop(monkeypatch, backend):
    """A host backend solves a batch system by system (the stacked solver is
    never reached), with the reference's answers."""
    monkeypatch.setattr(batch, "solve_batch", None)  # must not be reached
    lin = LinearSystem([40], backend=backend, device="cpu")
    lin_j = gf2bv_tpu.LinearSystem([40], backend=backend)
    zb, zb_j = _batch(lin, 4, 11), _batch(lin_j, 4, 11)
    got = lin.solve_one_batch(zb)
    assert got == lin_j.solve_one_batch(zb_j) and got[-1] is None and got[0] is not None
    raws = batch.solve_batch_systems(lin, zb, mode=1)
    want = [_space_key(s) for s in gf2bv_tpu.parallel.batch.solve_batch_systems(lin_j, zb_j,
                                                                                  mode=1)]
    assert [_space_key(s) for s in raws] == want
    gens = lin.solve_all_batch(zb, max_dimension=6)
    gens_j = lin_j.solve_all_batch(zb_j, max_dimension=6)
    assert [None if g is None else sorted(g) for g in gens] == [
        None if g is None else sorted(g) for g in gens_j]


def _xs_model(ws, p):
    x, y = ws
    return [(x ^ (x << 5) ^ (y >> 3)) ^ p[0], (y ^ (y << 7) ^ x) ^ p[1], (x ^ (y << 1)) ^ p[2]]


@needs_native
@pytest.mark.parametrize("mode", [0, 1])
def test_native_capture(mode):
    """CapturedTrace under native: single solves and solve_raw_batch (one host
    elimination) equal the reference's; mode 1 shares the structure's basis."""
    lazy_solve.clear_cache()
    lin = LinearSystem([32, 32], backend="native", device="cpu")
    lin_j = gf2bv_tpu.LinearSystem([32, 32], backend="native")
    tmpl, tmpl_j = lin.capture(_xs_model), lin_j.capture(_xs_model)
    rng = np.random.default_rng(mode)
    vals = [[int(v) for v in rng.integers(0, 1 << 32, size=3)] for _ in range(5)]
    got = tmpl.solve_raw_batch(vals, mode=mode)
    want = tmpl_j.solve_raw_batch(vals, mode=mode)
    if mode == 0:
        assert got == want
        assert tmpl.solve_one(vals[0]) == tmpl_j.solve_one(vals[0])
        assert tmpl.solve_one_batch(vals) == tmpl_j.solve_one_batch(vals)
    else:
        assert [_space_key(s) for s in got] == [_space_key(s) for s in want]
        cs = lazy_solve.cached_system(lin, tmpl.zeros)
        assert cs.backend == "native" and all(
            s is None or np.shares_memory(s._basis, cs.basis_cache["basis"]) for s in got)
    lazy_solve.clear_cache()


def test_jax_capture_batch_pads_for_the_multi_rhs_solver():
    """Under jax the cached matrix has the per-pivot solver's padding; a batch
    rides the blocked multi-RHS elimination, which takes the unaligned width
    as the reference does (``rref_blocked`` pads it inside)."""
    lazy_solve.clear_cache()
    lin = LinearSystem([32, 32], backend="jax", device="cpu")
    lin_j = gf2bv_tpu.LinearSystem([32, 32], backend="jax")
    tmpl, tmpl_j = lin.capture(_xs_model), lin_j.capture(_xs_model)
    rng = np.random.default_rng(9)
    vals = [[int(v) for v in rng.integers(0, 1 << 32, size=3)] for _ in range(4)]
    assert tmpl.solve_raw_batch(vals) == tmpl_j.solve_raw_batch(vals)
    cs = lazy_solve.cached_system(lin, tmpl.zeros)
    assert cs.backend == "jax" and cs.a_dev.shape[1] == 2 * packing.nwords64(65)
    lazy_solve.clear_cache()


@needs_native
@pytest.mark.parametrize("candidates", [None, [0, 3, 5, 7, 16]])
def test_native_sweep(candidates):
    """The sweeps under native ride one host multi-RHS elimination, with the
    reference's answers (16 pins an identically-0 bit: unsatisfiable)."""
    lin = LinearSystem([40], backend="native", device="cpu")
    lin_j = gf2bv_tpu.LinearSystem([40], backend="native")
    zeros, zeros_j = _batch(lin, 2, 21)[0], _batch(lin_j, 2, 21)[0]
    (x,), (x_j,) = lin.gens(lazy=False), lin_j.gens(lazy=False)
    got = lin.solve_one_sweep(zeros, [x & 7], candidates)
    assert got == lin_j.solve_one_sweep(zeros_j, [x_j & 7], candidates)
    assert any(g is not None for g in got)
    if candidates is not None:
        assert got[-1] is None
    spaces = lin.solve_all_sweep(zeros, [x & 3], candidates, max_dimension=8)
    spaces_j = lin_j.solve_all_sweep(zeros_j, [x_j & 3], candidates, max_dimension=8)
    assert [None if s is None else sorted(s) for s in spaces] == [
        None if s is None else sorted(s) for s in spaces_j]


@pytest.mark.parametrize("dim,start,count", [(0, 0, 1), (7, 0, 128), (20, 1000, 300),
                                             (40, (1 << 38) + 5, 64),
                                             (18, 77, 1 << 17), (40, (1 << 38) + 5, 1 << 17)])
def test_enumerate_packed_native_branch(monkeypatch, dim, start, count):
    """AffineSpace.enumerate_packed takes the C engine when it builds and the
    batch holds ``_NATIVE_MIN_WORDS`` output words or more; its points are
    the numpy path's and the reference's."""
    rng = np.random.default_rng(dim)
    cols = 77
    origin = packing.int_to_words(int(rng.integers(0, 1 << 62)), cols)
    basis = (packing.ints_to_rows([int(rng.integers(1, 1 << 62)) << 10 for _ in range(dim)], cols)
             if dim else np.zeros((0, packing.nwords64(cols)), np.uint64))
    sp, sp_j = AffineSpace(origin, basis, cols), AffineSpaceJax(origin, basis, cols)
    calls = []
    real = _native.enumerate_native
    monkeypatch.setattr(_native, "enumerate_native", lambda *a: calls.append(a) or real(*a))
    got = sp.enumerate_packed(start, count, True)
    big = count * packing.nwords64(cols) >= affine_torch._NATIVE_MIN_WORDS
    assert len(calls) == int(big and _native.available())
    assert np.array_equal(got, sp_j.enumerate_packed(start, count, True))
    monkeypatch.setattr(_native, "available", lambda: False)
    assert np.array_equal(got, sp.enumerate_packed(start, count, True))
    assert np.array_equal(sp.enumerate_packed(start, count, False),
                          sp_j.enumerate_packed(start, count, False))

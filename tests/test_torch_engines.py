"""The blocked solver's engines in the port against the JAX package's, on the CPU.

The port's kernels for the scan engines (two-pivot scan, min-key scan, fused
phase 1, the look-ahead update + scan) have plain PyTorch twins that follow
each kernel's own steps; on CPU tensors the wrappers run them.  The same
seeded numpy inputs go through the Pallas kernels in interpret mode and
through the port, kernel by kernel and engine by engine (the JAX side with
the ``_interpret`` engine names).  Tolerance 0: integer GF(2) arithmetic,
and the RREF is unique.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu import LinearSystem as LinearSystemJax
from gf2bv_tpu.core import packing
from gf2bv_tpu.crypto.mt import MersenneTwister as MersenneTwisterJax
from gf2bv_tpu.ops import lazy_solve as lazy_solve_jax
from gf2bv_tpu.ops import gauss_blocked as gb_jax
from gf2bv_tpu.ops import pallas_phase1
from gf2bv_tpu.ops.pallas_phase1 import _call_scan_kernel, phase1_panel
from gf2bv_tpu.ops.pallas_update import la_grid as la_grid_jax
from gf2bv_tpu.ops.pallas_update import panel_update_mxu_scan
from gf2bv_tpu_torch import LinearSystem, torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.crypto.mt import MT19937, MersenneTwister
from gf2bv_tpu_torch.ops import gauss_batched, lazy_solve, panel_update, phase1, solver
from gf2bv_tpu_torch.ops import gauss_blocked as gb_torch
from test_torch_kernels import PANELS, _panel

torch.set_num_threads(2)

# (phase1, phase2) of every engine the port adds to the default pair
ENGINES = [
    ("pallas_scan2", "mxu"),
    ("pallas_scanm", "mxu"),
    ("pallas", "mxu"),
    ("pallas_sub", "mxu"),
    ("pallas_scan", "mxu_la"),
    ("pallas_scan", "mxu_noseg"),
]


def t32(a):
    return u32_to_torch(a, "cpu")


def _jax_engine(name):
    # the reference derives mxu_noseg's interpret flag from phase2 ==
    # "mxu_interpret", so "mxu_noseg_interpret" cannot run on the CPU; its
    # full RREF is mxu's, and so is its mode-0 origin
    return "mxu_interpret" if name == "mxu_noseg" else name + "_interpret"


def _system(seed, rows, cols, dep=0, k_panel=256):
    """Padded (rows', wp) uint32 matrix of a consistent random system with
    ``dep`` duplicated rows."""
    rng = np.random.default_rng(seed)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    if dep:
        coeff[rows - dep :] = coeff[:dep]
    rhs = (coeff @ secret) % 2
    bits = np.concatenate([rhs[:, None], coeff], axis=1)
    return gb_jax._pad(packing.pack_bits(bits, 1 + cols), k_panel, word_align=128)


def _deficit_system():
    """tests/test_pallas_update.py's deficit-forcing system: the first
    SUBSET_ROWS + 32 rows touch only the first 8 columns, so the subset scan
    cannot pivot the others and the fallback pass runs."""
    S = pallas_phase1.SUBSET_ROWS
    rng = np.random.default_rng(99)
    cols, rows = 40, S + 64
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = np.zeros((rows, cols), dtype=np.uint8)
    coeff[: S + 32, :8] = rng.integers(0, 2, size=(S + 32, 8))
    coeff[S + 32 :, :] = rng.integers(0, 2, size=(32, cols))
    rhs = (coeff @ secret) % 2
    bits = np.concatenate([rhs[:, None], coeff], axis=1)
    return gb_jax._pad(packing.pack_bits(bits, 1 + cols), 256, word_align=128), cols


def _same_rref(a32, cols, k, p1, p2):
    """rref_blocked (whole RREF, pof, flag) and rref_origin_blocked (origin,
    verdict) of the port with (p1, p2) against the JAX package's."""
    r_j, p_j, i_j = gb_jax.rref_blocked(
        jnp.asarray(a32), cols, k, _jax_engine(p2), _jax_engine(p1), False
    )
    a_t = t32(a32)
    r_t, p_t, i_t = gb_torch.rref_blocked(a_t, cols, k, False, phase1=p1, phase2=p2)
    assert np.array_equal(torch_to_u32(r_t), np.asarray(r_j))
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))
    assert bool(i_t) == bool(i_j)
    o_j, u_j = gb_jax.rref_origin_blocked(
        jnp.asarray(a32), cols, k, _jax_engine(p2), _jax_engine(p1)
    )
    o_t, u_t = gb_torch.rref_origin_blocked(a_t, cols, k, phase1=p1, phase2=p2)
    assert np.array_equal(torch_to_u32(o_t), np.asarray(o_j))
    assert bool(u_t) == bool(u_j)
    assert np.array_equal(torch_to_u32(a_t), a32)  # input not mutated


# -- kernels 6 and 7: the scan variants -----------------------------------------------


@pytest.mark.parametrize("K,w0,cols", PANELS)
@pytest.mark.parametrize("variant", ["2", "m"])
def test_scan_variant_matches_pallas(variant, K, w0, cols):
    _, _, bT, used = _panel(K, w0, seed=K + w0)
    prow_j, used_j, cT_j = (np.asarray(x) for x in _call_scan_kernel(
        jnp.asarray(bT), jnp.asarray(used), jnp.asarray([w0], jnp.int32), K, cols, True,
        variant,
    ))
    twin = {"2": phase1.scan2_plain, "m": phase1.scan_minkey_plain}[variant]
    for prow_t, used_t, cT_t in (
        phase1.scan(t32(bT), torch.from_numpy(used), w0, K, cols, variant),
        twin(t32(bT), torch.from_numpy(used), w0, K, cols),
    ):
        assert (prow_j >= 0).any()
        assert np.array_equal(prow_t.numpy(), prow_j)
        assert np.array_equal(used_t.numpy(), used_j)
        assert np.array_equal(torch_to_u32(cT_t), cT_j)


def test_minkey_reroutes_tall_systems(monkeypatch):
    """Variant "m" at 2^15 rows or more runs the 1-pivot scan, as the
    reference's _call_scan_kernel does; below, the min-key scan."""
    rows, K, cols = phase1.MINKEY_MAX_ROWS, 64, 90
    rng = np.random.default_rng(7)
    bT = t32(rng.integers(0, 2**32, size=(K // 32, rows), dtype=np.uint32))
    used = torch.zeros((1, rows), dtype=torch.int32)
    with pytest.raises(ValueError, match="fewer than"):
        phase1.scan_minkey(bT, used, 0, K, cols)

    calls = []
    real = phase1.scan_minkey

    def spy(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    monkeypatch.setattr(phase1, "scan_minkey", spy)
    got = phase1.scan(bT, used, 0, K, cols, "m")
    want = phase1.scan_plain(bT, used, 0, K, cols)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert calls == []
    short = bT[:, : rows - 1].contiguous()
    phase1.scan(short, used[:, : rows - 1], 0, K, cols, "m")
    assert calls == [rows - 1]


def test_scan_rejects_unknown_variant():
    _, _, bT, used = _panel(64, 0, seed=1)
    with pytest.raises(ValueError, match="variant"):
        phase1.scan(t32(bT), torch.from_numpy(used), 0, 64, 100, "x")


# -- kernel 5: the fused phase 1 -------------------------------------------------------


@pytest.mark.parametrize("K,w0,cols", PANELS)
def test_phase1_panel_matches_pallas(K, w0, cols):
    """The fused twin against phase1_panel in interpret mode, and against the
    split engine on the same inputs."""
    _, a, bT, used = _panel(K, w0, seed=K + w0)
    pf_j, prow_j, used_j = (np.asarray(x) for x in phase1_panel(
        jnp.asarray(a), jnp.asarray(bT), jnp.asarray(used), w0, K, cols, True
    ))
    pf_t, prow_t, used_t = phase1.phase1_panel(
        t32(a), t32(bT), torch.from_numpy(used), w0, K, cols
    )
    assert (prow_j >= 0).any()
    assert np.array_equal(torch_to_u32(pf_t), pf_j)
    assert np.array_equal(prow_t.numpy(), prow_j)
    assert np.array_equal(used_t.numpy(), used_j)
    pf_s, prow_s, used_s = phase1.phase1_panel_split(
        t32(a), t32(bT), torch.from_numpy(used), w0, K, cols
    )
    assert torch.equal(pf_s, pf_t) and torch.equal(prow_s, prow_t)
    assert torch.equal(used_s, used_t)


# -- kernel 12: the update of panel t fused with the scan of panel t+1 -------------------


@pytest.mark.parametrize("w0n", [4, 260], ids=["next-near", "next-far"])
@pytest.mark.parametrize("w0", [None, 260], ids=["full", "trailing"])
def test_update_scan_matches_pallas(w0, w0n):
    """The twin against panel_update_mxu_scan in interpret mode: the whole
    updated matrix (w0 = 260: tile 0 const-only, tile 1 kept, tile 2 live)
    and the scan of the next slice, with pre-used rows."""
    rng = np.random.default_rng(46)
    rows, wp, k = 256, 384, 64
    kw = k // 32
    cols = 32 * wp - 40  # the last columns are invalid
    a = rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32)
    sel = rng.integers(0, 2**32, size=(rows, kw), dtype=np.uint32)
    pf = rng.integers(0, 2**32, size=(k, wp), dtype=np.uint32)
    used = np.zeros((1, rows), np.int32)
    used[0, rng.integers(0, rows, size=10)] = 1
    full = torch_to_u32(panel_update.update_full_plain(t32(a), t32(sel), t32(pf)))
    bTn = np.ascontiguousarray(full[:, w0n : w0n + kw].T)  # the already-updated slice
    want = [np.asarray(x) for x in panel_update_mxu_scan(
        jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), jnp.asarray(bTn),
        jnp.asarray(used), jnp.asarray(w0n, jnp.int32), cols=cols,
        w0=None if w0 is None else jnp.asarray(w0, jnp.int32), interpret=True,
    )]
    got = panel_update.update_scan(
        t32(a), t32(sel), t32(pf), t32(bTn), torch.from_numpy(used), w0n, cols, w0
    )
    assert np.array_equal(torch_to_u32(got[0]), want[0])  # a'
    assert np.array_equal(got[1].numpy(), want[1])  # prow of the next panel
    assert np.array_equal(torch_to_u32(got[2]), want[2])  # cT
    assert np.array_equal(got[3].numpy(), want[3])  # used'
    assert (want[1] >= 0).any()


@pytest.mark.parametrize("rows,wp", [(256, 128), (512, 128), (20224, 640), (300, 200)])
def test_la_grid_matches_jax(rows, wp):
    assert panel_update.la_grid(rows, wp) == la_grid_jax(rows, wp)


# -- the engines through the blocked solver ----------------------------------------------


@pytest.mark.parametrize("p1,p2", ENGINES, ids=[f"{p1}+{p2}" for p1, p2 in ENGINES])
def test_engine_matches_jax(p1, p2):
    """Per engine the whole RREF (trailing=False) and the mode-0 origin and
    verdict equal the JAX package's with the same engine.  mxu_la runs at
    k_panel 64, where its grid gate holds, so the look-ahead loop runs."""
    k = 64 if p2 == "mxu_la" else 128
    a32 = _system(500, 300, 200, dep=5, k_panel=k)
    if p2 == "mxu_la":
        assert panel_update.la_grid(*a32.shape)[2] * 32 >= k
    _same_rref(a32, 200, k, p1, p2)


def test_subset_fallback_matches_jax():
    """pallas_sub on a system whose subset misses pivots: the fallback pass
    runs, is counted, and the results equal the JAX package's."""
    a32, cols = _deficit_system()
    gb_torch.SUBSET_FALLBACKS["panels"] = 0
    _same_rref(a32, cols, 256, "pallas_sub", "mxu")
    assert gb_torch.SUBSET_FALLBACKS["panels"] == 2  # one per rref call


def test_lookahead_clamp_shape(monkeypatch):
    """The panels fill the width (wp = 128, K = 256, cols = 4095): the last
    look-ahead scan reads the slice at w0n = wp, which the reference clamps
    and finds all-invalid.  mxu_la equals the default engine there."""
    cols, K = 4095, 256
    a32 = _system(77, 2048, cols, dep=3)
    rows, wp = a32.shape
    assert wp == 128 and wp // (K // 32) == -(-(1 + cols) // K)  # panels == wp / kw
    assert panel_update.la_grid(rows, wp)[2] * 32 >= K  # the gate holds
    calls = []
    real = gb_torch.update_scan

    def spy(*args):
        calls.append(args[5])  # w0n
        return real(*args)

    monkeypatch.setattr(gb_torch, "update_scan", spy)
    a_t = t32(a32)
    got = gb_torch.rref_blocked(a_t, cols, K, False, phase2="mxu_la")
    assert calls[-1] == wp
    want = gb_torch.rref_blocked(a_t, cols, K, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    o_la, u_la = gb_torch.rref_origin_blocked(a_t, cols, K, phase2="mxu_la")
    o_d, u_d = gb_torch.rref_origin_blocked(a_t, cols, K)
    assert torch.equal(o_la, o_d) and not bool(u_la) and not bool(u_d)
    assert len(calls) == 2 * wp // (K // 32)


def test_lookahead_gate_runs_mxu(monkeypatch):
    """Below the la_grid gate mxu_la runs the mxu engine, as the reference
    does: no fused update + scan, the default engine's results."""
    a32 = _system(62, 100, 80, dep=3)
    assert panel_update.la_grid(*a32.shape)[2] * 32 < 256
    monkeypatch.setattr(gb_torch, "update_scan", None)  # must not be reached
    got = gb_torch.rref_blocked(t32(a32), 80, 256, False, phase2="mxu_la")
    want = gb_torch.rref_blocked(t32(a32), 80, 256, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the switch: names, environment, caches -----------------------------------------------


@pytest.mark.parametrize("phase,name", [
    ("phase1", "jnp"), ("phase1", "jnp_interpret"), ("phase2", "jnp"),
    ("phase2", "pallas"), ("phase2", "mxu2"), ("phase2", "mxu4_interpret"),
    ("phase2", "skip"),
])
def test_unported_engines_raise(phase, name):
    """The engines that used to raise as not ported now run: each gives the
    default engine's RREF, pivot map and verdict (skip, the phase-1-only
    diagnostic, the pivot map of the first panel and the matrix untouched).
    Nothing is left that raises NotImplementedError."""
    a32 = _system(6, 40, 30)
    want = gb_torch.rref_blocked(t32(a32), 30, 256)
    got = gb_torch.rref_blocked(t32(a32), 30, 256, **{phase: name})
    if name == "skip":
        assert np.array_equal(torch_to_u32(got[0]), a32)
        assert torch.equal(got[1], want[1])  # one panel: phase 1 saw the same matrix
        return
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_unknown_engine_names_raise():
    a32 = _system(6, 40, 30)
    with pytest.raises(ValueError, match="unknown phase1 engine"):
        gb_torch.rref_blocked(t32(a32), 30, 256, phase1="pallas_scan3")
    with pytest.raises(ValueError, match="unknown phase2 engine"):
        gb_torch.rref_blocked(t32(a32), 30, 256, phase2="MXU")


def test_interpret_suffix_is_the_same_engine():
    a32 = _system(9, 120, 100, dep=2)
    got = gb_torch.rref_blocked(
        t32(a32), 100, 128, phase1="pallas_scanm_interpret", phase2="mxu_noseg_interpret"
    )
    want = gb_torch.rref_blocked(t32(a32), 100, 128, phase1="pallas_scanm", phase2="mxu_noseg")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pick_engines_reads_the_environment(monkeypatch):
    monkeypatch.delenv("GF2BV_TPU_PHASE1", raising=False)
    monkeypatch.delenv("GF2BV_TPU_PHASE2", raising=False)
    assert gb_torch._pick_engines(640) == ("pallas_scan", "mxu")
    assert gb_torch._pick_engines(8) == ("pallas_scan", "mxu")
    monkeypatch.setenv("GF2BV_TPU_PHASE1", "pallas_scan2")
    monkeypatch.setenv("GF2BV_TPU_PHASE2", "mxu_la")
    assert gb_torch._pick_engines(640) == ("pallas_scan2", "mxu_la")


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_entry_points_take_engines_from_the_environment(monkeypatch):
    """solver.solve, solve_packed and solve_blocked pick their engines when
    called; explicit arguments win over the environment."""
    rng = np.random.default_rng(3)
    cols = 150
    bits = rng.integers(0, 2, size=(200, 1 + cols)).astype(np.uint8)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    bits[:, 0] = (bits[:, 1:] @ secret) % 2
    eqs = packing.pack_bits(bits, 1 + cols)
    # below 1024 columns auto takes the per-pivot solver: name the blocked one
    want = solver.solve(eqs, cols, 0, backend="blocked", device="cpu")
    scan2_calls = _count_calls(monkeypatch, phase1, "scan2")
    monkeypatch.setenv("GF2BV_TPU_PHASE1", "pallas_scan2")
    assert solver.solve(eqs, cols, 0, backend="blocked", device="cpu") == want
    n = len(scan2_calls)
    assert n > 0
    a = t32(packing.to_u32(eqs))
    assert solver.solve_packed(a, cols, 0, backend="blocked", device="cpu") == want
    assert len(scan2_calls) == 2 * n
    got = gb_torch.solve_blocked(eqs, cols, 0, phase1="pallas_scan", device="cpu")
    assert packing.words_to_int(got) == want
    assert len(scan2_calls) == 2 * n


def test_lazy_cache_keeps_its_engines(monkeypatch):
    """The engines cached with a lazily traced structure are those of the
    environment at the time of the solve: GF2BV_TPU_PHASE1 / PHASE2 are part
    of the cache key, as in the reference, so a change reaches the next
    solve_one without clear_cache, and going back finds the first entry."""
    params = dict(MT19937.PARAMS, n=8, m=3)
    state = [0x80000000, 1, 2, 3, 0xDEADBEEF, 5, 6, 0x12345678]
    gen = MersenneTwister(list(state), **params)
    outs = [gen() for _ in range(8)]

    def traced(linear_system, model):
        v = linear_system.gens()
        sym = model(list(v), **params)
        return [sym() ^ o for o in outs] + [v[0] ^ 0x80000000]

    # 256 columns: auto would take the per-pivot solver; the engines are the blocked one's
    lin = LinearSystem([32] * 8, backend="blocked", device="cpu")
    zeros = traced(lin, MersenneTwister)
    lin_j = LinearSystemJax([32] * 8, backend="blocked")
    zeros_j = traced(lin_j, MersenneTwisterJax)
    assert lazy_solve.eligible(lin, zeros) and lazy_solve_jax.eligible(lin_j, zeros_j)

    lazy_solve.clear_cache()
    lazy_solve_jax.clear_cache()
    monkeypatch.delenv("GF2BV_TPU_PHASE1", raising=False)
    monkeypatch.delenv("GF2BV_TPU_PHASE2", raising=False)
    calls = _count_calls(monkeypatch, phase1, "scan_minkey")
    assert lin.solve_one(zeros) == tuple(state)
    assert calls == []
    first = lazy_solve.cached_system(lin, zeros)
    assert first.phase1 == "pallas_scan"
    first_j = lazy_solve_jax.cached_system(lin_j, zeros_j)

    monkeypatch.setenv("GF2BV_TPU_PHASE1", "pallas_scanm")
    assert lin.solve_one(zeros) == tuple(state)  # no clear_cache
    assert calls  # the min-key scan ran: the new engine, not the cached one
    second = lazy_solve.cached_system(lin, zeros)
    second_j = lazy_solve_jax.cached_system(lin_j, zeros_j)
    assert second is not first and second_j is not first_j
    assert second.phase1 == second_j.phase1 == "pallas_scanm"
    assert len(lazy_solve._CACHE) == len(lazy_solve_jax._CACHE) == 2

    monkeypatch.delenv("GF2BV_TPU_PHASE1")
    assert lazy_solve.cached_system(lin, zeros) is first
    assert lazy_solve_jax.cached_system(lin_j, zeros_j) is first_j
    n = len(calls)
    assert lin.solve_one(zeros) == tuple(state)
    assert len(calls) == n  # back on pallas_scan
    lazy_solve.clear_cache()
    lazy_solve_jax.clear_cache()


def test_batched_solvers_take_engines():
    """solve_chained and solve_batched run any engine."""
    cols = 140
    mats = []
    for i in range(2):
        rng = np.random.default_rng(20 + i)
        bits = rng.integers(0, 2, size=(150, 1 + cols)).astype(np.uint8)
        bits[:, 0] = (bits[:, 1:] @ rng.integers(0, 2, size=cols)) % 2
        mats.append(packing.pack_bits(bits, 1 + cols))

    def ints(res):
        return [packing.words_to_int(o) for o in res]

    want = ints(gauss_batched.solve_chained(mats, cols, device="cpu"))
    for p1, p2 in (("pallas_scanm", "mxu_noseg"), ("pallas_sub", "mxu"), ("pallas", "mxu_la")):
        got = gauss_batched.solve_chained(mats, cols, phase1=p1, phase2=p2, device="cpu")
        assert ints(got) == want
    for p2 in ("mxu_la", "mxu_noseg_interpret"):
        assert ints(gauss_batched.solve_batched(mats, cols, 0, phase2=p2, device="cpu")) == want
    for p2 in ("mxu2", "mxu4_interpret", "pallas", "jnp"):
        assert ints(gauss_batched.solve_batched(mats, cols, 0, phase2=p2, device="cpu")) == want
    with pytest.raises(ValueError, match="unknown phase2 engine"):
        gauss_batched.solve_batched(mats, cols, 0, phase2="mxu3", device="cpu")

"""The annihilator attack on a filtered LFSR through rows picked per victim
(``QuadraticSystem.select_rows``, ``ops/quad_device.RowSelection``) against
the plain reference of the benchmark's ``nlfsr128`` configuration
(``benchmark/reference/nlfsr128.py``: the register in numpy, the equations
by direct evaluation, its own GF(2) elimination), at 24 bits on the CPU.

Also: the row bucket's duplicate padding leaves the space as it is, the
selection's checks and spans, and mode 1's full elimination on the CPU
(``gauss_blocked.rref_full_blocked``), which always runs the eager body and
keeps no graph.  Every input is made from a seed.  Tolerance 0: GF(2).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gf2bv_tpu_torch import BitVec, LinearSystem, QuadraticSystem, torch_to_u32
from gf2bv_tpu_torch.crypto.lfsr import GaloisLFSR
from gf2bv_tpu_torch.ops import gauss_blocked, quad_device
from gf2bv_tpu_torch.utils import profiling

torch.set_num_threads(2)

_REF = Path(__file__).resolve().parents[1] / "benchmark" / "reference" / "nlfsr128.py"
_spec = importlib.util.spec_from_file_location("nlfsr128_reference", _REF)
REF = sys.modules[_spec.name] = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF)

# the configuration's combiner and annihilator on a 24-bit register
CFG = {
    "width": 24, "taps": "0xE10000", "select": [3, 7, 11, 15, 19],
    "combiner": [[0, 1], [0, 1, 3, 4], [0], [1], [2]],
    "annihilator": {"pairs": [[0, 1], [1, 2]], "linear": [0, 1, 2], "const": 1},
}
STEPS = 2**12
COLS = 24 + 24 * 23 // 2
SEEDS = [3, 2**31 + 5, 2**32 - 7]
_TEMPLATES: dict = {}


def _template(backend):
    """The device-resident (here: CPU) rows of every step's annihilator,
    built as the benchmark's entry builds them, and the system."""
    if backend not in _TEMPLATES:
        n = CFG["width"]
        qsys = QuadraticSystem([n], backend=backend, device="cpu")
        reg = GaloisLFSR(n, int(CFG["taps"], 16),
                         BitVec.stack(LinearSystem([n], device="cpu").gens(lazy=False)))
        taps = [[] for _ in CFG["select"]]
        for _ in range(STEPS):
            reg()
            for bits, p in zip(taps, CFG["select"]):
                bits.append(reg.state[p])
        f = [BitVec.stack(b) for b in taps]
        eqs = quad_device.quad_rows(qsys, pairs=[(f[0], f[1]), (f[1], f[2])],
                                    linear=f[:3], const=(1 << STEPS) - 1)
        _TEMPLATES[backend] = qsys, eqs
    return _TEMPLATES[backend]


def _victim(seed):
    (secret,) = REF.secrets(CFG, [seed])
    return secret, REF.keystreams(CFG, [secret], STEPS)[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_keystream_is_the_ports_register(seed):
    secret, ks = _victim(seed)
    reg = GaloisLFSR(CFG["width"], int(CFG["taps"], 16), secret)
    want = []
    for _ in range(300):
        reg()
        x = [(reg.state >> p) & 1 for p in CFG["select"]]
        want.append((x[0] & x[1]) ^ (x[0] & x[1] & x[3] & x[4]) ^ x[0] ^ x[1] ^ x[2])
    assert ks[:300].tolist() == want
    assert 0 < secret < 2**24


@pytest.mark.parametrize("backend", ["blocked", None])
@pytest.mark.parametrize("seed", SEEDS)
def test_selected_solve_matches_the_plain_reference(seed, backend):
    """The kept rows' space is the plain elimination's of the directly
    evaluated equations, ``solve_one(keep)`` returns the secret, and
    ``solve_all_packed`` on the same rows gives the same points."""
    qsys, eqs = _template(backend)
    secret, ks = _victim(seed)
    keep = ks.astype(bool)
    sel = qsys.select_rows(eqs)

    ref_rows = REF.annihilator_rows(CFG, ks)
    assert len(ref_rows) == int(keep.sum())
    got_rows = torch_to_u32(eqs[torch.from_numpy(np.flatnonzero(keep))])
    for row, want in zip(got_rows, ref_rows):
        assert sum(int(w) << (32 * i) for i, w in enumerate(row)) == want

    origin, basis = REF.solve_space(ref_rows, COLS)
    space = sel.space(keep)
    assert (space.origin, space.basis) == (origin, basis)
    assert sel.solve_one(keep) == (secret,)
    kept = eqs[torch.from_numpy(np.flatnonzero(keep))]
    assert list(qsys.solve_all_packed(kept)) == list(qsys._enumerate_space(space, 16))
    assert (secret,) in list(qsys.solve_all_packed(kept))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_bucket_padding_with_duplicates_keeps_the_space(seed):
    qsys, eqs = _template("blocked")
    _, ks = _victim(seed)
    keep = ks.astype(bool)
    sel = qsys.select_rows(eqs)
    idx = np.flatnonzero(keep)
    padded = sel.select(keep)
    bucket = gauss_blocked._ROW_BUCKET
    assert padded.shape[0] % bucket == 0 and 0 <= padded.shape[0] - idx.size < bucket
    assert padded.shape[1] % 128 == 0  # the blocked solver's word alignment, made once
    rows = torch_to_u32(eqs[torch.from_numpy(idx)])
    got = torch_to_u32(padded)
    assert np.array_equal(got[: idx.size, : rows.shape[1]], rows)
    assert not got[:, rows.shape[1]:].any()
    assert (got[idx.size:] == got[0][None, :]).all()  # copies of the first kept row
    plain = qsys.solve_raw_packed(eqs[torch.from_numpy(idx)], 1)
    for space in (sel.space(keep), qsys.solve_raw_packed(padded, 1)):
        assert (space.origin, space.basis) == (plain.origin, plain.basis)


def test_selection_checks_its_inputs():
    qsys, eqs = _template("blocked")
    sel = qsys.select_rows(eqs)
    assert sel.rows == STEPS
    with pytest.raises(ValueError, match="mask"):
        sel.select(np.ones(STEPS - 1, dtype=bool))
    with pytest.raises(ValueError, match="no row"):
        sel.select(np.zeros(STEPS, dtype=bool))
    with pytest.raises(TypeError):
        qsys.select_rows(eqs.to(torch.int64))
    assert sel.space(np.ones(STEPS, dtype=bool)) is None  # every step's row: unsatisfiable


def test_selection_and_filter_open_their_spans():
    from torch.profiler import ProfilerActivity, profile

    qsys, eqs = _template("blocked")
    secret, ks = _victim(SEEDS[0])
    sel = qsys.select_rows(eqs)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]), profiling.span("request"):
        assert sel.solve_one(ks.astype(bool)) == (secret,)
    names = [r["name"] for r in profiling.spans()]
    assert names.count("quad.select") == 1 and "quad.filter" in names
    assert names.index("quad.select") < names.index("rref") < names.index("quad.filter")
    recs = {r["name"]: r for r in profiling.spans()}
    panels = -(-(1 + COLS) // 256)  # every one scanned subset-first: fewer rows than S
    assert recs["rref"]["counters"] == {"rref_full_calls": 1, "scan_panels": panels,
                                        "scan_subset_panels": panels}


def _counted(fn):
    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]), profiling.span("request"):
        out = fn()
    counts: dict = {}
    for r in profiling.spans():
        for k, n in r["counters"].items():
            counts[k] = counts.get(k, 0) + n
    return out, counts


@pytest.mark.parametrize("seed", SEEDS)
def test_mode1_on_the_cpu_runs_the_eager_body_and_keeps_no_graph(seed):
    gauss_blocked.clear_graphs()
    qsys, eqs = _template("blocked")
    _, ks = _victim(seed)
    a = qsys.select_rows(eqs).select(ks.astype(bool))
    keep = a.clone()
    want = gauss_blocked.rref_blocked(a, COLS, trailing=False)
    for _ in range(3):  # a repeated shape stays eager on the CPU
        got, counts = _counted(lambda: gauss_blocked.rref_full_blocked(a, COLS))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        panels = -(-(1 + COLS) // 256)
        assert counts == {"rref_full_calls": 1, "scan_panels": panels,
                          "scan_subset_panels": panels}
    assert torch.equal(a, keep)
    assert not gauss_blocked._graphs and not gauss_blocked._seen

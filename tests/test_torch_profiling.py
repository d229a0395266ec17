"""The port's utilities (gf2bv_tpu_torch/utils/profiling.py, timing.py)
against the JAX package's, on the CPU: the same solves record the same
phase names and counts at the same call sites; ``device_trace`` writes a
``torch.profiler`` trace where it is asked to and nothing otherwise."""

import os

import numpy as np
import pytest
import torch

from gf2bv_tpu.ops import solver as solver_jax
from gf2bv_tpu.utils import profiling as prof_jax
from gf2bv_tpu.utils import timing as timing_jax
from gf2bv_tpu_torch.ops import solver
from gf2bv_tpu_torch.utils import profiling, timing

from test_solver import random_system

torch.set_num_threads(2)


@pytest.mark.parametrize("backend,mode", [("blocked", 0), ("blocked", 1), ("jax", 0),
                                          ("oracle", 1)])
def test_phase_report_matches_jax(backend, mode):
    eqs, _ = random_system(np.random.default_rng(3), 80, 60, rank_deficit=2)
    reports = []
    for prof, solve in ((prof_jax, lambda: solver_jax.solve(eqs, 60, mode, backend)),
                        (profiling, lambda: solver.solve(eqs, 60, mode, backend,
                                                         device="cpu"))):
        prof.reset()
        solve()
        solve()
        reports.append({k: v["count"] for k, v in prof.phase_report().items()})
        assert all(v["total_s"] >= 0 for v in prof.phase_report().values())
    assert reports[0] == reports[1]
    assert reports[1][f"solve[{backend}]"] == 2
    if backend == "blocked":
        assert {"pad", "h2d", "rref+origin" if mode == 0 else "rref"} <= set(reports[1])


def test_phase_accumulates_and_reset():
    profiling.reset()
    for _ in range(3):
        with profiling.phase("x"):
            pass
    with pytest.raises(RuntimeError):
        with profiling.phase("y"):
            raise RuntimeError("recorded all the same")
    rep = profiling.phase_report()
    assert rep["x"]["count"] == 3 and rep["y"]["count"] == 1
    assert list(rep) == sorted(rep)
    profiling.reset()
    assert profiling.phase_report() == {}


def test_device_trace_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("GF2BV_TPU_TRACE_DIR", raising=False)
    with profiling.device_trace():  # no directory: a no-op
        torch.ones(4).sum()
    explicit = tmp_path / "explicit"
    with profiling.device_trace(str(explicit)):
        solver.solve(random_system(np.random.default_rng(1), 40, 30)[0], 30, 0, "blocked",
                     device="cpu")
    (trace,) = explicit.iterdir()
    assert trace.name.startswith("gf2bv_trace_") and trace.suffix == ".json"
    assert trace.stat().st_size > 0
    env_dir = tmp_path / "from_env"
    monkeypatch.setenv("GF2BV_TPU_TRACE_DIR", str(env_dir))
    with profiling.device_trace():
        torch.ones(4).sum()
    assert len(list(env_dir.iterdir())) == 1
    assert sorted(os.listdir(tmp_path)) == ["explicit", "from_env"]


def test_timeit_matches_jax(capsys):
    rec, rec_j = {}, {}
    with timing.timeit("port", record=rec):
        pass
    with timing_jax.timeit("port", record=rec_j):
        pass
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("port took ") and out[0].endswith(" seconds")
    assert out[1].startswith("port took ") and list(rec) == list(rec_j) == ["port"]
    with timing.timeit("quiet", record=rec, quiet=True):
        pass
    assert capsys.readouterr().out == "" and rec["quiet"] >= 0

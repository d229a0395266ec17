"""The environment variables the port reads, against the JAX package.

``GF2BV_TPU_LAZY`` (eager or lazy generators), ``GF2BV_TPU_BACKEND`` (the
backend when no argument names one) and ``GF2BV_TPU_TRACE_CACHE`` (how many
lazily traced structures stay cached) behave in the port as in the reference
on the same calls.  Everything runs on the CPU.
"""

import importlib
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from gf2bv_tpu import LinearSystem as LinearSystemJax
from gf2bv_tpu.core.lazy import LazyBitVec as LazyBitVecJax
from gf2bv_tpu.ops import solver as solver_jax
from gf2bv_tpu_torch import LinearSystem
from gf2bv_tpu_torch.core import packing
from gf2bv_tpu_torch.core.lazy import LazyBitVec
from gf2bv_tpu_torch.ops import lazy_solve, solver

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("value,lazy", [(None, True), ("0", False), ("1", True), ("no", True)])
def test_gens_reads_the_lazy_variable(monkeypatch, value, lazy):
    """gens() without an argument follows GF2BV_TPU_LAZY in both packages; an
    explicit lazy= wins over the variable."""
    if value is None:
        monkeypatch.delenv("GF2BV_TPU_LAZY", raising=False)
    else:
        monkeypatch.setenv("GF2BV_TPU_LAZY", value)
    for system, lazy_type in ((LinearSystem([4, 4], device="cpu"), LazyBitVec),
                              (LinearSystemJax([4, 4]), LazyBitVecJax)):
        assert all(isinstance(g, lazy_type) == lazy for g in system.gens())
        assert all(isinstance(g, lazy_type) for g in system.gens(lazy=True))
        assert not any(isinstance(g, lazy_type) for g in system.gens(lazy=False))


def test_env_backend_override(monkeypatch):
    """GF2BV_TPU_BACKEND takes the place of a missing backend argument, as in
    the reference (tests/test_backend_config.py): every backend is resolved,
    the host ones too (which used to raise), an unknown one is a ValueError
    in both packages, and an argument wins over the variable.  Without it,
    and under "auto", the columns decide as in the reference (on a CPU
    system; the card takes the blocked kernels at every size)."""
    monkeypatch.delenv("GF2BV_TPU_BACKEND", raising=False)
    assert solver._resolve_backend(None, 4096) == solver_jax._resolve_backend(None, 4096)
    assert solver._resolve_backend(None, 4, "cpu") == solver_jax._resolve_backend(None, 4) == "jax"
    monkeypatch.setenv("GF2BV_TPU_BACKEND", "jax")
    assert solver._resolve_backend(None, 4096) == solver_jax._resolve_backend(None, 4096) == "jax"
    assert solver._resolve_backend("blocked", 4) == "blocked"
    assert solver_jax._resolve_backend("blocked", 4) == "blocked"
    for name in ("oracle", "native"):
        monkeypatch.setenv("GF2BV_TPU_BACKEND", name)
        assert solver_jax._resolve_backend(None, 4096) == name
        assert solver._resolve_backend(None, 4096) == solver._resolve_backend(name, 4) == name
        assert solver._resolve_backend("blocked", 4) == "blocked"
    monkeypatch.setenv("GF2BV_TPU_BACKEND", "no_such_backend")
    for resolve in (lambda: solver._resolve_backend(None, 4096),
                    lambda: solver_jax._resolve_backend(None, 4096)):
        with pytest.raises(ValueError, match="unknown backend 'no_such_backend'"):
            resolve()
    monkeypatch.setenv("GF2BV_TPU_BACKEND", "auto")
    assert solver._resolve_backend(None, 4096) == solver_jax._resolve_backend(None, 4096)
    assert solver._resolve_backend(None, 1024, "cpu") == "blocked"
    assert solver._resolve_backend(None, 1023, "cpu") == "jax"


def test_env_backend_reaches_the_solve(monkeypatch):
    """Under GF2BV_TPU_BACKEND=jax, and with no backend named below 1024
    columns, solver.solve runs the per-pivot solver."""
    from gf2bv_tpu_torch.ops import gauss_jax

    rng = np.random.default_rng(5)
    cols = 40
    bits = rng.integers(0, 2, size=(60, 1 + cols)).astype(np.uint8)
    bits[:, 0] = (bits[:, 1:] @ rng.integers(0, 2, size=cols)) % 2
    eqs = packing.pack_bits(bits, 1 + cols)
    monkeypatch.delenv("GF2BV_TPU_BACKEND", raising=False)
    want = solver.solve(eqs, cols, 0, backend="blocked", device="cpu")
    calls = []
    real = gauss_jax.solve_jax
    monkeypatch.setattr(gauss_jax, "solve_jax",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("GF2BV_TPU_BACKEND", "blocked")
    assert solver.solve(eqs, cols, 0, device="cpu") == want and not calls
    monkeypatch.setenv("GF2BV_TPU_BACKEND", "jax")
    assert solver.solve(eqs, cols, 0, device="cpu") == want and calls == [1]
    assert solver.solve(eqs, cols, 0, backend="blocked", device="cpu") == want and calls == [1]
    monkeypatch.delenv("GF2BV_TPU_BACKEND")
    assert solver.solve(eqs, cols, 0, device="cpu") == want and calls == [1, 1]  # 40 < 1024


_TRACE_CACHE_SCRIPT = textwrap.dedent("""
    import sys
    pkg = sys.argv[1]
    if pkg == "gf2bv_tpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from gf2bv_tpu import LinearSystem
        from gf2bv_tpu.ops import lazy_solve
        make = lambda sizes: LinearSystem(sizes, backend="blocked")
    else:
        from gf2bv_tpu_torch import LinearSystem
        from gf2bv_tpu_torch.ops import lazy_solve
        make = lambda sizes: LinearSystem(sizes, device="cpu")
    lin = make([8])
    (x,) = lin.gens()
    first = [x ^ (x >> 1) ^ 0x5A]
    second = [x ^ (x >> 2) ^ 0x5A]
    a = lazy_solve.cached_system(lin, first)
    assert lazy_solve.cached_system(lin, first) is a
    lazy_solve.cached_system(lin, second)
    again = lazy_solve.cached_system(lin, first)
    print(lazy_solve._MAX_CACHED, len(lazy_solve._CACHE), again is a)
""")


@pytest.mark.parametrize("value,want", [("1", "1 1 False"), (None, "4 2 True")])
def test_trace_cache_size_from_the_environment(value, want):
    """GF2BV_TPU_TRACE_CACHE is read at import in both packages: at 1 a second
    structure evicts the first, by default (4) both stay."""
    import os

    env = {k: v for k, v in os.environ.items() if k != "GF2BV_TPU_TRACE_CACHE"}
    if value is not None:
        env["GF2BV_TPU_TRACE_CACHE"] = value
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    for pkg in ("gf2bv_tpu_torch", "gf2bv_tpu"):
        res = subprocess.run([sys.executable, "-c", _TRACE_CACHE_SCRIPT, pkg], env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert res.stdout.split("\n")[-2] == want, (pkg, res.stdout)


def test_trace_cache_size_after_a_reload(monkeypatch):
    """The same in this process: a reload of the module reads the variable anew."""
    monkeypatch.setenv("GF2BV_TPU_TRACE_CACHE", "1")
    try:
        importlib.reload(lazy_solve)
        assert lazy_solve._MAX_CACHED == 1
        lin = LinearSystem([8], device="cpu")
        (x,) = lin.gens()
        first, second = [x ^ (x >> 1) ^ 0x5A], [x ^ (x >> 2) ^ 0x5A]
        assert lin.solve_one(first) is not None
        a = lazy_solve.cached_system(lin, first)
        assert lin.solve_one(second) is not None
        assert len(lazy_solve._CACHE) == 1
        assert lazy_solve.cached_system(lin, first) is not a
    finally:
        monkeypatch.delenv("GF2BV_TPU_TRACE_CACHE")
        importlib.reload(lazy_solve)
    assert lazy_solve._MAX_CACHED == 4

"""gf2bv_tpu_torch stands alone: importing it and solving on the CPU pulls in
neither JAX nor the JAX package, and runs no nvcc.

Runs in a subprocess, because tests/conftest.py imports JAX into the pytest
process.  An ``nvcc`` stub first on PATH records any invocation.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent(
    """
    import sys
    import gf2bv_tpu_torch
    from gf2bv_tpu_torch import LinearSystem
    from gf2bv_tpu_torch.crypto.mt import MersenneTwister, MT19937
    from gf2bv_tpu_torch.ops import _cuda

    params = dict(MT19937.PARAMS, n=8, m=3)
    state = [0x80000000, 1, 2, 3, 0xDEADBEEF, 5, 6, 0x12345678]
    gen = MersenneTwister(list(state), **params)
    outs = [gen() for _ in range(8)]
    lin = LinearSystem([32] * 8, device="cpu")
    v = lin.gens()
    sym = MersenneTwister(list(v), **params)
    zeros = [sym() ^ o for o in outs] + [v[0] ^ 0x80000000]
    assert lin.solve_one(zeros) == tuple(state), lin.solve_one(zeros)
    assert list(lin.solve_all(zeros)) == [tuple(state)]
    assert lin.solve_one_batch([zeros, zeros]) == [tuple(state)] * 2
    from gf2bv_tpu_torch.ops import lazy_solve
    cs = lazy_solve.cached_system(lin, zeros)
    lazy_a = cs.a_dev
    rhs = lazy_solve._affine_vector([z._expr for z in zeros], cs.widths)[cs.kept][None, :]
    import gf2bv_tpu_torch.parallel.batch
    import gf2bv_tpu_torch.ops.gauss_batched
    import gf2bv_tpu_torch.ops.multi_rhs
    import gf2bv_tpu_torch.ops.launch_floor
    import gf2bv_tpu_torch.core.capture

    def model(ws, p):
        g = MersenneTwister(list(ws), **params)
        return [g() ^ p[k] for k in range(8)] + [ws[0] ^ 0x80000000]

    tmpl = lin.capture(model)
    assert tmpl.solve_one_batch([outs, outs]) == [tuple(state)] * 2
    swept = lin.solve_one_sweep(zeros, [v[1] & 3])
    assert [s for s in swept if s is not None] == [tuple(state)]
    for p2 in ("pallas", "mxu2", "mxu4", "jnp"):
        got = gf2bv_tpu_torch.ops.multi_rhs.solve_multi_rhs(
            lazy_a, lin.cols, rhs, 0, phase2=p2, device="cpu")
        assert got == [sum(w << (32 * i) for i, w in enumerate(state))], p2
    assert "jax" not in sys.modules
    assert not any(m == "gf2bv_tpu" or m.startswith("gf2bv_tpu.") for m in sys.modules)
    assert _cuda._lib is None
    print("STANDALONE_OK")
    """
)


def test_import_and_solve_without_jax(tmp_path):
    stub_dir = tmp_path / "bin"
    stub_dir.mkdir()
    marker = tmp_path / "nvcc_ran"
    stub = stub_dir / "nvcc"
    stub.write_text(f"#!/bin/sh\ntouch {marker}\nexit 1\n")
    stub.chmod(0o755)
    env = dict(os.environ)
    env["PATH"] = f"{stub_dir}{os.pathsep}{env.get('PATH', '')}"
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "STANDALONE_OK" in res.stdout
    assert not marker.exists(), "nvcc ran during import or a CPU solve"

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
    lin = LinearSystem([32] * 8, backend="blocked", device="cpu")
    v = lin.gens()
    sym = MersenneTwister(list(v), **params)
    zeros = [sym() ^ o for o in outs] + [v[0] ^ 0x80000000]
    assert lin.solve_one(zeros) == tuple(state), lin.solve_one(zeros)
    # 256 columns: no backend named takes the per-pivot solver
    assert LinearSystem([32] * 8, device="cpu").solve_one(zeros) == tuple(state)
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
    from gf2bv_tpu_torch.crypto import (
        bm, crc, gf2m, php, sfmt, taus, well, xorshift, xoshiro,
    )
    from gf2bv_tpu_torch.utils import matviz, serialization
    from gf2bv_tpu_torch import IncrementalSolver, m4ri_solve

    inc = IncrementalSolver(lin, zeros[:4])
    inc.add(zeros[4:])
    assert inc.solve_one() == tuple(state) and inc.dimension == 0
    assert m4ri_solve([0b010 ^ 1, 0b100], 2, 0, device="cpu") == 1
    assert crc.CRC32().process(int.from_bytes(b"123456789", "little"), 72) == 0xCBF43926
    assert matviz.system_matrix_png(lin, zeros)[1:4] == b"PNG"

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
    from gf2bv_tpu_torch.parallel import (
        collectives, distributed, mesh, multi_rhs_sharded, rowshard, rowshard_blocked,
        rowshard_tournament, solve_sharded,
    )
    from gf2bv_tpu_torch.utils import profiling, timing
    from gf2bv_tpu_torch.entry import dryrun_multichip, entry

    m = mesh.make_mesh(batch=1, rows=2, devices=["cpu"] * 2)
    from gf2bv_tpu_torch.core import packing
    assert packing.words_to_int(solve_sharded(lin.get_eqs_packed(zeros), lin.cols, 0, m,
                                              k_panel=64)) == \
        sum(w << (32 * i) for i, w in enumerate(state))
    assert tmpl.solve_raw_batch([outs, outs], 0, mesh=mesh.make_mesh(
        batch=2, devices=["cpu"] * 2)) == [sum(w << (32 * i) for i, w in enumerate(state))] * 2
    with profiling.device_trace():
        profiling.phase_report()
    dryrun_multichip(4, device="cpu")
    fn, args = entry(device="cpu")
    assert not bool(fn(*args)[1])
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

"""Multi-process validation of the port's sharded solvers: 2 and 4 gloo
processes with two CPU shards each solve one row-sharded system over the
world's mesh (scripts/multihost_worker_torch.py, which reads its world from
GF2BV_TPU_COORD / _NPROC / _PROC_ID), as tests/test_multihost.py does for
the JAX package, and a world joined again after ``shutdown``.
Subprocesses, because a process group is per process; each has a timeout."""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(nproc, *args):
    worker = REPO / "scripts" / "multihost_worker_torch.py"
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), *args], cwd=REPO,
            env=dict(os.environ, OMP_NUM_THREADS="1", GF2BV_TPU_COORD=f"localhost:{port}",
                     GF2BV_TPU_NPROC=str(nproc), GF2BV_TPU_PROC_ID=str(pid)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed: {err[-2000:]}"
        assert f"OK ({nproc} processes, {2 * nproc} shards)" in out


@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_rowsharded_solve(nproc):
    _run_workers(nproc)


def test_multi_process_reinitialize():
    """initialize, shutdown, initialize: 4 processes on a (2, 4) mesh, whose
    rows axis needs a sub-group of two processes in each world."""
    _run_workers(4, "--reinit", f"localhost:{_free_port()}")

"""Worker of tests/test_torch_multihost.py: one of N gloo processes with two
CPU shards each, solving row-sharded systems of the port over the world's
mesh.  It finds its world as a user's process would, in the environment:

    GF2BV_TPU_COORD=localhost:PORT GF2BV_TPU_NPROC=N GF2BV_TPU_PROC_ID=I \
        python scripts/multihost_worker_torch.py

Every process runs the same solves; each must equal the oracle's answer.
With ``--reinit HOST:PORT`` it instead solves on a (2, N) mesh, leaves the
world, joins a second one at that address and solves again.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo root

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gf2bv_tpu_torch.core import packing  # noqa: E402
from gf2bv_tpu_torch.ops import solver  # noqa: E402
from gf2bv_tpu_torch.parallel import collectives, distributed  # noqa: E402
from gf2bv_tpu_torch.parallel import mesh as meshlib  # noqa: E402
from gf2bv_tpu_torch.parallel.multi_rhs_sharded import solve_multi_rhs_sharded  # noqa: E402
from gf2bv_tpu_torch.parallel.rowshard_blocked import solve_rowsharded_blocked  # noqa: E402
from gf2bv_tpu_torch.parallel.rowshard_tournament import (  # noqa: E402
    solve_rowsharded_tournament,
)


def _system():
    cols = 96
    rng = np.random.default_rng(42)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(128, cols)).astype(np.uint8)
    rhs = (coeff @ secret) % 2
    eqs = packing.pack_bits(np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols)
    return eqs, cols, coeff, rng, solver.solve(eqs, cols, 0, backend="oracle")


def _solve_on_batch_rows(eqs, cols, want, nproc):
    """Two batch rows: a rows group per batch row (their own process group
    when a row spans processes, none when one process holds it)."""
    mesh2 = meshlib.make_mesh(batch=2, rows=nproc, devices=["cpu", "cpu"])
    got2 = solve_rowsharded_tournament(eqs, cols, 0, mesh2, k_panel=64)
    assert packing.words_to_int(got2) == want, "tournament on a (2, n) mesh mismatch"


def _solve_all(nproc):
    shards = 2 * nproc
    mesh = meshlib.make_mesh(batch=1, rows=shards, devices=["cpu", "cpu"])
    assert distributed.is_multi_process() and mesh.shape["rows"] == shards
    eqs, cols, coeff, rng, want = _system()

    collectives.reset_counts()
    got = solve_rowsharded_blocked(eqs, cols, 0, mesh, k_panel=64)
    assert packing.words_to_int(got) == want, "multi-process blocked solve mismatch"
    assert collectives.COUNTS["pmin"] == collectives.COUNTS["psum"] == cols
    assert collectives.COUNTS["readout"] == 1  # the rref read whole for extraction
    collectives.reset_counts()
    got_t = solve_rowsharded_tournament(eqs, cols, 0, mesh, k_panel=64)
    assert packing.words_to_int(got_t) == want, "multi-process tournament mismatch"
    assert collectives.COUNTS == {"pmin": 0, "psum": 1, "pmax": 1, "all_gather": 2,
                                  "readout": 0}, collectives.COUNTS
    space = solve_rowsharded_tournament(eqs, cols, 1, mesh, k_panel=64)
    assert packing.words_to_int(space[0]) == want and space[1].shape[0] == 0

    _solve_on_batch_rows(eqs, cols, want, nproc)

    # multi-RHS over the world's batch axis: no collective, results read out
    coeff0 = np.concatenate([np.zeros((128, 1), np.uint8), coeff], axis=1)
    a32 = packing.pad2d(packing.to_u32(packing.pack_bits(coeff0, 1 + cols)),
                        row_align=256, word_align=128)
    secrets = rng.integers(0, 2, size=(2 * shards + 1, cols)).astype(np.uint8)
    rhs_b = (secrets @ coeff.T % 2).astype(np.uint8)
    collectives.reset_counts()
    got_m = solve_multi_rhs_sharded(a32, cols, rhs_b, 0,
                                    mesh=meshlib.make_mesh(batch=shards, rows=1,
                                                           devices=["cpu", "cpu"]))
    assert got_m == [int.from_bytes(np.packbits(s, bitorder="little").tobytes(), "little")
                     for s in secrets], "multi-process multi-RHS mismatch"
    assert collectives.COUNTS["all_gather"] == collectives.COUNTS["psum"] == 0


def _reinitialize(address, nproc):
    """A second world after ``shutdown``, at a new address: the sub-groups of
    the first world are gone, and the same mesh makes its groups anew."""
    eqs, cols, _, _, want = _system()
    _solve_on_batch_rows(eqs, cols, want, nproc)
    distributed.shutdown()
    assert not collectives._GROUPS and not distributed.is_multi_process()
    distributed.initialize(coordinator_address=address, device="cpu")
    assert distributed.world_size() == nproc
    _solve_on_batch_rows(eqs, cols, want, nproc)


def main() -> int:
    torch.set_num_threads(1)
    reinit = sys.argv[2] if sys.argv[1:2] == ["--reinit"] else None
    distributed.initialize(device="cpu")  # GF2BV_TPU_COORD / _NPROC / _PROC_ID
    pid, nproc = distributed.rank_and_world()
    try:
        if reinit is None:
            _solve_all(nproc)
        else:
            _reinitialize(reinit, nproc)
        assert "jax" not in sys.modules
        print(f"proc {pid}: OK ({distributed.world_size()} processes, {2 * nproc} shards)",
              flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

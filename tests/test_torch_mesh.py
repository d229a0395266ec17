"""Meshes and collectives of the port (gf2bv_tpu_torch/parallel/mesh.py,
collectives.py) on the CPU: ``make_mesh`` follows the JAX package's
arithmetic on the same device counts, ``Sharding`` places each block where
the reference's ``NamedSharding`` would, and the four collectives return
what ``lax.pmin`` / ``psum`` / ``pmax`` / ``all_gather`` return on every
shard, one round each."""

import numpy as np
import pytest
import torch

import jax

from gf2bv_tpu.parallel import mesh as mesh_jax
from gf2bv_tpu_torch.parallel import collectives, distributed
from gf2bv_tpu_torch.parallel import mesh as meshlib


@pytest.mark.parametrize("batch,rows", [(None, None), (2, None), (None, 4), (2, 4), (8, 1),
                                        (1, 8)])
def test_make_mesh_matches_jax(batch, rows):
    got = meshlib.make_mesh(batch=batch, rows=rows, devices=["cpu"] * 8)
    want = mesh_jax.make_mesh(batch=batch, rows=rows, devices=jax.devices()[:8])
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)
    assert not got.procs.any()


def test_make_mesh_errors():
    with pytest.raises(ValueError, match="3x2 != 8"):
        meshlib.make_mesh(batch=3, rows=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="3x2 != 8"):
        mesh_jax.make_mesh(batch=3, rows=2, devices=jax.devices()[:8])
    if not torch.cuda.is_available():  # the default is every CUDA device, no CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            meshlib.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            meshlib.make_mesh(devices=["cuda"])
    with pytest.raises(TypeError, match="Mesh"):
        meshlib.require_mesh("rows")
    with pytest.raises(ValueError, match="rank-major"):
        meshlib.Mesh(np.array([[torch.device("cpu")] * 2], dtype=object), procs=[1, 0])
    assert distributed.world_size() == 1 and not distributed.is_multi_process()


def test_mesh_key():
    a = meshlib.make_mesh(batch=2, rows=4, devices=["cpu"] * 8)
    assert meshlib._mesh_key(a) == meshlib._mesh_key(
        meshlib.make_mesh(batch=2, rows=4, devices=["cpu"] * 8))
    assert meshlib._mesh_key(a) != meshlib._mesh_key(
        meshlib.make_mesh(batch=4, rows=2, devices=["cpu"] * 8))


def test_sharding_places_blocks():
    mesh = meshlib.make_mesh(batch=2, rows=4, devices=["cpu"] * 8)
    rows = meshlib.rows_sharding(mesh)
    assert (rows.size, rows.positions, rows.ranks) == (4, [0, 1, 2, 3], [0])
    x = np.arange(8 * 3, dtype=np.uint32).reshape(8, 3)
    parts = rows.split(x)
    assert [p.dtype for p in parts] == [torch.int32] * 4
    assert np.array_equal(torch.cat(parts).numpy().view(np.uint32), x)
    batch = meshlib.batch_sharding(mesh)
    assert (batch.size, batch.positions) == (2, [0, 1])
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert [p.tolist() for p in batch.split(t)] == [[[0, 1, 2]], [[3, 4, 5]]]
    with pytest.raises(ValueError, match="not a multiple"):
        rows.split(x[:6])


def test_collectives_on_cpu_shards():
    sh = meshlib.rows_sharding(meshlib.make_mesh(batch=1, rows=4, devices=["cpu"] * 4))
    xs = [torch.tensor([3, -5, 7], dtype=torch.int32) * (i + 1) for i in range(4)]
    collectives.reset_counts()
    assert collectives.pmin(sh, xs).tolist() == [3, -20, 7]
    assert collectives.pmax(sh, xs).tolist() == [12, -5, 28]
    # one-hot words, as the solvers sum them: the sum is the set word, bit 31 too
    onehot = [torch.zeros(2, dtype=torch.int32) for _ in range(4)]
    onehot[2][1] = -(2**31)
    onehot[1][0] = 5
    assert collectives.psum(sh, onehot).tolist() == [5, -(2**31)]
    g = collectives.all_gather(sh, [x[None, :2] for x in xs])
    assert g.shape == (4, 1, 2) and g[:, 0, 0].tolist() == [3, 6, 9, 12]
    assert collectives.COUNTS == {"pmin": 1, "psum": 1, "pmax": 1, "all_gather": 1,
                                  "readout": 0}
    assert [r.tolist() for r in collectives.readout(sh, xs)] == [x.tolist() for x in xs]
    assert collectives.COUNTS["readout"] == 0  # nothing crossed a process

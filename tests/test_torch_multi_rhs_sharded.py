"""Mesh-sharded multi-RHS, the captured batch and the sweep over a mesh, and
batches over a mesh: the port (gf2bv_tpu_torch/parallel/) against the JAX
package's, on the CPU.

The JAX side runs on its 8-device virtual CPU mesh, the port on a mesh of
CPU shards of the same shape.  Inputs are made from numpy seeds.  Tolerance
0: the coefficient matrix is shared and the RREF unique, so per-instance
origins, verdicts and the mode-1 basis are equal entry by entry.  The
sharded multi-RHS solver makes no collective at all.
"""

import random

import numpy as np
import pytest
import torch

import jax

import gf2bv_tpu
from gf2bv_tpu.core import packing
from gf2bv_tpu.crypto.lfsr import GaloisLFSR as GaloisLFSR_jax
from gf2bv_tpu.ops import multi_rhs as mr_jax
from gf2bv_tpu.ops.gauss_blocked import _pad
from gf2bv_tpu.parallel import batch as pbatch_jax
from gf2bv_tpu.parallel import mesh as mesh_jax
from gf2bv_tpu.parallel import multi_rhs_sharded as mrs_jax
from gf2bv_tpu_torch import LinearSystem
from gf2bv_tpu_torch.crypto.lfsr import GaloisLFSR
from gf2bv_tpu_torch.ops import multi_rhs
from gf2bv_tpu_torch.parallel import batch as pbatch
from gf2bv_tpu_torch.parallel import collectives
from gf2bv_tpu_torch.parallel import mesh as meshlib
from gf2bv_tpu_torch.parallel import multi_rhs_sharded as mrs

from test_solver import random_system

torch.set_num_threads(2)

COLS = 300


def _mesh(batch, rows=1):
    return meshlib.make_mesh(batch=batch, rows=rows, devices=["cpu"] * (batch * rows))


def _mesh_jax(batch, rows=1):
    return mesh_jax.make_mesh(batch=batch, rows=rows, devices=jax.devices()[: batch * rows])


def _structure(rng, rows=340):
    bits = rng.integers(0, 2, size=(rows, 1 + COLS), dtype=np.uint8)
    bits[rows - 3:] = bits[:3]  # slight rank deficiency
    return bits, _pad(packing.pack_bits(bits, 1 + COLS), 256, word_align=128)


def _instances(rng, bits, nb):
    """Random solutions -> consistent affine columns, with planted unsats."""
    rows = bits.shape[0]
    rhs = np.zeros((nb, rows), np.uint8)
    for k in range(nb):
        x = rng.integers(0, 2, size=COLS).astype(np.uint8)
        rhs[k] = (bits[:, 1:] @ x) % 2
        if k % 7 == 3:  # a flipped bit of a duplicated row
            rhs[k, rows - 1] ^= 1
    return rhs


def _same(got, want, mode):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        if mode == 0:
            assert g == w
        else:
            assert np.array_equal(g.origin, w.origin) and np.array_equal(g.basis, w.basis)


@pytest.mark.parametrize("shards", [8, 3])
@pytest.mark.parametrize("mode", [0, 1])
def test_sharded_matches_jax(mode, shards):
    """41 instances over 8 shards (6 a shard, the last one short) or 3."""
    rng = np.random.default_rng(0x5A5)
    bits, a32 = _structure(rng)
    rhs = _instances(rng, bits, 41)
    collectives.reset_counts()
    got = mrs.solve_multi_rhs_sharded(a32, COLS, rhs, mode, mesh=_mesh(shards))
    assert all(v == 0 for v in collectives.COUNTS.values())  # no collective at all
    want = mrs_jax.solve_multi_rhs_sharded(a32, COLS, rhs, mode, mesh=_mesh_jax(shards))
    _same(got, want, mode)
    _same(got, multi_rhs.solve_multi_rhs(a32, COLS, rhs, mode, device="cpu"), mode)
    assert any(g is None for g in got) and any(g is not None for g in got)


def test_sharded_mode1_shares_one_basis():
    rng = np.random.default_rng(0x7B1)
    bits, a32 = _structure(rng, rows=280)  # underdetermined: a nonempty basis
    rhs = _instances(rng, bits, 17)
    cache: dict = {}
    got = mrs.solve_multi_rhs_sharded(a32, COLS, rhs, 1, mesh=_mesh(8), basis_cache=cache)
    assert cache["basis"].shape[0] > 0
    for sp in got:
        if sp is not None:
            assert np.shares_memory(sp._basis, cache["basis"])


@pytest.mark.parametrize("nb,n_dev", [(41, 8), (5, 8), (64, 4), (1, 1)])
def test_pack_shard_blocks_matches_jax(nb, n_dev):
    rng = np.random.default_rng(nb)
    inst = rng.integers(0, 2, size=(nb, 300), dtype=np.uint8)
    got, bw = mrs.pack_shard_blocks(inst, nb, n_dev, 512, multi_rhs._pack_rhs)
    want, bw_j = mrs_jax.pack_shard_blocks(inst, nb, n_dev, 512, mr_jax._pack_rhs)
    assert bw == bw_j and np.array_equal(got, want)


def test_shard_capacity_and_errors():
    rng = np.random.default_rng(2)
    bits, a32 = _structure(rng)
    rhs = _instances(rng, bits, 4)
    mesh, n_dev, cap = mrs.shard_capacity(_mesh(4))
    assert (n_dev, cap) == (4, 4 * multi_rhs.MAX_RHS)
    assert mrs_jax.shard_capacity(_mesh_jax(4))[1:] == (n_dev, cap)
    with pytest.raises(ValueError, match="batch axis"):
        mrs.solve_multi_rhs_sharded(a32, COLS, rhs, 0, mesh=_mesh(2, 2))
    with pytest.raises(ValueError, match="requires nb"):
        mrs.solve_multi_rhs_sharded(a32, COLS, None, 0, mesh=_mesh(2),
                                    rhs_packed=np.zeros((a32.shape[0], 2), np.uint32))
    with pytest.raises(ValueError, match="n_dev \\* bucket"):
        mrs.solve_multi_rhs_sharded(a32, COLS, None, 0, mesh=_mesh(2), nb=70,
                                    rhs_packed=np.zeros((a32.shape[0], 2), np.uint32))
    big = np.zeros((2 * multi_rhs.MAX_RHS + 1, bits.shape[0]), np.uint8)
    with pytest.raises(ValueError, match="chunk the batch"):
        mrs.solve_multi_rhs_sharded(a32, COLS, big, 0, mesh=_mesh(2))
    with pytest.raises(TypeError, match="Mesh"):
        mrs.shard_capacity(object())
    assert mrs.solve_multi_rhs_sharded(a32, COLS, rhs[:0], 0, mesh=_mesh(2)) == []


WIDTH, TAPS = 48, (1 << 47) | (1 << 20) | 0b1011


def _lfsr_model(cls):
    def model(gens, p):
        (x,) = gens
        sym = cls(WIDTH, TAPS, x)
        return [sym() ^ p[i] for i in range(60)]
    return model


def test_captured_batch_through_mesh_matches_jax():
    batch = []
    for k in range(11):
        s = GaloisLFSR(WIDTH, TAPS, random.Random(900 + k).getrandbits(WIDTH) | 1)
        batch.append([s() for _ in range(60)])
    batch[4][7] ^= 1  # an unsatisfiable instance
    tmpl = LinearSystem([WIDTH], device="cpu").capture(_lfsr_model(GaloisLFSR))
    tmpl_j = gf2bv_tpu.LinearSystem([WIDTH]).capture(_lfsr_model(GaloisLFSR_jax))
    collectives.reset_counts()
    got = tmpl.solve_raw_batch(batch, 0, mesh=_mesh(8))
    assert all(v == 0 for v in collectives.COUNTS.values())
    assert got == tmpl_j.solve_raw_batch(batch, 0, mesh=_mesh_jax(8))
    assert got == tmpl.solve_raw_batch(batch, 0)
    assert sum(r is not None for r in got) == len(batch) - 1 and got[4] is None
    with pytest.raises(ValueError, match="batch axis"):
        tmpl.solve_raw_batch(batch, 0, mesh=_mesh(4, 2))


def test_sweep_through_mesh_matches_jax():
    width, taps = 56, (1 << 55) | (1 << 23) | 0b1011
    key = random.Random(77).getrandbits(width) | 1
    stream = GaloisLFSR(width, taps, key)
    observed = [stream() for _ in range(50)]
    results = []
    for pkg, lfsr, mesh in ((gf2bv_tpu, GaloisLFSR_jax, _mesh_jax(8)),
                            (None, GaloisLFSR, _mesh(8))):
        lin = pkg.LinearSystem([width]) if pkg else LinearSystem([width], device="cpu")
        (x,) = lin.gens()
        sym = lfsr(width, taps, x)
        zeros = [sym() ^ o for o in observed]
        guesses = [x[i] for i in range(width - 7, width)]  # 128 candidates
        results.append((lin.solve_one_sweep(zeros, guesses, mesh=mesh),
                        lin.solve_one_sweep(zeros, guesses)))
    (j_mesh, j_one), (t_mesh, t_one) = results
    assert t_mesh == j_mesh == t_one == j_one
    assert any(s is not None and s[0] == key for s in t_mesh)


# -- batches over a mesh (parallel/batch.py) --------------------------------

@pytest.mark.parametrize("shape", [(8, 1), (2, 4), (3, 1)])
@pytest.mark.parametrize("mode", [0, 1])
def test_solve_batch_over_mesh_matches_jax(shape, mode):
    rng = np.random.default_rng(17)
    mats = []
    for i in range(5):  # not a multiple of the batch axis
        eqs, _ = random_system(rng, 48 + 8 * i, 40, rank_deficit=i % 3, inconsistent=(i == 3))
        mats.append(eqs)
    got = pbatch.solve_batch(mats, 40, mode, mesh=_mesh(*shape))
    want = pbatch_jax.solve_batch(mats, 40, mode, mesh=_mesh_jax(*shape))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None and mode == 0:
            assert np.array_equal(g, w)
        elif g is not None:
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


def test_solve_batch_wide_ignores_mesh():
    eqs, secret = random_system(np.random.default_rng(31), 2080, 2048)
    with pytest.warns(UserWarning, match="mesh is not used"):
        got = pbatch.solve_batch([eqs], 2048, 0, mesh=_mesh(2), device="cpu")
    assert np.array_equal(got[0], packing.pack_bits(secret[None, :], 2048)[0])


def test_system_batches_over_mesh_match_jax():
    lin = LinearSystem([16], device="cpu")
    (x,) = lin.gens()
    lin_j = gf2bv_tpu.LinearSystem([16])
    (xj,) = lin_j.gens()
    secrets = [0xBEE5 + i for i in range(9)]
    batch = [[x ^ s] for s in secrets] + [[x[0] ^ 1, x[0]]]
    batch_j = [[xj ^ s] for s in secrets] + [[xj[0] ^ 1, xj[0]]]
    got = pbatch.solve_batch_systems(lin, batch, mode=0, mesh=_mesh(8))
    assert got == pbatch_jax.solve_batch_systems(lin_j, batch_j, mode=0, mesh=_mesh_jax(8))
    assert got == secrets + [None]
    one = lin.solve_one_batch(batch, mesh=_mesh(2, 4))
    assert one == lin_j.solve_one_batch(batch_j, mesh=_mesh_jax(2, 4))
    lin6 = LinearSystem([6], device="cpu")
    (y,) = lin6.gens()
    lin6_j = gf2bv_tpu.LinearSystem([6])
    (yj,) = lin6_j.gens()
    gens = lin6.solve_all_batch([[(y & 0b11) ^ 0b10], [y ^ 5], [y[0] ^ 1, y[0]]],
                                mesh=_mesh(4))
    gens_j = lin6_j.solve_all_batch([[(yj & 0b11) ^ 0b10], [yj ^ 5], [yj[0] ^ 1, yj[0]]],
                                    mesh=_mesh_jax(4))
    assert sorted(gens[0]) == sorted(gens_j[0]) == [(v,) for v in range(2, 64, 4)]
    assert list(gens[1]) == [(5,)] and gens[2] is None and gens_j[2] is None


def test_native_backend_warns_and_ignores_the_mesh():
    """Under the host engine the mesh is not used, as in the reference: the
    captured batch and the sweep warn and solve on the host."""
    from gf2bv_tpu_torch import _native

    if not _native.available():
        pytest.skip("the host C engine needs gcc")
    lin = LinearSystem([WIDTH], backend="native", device="cpu")
    tmpl = lin.capture(_lfsr_model(GaloisLFSR))
    key = random.Random(5).getrandbits(WIDTH) | 1
    s = GaloisLFSR(WIDTH, TAPS, key)
    outs = [s() for _ in range(60)]
    with pytest.warns(UserWarning, match="mesh is not used"):
        got = tmpl.solve_raw_batch([outs], 0, mesh=_mesh(2))
    assert got == tmpl.solve_raw_batch([outs], 0) and got[0] is not None
    (x,) = lin.gens()
    sym = GaloisLFSR(WIDTH, TAPS, x)
    zeros = [sym() ^ o for o in outs]
    with pytest.warns(UserWarning, match="mesh is not used"):
        swept = lin.solve_one_sweep(zeros, [x & 3], mesh=_mesh(2))
    assert swept == lin.solve_one_sweep(zeros, [x & 3])
    assert swept[key & 3] == (key,)

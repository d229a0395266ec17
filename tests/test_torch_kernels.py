"""Plain twins of the port's four Hopper kernels against the Pallas kernels.

Each CUDA kernel of gf2bv_tpu_torch has a plain PyTorch twin with the same
contract; on the CPU the wrappers run the twin.  Here the same seeded numpy
inputs go through the Pallas kernel (interpret mode) and through the port's
wrapper on CPU tensors.  Tolerance 0: integer GF(2) arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu.ops.gauss_blocked import rank_k_update_jnp
from gf2bv_tpu.ops.pallas_phase1 import _call_scan_kernel, phase1_reconstruct
from gf2bv_tpu.ops.pallas_update import panel_update_mxu, panel_update_mxu_seg
from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import panel_update, phase1

torch.set_num_threads(2)

ROWS = 512
# (K, w0, cols): panels at the start, past a panel, crossing ``cols`` (some
# columns invalid) and wholly inside a wide system
PANELS = [
    (64, 0, 5000),
    (64, 2, 80),
    (64, 6, 100000),
    (256, 0, 5000),
    (256, 8, 300),
]


def t32(a):
    return u32_to_torch(a, "cpu")


def _panel(K, w0, seed):
    """A random (ROWS, 128) matrix, its panel slice and pre-used rows."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(ROWS, 128), dtype=np.uint32)
    bT = np.ascontiguousarray(a[:, w0 : w0 + K // 32].T)
    used = (rng.random((1, ROWS)) < 0.3).astype(np.int32)
    return rng, a, bT, used


def _jax_scan(bT, used, w0, K, cols):
    prow, used_o, cT = _call_scan_kernel(
        jnp.asarray(bT), jnp.asarray(used), jnp.asarray([w0], jnp.int32),
        K, cols, True,
    )
    return np.asarray(prow), np.asarray(used_o), np.asarray(cT)


@pytest.mark.parametrize("K,w0,cols", PANELS)
def test_scan_matches_pallas(K, w0, cols):
    _, _, bT, used = _panel(K, w0, seed=K + w0)
    prow_j, used_j, cT_j = _jax_scan(bT, used, w0, K, cols)
    prow_t, used_t, cT_t = phase1.scan(t32(bT), torch.from_numpy(used), w0, K, cols)
    assert (prow_j >= 0).any()
    assert np.array_equal(prow_t.numpy(), prow_j)
    assert np.array_equal(used_t.numpy(), used_j)
    assert np.array_equal(torch_to_u32(cT_t), cT_j)


@pytest.mark.parametrize("consistent", [True, False], ids=["solver", "arbitrary"])
@pytest.mark.parametrize("K,w0,cols", PANELS)
def test_reconstruct_matches_pallas(K, w0, cols, consistent):
    """``solver``: the pivot rows carry the scanned slice, as in the solver;
    ``arbitrary``: unrelated rows, which reach the kernel's triangular
    back-pass window."""
    rng, a, bT, used = _panel(K, w0, seed=K + w0)
    prow, _, cT = _jax_scan(bT, used, w0, K, cols)
    src = a if consistent else rng.integers(0, 2**32, size=a.shape, dtype=np.uint32)
    ps = np.maximum(prow, 0)
    arows = np.ascontiguousarray(src[ps])
    coeff = np.ascontiguousarray(cT[:, ps].T)
    want = np.asarray(
        phase1_reconstruct(
            jnp.asarray(arows), jnp.asarray(coeff), jnp.asarray(prow), w0, K,
            cols, True,
        )
    )
    got = phase1.reconstruct(t32(arows), t32(coeff), torch.from_numpy(prow.copy()), w0)
    assert np.array_equal(torch_to_u32(got), want)


def _update_inputs(rows, wp, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32)
    sel = rng.integers(0, 2**32, size=(rows, k // 32), dtype=np.uint32)
    pf = rng.integers(0, 2**32, size=(k, wp), dtype=np.uint32)
    return a, sel, pf


def test_update_full_matches_pallas():
    """Also against ``rank_k_update_jnp``, whose port is update_full_plain."""
    a, sel, pf = _update_inputs(256, 128, 128, seed=21)
    want = np.asarray(
        panel_update_mxu(jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), interpret=True)
    )
    got = panel_update.update_full(t32(a), t32(sel), t32(pf))
    assert np.array_equal(torch_to_u32(got), want)
    want_jnp = rank_k_update_jnp(jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf))
    assert np.array_equal(np.asarray(want_jnp), want)


@pytest.mark.parametrize("dead", [1, 2])
def test_update_seg_matches_pallas(dead):
    """Tile 0 (const word updated, words 1..127 as they were) and the live
    tiles must match; tiles [1, dead) are undefined in the reference."""
    a, sel, pf = _update_inputs(256, 384, 64, seed=22)
    want = np.asarray(
        panel_update_mxu_seg(
            jnp.asarray(a), jnp.asarray(sel), jnp.asarray(pf), dead, interpret=True
        )
    )
    got = torch_to_u32(panel_update.update_seg(t32(a), t32(sel), t32(pf), dead))
    assert np.array_equal(got[:, :128], want[:, :128])
    assert np.array_equal(got[:, dead * 128 :], want[:, dead * 128 :])
    assert np.array_equal(got[:, 1:128], a[:, 1:128])


def test_update_seg_rejects_bad_dead_tiles():
    a, sel, pf = _update_inputs(256, 384, 64, seed=23)
    for dead in (0, 3):
        with pytest.raises(ValueError):
            panel_update.update_seg(t32(a), t32(sel), t32(pf), dead)


def test_wrappers_reject_other_devices():
    """A wrapper runs the plain twin only for CPU tensors; other devices
    raise instead of silently taking either path."""
    a = torch.zeros((256, 128), dtype=torch.int32, device="meta")
    sel = torch.zeros((256, 2), dtype=torch.int32, device="meta")
    pf = torch.zeros((64, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        panel_update.update_full(a, sel, pf)
    with pytest.raises(ValueError, match="unsupported device"):
        phase1.scan(sel.T.contiguous(), a[:1, :], 0, 64, 100)

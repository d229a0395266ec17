"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance 0 everywhere (integer GF(2) arithmetic).
"""

import random

import numpy as np
import pytest
import torch

from gf2bv_tpu_torch import LinearSystem, torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.core import packing
from gf2bv_tpu_torch.ops import (
    _cuda, gauss_batched, gauss_blocked, launch_floor, multi_rhs, panel_update, phase1,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(rng, shape, dev):
    return u32_to_torch(rng.integers(0, 2**32, size=shape, dtype=np.uint32), dev)


@pytest.mark.parametrize("rows,K,w0,cols", [
    (512, 64, 0, 5000), (512, 64, 2, 80), (2048, 256, 8, 300),
    (3000, 256, 0, 10**6), (20224, 256, 160, 19968),
])
def test_scan_kernel(dev, rows, K, w0, cols):
    rng = np.random.default_rng(rows + K + w0)
    bT = _rand(rng, (K // 32, rows), dev)
    used = u32_to_torch((rng.random((1, rows)) < 0.3).astype(np.uint32), dev)
    got = phase1.scan(bT, used, w0, K, cols)
    want = phase1.scan_plain(bT, used, w0, K, cols)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("consistent", [True, False])
@pytest.mark.parametrize("K,w0,cols,wp", [(64, 2, 80, 128), (256, 8, 3000, 640)])
def test_reconstruct_kernel(dev, K, w0, cols, wp, consistent):
    rng = np.random.default_rng(K + w0 + wp)
    a = _rand(rng, (1024, wp), dev)
    bT = a[:, w0 : w0 + K // 32].T.contiguous()
    used = torch.zeros((1, 1024), dtype=torch.int32, device=dev)
    prow, _, cT = phase1.scan(bT, used, w0, K, cols)
    src = a if consistent else _rand(rng, (1024, wp), dev)
    ps = prow.clamp(min=0).long()
    arows, coeff = src[ps], cT[:, ps].T.contiguous()
    got = phase1.reconstruct(arows, coeff, prow, w0)
    want = phase1.reconstruct_plain(arows, coeff, prow, w0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows,wp,K", [(256, 128, 64), (300, 384, 256), (20224, 640, 256)])
def test_update_kernels(dev, rows, wp, K):
    rng = np.random.default_rng(rows + wp)
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, K // 32), dev)
    pf = _rand(rng, (K, wp), dev)
    got = panel_update.update_full(a.clone(), sel, pf)
    want = panel_update.update_full_plain(a.clone(), sel, pf)
    assert torch.equal(got, want)
    for dead in range(1, wp // 128):
        got = panel_update.update_seg(a.clone(), sel, pf, dead)
        want = panel_update.update_seg_plain(a.clone(), sel, pf, dead)
        assert torch.equal(got[:, :128], want[:, :128])
        assert torch.equal(got[:, 128 * dead :], want[:, 128 * dead :])
    torch.cuda.synchronize()


def test_wrapper_counts_launches(dev):
    rng = np.random.default_rng(5)
    a = _rand(rng, (256, 256), dev)
    sel = _rand(rng, (256, 2), dev)
    pf = _rand(rng, (64, 256), dev)
    _cuda.reset_launches()
    panel_update.update_full(a, sel, pf)
    panel_update.update_seg(a, sel, pf, 1)
    panel_update.update_full_plain(a, sel, pf)  # the twin is not a launch
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == {
        "scan": 0, "reconstruct": 0, "update_full": 1, "update_seg": 1,
        "update_trailing": 0, "scan_batched": 0, "reconstruct_batched": 0,
        "scan2": 0, "scan_minkey": 0, "phase1_fused": 0, "update_scan": 0,
        "update_pallas": 0, "update_mxu2": 0, "update_mxu4": 0, "launch_probe": 0,
    }


@pytest.mark.parametrize("B,rows,K,w0,cols", [
    (3, 512, 64, 2, 80), (4, 2048, 256, 8, 3000), (2, 20224, 256, 160, 19968),
])
def test_scan_batched_kernel(dev, B, rows, K, w0, cols):
    rng = np.random.default_rng(B + rows + K)
    bT = _rand(rng, (B, K // 32, rows), dev)
    used = u32_to_torch((rng.random((B, rows)) < 0.3).astype(np.uint32), dev)
    got = gauss_batched.scan_batched(bT, used, w0, K, cols)
    want = gauss_batched.scan_batched_plain(bT, used, w0, K, cols)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("consistent", [True, False])
@pytest.mark.parametrize("K,w0,cols,wp", [(64, 2, 80, 128), (256, 8, 3000, 640)])
def test_reconstruct_batched_kernel(dev, K, w0, cols, wp, consistent):
    rng = np.random.default_rng(K + w0 + wp + 1)
    B, rows = 3, 1024
    a = _rand(rng, (B, rows, wp), dev)
    bT = a[:, :, w0 : w0 + K // 32].transpose(1, 2).contiguous()
    used = torch.zeros((B, rows), dtype=torch.int32, device=dev)
    prow, _, cT = gauss_batched.scan_batched(bT, used, w0, K, cols)
    src = a if consistent else _rand(rng, (B, rows, wp), dev)
    ps = prow.clamp(min=0).long()
    arows = torch.gather(src, 1, ps[:, :, None].expand(B, K, wp)).contiguous()
    coeff = torch.gather(cT, 2, ps[:, None, :].expand(B, K // 32, K)).transpose(1, 2).contiguous()
    got = gauss_batched.reconstruct_batched(arows, coeff, prow, w0)
    want = gauss_batched.reconstruct_batched_plain(arows, coeff, prow, w0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows,wp,K", [(256, 200, 64), (300, 384, 256), (20224, 640, 256)])
def test_update_trailing_kernel(dev, rows, wp, K):
    """The whole matrix, for w0 in the first tile, on tile edges and in the
    last tile."""
    rng = np.random.default_rng(rows + wp + 2)
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, K // 32), dev)
    pf = _rand(rng, (K, wp), dev)
    for w0 in sorted({0, 8, 120, 128, 160, wp // 2, wp - 8} & set(range(wp))):
        got = panel_update.update_trailing(a.clone(), sel, pf, w0)
        want = panel_update.update_trailing_plain(a.clone(), sel, pf, w0)
        assert torch.equal(got, want), w0
    torch.cuda.synchronize()


@pytest.mark.parametrize("trailing", [False, True])
def test_rref_blocked_batched_cuda_matches_cpu(dev, trailing):
    rng = np.random.default_rng(13)
    cols, rows, B = 8190, 300, 3
    mats = [packing.pack_bits(rng.integers(0, 2, size=(rows, 1 + cols)).astype(np.uint8), 1 + cols)
            for _ in range(B)]
    a32 = np.stack([gauss_blocked._pad(m, 256, word_align=128) for m in mats])
    _cuda.reset_launches()
    got = gauss_batched.rref_blocked_batched(u32_to_torch(a32, dev), cols, 256, trailing)
    want = gauss_batched.rref_blocked_batched(u32_to_torch(a32, "cpu"), cols, 256, trailing)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    panels = a32.shape[2] // 8
    key = "update_trailing" if trailing else "update_full"
    assert _cuda.LAUNCHES["scan_batched"] == _cuda.LAUNCHES["reconstruct_batched"] == panels
    assert _cuda.LAUNCHES[key] == B * panels


@pytest.mark.parametrize("trailing", [False, True])
def test_rref_blocked_cuda_matches_cpu(dev, trailing):
    rng = np.random.default_rng(11)
    cols, rows = 8190, 300  # two 128-word tiles: trailing reaches dead_tiles 1
    bits = rng.integers(0, 2, size=(rows, 1 + cols)).astype(np.uint8)
    a32 = gauss_blocked._pad(packing.pack_bits(bits, 1 + cols), 256, word_align=128)
    got = gauss_blocked.rref_blocked(u32_to_torch(a32, dev), cols, 256, trailing)
    want = gauss_blocked.rref_blocked(u32_to_torch(a32, "cpu"), cols, 256, trailing)
    assert np.array_equal(torch_to_u32(got[1]), torch_to_u32(want[1]))  # pof
    if not trailing:
        assert np.array_equal(torch_to_u32(got[0]), torch_to_u32(want[0]))
        assert bool(got[2]) == bool(want[2])
    o_cuda, u_cuda = gauss_blocked.rref_origin_blocked(u32_to_torch(a32, dev), cols)
    o_cpu, u_cpu = gauss_blocked.rref_origin_blocked(u32_to_torch(a32, "cpu"), cols)
    assert np.array_equal(torch_to_u32(o_cuda), torch_to_u32(o_cpu))
    assert bool(u_cuda) == bool(u_cpu)


def test_batch_entry_points_cuda(dev):
    """solve_one_batch / solve_all_batch on the card agree with the CPU."""
    taps, n = (0, 1, 3, 4), 64

    def zeros_batch(lin, seeds):
        (s,) = lin.gens()
        out = []
        for seed in seeds:
            st, sym, zs = seed, s, []
            for _ in range(n):
                fb, fbs = 0, 0
                for t in taps:
                    fb ^= (st >> t) & 1
                    fbs = fbs ^ ((sym >> t) & 1)
                zs.append((sym & 1) ^ (st & 1))
                st = (st >> 1) | (fb << (n - 1))
                sym = (sym >> 1) | (fbs << (n - 1))
            out.append(zs)
        return out

    seeds = [random.Random(i).getrandbits(n) | 1 for i in range(3)]
    lin = LinearSystem([n], device=dev)
    lin_cpu = LinearSystem([n], device="cpu")
    got = lin.solve_one_batch(zeros_batch(lin, seeds))
    assert got == lin_cpu.solve_one_batch(zeros_batch(lin_cpu, seeds)) == [(s,) for s in seeds]
    spaces = lin.solve_all_batch(zeros_batch(lin, seeds))
    assert [list(g) for g in spaces] == [[(s,)] for s in seeds]


def test_linear_system_solve_one_cuda(dev):
    """Public API on the card: a lazily traced system of XOR/shift relations
    solves to the same point as on the CPU, and the point satisfies it."""
    rnd = random.Random(3)
    x, y = rnd.getrandbits(64), rnd.getrandbits(64)
    m64 = (1 << 64) - 1

    def zeros_of(lin):
        a, b = lin.gens()
        return [
            a ^ (b >> 1) ^ (x ^ (y >> 1)),
            b ^ (a << 3) ^ (y ^ ((x << 3) & m64)),
            (a >> 7) ^ b ^ ((x >> 7) ^ y),
        ]

    lin = LinearSystem([64, 64], device=dev)
    zeros = zeros_of(lin)
    sol = lin.solve_one(zeros)
    assert sol is not None
    assert sol == LinearSystem([64, 64], device="cpu").solve_one(
        zeros_of(LinearSystem([64, 64], device="cpu"))
    )
    assert all(lin.evaluate(z, sol) == 0 for z in zeros)


SCAN_SHAPES = [
    (512, 64, 0, 5000), (512, 64, 2, 80), (2048, 256, 8, 300),
    (3000, 256, 0, 10**6), (20224, 256, 160, 19968),
]


@pytest.mark.parametrize("rows,K,w0,cols", SCAN_SHAPES)
@pytest.mark.parametrize("variant", ["2", "m"])
def test_scan_variant_kernels(dev, variant, rows, K, w0, cols):
    rng = np.random.default_rng(rows + K + w0 + 3)
    bT = _rand(rng, (K // 32, rows), dev)
    used = u32_to_torch((rng.random((1, rows)) < 0.3).astype(np.uint32), dev)
    twin = {"2": phase1.scan2_plain, "m": phase1.scan_minkey_plain}[variant]
    key = {"2": "scan2", "m": "scan_minkey"}[variant]
    _cuda.reset_launches()
    got = phase1.scan(bT, used, w0, K, cols, variant)
    assert _cuda.LAUNCHES[key] == 1
    want = twin(bT, used, w0, K, cols)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got, phase1.scan_plain(bT, used, w0, K, cols)):
        assert torch.equal(g, w)


def test_minkey_reroute_on_the_card(dev):
    rows, K = 1 << 15, 64
    rng = np.random.default_rng(8)
    bT = _rand(rng, (K // 32, rows), dev)
    used = torch.zeros((1, rows), dtype=torch.int32, device=dev)
    _cuda.reset_launches()
    got = phase1.scan(bT, used, 0, K, 90, "m")
    assert _cuda.LAUNCHES["scan"] == 1 and _cuda.LAUNCHES["scan_minkey"] == 0
    for g, w in zip(got, phase1.scan_plain(bT, used, 0, K, 90)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rows,K,w0,cols,wp", [
    (512, 64, 2, 80, 128), (1024, 256, 8, 3000, 640), (20224, 256, 160, 19968, 640),
])
def test_phase1_fused_kernel(dev, rows, K, w0, cols, wp):
    rng = np.random.default_rng(rows + K + wp)
    a = _rand(rng, (rows, wp), dev)
    bT = a[:, w0 : w0 + K // 32].T.contiguous()
    used = u32_to_torch((rng.random((1, rows)) < 0.3).astype(np.uint32), dev)
    got = phase1.phase1_panel(a, bT, used, w0, K, cols)
    want = phase1.phase1_panel_plain(a, bT, used, w0, K, cols)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got, phase1.phase1_panel_split(a, bT, used, w0, K, cols)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rows,wp,K", [(256, 384, 64), (512, 640, 256), (20224, 640, 256)])
def test_update_scan_kernel(dev, rows, wp, K):
    rng = np.random.default_rng(rows + wp + 4)
    kw = K // 32
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, kw), dev)
    pf = _rand(rng, (K, wp), dev)
    used = u32_to_torch((rng.random((1, rows)) < 0.3).astype(np.uint32), dev)
    cols = 32 * wp - 40
    for w0 in (None, 0, 8, 128, 260, wp - kw):
        for w0n in (8, wp - kw, wp):
            bTn = _rand(rng, (kw, rows), dev)
            got = panel_update.update_scan(a.clone(), sel, pf, bTn, used, w0n, cols, w0)
            want = panel_update.update_scan_plain(a.clone(), sel, pf, bTn, used, w0n, cols, w0)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (w0, w0n)
    torch.cuda.synchronize()


ENGINES = [
    ("pallas_scan2", "mxu"), ("pallas_scanm", "mxu"), ("pallas", "mxu"),
    ("pallas_sub", "mxu"), ("pallas_scan", "mxu_la"), ("pallas_scan", "mxu_noseg"),
]


@pytest.mark.parametrize("p1,p2", ENGINES)
def test_engine_rref_cuda_matches_default(dev, p1, p2):
    """Each engine's whole RREF and mode-0 origin on the card equal the
    default engine's."""
    rng = np.random.default_rng(17)
    cols, rows = 8190, 2300  # two 128-word tiles; 9 row tiles: the la gate holds
    bits = rng.integers(0, 2, size=(rows, 1 + cols)).astype(np.uint8)
    a32 = gauss_blocked._pad(packing.pack_bits(bits, 1 + cols), 256, word_align=128)
    assert panel_update.la_grid(*a32.shape)[2] * 32 >= 256
    a = u32_to_torch(a32, dev)
    want = gauss_blocked.rref_blocked(a, cols, 256, False)
    got = gauss_blocked.rref_blocked(a, cols, 256, False, phase1=p1, phase2=p2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    o_w, u_w = gauss_blocked.rref_origin_blocked(a, cols)
    o_g, u_g = gauss_blocked.rref_origin_blocked(a, cols, phase1=p1, phase2=p2)
    assert torch.equal(o_g, o_w) and bool(u_g) == bool(u_w)


# -- the update engines pallas, mxu2, mxu4 and the launch probe ---------------------------

UPDATE_SHAPES = [(256, 128, 64), (300, 384, 256), (1000, 200, 96), (20224, 768, 256)]


@pytest.mark.parametrize("rows,wp,K", UPDATE_SHAPES + [(77, 13, 32)])
def test_update_pallas_kernel(dev, rows, wp, K):
    """The table kernel on aligned and ragged widths (wp % 4 != 0 takes the
    scalar loads) against the mask-and-XOR twin and the default update."""
    rng = np.random.default_rng(rows + wp + 5)
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, K // 32), dev)
    pf = _rand(rng, (K, wp), dev)
    _cuda.reset_launches()
    got = panel_update.update_pallas(a.clone(), sel, pf)
    assert _cuda.LAUNCHES["update_pallas"] == 1 and _cuda.LAUNCHES["update_full"] == 0
    torch.cuda.synchronize()
    assert torch.equal(got, panel_update.update_full(a.clone(), sel, pf))
    if rows <= 1000:
        assert torch.equal(got, panel_update.update_pallas_plain(a.clone(), sel, pf))


@pytest.mark.parametrize("rows,wp,K", UPDATE_SHAPES)
@pytest.mark.parametrize("name", ["mxu2", "mxu4"])
def test_update_mma_kernels(dev, name, rows, wp, K):
    """The tensor-core kernels, full and for w0 in the first tile, on tile
    edges and in the last tile: the whole matrix against the twin, so each
    engine's trailing rule is held."""
    kernel = getattr(panel_update, f"update_{name}")
    twin = getattr(panel_update, f"update_{name}_plain")
    rng = np.random.default_rng(rows + wp + 6)
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, K // 32), dev)
    pf = _rand(rng, (K, wp), dev)
    for w0 in [None] + sorted({0, 8, 127, 128, 160, 256, wp - 8} & set(range(wp))):
        _cuda.reset_launches()
        got = kernel(a.clone(), sel, pf, w0)
        assert _cuda.LAUNCHES[f"update_{name}"] == 1
        want = twin(a.clone(), sel, pf, w0)
        torch.cuda.synchronize()
        assert torch.equal(got, want), w0
    assert torch.equal(kernel(a.clone(), sel, pf), panel_update.update_full(a.clone(), sel, pf))


def test_launch_probe_kernel(dev):
    rng = np.random.default_rng(15)
    a = _rand(rng, launch_floor.PROBE_SHAPE, dev)
    _cuda.reset_launches()
    got = launch_floor.tiny_call(a)
    assert _cuda.LAUNCHES["launch_probe"] == 1
    assert torch.equal(got, launch_floor.tiny_call_plain(a)) and got.data_ptr() != a.data_ptr()
    floor = launch_floor.measure(dev, n=64)
    assert all(floor[k] > 0 for k in ("probe_us", "probe_python_us", "bitwise_xor_us",
                                      "update_tile_us"))


@pytest.mark.parametrize("p2", ["pallas", "mxu2", "mxu4", "jnp", "skip"])
def test_update_engine_rref_cuda_matches_default(dev, p2):
    rng = np.random.default_rng(19)
    cols, rows = 8190, 600
    bits = rng.integers(0, 2, size=(rows, 1 + cols)).astype(np.uint8)
    a32 = gauss_blocked._pad(packing.pack_bits(bits, 1 + cols), 256, word_align=128)
    a = u32_to_torch(a32, dev)
    got = gauss_blocked.rref_blocked(a, cols, 256, False, phase2=p2)
    if p2 == "skip":
        assert torch.equal(got[0], a)
        return
    want = gauss_blocked.rref_blocked(a, cols, 256, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    o_w, u_w = gauss_blocked.rref_origin_blocked(a, cols)
    o_g, u_g = gauss_blocked.rref_origin_blocked(a, cols, phase2=p2)
    assert torch.equal(o_g, o_w) and bool(u_g) == bool(u_w)


def test_multi_rhs_cuda_matches_cpu(dev):
    rng = np.random.default_rng(23)
    rows, cols, nb = 300, 260, 70
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    coeff[:, 40] = 0
    coeff[rows - 1] = coeff[0] ^ coeff[1]
    rhs = ((rng.integers(0, 2, size=(nb, cols)).astype(np.uint8) @ coeff.T) % 2).astype(np.uint8)
    rhs[::4, rows - 1] ^= 1
    bits = np.concatenate([np.zeros((rows, 1), np.uint8), coeff], axis=1)
    eqs = packing.pack_bits(bits, 1 + cols)
    a32 = gauss_blocked._pad(eqs, 256, word_align=128)
    for mode in (0, 1):
        want = multi_rhs.solve_multi_rhs(a32, cols, rhs, mode, device="cpu")
        for p2 in (None, "pallas", "mxu2", "mxu4"):
            got = multi_rhs.solve_multi_rhs(a32, cols, rhs, mode, phase2=p2, device=dev)
            for g, w in zip(got, want):
                if mode == 0 or w is None:
                    assert g == w
                else:
                    assert g.origin == w.origin and g.basis == w.basis

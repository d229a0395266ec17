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


# rows that take each route of the 1-pivot scan: one block, clusters of 2, 4, 8
# and 16 blocks, and the chained scan past the largest cluster
SCAN_ROUTE_SHAPES = [
    (512, 64, 0, 5000), (512, 64, 2, 80), (2048, 256, 8, 300),
    (3000, 256, 0, 10**6), (20224, 256, 160, 19968),
    (768, 256, 160, 19968), (1, 32, 1, 64), (255, 96, 0, 70), (5001, 256, 8, 10**6),
    (10000, 256, 8, 10**6), (40192, 256, 160, 19968), (20011, 128, 3, 200),
    (70001, 256, 8, 10**6),
]


@pytest.mark.parametrize("used_frac", [0.3, 0.0, 1.0, 0.25])
@pytest.mark.parametrize("rows,K,w0,cols", SCAN_ROUTE_SHAPES)
def test_scan_kernel(dev, rows, K, w0, cols, used_frac):
    """Every route against the twin: no row used, all used, some used;
    several shapes have columns outside 1..cols (bit 0 at w0 = 0, and a panel
    that crosses cols)."""
    rng = np.random.default_rng(rows + K + w0)
    bT = _rand(rng, (K // 32, rows), dev)
    used = u32_to_torch((rng.random((1, rows)) < used_frac).astype(np.uint32), dev)
    route = phase1.scan_route(rows, K // 32)
    _cuda.reset_launches()
    got = phase1.scan(bT, used, w0, K, cols)
    launches = route.chunks if route.kernel == "scan_chunked" else 1  # a launch a chunk
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {route.kernel: launches}
    want = phase1.scan_plain(bT, used, w0, K, cols)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_scan_routes_are_all_taken():
    taken = {(r.kernel, r.nblocks) for r in
             (phase1.scan_route(rows, K // 32) for rows, K, _, _ in SCAN_ROUTE_SHAPES)}
    assert taken == ({("scan", nb) for nb in phase1.SCAN_CLUSTER_SIZES}
                     | {("scan_chunked", phase1.SCAN_CLUSTER_SIZES[-1])})


@pytest.mark.parametrize("nblocks", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("rows,K,w0,cols", [(4000, 256, 8, 10**6), (20224, 64, 160, 5150)])
def test_scan_cluster_and_scan_block_kernels(dev, rows, K, w0, cols, nblocks):
    """Any cluster size that holds the state gives the twin's outputs; a
    cluster that cannot hold it raises instead of running something else."""
    rng = np.random.default_rng(rows + nblocks)
    bT = _rand(rng, (K // 32, rows), dev)
    used = u32_to_torch((rng.random((1, rows)) < 0.25).astype(np.uint32), dev)
    want = phase1.scan_plain(bT, used, w0, K, cols)
    if phase1.scan_fits(-(-rows // nblocks), K // 32):
        got = phase1.scan_cluster(bT, used, w0, K, cols, nblocks)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    else:
        with pytest.raises(RuntimeError, match="scan kernel"):
            phase1.scan_cluster(bT, used, w0, K, cols, nblocks)


# (K, w0, wp): the first, a middle and the last panel of 640- and 768-word rows,
# an unaligned width, and the narrower panels
RECONSTRUCT_SHAPES = [
    (64, 2, 128), (256, 8, 640), (256, 0, 640), (256, 160, 640), (256, 632, 640),
    (256, 0, 768), (256, 320, 768), (256, 760, 768), (256, 40, 333), (128, 4, 640),
    (128, 636, 640), (64, 0, 200), (32, 5, 13), (96, 3, 50), (224, 7, 77),
]


def _reconstruct_inputs(dev, K, w0, wp, kind, seed, B=None):
    """``solver``: the pivot rows of a scanned random matrix and their
    coefficients; ``inconsistent``: the scan's coefficients on unrelated
    rows; ``arbitrary``: random rows, random coefficients and about a tenth
    of prow at -1 (rows above the back pass's window with bit j set, rows
    k > j inside the group too).  With B: a (B, ...) stack of such systems."""
    rng = np.random.default_rng(seed)
    kw = K // 32
    nb, rows = B or 1, 1024
    cols = 32 * (w0 + kw) - 9  # the panel crosses cols: its last columns have no pivot
    if kind == "arbitrary":
        arows = _rand(rng, (nb, K, wp), dev)
        coeff = _rand(rng, (nb, K, kw), dev)
        prow = torch.from_numpy(np.where(rng.random((nb, K)) < 0.1, -1, 7).astype(np.int32)).to(dev)
    else:
        a = _rand(rng, (nb, rows, wp), dev)
        bT = a[:, :, w0 : w0 + kw].transpose(1, 2).contiguous()
        used = torch.zeros((nb, rows), dtype=torch.int32, device=dev)
        prow, _, cT = gauss_batched.scan_batched(bT, used, w0, K, cols)
        src = a if kind == "solver" else _rand(rng, (nb, rows, wp), dev)
        ps = prow.clamp(min=0).long()
        arows = torch.gather(src, 1, ps[:, :, None].expand(nb, K, wp)).contiguous()
        coeff = torch.gather(cT, 2, ps[:, None, :].expand(nb, kw, K)).transpose(1, 2).contiguous()
    if B is None:
        return arows[0].contiguous(), coeff[0].contiguous(), prow[0].contiguous()
    return arows, coeff, prow


@pytest.mark.parametrize("kind", ["solver", "inconsistent", "arbitrary"])
@pytest.mark.parametrize("K,w0,wp", RECONSTRUCT_SHAPES)
def test_reconstruct_kernel(dev, K, w0, wp, kind):
    arows, coeff, prow = _reconstruct_inputs(dev, K, w0, wp, kind, seed=K + w0 + wp)
    _cuda.reset_launches()
    got = phase1.reconstruct(arows, coeff, prow, w0)
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"reconstruct": 1}
    want = phase1.reconstruct_plain(arows, coeff, prow, w0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["solver", "arbitrary"])
@pytest.mark.parametrize("K,w0,wp", RECONSTRUCT_SHAPES)
def test_coefficient_solves_agree(dev, K, w0, wp, kind):
    """The blocked coefficient solve and both plain twins give the same T,
    for one system and for a batch; the launch is counted under its own name
    and never as a rebuild."""
    kw = K // 32
    for B in (None, 4):
        arows, coeff, prow = _reconstruct_inputs(dev, K, w0, wp, kind, seed=K + w0 + wp + 1, B=B)
        _cuda.reset_launches()
        new = phase1.reconstruct_coeff(arows, coeff, prow, w0)
        torch.cuda.synchronize()
        assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"reconstruct_coeff": 1}
        for b in range(B or 1):
            one = (lambda t: t if B is None else t[b])
            sl = one(arows)[:, w0 : w0 + kw].cpu().contiguous()
            args = (sl, one(coeff).cpu(), one(prow).cpu())
            want = phase1.reconstruct_coeff_plain(*args)
            assert torch.equal(one(new).cpu(), want)
            assert torch.equal(phase1.reconstruct_coeff_blocked_plain(*args), want)


def test_coefficient_solve_rejects_what_the_kernel_does_not_take(dev):
    arows, coeff, prow = _reconstruct_inputs(dev, 64, 2, 128, "arbitrary", seed=1)
    for fn in (phase1.reconstruct_coeff, phase1.reconstruct):
        with pytest.raises(ValueError, match="outside"):
            fn(arows, coeff, prow, 127)
        with pytest.raises(ValueError):
            fn(arows, coeff[:, :1].contiguous(), prow, 2)
    with pytest.raises(ValueError, match="expected"):
        phase1.reconstruct_coeff(arows[None, None], coeff[None, None], prow[None, None], 2)


# aligned widths, widths that are no multiple of 4 (scalar loads and stores), the
# look-ahead engine's (rows, 8) slice, rows that are no multiple of a row chunk
UPDATE_RULE_SHAPES = [(256, 128, 64), (300, 384, 256), (20224, 640, 256), (77, 13, 32),
                      (1000, 202, 96), (2048, 8, 256), (20224, 8, 256), (4100, 384, 256),
                      (33, 640, 128), (20224, 768, 256)]


@pytest.mark.parametrize("rows,wp,K", UPDATE_RULE_SHAPES)
def test_update_kernels(dev, rows, wp, K):
    """The whole matrix against the twins: the words outside an update's
    rule stay as they were, not copied through."""
    rng = np.random.default_rng(rows + wp)
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, K // 32), dev)
    pf = _rand(rng, (K, wp), dev)
    got = panel_update.update_full(a.clone(), sel, pf)
    want = panel_update.update_full_plain(a.clone(), sel, pf)
    assert torch.equal(got, want)
    for dead in range(1, wp // 128 if wp % 128 == 0 else 0):
        got = panel_update.update_seg(a.clone(), sel, pf, dead)
        want = panel_update.update_seg_plain(a.clone(), sel, pf, dead)
        assert torch.equal(got, want)
        assert torch.equal(got[:, 1 : 128 * dead], a[:, 1 : 128 * dead])
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
        "reconstruct_coeff": 0, "scan_chunked": 0, "scan_batched_chunked": 0,
        "phase1_fused_chunked": 0, "update_scan_chunked": 0, "scan2_chunked": 0,
        "scan_subset": 0, "scan_subset_test": 0,
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


@pytest.mark.parametrize("kind", ["solver", "inconsistent", "arbitrary"])
@pytest.mark.parametrize("K,w0,wp", RECONSTRUCT_SHAPES)
def test_reconstruct_batched_kernel(dev, K, w0, wp, kind):
    arows, coeff, prow = _reconstruct_inputs(dev, K, w0, wp, kind, seed=K + w0 + wp + 2, B=3)
    _cuda.reset_launches()
    got = gauss_batched.reconstruct_batched(arows, coeff, prow, w0)
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"reconstruct_batched": 1}
    want = gauss_batched.reconstruct_batched_plain(arows, coeff, prow, w0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows,wp,K", [(256, 200, 64), (300, 384, 256), (20224, 640, 256),
                                       (77, 13, 32), (2048, 8, 256), (4100, 384, 256),
                                       (1000, 202, 96), (20224, 768, 256)])
def test_update_trailing_kernel(dev, rows, wp, K):
    """The whole matrix, for w0 in the first tile, on tile edges and in the
    last tile."""
    rng = np.random.default_rng(rows + wp + 2)
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, K // 32), dev)
    pf = _rand(rng, (K, wp), dev)
    for w0 in sorted({0, 8, 120, 128, 160, wp // 2, wp - 8, wp - 1} & set(range(wp))):
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


@pytest.mark.parametrize("trailing", [False, True])
def test_rref_blocked_unaligned_width_cuda(dev, trailing):
    """A width that is not a multiple of K/32 words (a per-pivot cached
    matrix beside a 128-word RHS tile) runs padded on the card and comes
    back at its own width, as on the CPU."""
    rng = np.random.default_rng(12)
    cols, rows = 64, 256
    bits = rng.integers(0, 2, size=(rows, 1 + cols)).astype(np.uint8)
    raw = packing.to_u32(packing.pack_bits(bits, 1 + cols))
    rhs = rng.integers(0, 2**32, size=(rows, 128), dtype=np.uint32)
    a32 = np.concatenate([raw, rhs], axis=1)
    assert a32.shape[1] == 132  # 4 words of 65 bits, then the tile: not a multiple of 8
    got = gauss_blocked.rref_blocked(u32_to_torch(a32, dev), cols, 256, trailing)
    want = gauss_blocked.rref_blocked(u32_to_torch(a32, "cpu"), cols, 256, trailing)
    assert got[0].shape == a32.shape
    assert np.array_equal(torch_to_u32(got[1]), torch_to_u32(want[1]))  # pof
    if not trailing:
        assert np.array_equal(torch_to_u32(got[0]), torch_to_u32(want[0]))
        assert bool(got[2]) == bool(want[2])


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
    # 128 columns: auto takes the blocked kernels on the card; the per-pivot
    # solver agrees and launches none
    per_pivot = LinearSystem([64, 64], backend="jax", device=dev)
    _cuda.reset_launches()
    assert per_pivot.solve_one(zeros_of(per_pivot)) == sol
    assert not _cuda.LAUNCHES["scan"]
    _cuda.reset_launches()
    assert lin.solve_one(zeros) == sol
    assert _cuda.LAUNCHES["scan"] >= 1


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


# -- the kernels that carry the cluster scan inside another launch ---------------------

CLUSTER_ROWS = [300, 768, 2560, 20011, 20224, 40192]
VERY_TALL_ROWS = 67328  # past the largest cluster at K = 256


def _panels(kw, wp):
    """(w0, cols) of the first, a middle and the last panel of wp-word rows;
    the last one crosses cols."""
    return [(0, 32 * wp - 40), ((wp // 2) // kw * kw, 32 * wp - 40), (wp - kw, 32 * wp - 40)]


@pytest.mark.parametrize("kw", [2, 4, 8])
@pytest.mark.parametrize("rows", CLUSTER_ROWS)
@pytest.mark.parametrize("B", [1, 3, 4, 16])
def test_scan_batched_cluster_kernel(dev, B, rows, kw):
    """One cluster per system against the twin: systems with different used
    rows, the last one with every row used (no pivot at all), at the first, a
    middle and the last panel; the launch is counted under its kernel's
    name."""
    K = 32 * kw
    rng = np.random.default_rng(B + rows + kw)
    bT = _rand(rng, (B, kw, rows), dev)
    fracs = np.linspace(0.0, 0.6, B)[:, None]
    used_h = (rng.random((B, rows)) < fracs).astype(np.uint32)
    used_h[B - 1] = 1
    used = u32_to_torch(used_h, dev)
    route = phase1.scan_batched_route(B, rows, kw)
    assert route.kernel == "scan_batched"
    for w0, cols in _panels(kw, 640):
        _cuda.reset_launches()
        got = gauss_batched.scan_batched(bT, used, w0, K, cols)
        assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"scan_batched": 1}
        want = gauss_batched.scan_batched_plain(bT, used, w0, K, cols)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (w0, cols)
        assert int((got[0][B - 1] >= 0).sum()) == 0
        if B > 1:
            assert int((got[0][0] >= 0).sum()) > 0


@pytest.mark.parametrize("nblocks", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("B,rows,K", [(3, 4000, 256), (5, 20224, 64), (16, 20224, 256)])
def test_scan_batched_on_every_cluster_size(dev, B, rows, K, nblocks):
    """Any cluster size that holds a slice gives the twin's outputs, in as many
    waves as the card needs; one that cannot hold it raises instead of running
    something else."""
    rng = np.random.default_rng(B + rows + nblocks)
    bT = _rand(rng, (B, K // 32, rows), dev)
    used = u32_to_torch((rng.random((B, rows)) < 0.25).astype(np.uint32), dev)
    if phase1.scan_fits(-(-rows // nblocks), K // 32):
        got = gauss_batched.scan_batched_cluster(bT, used, 8, K, 10**6, nblocks)
        want = gauss_batched.scan_batched_plain(bT, used, 8, K, 10**6)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert phase1.scan_occupancy(rows, K // 32, nblocks) >= 1
    else:
        with pytest.raises(RuntimeError, match="scan_batched kernel"):
            gauss_batched.scan_batched_cluster(bT, used, 8, K, 10**6, nblocks)
        with pytest.raises(RuntimeError, match="occupancy"):
            phase1.scan_occupancy(rows, K // 32, nblocks)


@pytest.mark.parametrize("kw", [2, 4, 8])
@pytest.mark.parametrize("rows", CLUSTER_ROWS)
def test_update_scan_cluster_kernel(dev, rows, kw):
    """The cluster scan beside the table updates against the twin: full and
    trailing at the first, a middle and the last panel, the next panel's scan
    inside the matrix, at its last panel and past cols (the look-ahead's
    clamped slice: no valid column)."""
    K, wp = 32 * kw, 640 if kw == 8 else 384
    rng = np.random.default_rng(rows + kw + 9)
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, kw), dev)
    pf = _rand(rng, (K, wp), dev)
    used = u32_to_torch((rng.random((1, rows)) < 0.3).astype(np.uint32), dev)
    cols = 32 * wp - 40
    assert phase1.scan_route(rows, kw).kernel == "scan"
    for w0 in [None] + [w for w, _ in _panels(kw, wp)]:
        for w0n in (kw, wp - kw, wp):
            bTn = _rand(rng, (kw, rows), dev)
            _cuda.reset_launches()
            got = panel_update.update_scan(a.clone(), sel, pf, bTn, used, w0n, cols, w0)
            assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"update_scan": 1}
            want = panel_update.update_scan_plain(a.clone(), sel, pf, bTn, used, w0n, cols, w0)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (w0, w0n)
            if w0n == wp:
                assert int((got[1] >= 0).sum()) == 0


@pytest.mark.parametrize("nblocks", [1, 2, 4, 8, 16])
def test_update_scan_on_every_cluster_size(dev, nblocks):
    """The scan cluster's size is the launch's cluster size: every size that
    holds the slice gives the twin's outputs, an unaligned width included; one
    that cannot hold it raises."""
    rows, K, wp = 6000, 256, 202
    rng = np.random.default_rng(nblocks)
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, K // 32), dev)
    pf = _rand(rng, (K, wp), dev)
    bTn = _rand(rng, (K // 32, rows), dev)
    used = u32_to_torch((rng.random((1, rows)) < 0.3).astype(np.uint32), dev)
    args = (sel, pf, bTn, used, 8, 10**6)
    if phase1.scan_fits(-(-rows // nblocks), K // 32):
        for w0 in (None, 150):
            got = panel_update.update_scan_cluster(a.clone(), *args, w0, nblocks)
            want = panel_update.update_scan_plain(a.clone(), *args, w0)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), w0
    else:
        with pytest.raises(RuntimeError, match="update_scan kernel"):
            panel_update.update_scan_cluster(a.clone(), *args, None, nblocks)


def test_very_tall_slices_take_the_one_block_kernels(dev):
    """Past the largest cluster's rows the batched scan runs the chained scan
    and the fused update + scan its chained kernel (a launch a chunk), by the
    route and not after a failure."""
    rows, K, kw, wp = VERY_TALL_ROWS, 256, 8, 128
    assert phase1.scan_route(rows, kw).kernel == "scan_chunked"
    assert phase1.scan_batched_route(2, rows, kw).kernel == "scan_batched_chunked"
    route = panel_update.update_scan_route(rows, kw)
    assert route.kernel == "update_scan_chunked"
    rng = np.random.default_rng(67)
    bT = _rand(rng, (2, kw, rows), dev)
    used = u32_to_torch((rng.random((2, rows)) < 0.25).astype(np.uint32), dev)
    _cuda.reset_launches()
    got = gauss_batched.scan_batched(bT, used, 8, K, 10**6)
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"scan_batched_chunked": 2}
    for g, w in zip(got, gauss_batched.scan_batched_plain(bT, used, 8, K, 10**6)):
        assert torch.equal(g, w)
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, kw), dev)
    pf = _rand(rng, (K, wp), dev)
    _cuda.reset_launches()
    got = panel_update.update_scan(a.clone(), sel, pf, bT[0], used[:1], 16, 10**6, 8)
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"update_scan_chunked": route.chunks}
    want = panel_update.update_scan_plain(a.clone(), sel, pf, bT[0], used[:1], 16, 10**6, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(RuntimeError, match="scan_batched kernel"):
        gauss_batched.scan_batched_cluster(bT, used, 8, K, 10**6, 16)
    with pytest.raises(RuntimeError, match="update_scan kernel"):
        panel_update.update_scan_cluster(a, sel, pf, bT[0], used[:1], 16, 10**6, 8, 16)


# -- the min-key scan and the fused phase 1 as cluster kernels -------------------------

MINKEY_ROWS = [300, 768, 2560, 20011, 20224, 32767]


def _panels_cases(kw, wp):
    """(w0, cols) of the first, a middle and the last panel, and a panel with
    no valid column (cols = 0)."""
    return _panels(kw, wp) + [(kw, 0)]


@pytest.mark.parametrize("kw", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", MINKEY_ROWS)
def test_scan_minkey_cluster_kernel(dev, rows, kw):
    """The min-key cluster kernel against both twins, the min-key and the
    1-pivot one, at the first, a middle and the last panel, a panel with no
    valid column, and a system with every row used (no pivot); the launch
    counted under its kernel's name."""
    K = 32 * kw
    rng = np.random.default_rng(rows + kw + 17)
    bT = _rand(rng, (kw, rows), dev)
    route = phase1.scan_minkey_route(rows, kw)
    assert route.nblocks == phase1.scan_route(rows, kw).nblocks
    for frac in (0.3, 1.0):
        used = u32_to_torch((rng.random((1, rows)) < frac).astype(np.uint32), dev)
        for w0, cols in _panels_cases(kw, 640):
            _cuda.reset_launches()
            got = phase1.scan(bT, used, w0, K, cols, "m")
            assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"scan_minkey": 1}
            want = phase1.scan_minkey_plain(bT, used, w0, K, cols)
            torch.cuda.synchronize()
            for g, w, p in zip(got, want, phase1.scan_plain(bT, used, w0, K, cols)):
                assert torch.equal(g, w), (frac, w0, cols)
                assert torch.equal(g, p), (frac, w0, cols)
            if frac == 1.0 or cols == 0:
                assert int((got[0] >= 0).sum()) == 0


@pytest.mark.parametrize("nblocks", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("rows,K", [(4000, 256), (20224, 64), (32767, 256), (700, 96)])
def test_scan_minkey_on_every_cluster_size(dev, rows, K, nblocks):
    """Any cluster size that holds the state gives the twin's outputs, and
    the cluster twin's order on those blocks; one that cannot hold it
    raises instead of running something else."""
    rng = np.random.default_rng(rows + nblocks + 3)
    kw = K // 32
    bT = _rand(rng, (kw, rows), dev)
    used = u32_to_torch((rng.random((1, rows)) < 0.25).astype(np.uint32), dev)
    want = phase1.scan_minkey_plain(bT, used, 8, K, 10**6)
    if phase1.scan_fits(-(-rows // nblocks), kw, minkey=True):
        got = phase1.scan_minkey_cluster(bT, used, 8, K, 10**6, nblocks)
        torch.cuda.synchronize()
        for g, w, c in zip(got, want, phase1.scan_minkey_cluster_plain(
                bT.cpu(), used.cpu(), 8, K, 10**6, nblocks)):
            assert torch.equal(g, w)
            assert torch.equal(g.cpu(), c)
    else:
        with pytest.raises(RuntimeError, match="scan_minkey kernel"):
            phase1.scan_minkey_cluster(bT, used, 8, K, 10**6, nblocks)


FUSED_ROWS = [20224, 40192, VERY_TALL_ROWS]


@pytest.mark.parametrize("kw", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", FUSED_ROWS)
def test_phase1_fused_cluster_kernel(dev, rows, kw):
    """The fused phase 1 by its route (the cluster kernel, the chained kernel
    past the largest cluster) against its twin and the split engine: the
    first, a middle and the last panel, a panel with no valid column, and a
    system with every row used (no pivot)."""
    K, wp = 32 * kw, 640 if kw == 8 else 384
    rng = np.random.default_rng(rows + kw + 23)
    a = _rand(rng, (rows, wp), dev)
    route = phase1.phase1_fused_route(rows, kw)
    chained = rows == VERY_TALL_ROWS
    assert route.kernel == ("phase1_fused_chunked" if chained else "phase1_fused")
    for frac in (0.3, 1.0):
        used = u32_to_torch((rng.random((1, rows)) < frac).astype(np.uint32), dev)
        for w0, cols in _panels_cases(kw, wp):
            bT = a[:, w0 : w0 + kw].T.contiguous()
            _cuda.reset_launches()
            got = phase1.phase1_panel(a, bT, used, w0, K, cols)
            assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {
                route.kernel: route.chunks if chained else 1}
            want = phase1.phase1_panel_plain(a, bT, used, w0, K, cols)
            torch.cuda.synchronize()
            for g, w, sp in zip(got, want, phase1.phase1_panel_split(a, bT, used, w0, K, cols)):
                assert torch.equal(g, w), (frac, w0, cols)
                assert torch.equal(g, sp), (frac, w0, cols)
            if frac == 1.0 or cols == 0:
                assert int((got[1] >= 0).sum()) == 0 and int(got[0].abs().sum()) == 0


@pytest.mark.parametrize("nblocks", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("rows,wp,K", [(6000, 202, 256), (3000, 640, 256), (20224, 96, 64)])
def test_phase1_fused_on_every_cluster_size(dev, rows, wp, K, nblocks):
    """Every cluster size that holds the slice gives the twin's outputs, an
    unaligned width (scalar accesses in the product) included; one that
    cannot hold it raises."""
    rng = np.random.default_rng(rows + wp + nblocks)
    kw = K // 32
    a = _rand(rng, (rows, wp), dev)
    used = u32_to_torch((rng.random((1, rows)) < 0.3).astype(np.uint32), dev)
    w0, cols = 2 * kw, 32 * wp - 7
    bT = a[:, w0 : w0 + kw].T.contiguous()
    want = phase1.phase1_panel_plain(a, bT, used, w0, K, cols)
    if phase1.scan_fits(-(-rows // nblocks), kw):
        got = phase1.phase1_panel_cluster(a, bT, used, w0, K, cols, nblocks)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    else:
        with pytest.raises(RuntimeError, match="phase1_fused kernel"):
            phase1.phase1_panel_cluster(a, bT, used, w0, K, cols, nblocks)


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


# the probe's own shape, sizes with n % 4 != 0, fewer words than one vector, nothing,
# more vectors than the grid has threads
PROBE_SIZES = [launch_floor.PROBE_SHAPE, (1,), (3,), (4,), (5,), (1023,), (257, 3), (0,),
               (2_000_003,)]


@pytest.mark.parametrize("shape", PROBE_SIZES)
def test_launch_probe_kernel(dev, shape):
    rng = np.random.default_rng(15)
    a = _rand(rng, shape, dev)
    _cuda.reset_launches()
    got = launch_floor.tiny_call(a)
    assert _cuda.LAUNCHES["launch_probe"] == 1
    assert torch.equal(got, launch_floor.tiny_call_plain(a))
    assert a.numel() == 0 or got.data_ptr() != a.data_ptr()
    if a.numel() > 8:  # a view that starts 4 bytes into an allocation: no 16-byte alignment
        off = a.flatten()[1:]
        assert off.data_ptr() % 16 and off.is_contiguous()
        assert torch.equal(launch_floor.tiny_call(off), launch_floor.tiny_call_plain(off))


def test_launch_floor_measure(dev):
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


# -- the two-pivot scan as a cluster kernel, the one-launch mxu2 update --------------------

SCAN2_ROWS = [300, 768, 2560, 20011, 20224, 40192]


def _sparse_election_slice(rng, case, dev):
    """64 rows, K = 64, w0 = 1, four blocks of 16 rows: rows (bits of the first
    pair) that make the election cases of tests/test_torch_scan2_mxu2.py."""
    cases = [{35: 1, 3: 2, 50: 3}, {5: 3, 36: 1, 37: 3, 52: 2}, {20: 3, 40: 2, 41: 1},
             {2: 3, 4: 3, 9: 1, 30: 2}]
    bits = rng.random((2, 64, 32)) < 0.06
    bT = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
    bT[0] &= np.uint32(0xFFFFFFFC)
    for r, b in cases[case].items():
        bT[0, r] |= np.uint32(b)
    return u32_to_torch(bT, dev)


@pytest.mark.parametrize("kw", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", SCAN2_ROWS)
def test_scan2_cluster_kernel(dev, rows, kw):
    """The two-pivot cluster kernel by its route against the step twin and
    the 1-pivot twin: the first, a middle and the last panel, a panel with no
    valid column, and every row used (no pivot); one launch of scan2."""
    K = 32 * kw
    rng = np.random.default_rng(rows + kw + 29)
    bT = _rand(rng, (kw, rows), dev)
    route = phase1.scan2_route(rows, kw)
    assert route.kernel == "scan2" and route.nblocks == phase1.scan_route(rows, kw).nblocks
    for frac in (0.3, 1.0):
        used = u32_to_torch((rng.random((1, rows)) < frac).astype(np.uint32), dev)
        for w0, cols in _panels_cases(kw, 640) + [(0, 10**6), (2, 64 + 41)]:
            _cuda.reset_launches()
            got = phase1.scan(bT, used, w0, K, cols, "2")
            assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"scan2": 1}
            want = phase1.scan2_plain(bT, used, w0, K, cols)
            torch.cuda.synchronize()
            for g, w, p in zip(got, want, phase1.scan_plain(bT, used, w0, K, cols)):
                assert torch.equal(g, w), (frac, w0, cols)
                assert torch.equal(g, p), (frac, w0, cols)
            if frac == 1.0 or cols == 0:
                assert int((got[0] >= 0).sum()) == 0


@pytest.mark.parametrize("nblocks", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("rows,K,w0,cols", SCAN_SHAPES)
def test_scan2_on_every_cluster_size(dev, rows, K, w0, cols, nblocks):
    """Every cluster size that holds the slice gives the step twin's and the
    1-pivot twin's outputs, and the cluster twin's order on those blocks; one
    that cannot hold it raises instead of running something else."""
    rng = np.random.default_rng(rows + nblocks + 41)
    kw = K // 32
    bT = _rand(rng, (kw, rows), dev)
    used = u32_to_torch((rng.random((1, rows)) < 0.3).astype(np.uint32), dev)
    want = phase1.scan2_plain(bT, used, w0, K, cols)
    if phase1.scan_fits(-(-rows // nblocks), kw, pairs=True):
        got = phase1.scan2_cluster(bT, used, w0, K, cols, nblocks)
        torch.cuda.synchronize()
        for g, w, p in zip(got, want, phase1.scan_plain(bT, used, w0, K, cols)):
            assert torch.equal(g, w)
            assert torch.equal(g, p)
    else:
        with pytest.raises(RuntimeError, match="scan2 kernel"):
            phase1.scan2_cluster(bT, used, w0, K, cols, nblocks)


@pytest.mark.parametrize("nblocks", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", range(4))
def test_scan2_election_cases_on_the_card(dev, case, nblocks):
    """The hand-built sparse slices of the four election cases on every
    cluster size against both twins."""
    rng = np.random.default_rng(case + 50)
    bT = _sparse_election_slice(rng, case, dev)
    used = torch.zeros((1, 64), dtype=torch.int32, device=dev)
    used[0, 60] = 1
    want = phase1.scan2_plain(bT, used, 1, 64, 10**6)
    got = phase1.scan2_cluster(bT, used, 1, 64, 10**6, nblocks)
    torch.cuda.synchronize()
    for g, w, p in zip(got, want, phase1.scan_plain(bT, used, 1, 64, 10**6)):
        assert torch.equal(g, w)
        assert torch.equal(g, p)


def test_scan2_block_takes_the_very_tall_slice(dev):
    """Past the largest cluster's rows the two-pivot scan's route is the
    chained kernel, taken by the route and not after a failure; the largest
    cluster refuses the slice."""
    rows, K, kw = VERY_TALL_ROWS, 256, 8
    route = phase1.scan2_route(rows, kw)
    assert route.kernel == "scan2_chunked"
    rng = np.random.default_rng(71)
    bT = _rand(rng, (kw, rows), dev)
    used = u32_to_torch((rng.random((1, rows)) < 0.25).astype(np.uint32), dev)
    want = phase1.scan_plain(bT, used, 8, K, 10**6)
    _cuda.reset_launches()
    got = phase1.scan(bT, used, 8, K, 10**6, "2")
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"scan2_chunked": route.chunks}
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(RuntimeError, match="scan2 kernel"):
        phase1.scan2_cluster(bT, used, 8, K, 10**6, 16)


# (rows, kw, chunk_rows, w0, cols): the route's cut of the very tall system,
# the largest cluster filled first (last link 1792 rows on 2 blocks), chunks of
# 8192 (nine, the last on 2 blocks), 5000 rows in chunks of 1024 (the last,
# 904 rows, on one block), 70000 rows at kw 3 with a panel crossing cols, and
# a one-row last chunk with invalid column 0
SCAN2_CHUNKED_SHAPES = [(VERY_TALL_ROWS, 8, None, 160, 19968),
                        (VERY_TALL_ROWS, 8, 65536, 8, 10**6),
                        (VERY_TALL_ROWS, 8, 8192, 160, 19968), (5000, 8, 1024, 8, 10**6),
                        (70000, 3, None, 2, 150), (65537, 8, None, 0, 10**6)]


@pytest.mark.parametrize("pattern", ["random", "chunk0-used", "sparse"])
@pytest.mark.parametrize("rows,kw,chunk_rows,w0,cols", SCAN2_CHUNKED_SHAPES)
def test_scan2_chunked_kernel(dev, rows, kw, chunk_rows, w0, cols, pattern):
    """The chained two-pivot scan equals its twin in the chain's order, the
    step twin and the 1-pivot scan's twin (max_abs_err 0), a launch a chunk:
    a quarter of the rows used, the first chunk all used (the later chunks
    elect), sparse (columns without a candidate, pivots in later chunks)."""
    rng = np.random.default_rng(rows + kw + len(pattern) + 3)
    bT, used = _chained_inputs(rng, 1, kw, rows, pattern, dev, chunk_rows)
    K = 32 * kw
    route = phase1.scan_chunked_route(rows, kw, chunk_rows, kernel="scan2_chunked")
    _cuda.reset_launches()
    got = phase1.scan2_chunked(bT[0], used, w0, K, cols, chunk_rows)
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"scan2_chunked": route.chunks}
    want = phase1.scan2_chunked_plain(bT[0], used, w0, K, cols, route.chunk_rows)
    torch.cuda.synchronize()
    for g, w, p, q in zip(got, want, phase1.scan2_plain(bT[0], used, w0, K, cols),
                          phase1.scan_plain(bT[0], used, w0, K, cols)):
        assert torch.equal(g, w)
        assert torch.equal(g, p)
        assert torch.equal(g, q)
    if pattern == "chunk0-used":
        pivots = got[0][got[0] >= 0]
        assert pivots.numel() and int(pivots.min()) >= route.chunk_rows


def test_scan2_chunked_raises_instead_of_falling_back(dev):
    """A chain the kernel cannot take (a cluster of 3 blocks, first or last)
    raises; nothing else runs in its place (no other kernel, no twin) and
    nothing is counted."""
    rng = np.random.default_rng(12)
    bT, used = _chained_inputs(rng, 1, 8, VERY_TALL_ROWS, "random", dev)
    route = phase1.scan2_route(VERY_TALL_ROWS, 8)
    _cuda.reset_launches()
    for bad in (route._replace(nblocks=3), route._replace(nblocks_last=3)):
        with pytest.raises(RuntimeError, match="scan2_chunked kernel"):
            phase1.launch_chunked("gf2_scan2_chunked", "scan2_chunked", bT, used, 8, 256, 10**6,
                                  bad, batched=False)
    torch.cuda.synchronize()
    assert not any(_cuda.LAUNCHES.values())


@pytest.mark.parametrize("rows,wp,K", [(20224, 640, 256), (20224, 768, 256), (20224, 638, 256),
                                       (20224, 8, 256), (1000, 389, 160)])
def test_update_mxu4_kernel(dev, rows, wp, K):
    """mxu4 as one launch of the strip kernel under its own rule: the
    flagship and multi-RHS widths, an unaligned width (scalar accesses), the
    look-ahead engine's (rows, 8) slice and a ragged strip, full and trailing
    (w0 in the first tile, on its edge, past it, in the last tile), the whole
    matrix against the twin, which follows the TPU body's second product;
    one launch of update_mxu4, nothing else."""
    rng = np.random.default_rng(rows + wp + 67)
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, K // 32), dev)
    pf = _rand(rng, (K, wp), dev)
    for w0 in [None] + sorted({0, 127, 128, 160, 632} & set(range(wp))):
        _cuda.reset_launches()
        got = panel_update.update_mxu4(a.clone(), sel, pf, w0)
        assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"update_mxu4": 1}
        want = panel_update.update_mxu4_plain(a.clone(), sel, pf, w0)
        torch.cuda.synchronize()
        assert torch.equal(got, want), w0
    # an a that starts 4 bytes past a 16-byte boundary takes the scalar accesses
    big = _rand(rng, (rows * wp + 1,), dev)
    view = big[1:].view(rows, wp)
    want = panel_update.update_mxu4_plain(view.clone(), sel, pf, 160 if wp > 160 else None)
    assert torch.equal(panel_update.update_mxu4(view, sel, pf, 160 if wp > 160 else None), want)


@pytest.mark.parametrize("rows,wp,K", UPDATE_SHAPES + [
    (20224, 638, 256), (20224, 8, 256), (20224, 4, 256), (4096, 40, 256), (77, 13, 32),
    (1000, 389, 160)])
def test_update_mxu2_kernel(dev, rows, wp, K):
    """The one-launch mxu2 kernel on aligned widths, unaligned ones (scalar
    accesses), the look-ahead engine's (rows, 8) slice and other strips
    narrower than 32 words (lanes past the strip's end must touch nothing:
    a first form wrote their quads into the next row), a ragged strip,
    under every w0 of test_update_mma_kernels: the whole matrix against the
    twin and one launch of update_mxu2, nothing else."""
    rng = np.random.default_rng(rows + wp + 61)
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, K // 32), dev)
    pf = _rand(rng, (K, wp), dev)
    for w0 in [None] + sorted({0, 8, 127, 128, 160, 256, wp - 8} & set(range(wp))):
        _cuda.reset_launches()
        got = panel_update.update_mxu2(a.clone(), sel, pf, w0)
        assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"update_mxu2": 1}
        want = panel_update.update_mxu2_plain(a.clone(), sel, pf, w0)
        torch.cuda.synchronize()
        assert torch.equal(got, want), w0
    # an a that starts 4 bytes past a 16-byte boundary takes the scalar accesses
    big = _rand(rng, (rows * wp + 1,), dev)
    view = big[1:].view(rows, wp)
    want = panel_update.update_mxu2_plain(view.clone(), sel, pf)
    assert torch.equal(panel_update.update_mxu2(view, sel, pf), want)


# -- the chained scan of slices taller than one cluster --------------------------------


def _chained_inputs(rng, B, kw, rows, pattern, dev, chunk_rows=None):
    """B slices: ``random`` (a quarter of the rows used), ``chunk0-used`` (every
    row of the first chunk used, so the later chunks elect), ``sparse`` (one
    bit in 40 set: columns without a candidate, pivots in later chunks)."""
    bT = rng.integers(0, 2**32, size=(B, kw, rows), dtype=np.uint32)
    used = (rng.random((B, rows)) < 0.25).astype(np.uint32)
    if pattern == "chunk0-used":
        used[:, : phase1.scan_chunked_route(rows, kw, chunk_rows).chunk_rows] = 1
    elif pattern == "sparse":
        keep = (rng.random((B, kw, rows, 32)) < 1 / 40) * (1 << np.arange(32, dtype=np.uint64))
        bT = keep.sum(-1).astype(np.uint32)
    return u32_to_torch(bT, dev), u32_to_torch(used, dev)


@pytest.mark.parametrize("pattern", ["random", "chunk0-used", "sparse"])
@pytest.mark.parametrize("rows,kw,chunk_rows,w0,cols", [
    (65537, 8, None, 8, 10**6), (67328, 8, None, 160, 19968), (140000, 8, None, 0, 200),
    (70000, 1, None, 0, 10**6), (70000, 3, None, 2, 150), (5000, 8, 1024, 8, 10**6),
])
def test_scan_chunked_kernel(dev, rows, kw, chunk_rows, w0, cols, pattern):
    """The chained scan equals its twin in the chain's order and the step twin
    (max_abs_err 0): a one-row last chunk, the very tall system's shape, three
    chunks, narrow slices, a forced chunk of 1024 rows; invalid columns at
    either end; a launch a chunk."""
    rng = np.random.default_rng(rows + kw + len(pattern))
    bT, used = _chained_inputs(rng, 1, kw, rows, pattern, dev, chunk_rows)
    K = 32 * kw
    route = phase1.scan_chunked_route(rows, kw, chunk_rows)
    _cuda.reset_launches()
    got = phase1.scan_chunked(bT[0], used, w0, K, cols, chunk_rows)
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {"scan_chunked": route.chunks}
    want = phase1.scan_chunked_plain(bT[0], used, w0, K, cols, route.chunk_rows)
    torch.cuda.synchronize()
    for g, w, p in zip(got, want, phase1.scan_plain(bT[0], used, w0, K, cols)):
        assert torch.equal(g, w)
        assert torch.equal(g, p)


@pytest.mark.parametrize("B,rows", [(1, 67328), (2, 67328), (4, 67328), (2, 140000)])
def test_scan_batched_chunked_kernel(dev, B, rows):
    """One cluster per system in each launch, each system with its own record:
    the systems differ (random, first chunk used, sparse), and each equals the
    single chained scan's twin."""
    rng = np.random.default_rng(B + rows)
    kw, K, w0, cols = 8, 256, 160, 19968
    parts = [_chained_inputs(rng, 1, kw, rows, ("random", "chunk0-used", "sparse")[b % 3], dev)
             for b in range(B)]
    bT = torch.cat([p[0] for p in parts]).contiguous()
    used = torch.cat([p[1] for p in parts]).contiguous()
    route = phase1.scan_batched_route(B, rows, kw)
    assert route.kernel == "scan_batched_chunked"
    _cuda.reset_launches()
    got = gauss_batched.scan_batched(bT, used, w0, K, cols)
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {
        "scan_batched_chunked": route.chunks}
    want = gauss_batched.scan_batched_chunked_plain(bT, used, w0, K, cols, route.chunk_rows)
    torch.cuda.synchronize()
    for g, w, p in zip(got, want, gauss_batched.scan_batched_plain(bT, used, w0, K, cols)):
        assert torch.equal(g, w)
        assert torch.equal(g, p)


def test_scan_chunked_raises_instead_of_falling_back(dev):
    """A chain the kernel cannot take (a cluster of 3 blocks) raises; nothing
    else runs in its place and nothing is counted."""
    rng = np.random.default_rng(9)
    bT, used = _chained_inputs(rng, 1, 8, 67328, "random", dev)
    bad = phase1.scan_chunked_route(67328, 8)._replace(nblocks=3)
    _cuda.reset_launches()
    with pytest.raises(RuntimeError, match="scan_chunked kernel"):
        phase1.launch_chunked("gf2_scan_chunked", "scan_chunked", bT, used, 8, 256, 10**6,
                              bad, batched=False)
    assert not any(_cuda.LAUNCHES.values())


# -- the fused kernels of slices taller than one cluster -------------------------------


def _spread_used(rows, chunk_rows, K, rng):
    """Every row used but a few in each chunk (K in all, the last chunk's
    share the largest), so that on a dense slice every chunk elects pivots
    and the product reads pivot rows of every chunk."""
    starts = list(range(0, rows, chunk_rows))
    per = K // (2 * len(starts))
    used = np.ones((1, rows), np.uint32)
    for i, lo in enumerate(starts):
        n = K - per * (len(starts) - 1) if i == len(starts) - 1 else per
        hi = min(rows, lo + chunk_rows)
        used[0, rng.choice(np.arange(lo, hi), size=min(n, hi - lo), replace=False)] = 0
    return used


# (rows, wp, kw, chunk_rows): the route's cut of the very tall system, the
# largest cluster filled first (last chunk 1792 rows on 2 blocks), chunks of
# 8192 (nine, the last on 2 blocks), and 5000 rows in chunks of 1024 (the
# last, 904 rows, on one block with every strip of the product)
FUSED_CHUNKED_SHAPES = [(VERY_TALL_ROWS, 640, 8, None), (VERY_TALL_ROWS, 640, 8, 65536),
                        (VERY_TALL_ROWS, 640, 8, 8192), (5000, 640, 8, 1024),
                        (70000, 384, 3, None)]


@pytest.mark.parametrize("rows,wp,kw,chunk_rows", FUSED_CHUNKED_SHAPES)
def test_phase1_fused_chunked_kernel(dev, rows, wp, kw, chunk_rows):
    """The chained fused phase 1 equals its twin in the chain's order and the
    step twin (max_abs_err 0): a middle panel, the last panel (cut by cols)
    and a panel with no valid column, with a third of the rows used, every
    row used, and few rows free in each chunk (pivot rows read from every
    chunk, asserted); a launch a chunk."""
    K = 32 * kw
    rng = np.random.default_rng(rows + wp + (chunk_rows or 0))
    a = _rand(rng, (rows, wp), dev)
    route = phase1.scan_chunked_route(rows, kw, chunk_rows, kernel="phase1_fused_chunked")
    useds = {"a third": (rng.random((1, rows)) < 0.3).astype(np.uint32),
             "all": np.ones((1, rows), np.uint32),
             "spread": _spread_used(rows, route.chunk_rows, K, rng)}
    for name, u in useds.items():
        used = u32_to_torch(u, dev)
        for w0, cols in ((wp // 2 // kw * kw, 10**6), (wp - kw, 32 * wp - 40), (kw, 0)):
            bT = a[:, w0 : w0 + kw].T.contiguous()
            _cuda.reset_launches()
            got = phase1.phase1_panel_chunked(a, bT, used, w0, K, cols, chunk_rows)
            assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {
                "phase1_fused_chunked": route.chunks}
            want = phase1.phase1_panel_chunked_plain(a, bT, used, w0, K, cols, route.chunk_rows)
            torch.cuda.synchronize()
            for g, w, p in zip(got, want, phase1.phase1_panel_plain(a, bT, used, w0, K, cols)):
                assert torch.equal(g, w), (name, w0, cols)
                assert torch.equal(g, p), (name, w0, cols)
            pivots = got[1][got[1] >= 0]
            if name == "all" or cols == 0:
                assert pivots.numel() == 0 and int(got[0].abs().sum()) == 0
            if name == "spread" and cols == 10**6:
                assert set((pivots // route.chunk_rows).tolist()) == set(range(route.chunks))


@pytest.mark.parametrize("rows,wp,kw,chunk_rows", FUSED_CHUNKED_SHAPES)
def test_update_scan_chunked_kernel(dev, rows, wp, kw, chunk_rows):
    """The update beside the chained scan's links (the route's share beside
    the first, and a third of the rows there with the rest beside the later
    links) equals its twin in the chain's order and the step twin: full and
    trailing at a middle and the last panel, the next panel's scan inside the
    matrix, at its last panel and past cols (no valid column), with a third
    of the rows used and every row used; a launch a chunk."""
    K = 32 * kw
    rng = np.random.default_rng(rows + wp + (chunk_rows or 0) + 1)
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, kw), dev)
    pf = _rand(rng, (K, wp), dev)
    cols = 32 * wp - 40
    route = phase1.scan_chunked_route(rows, kw, chunk_rows, kernel="update_scan_chunked")
    for frac in (0.3, 1.0):
        used = u32_to_torch((rng.random((1, rows)) < frac).astype(np.uint32), dev)
        for w0, w0n in ((None, kw), (wp // 2 // kw * kw, wp - kw), (wp - kw, wp)):
            bTn = _rand(rng, (kw, rows), dev)
            want = panel_update.update_scan_chunked_plain(a.clone(), sel, pf, bTn, used, w0n,
                                                          cols, w0, route.chunk_rows)
            step = panel_update.update_scan_plain(a.clone(), sel, pf, bTn, used, w0n, cols, w0)
            # the update's rows by the route's rule, and a third of them beside link 0
            for first in (None, rows // 3):
                _cuda.reset_launches()
                got = panel_update.update_scan_chunked(a.clone(), sel, pf, bTn, used, w0n, cols,
                                                       w0, chunk_rows, first)
                assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {
                    "update_scan_chunked": route.chunks}
                torch.cuda.synchronize()
                for g, w, p in zip(got, want, step):
                    assert torch.equal(g, w), (frac, w0, w0n, first)
                    assert torch.equal(g, p), (frac, w0, w0n, first)
                if frac == 1.0 or w0n == wp:
                    assert int((got[1] >= 0).sum()) == 0


def test_fused_chunked_kernels_raise_instead_of_falling_back(dev):
    """A chain the kernels cannot take (a cluster of 3 blocks) raises; nothing
    else runs in its place (no twin, no other kernel) and nothing is
    counted."""
    rng = np.random.default_rng(10)
    rows, wp, K = VERY_TALL_ROWS, 128, 256
    a = _rand(rng, (rows, wp), dev)
    sel = _rand(rng, (rows, 8), dev)
    pf = _rand(rng, (K, wp), dev)
    used = u32_to_torch((rng.random((1, rows)) < 0.25).astype(np.uint32), dev)
    bT = a[:, 8:16].T.contiguous()
    _cuda.reset_launches()
    bad = phase1.phase1_fused_route(rows, 8)._replace(nblocks=3)
    with pytest.raises(RuntimeError, match="phase1_fused_chunked kernel"):
        phase1.launch_phase1_chunked(a, bT, used, 8, K, 10**6, bad)
    bad = panel_update.update_scan_route(rows, 8)._replace(nblocks_last=3)
    with pytest.raises(RuntimeError, match="update_scan_chunked kernel"):
        panel_update._launch_update_scan("gf2_update_scan_chunked", "update_scan_chunked",
                                         a, sel, pf, bT, used, 16, 10**6, 8, None, bad, rows)
    torch.cuda.synchronize()
    assert not any(_cuda.LAUNCHES.values())


# -- routing, host backends, quadratic systems --------------------------------------------


def _consistent(seed, rows, cols):
    rng = np.random.default_rng(seed)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    rhs = (coeff.astype(np.int64) @ rng.integers(0, 2, size=cols)) % 2
    return packing.pack_bits(np.concatenate([rhs[:, None].astype(np.uint8), coeff], axis=1),
                             1 + cols)


@pytest.mark.parametrize("cols", [16, 100, 1023, 1024])
def test_auto_routing_on_the_card(dev, cols):
    """auto on a CUDA system: the blocked kernels at every size; the answer
    equals the oracle's."""
    from gf2bv_tpu_torch.ops import solver

    assert solver._resolve_backend(None, cols, dev) == "blocked"
    eqs = _consistent(cols, cols + 40, cols)
    _cuda.reset_launches()
    got = solver.solve(eqs, cols, 0, device=dev)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["scan"] > 0
    assert got == solver.solve(eqs, cols, 0, backend="oracle", device="cpu") is not None


@pytest.mark.parametrize("cols", [1500, 3000, 5000])
def test_native_host_and_blocked_card_agree(dev, cols):
    """On a mid-size system the host C engine and the card's blocked kernels
    give the same point and the same space."""
    from gf2bv_tpu_torch import _native
    from gf2bv_tpu_torch.ops import solver

    if not _native.available():
        pytest.skip("no native engine (gcc missing)")
    eqs = _consistent(cols + 1, cols - 30, cols)
    for mode in (0, 1):
        host = solver.solve(eqs, cols, mode, backend="native", device="cpu")
        card = solver.solve(eqs, cols, mode, backend="blocked", device=dev)
        if mode == 0:
            assert host == card is not None
        else:
            assert (host.dimension, host.origin, host.basis) == (
                card.dimension, card.origin, card.basis)


@pytest.mark.parametrize("n,rows", [(24, 300), (128, 3000)])
def test_quad_rows_cuda(dev, n, rows):
    """quad_rows on the card equals its CPU result."""
    from gf2bv_tpu_torch import BitVec, QuadraticSystem
    from gf2bv_tpu_torch.ops import quad_device

    rng = np.random.default_rng(n + rows)

    def narrow():
        raw = rng.integers(0, 1 << 63, size=(rows, packing.nwords64(1 + n)), dtype=np.uint64)
        return BitVec(packing.pack_bits(packing.unpack_rows(raw, 1 + n), 1 + n), 1 + n)

    a, b, c = narrow(), narrow(), narrow()
    const = int(rng.integers(0, 1 << 62))
    got = quad_device.quad_rows(QuadraticSystem([n], device=dev), [(a, b), (b, c)], [a, b, c],
                                const)
    want = quad_device.quad_rows(QuadraticSystem([n], device="cpu"), [(a, b), (b, c)],
                                 [a, b, c], const)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dim", [0, 9, 33, 64])
def test_enumerate_cuda(dev, dim):
    """enumerate_points and quad_consistency_mask on the card equal the CPU,
    with the index crossing 2^63."""
    from gf2bv_tpu_torch.ops import enumerate as enum_torch

    rng = np.random.default_rng(dim)
    origin = rng.integers(0, 2**32, size=40, dtype=np.uint32)
    basis = rng.integers(0, 2**32, size=(dim, 40), dtype=np.uint32)
    for start in (0, (1 << 63) - 100):
        got = enum_torch.enumerate_points(u32_to_torch(origin, dev), u32_to_torch(basis, dev),
                                          start, 300, True)
        want = enum_torch.enumerate_points(u32_to_torch(origin, "cpu"),
                                           u32_to_torch(basis, "cpu"), start, 300, True)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(enum_torch.quad_consistency_mask(got, 12).cpu(),
                           enum_torch.quad_consistency_mask(want, 12))


@pytest.mark.parametrize("nzeros", [19, 30])
def test_quadratic_system_cuda(dev, nzeros):
    """QuadraticSystem at a small width solves the same on the card as on the
    CPU: the 24-bit NLFSR attack, and a rank-deficient system whose space
    (dimension 17 or 6) is filtered on the card past 8 dimensions."""
    from gf2bv_tpu_torch import QuadraticSystem
    from gf2bv_tpu_torch.crypto.lfsr import GaloisLFSR

    n, mask, select = 24, 0xE10000, (3, 7, 11, 15, 19)
    init = random.Random(24).getrandbits(n) | 1
    reg = GaloisLFSR(n, mask, init)
    out = []
    for _ in range(1 << 12):
        reg()
        x = [(reg.state >> i) & 1 for i in select]
        out.append((x[0] * x[1]) ^ (x[0] * x[1] * x[3] * x[4]) ^ x[0] ^ x[1] ^ x[2])

    def nlfsr(q):
        (x,) = q.gens()
        sym = GaloisLFSR(n, mask, x)
        zeros = []
        for o in out:
            sym()
            if o:
                x0, x1, x2 = (sym.state[i] for i in select[:3])
                zeros.append(q.mul_bit(x0, x1) ^ x0 ^ q.mul_bit(x1, x2) ^ x1 ^ x2 ^ 1)
        return zeros

    def deficient(q):
        rng = np.random.default_rng(17)
        (x,) = q.gens()
        secret = int(rng.integers(1, 1 << 8))
        sb = [(secret >> i) & 1 for i in range(8)]
        mono = sb + [sb[i] & sb[j] for i in range(8) for j in range(i)]
        parts = [x[i] for i in range(8)] + [q.mul_bit(x[i], x[j]) for i in range(8)
                                            for j in range(i)]
        zeros = []
        while len(zeros) < nzeros:
            sel = rng.integers(0, 2, size=len(mono))
            if sel.any():
                acc = None
                for s_, p in zip(sel, parts):
                    if s_:
                        acc = p if acc is None else acc ^ p
                zeros.append(acc ^ int(np.dot(sel, mono) % 2))
        return zeros

    q, q_cpu = QuadraticSystem([n], device=dev), QuadraticSystem([n], device="cpu")
    got = list(q.solve_all(nlfsr(q), max_dimension=12))
    assert got == list(q_cpu.solve_all(nlfsr(q_cpu), max_dimension=12)) and (init,) in got
    assert q.solve_one(nlfsr(q)) == q_cpu.solve_one(nlfsr(q_cpu))
    q8, q8_cpu = QuadraticSystem([8], device=dev), QuadraticSystem([8], device="cpu")
    assert list(q8.solve_all(deficient(q8), max_dimension=17)) == list(
        q8_cpu.solve_all(deficient(q8_cpu), max_dimension=17))


# -- the incremental solver and m4ri_solve -------------------------------------------------


def _inc_state(inc):
    return {"M": torch_to_u32(inc._M), "pof": inc._pof.cpu().numpy(),
            "pcol": inc._pcol.cpu().numpy(), "nrows": inc._nrows, "rank": inc.rank,
            "unsat": inc.unsat}


def _same_inc_state(a, b):
    sa, sb = _inc_state(a), _inc_state(b)
    for key in ("nrows", "rank", "unsat"):
        assert sa[key] == sb[key], key
    for key in ("M", "pof", "pcol"):
        assert sa[key].shape == sb[key].shape and np.array_equal(sa[key], sb[key]), key


def _mt_incremental_eqs(n_out):
    """Packed equations of n_out MT19937 outputs and the mt[0] row block."""
    from gf2bv_tpu_torch.crypto.mt import MT19937

    rand = random.Random(1414)
    state = tuple(rand.getstate()[1][:-1])
    outs = [rand.getrandbits(32) for _ in range(n_out)]
    lin = LinearSystem([32] * 624, device="cpu")
    mt = lin.gens()
    rng = MT19937(list(mt))
    eqs = lin.get_eqs_packed([rng.getrandbits(32) ^ o for o in outs])
    return state, lin, eqs, lin.get_eqs_packed([mt[0] ^ 0x80000000])


@pytest.mark.parametrize("shape", ["1000 columns", "19968 columns"])
def test_incremental_cuda_matches_cpu(dev, shape):
    """The same starts and adds on the card and on the CPU: the whole state
    (M, pof, pcol, nrows, rank, unsat) equal bit for bit after every add, in
    the 128-, 512- and 2048-row buckets; the card's adds launch update_full
    alone; the answer is the generator's state."""
    from gf2bv_tpu_torch import IncrementalSolver

    if shape == "1000 columns":
        cols = 1000
        eqs = _consistent(5, 1400, cols)
        start, adds = eqs[:900], [eqs[900:1000], eqs[1000:1400], np.concatenate([eqs] * 2)]
        want = None
    else:
        state, lin, eqs, msb = _mt_incremental_eqs(624 + 64)
        cols = lin.cols
        start = np.concatenate([eqs[: 32 * 600], msb])
        adds = [eqs[32 * k : 32 * (k + 4)] for k in range(600, 624, 4)]
        adds += [eqs[32 * 624 : 32 * 640], eqs[32 * 624 :]]
        want = state
    card = IncrementalSolver.from_packed(start, cols, device=dev)
    host = IncrementalSolver.from_packed(start, cols, device="cpu")
    _same_inc_state(card, host)
    for rows in adds:
        _cuda.reset_launches()
        card.add_packed(rows)
        torch.cuda.synchronize()
        assert set(k for k, v in _cuda.LAUNCHES.items() if v) == {"update_full"}
        host.add_packed(rows)
        _same_inc_state(card, host)
    assert card.solve_raw_one() == host.solve_raw_one()
    if want is not None:
        assert card.dimension == 0 and lin.convert_sol(card.solve_raw_one()) == want
    else:
        from gf2bv_tpu_torch.ops import solver

        assert card.solve_raw_one() == solver.solve(eqs, cols, 0, backend="oracle", device="cpu")


@pytest.mark.parametrize("cols", [40, 300, 1500])
def test_m4ri_solve_on_the_card(dev, cols):
    """m4ri_solve on its default device (the card) against the oracle, modes
    0 and 1."""
    from gf2bv_tpu_torch import m4ri_solve
    from gf2bv_tpu_torch.ops import solver

    rng = random.Random(cols)
    masks = [rng.getrandbits(cols + 1) for _ in range(cols - 5)]
    secret = rng.getrandbits(cols)
    masks = [(m & ~1) | (bin((m >> 1) & secret).count("1") & 1) for m in masks]
    eqs = packing.ints_to_rows(masks, 1 + cols)
    assert m4ri_solve(masks, cols, 0) == solver.solve(eqs, cols, 0, backend="oracle",
                                                      device="cpu")
    sp = m4ri_solve(masks, cols, 1)
    ref = solver.solve(eqs, cols, 1, backend="oracle", device="cpu")
    assert (sp.dimension, sp.origin, sorted(sp.basis)) == (
        ref.dimension, ref.origin, sorted(ref.basis))


# -- the sharded solvers on shards of one card (parallel/) ------------------


def _sharded_system(seed, rows, cols, deficit=0):
    rng = np.random.default_rng(seed)
    coeff = rng.integers(0, 2, size=(rows, cols), dtype=np.uint8)
    if deficit:
        coeff[rows - deficit:] = coeff[:deficit]
    rhs = (coeff.astype(np.int64) @ rng.integers(0, 2, size=cols)) % 2
    return packing.pack_bits(np.concatenate([rhs[:, None].astype(np.uint8), coeff], axis=1),
                             1 + cols)


@pytest.mark.parametrize("shards,k_panel", [(4, 256), (2, 64), (8, 128)])
def test_tournament_on_card_shards_matches_cpu_shards(dev, shards, k_panel):
    """The tournament on shards of cuda:0 (the scan, rebuild and update
    kernels) against the same mesh of CPU shards (their twins): mode 1's RREF
    and pivot map, the fused tail's origin and verdict, the same rounds."""
    from gf2bv_tpu_torch.parallel import collectives, mesh as meshlib
    from gf2bv_tpu_torch.parallel.rowshard_tournament import rref_rowsharded_tournament

    cols = 700
    a32 = packing.pad2d(packing.to_u32(_sharded_system(shards, 900, cols, deficit=9)),
                        row_align=256 * shards, word_align=128)
    on_card = meshlib.make_mesh(batch=1, rows=shards, devices=[dev] * shards)
    on_cpu = meshlib.make_mesh(batch=1, rows=shards, devices=["cpu"] * shards)
    for fused in (False, True):
        collectives.reset_counts()
        _cuda.reset_launches()
        got = rref_rowsharded_tournament(a32, cols, on_card, k_panel, "mxu", fused_origin=fused)
        rounds = dict(collectives.COUNTS)
        panels = -(-(1 + cols) // k_panel)
        update = "update_trailing" if fused else "update_full"
        assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {
            "scan": (shards + 1) * panels, "reconstruct": panels, update: shards * panels}
        want = rref_rowsharded_tournament(a32, cols, on_cpu, k_panel, "jnp", fused_origin=fused)
        assert dict(collectives.COUNTS) == {k: 2 * v for k, v in rounds.items()}
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("shards", [2, 4])
def test_blocked_and_per_pivot_on_card_shards(dev, shards):
    from gf2bv_tpu_torch.ops import solver
    from gf2bv_tpu_torch.parallel import mesh as meshlib
    from gf2bv_tpu_torch.parallel.rowshard import solve_rowsharded
    from gf2bv_tpu_torch.parallel.rowshard_blocked import solve_rowsharded_blocked

    cols = 300
    eqs = _sharded_system(10 + shards, 360, cols, deficit=5)
    mesh = meshlib.make_mesh(batch=1, rows=shards, devices=[dev] * shards)
    want = solver.solve(eqs, cols, 1, backend="oracle")
    for solve in (solve_rowsharded, solve_rowsharded_blocked):
        _cuda.reset_launches()
        origin, basis = solve(eqs, cols, 1, mesh)
        if solve is solve_rowsharded_blocked:  # on the card: the table kernel
            assert _cuda.LAUNCHES["update_full"] == shards * 2
        assert packing.words_to_int(origin) == want.origin
        assert packing.rows_to_ints(basis) == list(want.basis)


def test_multi_rhs_sharded_on_card_shards(dev):
    from gf2bv_tpu_torch.parallel import collectives, mesh as meshlib
    from gf2bv_tpu_torch.parallel.multi_rhs_sharded import solve_multi_rhs_sharded

    cols = 300
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, size=(340, 1 + cols), dtype=np.uint8)
    bits[-3:] = bits[:3]
    a32 = gauss_blocked._pad(packing.pack_bits(bits, 1 + cols), 256, word_align=128)
    rhs = np.stack([(bits[:, 1:] @ rng.integers(0, 2, size=cols)) % 2 for _ in range(41)])
    rhs = rhs.astype(np.uint8)
    rhs[3, -1] ^= 1  # an unsatisfiable instance
    for mode in (0, 1):
        collectives.reset_counts()
        _cuda.reset_launches()
        got = solve_multi_rhs_sharded(a32, cols, rhs, mode,
                                      mesh=meshlib.make_mesh(batch=4, devices=[dev] * 4))
        assert all(v == 0 for v in collectives.COUNTS.values())
        assert _cuda.LAUNCHES["scan"] == 4 * 2 and _cuda.LAUNCHES["update_full"] == 4 * 2
        want = solve_multi_rhs_sharded(a32, cols, rhs, mode,
                                       mesh=meshlib.make_mesh(batch=4, devices=["cpu"] * 4))
        assert got[3] is None and sum(g is None for g in got) == 1
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert (g == w) if mode == 0 else (
                    np.array_equal(g.origin, w.origin) and np.array_equal(g.basis, w.basis))


def test_nccl_world_of_one_takes_its_card_from_the_rank(dev, monkeypatch):
    """``initialize()`` with the world in ``env://`` variables, as torchrun
    sets them, and no ``process_id``: the card is chosen from the rank that
    the group gives, and a shutdown leaves no group behind."""
    import socket

    from gf2bv_tpu_torch.parallel import collectives, distributed, mesh as meshlib
    from gf2bv_tpu_torch.parallel.rowshard_tournament import solve_rowsharded_tournament

    for k in ("GF2BV_TPU_COORD", "GF2BV_TPU_NPROC", "GF2BV_TPU_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    cols = 300
    eqs = _sharded_system(21, 360, cols)
    want = solve_rowsharded_tournament(  # CPU shards, before the NCCL group
        eqs, cols, 0, meshlib.make_mesh(batch=1, rows=2, devices=["cpu", "cpu"]))
    distributed.initialize()
    try:
        assert distributed.local_devices() == [torch.device("cuda", 0)]
        assert torch.cuda.current_device() == 0 and distributed.world_size() == 1
        mesh = meshlib.make_mesh(batch=1, rows=2, devices=[dev, dev])
        assert np.array_equal(solve_rowsharded_tournament(eqs, cols, 0, mesh), want)
    finally:
        distributed.shutdown()
    assert not collectives._GROUPS and distributed.rank_and_world() == (0, 1)


# -- spans and counters (utils/profiling) on the card ---------------------------------


def _mt_request(samples):
    from gf2bv_tpu_torch.crypto.mt_torch import solve_mt19937

    rng = random.Random(samples)
    state = list(rng.getstate()[1][:624])
    outs = [rng.getrandbits(32) for _ in range(samples)]
    return lambda: solve_mt19937(outs, 32, samples=samples, device="cuda"), state


def _sfmt_request():
    from gf2bv_tpu_torch.crypto.sfmt import SFMT19937

    victim = SFMT19937.from_seed(1234)
    for _ in range(3 * 624):
        victim()
    observed = [victim() & 0xFFFF for _ in range(2496)]

    def model(words, p):
        sym = SFMT19937(list(words), index=624)
        return [(sym() & 0xFFFF) ^ p[k] for k in range(2496)]

    tmpl = LinearSystem([32] * 624, device="cuda").capture(model)
    return lambda: tmpl.solve_one(observed)


@pytest.mark.parametrize("request_of", ["mt624", "mt2100", "sfmt2496"])
def test_h2d_copies_match_the_trace_and_launches_do_not_move(dev, request_of):
    """A request of each benchmark cell under the profiler: the program's
    ``h2d_copies`` over the request's span records equal the trace's
    ``Memcpy HtoD`` device rows, one root span holds the request, and the
    kernel launches are those of the same request untraced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gf2bv_tpu_torch.utils import profiling

    if request_of == "sfmt2496":
        solve, state, root = _sfmt_request(), None, "capture.solve"
    else:
        (solve, state), root = _mt_request(int(request_of[2:])), "mt.solve"
    first = solve()  # warm: kernels built, the model's matrix cached
    assert first is not None and (state is None or list(first) == state)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    assert solve() == first
    torch.cuda.synchronize()
    untraced = dict(_cuda.LAUNCHES)
    profiling.reset()
    _cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        assert solve() == first
        torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == untraced
    recs = profiling.spans()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == [root]
    assert {r["request"] for r in recs} == {roots[0]["id"]}
    copies = sum(r["counters"].get("h2d_copies", 0) for r in recs)
    htod = sum(1 for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == DeviceType.CUDA and ev.name().startswith("Memcpy HtoD"))
    print(f"{request_of}: h2d_copies {copies}, Memcpy HtoD rows {htod}, "
          f"launches {sum(untraced.values())}")
    assert copies == htod > 0
    assert ("mt.build" if root == "mt.solve" else "lazy.bind") in {r["name"] for r in recs}
    # the shape's third call replays the elimination's CUDA graph: no panel spans
    assert sum(r["name"] == "panel" for r in recs) == 0
    assert sum(r["counters"].get("rref_graph_replays", 0) for r in recs) == 1

"""The blocked order of the rebuild's coefficient solve, held on the CPU.

The CUDA kernel of ``csrc/reconstruct.cu`` solves for the K x K matrix T
group of 32 rows by group (diagonal phase inside a warp, snapshot of each
back-pass row as it was used, panel phase) and runs only on the card.
``phase1.reconstruct_coeff_blocked_plain`` takes the same order in plain
Python; here it is held against the step-by-step twin
(``reconstruct_coeff_plain``, the T that ``reconstruct_plain`` forms) and,
through the product ``pf = T.arows``, against the Pallas rebuild in interpret
mode, on seeded numpy inputs.  Tolerance 0: integer GF(2) arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gf2bv_tpu.ops.pallas_phase1 import phase1_reconstruct
from gf2bv_tpu_torch import torch_to_u32, u32_to_torch
from gf2bv_tpu_torch.ops import _cuda, gauss_batched, phase1
from gf2bv_tpu_torch.ops.panel_update import rank_k_xor_

torch.set_num_threads(2)

KS = [32, 64, 128, 256]
PIVOTS = ["scanned", "all", "none", "sparse", "half"]


def t32(a):
    return u32_to_torch(a, "cpu")


def _inputs(K, kind, pivots, seed, wp=None, w0=None):
    """arows (K, wp), coeff (K, kw), prow (K,) as numpy arrays.

    ``solver``: a random matrix is scanned (the plain scan twin) and its
    pivot rows and their coefficients gathered, as the solver does;
    ``arbitrary``: random rows and random coefficients (bits t >= k set too,
    rows above the back pass's window with bit j set).  ``pivots`` then
    overrides prow: all rows, none, about a tenth or a half without a pivot."""
    kw = K // 32
    wp = wp or max(16, 2 * kw)
    w0 = kw if w0 is None else w0
    rng = np.random.default_rng(seed)
    rows = 2 * K + 40
    a = rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32)
    if kind == "solver" or pivots == "scanned":
        a[rng.random(rows) < 0.2, w0 : w0 + kw] &= rng.integers(
            0, 2**32, size=kw, dtype=np.uint32)  # some sparse rows: a few columns lack a pivot
        bT = t32(np.ascontiguousarray(a[:, w0 : w0 + kw].T))
        used = torch.from_numpy((rng.random((1, rows)) < 0.3).astype(np.int32))
        prow_t, _, cT = phase1.scan_plain(bT, used, w0, K, 32 * (w0 + kw) - 7)
        prow = prow_t.numpy().copy()
        ps = np.maximum(prow, 0)
        coeff = np.ascontiguousarray(torch_to_u32(cT)[:, ps].T)
    if kind == "solver":
        arows = np.ascontiguousarray(a[ps])
    else:
        arows = rng.integers(0, 2**32, size=(K, wp), dtype=np.uint32)
        coeff = rng.integers(0, 2**32, size=(K, kw), dtype=np.uint32)
    if pivots != "scanned":
        gone = {"all": 0.0, "none": 1.0, "sparse": 0.1, "half": 0.5}[pivots]
        prow = np.where(rng.random(K) < gone, -1, np.arange(K)).astype(np.int32)
    return arows, coeff, prow.astype(np.int32), w0


def _both(arows, coeff, prow, w0):
    kw = arows.shape[0] // 32
    sl = t32(np.ascontiguousarray(arows[:, w0 : w0 + kw]))
    args = (sl, t32(coeff), torch.from_numpy(prow.copy()))
    return phase1.reconstruct_coeff_blocked_plain(*args), phase1.reconstruct_coeff_plain(*args)


@pytest.mark.parametrize("pivots", PIVOTS)
@pytest.mark.parametrize("kind", ["solver", "arbitrary"])
@pytest.mark.parametrize("K", KS)
def test_blocked_order_equals_the_steps(K, kind, pivots):
    arows, coeff, prow, w0 = _inputs(K, kind, pivots, seed=K + len(pivots))
    blocked, steps = _both(arows, coeff, prow, w0)
    assert torch.equal(blocked, steps)
    if pivots == "none":
        assert not blocked.any()
    if pivots == "scanned":
        assert (prow >= 0).sum() > K // 2 and (kind == "arbitrary" or (prow < 0).any())


@pytest.mark.parametrize("kind", ["solver", "arbitrary"])
@pytest.mark.parametrize("K", KS)
def test_blocked_order_through_the_product_equals_pallas(K, kind):
    """pf = T.arows with the blocked T against the Pallas rebuild kernel in
    interpret mode, triangular window and all."""
    arows, coeff, prow, w0 = _inputs(K, kind, "scanned", seed=3 * K + 1, wp=128)
    want = np.asarray(phase1_reconstruct(
        jnp.asarray(arows), jnp.asarray(coeff), jnp.asarray(prow), w0, K,
        32 * (w0 + K // 32) - 7, True,
    ))
    blocked, _ = _both(arows, coeff, prow, w0)
    pf = torch.zeros((K, 128), dtype=torch.int32)
    rank_k_xor_(pf, blocked, t32(arows))
    assert np.array_equal(torch_to_u32(pf), want)
    got = phase1.reconstruct(t32(arows), t32(coeff), torch.from_numpy(prow.copy()), w0)
    assert torch.equal(got, pf)


def _steps_with_a_log(sl, has):
    """The back pass step by step on slice rows alone (coeff = 0, so the
    forward pass leaves T = I and the slice as it is).  Returns the final
    rows and, for each step j, row j as it was when the step used it."""
    K = len(sl)
    rows = [(1 << k) | (s << K) for k, s in enumerate(sl)]
    used_as = {}
    for j in range(K - 1, -1, -1):
        if not has[j]:
            continue
        used_as[j] = rows[j]
        for k in range(32 * ((j >> 5) + 1)):
            if k != j and (rows[k] >> (K + j)) & 1:
                rows[k] ^= rows[j]
    return rows, used_as


def test_a_row_changed_after_it_was_used_needs_its_snapshot():
    """Row 50 is taken by row 5 (a lower group) at step 50, and then changed
    by row 45 at step 45, inside its own group.  Row 45 lacks its own bit 45
    (an arbitrary input: in the solver a pivot row has it), so a panel phase
    that replayed the group's FINAL rows in place of the rows as they were
    used would hand row 5 row 45 twice."""
    K, kw = 64, 2
    sl = [1 << k for k in range(K)]  # the identity: every row its own pivot bit
    sl[5] |= 1 << 50  # row 5 takes row 50 at step 50
    sl[50] |= 1 << 45  # row 50 takes row 45 at step 45, after it was used
    sl[45] = 1 << 3  # row 45: no bit 45 of its own, and a bit row 3 will answer
    has = [True] * K
    rows, used_as = _steps_with_a_log(sl, has)
    assert used_as[50] != rows[50]  # the premise: row 50 changed after its use

    def replay(sources):
        """Row 5 through group 1's steps against ``sources``."""
        row = (1 << 5) | (sl[5] << K)
        for j in range(63, 31, -1):
            if (row >> (K + j)) & 1:
                row ^= sources[j]
        return row

    assert replay(used_as) != replay(rows)  # final rows in place of snapshots go wrong

    def words(vals):
        return t32(np.array([[(v >> (32 * w)) & 0xFFFFFFFF for w in range(kw)] for v in vals],
                            dtype=np.uint32))

    prow = torch.arange(K, dtype=torch.int32)
    coeff = torch.zeros((K, kw), dtype=torch.int32)
    blocked = phase1.reconstruct_coeff_blocked_plain(words(sl), coeff, prow)
    assert torch.equal(blocked, phase1.reconstruct_coeff_plain(words(sl), coeff, prow))
    assert torch.equal(blocked, words([r & ((1 << K) - 1) for r in rows]))
    # row 5 = e5 ^ e50 ^ e45 ^ e3: rows 50 and 45 as they were used, then row 3
    assert torch_to_u32(blocked)[5].tolist() == [(1 << 5) | (1 << 3), (1 << 18) | (1 << 13)]
    assert torch_to_u32(blocked)[50].tolist() == [0, (1 << 18) | (1 << 13)]


def test_window_rows_above_the_group_are_left_alone():
    """Row 40 has bit 3 set, but step 3's window ends at row 31."""
    K, kw = 64, 2
    sl = np.zeros((K, kw), np.uint32)
    sl[np.arange(K), np.arange(K) // 32] = np.uint32(1) << (np.arange(K) % 32).astype(np.uint32)
    sl[40, 0] |= 1 << 3
    sl[2, 0] |= 1 << 3
    prow = torch.arange(K, dtype=torch.int32)
    coeff = torch.zeros((K, kw), dtype=torch.int32)
    got = torch_to_u32(phase1.reconstruct_coeff_blocked_plain(t32(sl), coeff, prow))
    assert got[40].tolist() == [0, 1 << 8]  # untouched: still e40
    assert got[2].tolist() == [(1 << 2) | (1 << 3), 0]
    assert torch.equal(t32(got), phase1.reconstruct_coeff_plain(t32(sl), coeff, prow))


def test_coefficient_bits_at_or_past_the_row_are_ignored():
    K, kw = 64, 2
    arows, coeff, prow, w0 = _inputs(K, "arbitrary", "all", seed=77)
    low = coeff.copy()
    for k in range(K):  # keep only bits t < k
        for w in range(kw):
            keep = np.clip(k - 32 * w, 0, 32)
            low[k, w] &= np.uint32((1 << int(keep)) - 1)
    assert not np.array_equal(low, coeff)
    blocked, _ = _both(arows, coeff, prow, w0)
    blocked_low, steps_low = _both(arows, low, prow, w0)
    assert torch.equal(blocked, blocked_low) and torch.equal(blocked, steps_low)


@pytest.mark.parametrize("K", [64, 256])
def test_batched_rebuild_from_the_blocked_order(K):
    B, wp = 3, 32
    per = [_inputs(K, kind, "scanned" if kind == "solver" else "sparse", seed=K + b, wp=wp)
           for b, kind in enumerate(["solver", "arbitrary", "solver"])]
    w0 = per[0][3]
    arows = t32(np.stack([p[0] for p in per]))
    coeff = t32(np.stack([p[1] for p in per]))
    prow = torch.from_numpy(np.stack([p[2] for p in per]))
    want = gauss_batched.reconstruct_batched_plain(arows, coeff, prow, w0)
    assert torch.equal(gauss_batched.reconstruct_batched(arows, coeff, prow, w0), want)
    pf = torch.zeros_like(arows)
    for b in range(B):
        blocked, _ = _both(*per[b][:3], w0)
        rank_k_xor_(pf[b], blocked, arows[b])
    assert torch.equal(pf, want)


@pytest.mark.parametrize("entry", ["reconstruct_coeff"])
def test_coefficient_solve_wrappers_run_the_twin_on_cpu_tensors(entry):
    """The launcher of the coefficient solve alone takes (K, wp) or
    (B, K, wp), gives the step-by-step twin's T on CPU tensors and counts no
    launch."""
    K, wp = 64, 24
    per = [_inputs(K, "arbitrary", "sparse", seed=b, wp=wp) for b in range(2)]
    w0 = per[0][3]
    fn = getattr(phase1, entry)
    _cuda.reset_launches()
    want = []
    for arows, coeff, prow, _ in per:
        _, steps = _both(arows, coeff, prow, w0)
        got = fn(t32(arows), t32(coeff), torch.from_numpy(prow.copy()), w0)
        assert torch.equal(got, steps)
        want.append(steps)
    got = fn(t32(np.stack([p[0] for p in per])), t32(np.stack([p[1] for p in per])),
             torch.from_numpy(np.stack([p[2] for p in per])), w0)
    assert torch.equal(got, torch.stack(want))
    assert not any(_cuda.LAUNCHES.values())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gf2bv_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the port's kernels from gf2bv_tpu_torch/csrc with nvcc (sm_90a).
3. Holds each of the eleven kernels against its plain PyTorch twin on the
   card, bit for bit, at the flagship MT19937 shapes (20224 rows x 640
   words, K = 256, panel 20), and times both with CUDA events: scan,
   reconstruct, full-width update, segmented update (dead_tiles 1..4),
   trailing update (w0 in {0, 160, 320, 632}, whole matrix), batched scan
   and batched rebuild (4 systems), two-pivot scan, min-key scan, fused
   phase 1, fused update + scan (full and trailing); also the batched
   scan's time per step for 1, 4 and 16 systems and each scan's time per
   step.
4. Drives the mode-0 main path: recovers a random.Random MT19937 state from
   624 outputs through crypto.mt_torch.solve_mt19937 and through
   LinearSystem([32]*624).solve_one, and checks the kernel launch counts of
   one solve (79 scans, 79 reconstructs, 16 full and 63 segmented updates).
5. Checks that a flipped output bit makes the system unsatisfiable.
6. Times solve_mt19937 warm (best of 3).
7. Mode 1: solve_mt19937(mode=1) is a space of dimension 0 at the state;
   without the known-MSB equations LinearSystem.solve_raw_space has
   dimension 31 (the low 31 bits of mt[0] are never read), holds the
   state, and its origin and basis pass the parity check against the
   system.  Launch counts 79 scans, 79 reconstructs, 79 full updates.
8. Batches of 4: LinearSystem.solve_all_batch (mode 1, batched kernels;
   80 batched scans and rebuilds, 320 full updates), gauss_batched.
   solve_batched mode 0 with one flipped system (3 states and None; 80/80
   and 320 trailing updates), LinearSystem.solve_one_batch and
   solve_mt19937_batch (both a loop of the single-system solver), each
   timed warm as recoveries per second.
9. Engines: for each engine of the blocked solver other than the default
   (pallas_scan2, pallas_scanm, pallas, pallas_sub with mxu; mxu_la and
   mxu_noseg with pallas_scan), chosen through GF2BV_TPU_PHASE1/2,
   solve_mt19937 recovers the flagship state with the engine's launch
   counts (pallas_sub: 79 + f scans, rebuilds and updates, f its fallback
   passes), and rref_blocked(trailing=False) gives the default engine's
   RREF and pivot map word for word; each is timed warm (best of 3).  One
   warm solve each under mxu_la and the default runs under torch.profiler
   (device time by kernel).
10. A tall system, 1248 outputs (39968 rows, padded to 40192), is recovered
   under the default engine, pallas_scanm (which must run the 1-pivot scan:
   the min-key packing takes fewer than 2^15 rows) and pallas_sub, each
   timed warm.

Any failure raises (non-zero exit).  The line before the last is a JSON
object with the per-kernel results; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20240531
ROWS, WP, K = 20224, 640, 256  # flagship padded shape and panel width
NB = 4  # systems per batch phase
EXPECTED_LAUNCHES = {"scan": 79, "reconstruct": 79, "update_full": 16, "update_seg": 63}
MODE1_LAUNCHES = {"scan": 79, "reconstruct": 79, "update_full": 79}
BATCH1_LAUNCHES = {"scan_batched": 80, "reconstruct_batched": 80, "update_full": 320}
BATCH0_LAUNCHES = {"scan_batched": 80, "reconstruct_batched": 80, "update_trailing": 320}
# (phase1, phase2) -> launch counts of one flagship mode-0 solve (pallas_sub:
# checked against its fallback count in check_engines)
ENGINE_LAUNCHES = {
    ("pallas_scan2", "mxu"): {"scan2": 79, "reconstruct": 79, "update_full": 16,
                              "update_seg": 63},
    ("pallas_scanm", "mxu"): {"scan_minkey": 79, "reconstruct": 79, "update_full": 16,
                              "update_seg": 63},
    ("pallas", "mxu"): {"phase1_fused": 79, "update_full": 16, "update_seg": 63},
    ("pallas_sub", "mxu"): None,
    ("pallas_scan", "mxu_la"): {"scan": 1, "reconstruct": 79, "update_scan": 79,
                                "update_full": 79},
    ("pallas_scan", "mxu_noseg"): {"scan": 79, "reconstruct": 79, "update_trailing": 79},
}
TALL_SAMPLES = 1248  # 39968 rows: above the min-key scan's 2^15
KERNELS = {
    # name: (wrapper launch-count key, source, TPU kernel it replaces)
    "scan": ("scan", "gf2bv_tpu_torch/csrc/scan.cu",
             "gf2bv_tpu/ops/pallas_phase1.py:233"),
    "reconstruct": ("reconstruct", "gf2bv_tpu_torch/csrc/reconstruct.cu",
                    "gf2bv_tpu/ops/pallas_phase1.py:278"),
    "update_seg": ("update_seg", "gf2bv_tpu_torch/csrc/panel_update.cu",
                   "gf2bv_tpu/ops/pallas_update.py:312"),
    "update_full": ("update_full", "gf2bv_tpu_torch/csrc/panel_update.cu",
                    "gf2bv_tpu/ops/pallas_update.py:65"),
    "update_trailing": ("update_trailing", "gf2bv_tpu_torch/csrc/panel_update.cu",
                        "gf2bv_tpu/ops/pallas_update.py:261"),
    "scan_batched": ("scan_batched", "gf2bv_tpu_torch/csrc/scan.cu",
                     "gf2bv_tpu/ops/gauss_batched.py:53"),
    "reconstruct_batched": ("reconstruct_batched", "gf2bv_tpu_torch/csrc/reconstruct.cu",
                            "gf2bv_tpu/ops/gauss_batched.py:107"),
    "scan2": ("scan2", "gf2bv_tpu_torch/csrc/scan.cu", "gf2bv_tpu/ops/pallas_phase1.py:353"),
    "scan_minkey": ("scan_minkey", "gf2bv_tpu_torch/csrc/scan.cu",
                    "gf2bv_tpu/ops/pallas_phase1.py:439"),
    "phase1_fused": ("phase1_fused", "gf2bv_tpu_torch/csrc/phase1_fused.cu",
                     "gf2bv_tpu/ops/pallas_phase1.py:39"),
    "update_scan": ("update_scan", "gf2bv_tpu_torch/csrc/panel_update.cu",
                    "gf2bv_tpu/ops/pallas_update.py:514"),
}


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` warm calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> int:
    if x.shape != y.shape:
        raise AssertionError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
    return int((x.long() - y.long()).abs().max().item()) if x.numel() else 0


def require_equal(name: str, pairs) -> int:
    err = max(max_abs_err(x, y) for x, y in pairs)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain twin (max_abs_err={err})")
    return err


def mt_outputs(seed: int, n: int = 624):
    rand = random.Random(seed)
    state = tuple(rand.getstate()[1][:-1])
    return state, [rand.getrandbits(32) for _ in range(n)]


def flagship_system(dev, outs) -> torch.Tensor:
    """The (ROWS, WP) padded MT19937 recovery system of ``outs``."""
    from gf2bv_tpu_torch.core.words import u32_to_torch
    from gf2bv_tpu_torch.crypto.mt_torch import mt19937_system_device

    eqs = mt19937_system_device(u32_to_torch(np.array(outs, np.uint32), dev), 32, 624)
    a = torch.nn.functional.pad(eqs, (0, 0, 0, ROWS - eqs.shape[0])).contiguous()
    assert tuple(a.shape) == (ROWS, WP), a.shape
    return a


def check_launches(what: str, want: dict) -> dict:
    """The nonzero launch counts since the last reset, which must be ``want``."""
    from gf2bv_tpu_torch.ops import _cuda

    got = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if got != want:
        raise AssertionError(f"{what}: launch counts {got}, expected {want}")
    return got


def check_kernels(dev, card: str) -> dict:
    """Each kernel against its plain twin at the flagship shapes."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import gauss_blocked, panel_update, phase1

    a = flagship_system(dev, mt_outputs(SEED + 1)[1])
    gen = torch.Generator().manual_seed(SEED)
    used = (torch.rand((1, ROWS), generator=gen) < 0.25).to(torch.int32).to(dev)
    w0 = 20 * (K // 32)
    b_orig = a[:, w0 : w0 + K // 32].clone()
    bT = b_orig.T.contiguous()
    res = {}

    out_k = phase1.scan(bT, used, w0, K, COLS)
    out_p = phase1.scan_plain(bT, used, w0, K, COLS)
    res["scan"] = (require_equal("scan", zip(out_k, out_p)),
                   cuda_ms(lambda: phase1.scan(bT, used, w0, K, COLS), 5),
                   cuda_ms(lambda: phase1.scan_plain(bT, used, w0, K, COLS), 2))
    prow, _, cT = out_k
    if int((prow >= 0).sum()) == 0:
        raise AssertionError("scan comparison panel has no pivots")

    prow_safe = prow.clamp(min=0).long()
    arows = a[prow_safe]
    coeff = cT[:, prow_safe].T.contiguous()
    pf = phase1.reconstruct(arows, coeff, prow, w0)
    pf_p = phase1.reconstruct_plain(arows, coeff, prow, w0)
    res["reconstruct"] = (
        require_equal("reconstruct", [(pf, pf_p)]),
        cuda_ms(lambda: phase1.reconstruct(arows, coeff, prow, w0), 20),
        cuda_ms(lambda: phase1.reconstruct_plain(arows, coeff, prow, w0), 2),
    )

    sel = gauss_blocked.selector_from_prow(b_orig, prow)
    full_k = panel_update.update_full(a.clone(), sel, pf)
    full_p = panel_update.update_full_plain(a.clone(), sel, pf)
    scratch = a.clone()
    res["update_full"] = (
        require_equal("update_full", [(full_k, full_p)]),
        cuda_ms(lambda: panel_update.update_full(scratch, sel, pf), 10),
        cuda_ms(lambda: panel_update.update_full_plain(scratch, sel, pf), 3),
    )

    errs, ms_k, ms_p = [], [], []
    for dead in range(1, WP // 128):
        seg_k = panel_update.update_seg(a.clone(), sel, pf, dead)
        seg_p = panel_update.update_seg_plain(a.clone(), sel, pf, dead)
        lo = 128 * dead
        errs.append(require_equal(
            f"update_seg dead_tiles={dead}",
            [(seg_k[:, :128], seg_p[:, :128]), (seg_k[:, lo:], seg_p[:, lo:])],
        ))
        ms_k.append(cuda_ms(lambda: panel_update.update_seg(scratch, sel, pf, dead), 10))
        ms_p.append(cuda_ms(lambda: panel_update.update_seg_plain(scratch, sel, pf, dead), 3))
        print(f"update_seg dead_tiles={dead}: kernel {ms_k[-1]:.4f} ms, "
              f"plain {ms_p[-1]:.4f} ms ({card})")
    # the segmented update's time is the mean over dead_tiles 1..4
    res["update_seg"] = (max(errs), sum(ms_k) / len(ms_k), sum(ms_p) / len(ms_p))

    errs, ms_k, ms_p = [], [], []
    for w0t in (0, 160, 320, 632):
        tr_k = panel_update.update_trailing(a.clone(), sel, pf, w0t)
        tr_p = panel_update.update_trailing_plain(a.clone(), sel, pf, w0t)
        errs.append(require_equal(f"update_trailing w0={w0t}", [(tr_k, tr_p)]))
        ms_k.append(cuda_ms(lambda: panel_update.update_trailing(scratch, sel, pf, w0t), 10))
        ms_p.append(cuda_ms(lambda: panel_update.update_trailing_plain(scratch, sel, pf, w0t), 3))
        print(f"update_trailing w0={w0t}: kernel {ms_k[-1]:.4f} ms, "
              f"plain {ms_p[-1]:.4f} ms ({card})")
    # the trailing update's time is the mean over the four w0
    res["update_trailing"] = (max(errs), sum(ms_k) / len(ms_k), sum(ms_p) / len(ms_p))
    res.update(check_batched_kernels(dev, card, used, w0))
    res.update(check_engine_kernels(dev, card, a, bT, used, w0, sel, pf))
    for name, (_, ms, plain_ms) in res.items():
        print(f"kernel {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"at the flagship shapes ({card})")
    return res


def check_batched_kernels(dev, card: str, used0: torch.Tensor, w0: int) -> dict:
    """The batched scan and rebuild on NB systems from different seeds, at
    panel 20 with the same pre-used rows; the scan's time per step for 1, NB
    and 16 systems."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import gauss_batched

    mats = torch.stack([flagship_system(dev, mt_outputs(SEED + 10 + b)[1]) for b in range(NB)])
    bT = mats[:, :, w0 : w0 + K // 32].transpose(1, 2).contiguous()
    used = used0.expand(NB, ROWS).contiguous()
    res = {}
    out_k = gauss_batched.scan_batched(bT, used, w0, K, COLS)
    out_p = gauss_batched.scan_batched_plain(bT, used, w0, K, COLS)
    res["scan_batched"] = (
        require_equal("scan_batched", zip(out_k, out_p)),
        cuda_ms(lambda: gauss_batched.scan_batched(bT, used, w0, K, COLS), 5),
        cuda_ms(lambda: gauss_batched.scan_batched_plain(bT, used, w0, K, COLS), 2),
    )
    prow, _, cT = out_k
    if int((prow >= 0).sum(dim=1).min()) == 0:
        raise AssertionError("a batched scan system has no pivots")
    for nb in (1, NB, 16):
        reps = -(-nb // NB)
        bTn = bT.repeat(reps, 1, 1)[:nb].contiguous()
        usedn = used.repeat(reps, 1)[:nb].contiguous()
        ms = cuda_ms(lambda: gauss_batched.scan_batched(bTn, usedn, w0, K, COLS), 5)
        print(f"scan_batched B={nb}: {ms:.4f} ms per panel, {1000 * ms / K:.3f} us per "
              f"step, {ms / nb:.4f} ms per system ({card})")

    ps = prow.clamp(min=0).long()
    arows = torch.gather(mats, 1, ps[:, :, None].expand(NB, K, WP)).contiguous()
    coeff = torch.gather(cT, 2, ps[:, None, :].expand(NB, K // 32, K)).transpose(1, 2).contiguous()
    pf_k = gauss_batched.reconstruct_batched(arows, coeff, prow, w0)
    pf_p = gauss_batched.reconstruct_batched_plain(arows, coeff, prow, w0)
    res["reconstruct_batched"] = (
        require_equal("reconstruct_batched", [(pf_k, pf_p)]),
        cuda_ms(lambda: gauss_batched.reconstruct_batched(arows, coeff, prow, w0), 20),
        cuda_ms(lambda: gauss_batched.reconstruct_batched_plain(arows, coeff, prow, w0), 2),
    )
    return res


def check_engine_kernels(dev, card: str, a, bT, used, w0: int, sel, pf) -> dict:
    """The scan variants, the fused phase 1 and the fused update + scan at
    panel 20 of the flagship system, against their twins."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import panel_update, phase1

    res = {}
    scan_ms = {"scan": None}
    for key, kern, twin in (("scan2", phase1.scan2, phase1.scan2_plain),
                            ("scan_minkey", phase1.scan_minkey, phase1.scan_minkey_plain)):
        out_k = kern(bT, used, w0, K, COLS)
        out_p = twin(bT, used, w0, K, COLS)
        same_as_scan = phase1.scan_plain(bT, used, w0, K, COLS)
        require_equal(f"{key} against the 1-pivot twin", zip(out_k, same_as_scan))
        res[key] = (require_equal(key, zip(out_k, out_p)),
                    cuda_ms(lambda: kern(bT, used, w0, K, COLS), 5),
                    cuda_ms(lambda: twin(bT, used, w0, K, COLS), 2))
        scan_ms[key] = res[key][1]
    scan_ms["scan"] = cuda_ms(lambda: phase1.scan(bT, used, w0, K, COLS), 5)
    # pallas_sub's scan: the first SUBSET_ROWS unused rows
    free = torch.nonzero(used[0] == 0)[: phase1.SUBSET_ROWS, 0]
    bT_sub = bT[:, free].contiguous()
    used_sub = torch.zeros((1, phase1.SUBSET_ROWS), dtype=torch.int32, device=dev)
    scan_ms[f"scan on {phase1.SUBSET_ROWS} rows"] = cuda_ms(
        lambda: phase1.phase1_scan_subset(bT_sub, used_sub, w0, K, COLS), 5)
    for key, ms in scan_ms.items():
        print(f"{key} at panel 20: {ms:.4f} ms per panel, {1000 * ms / K:.3f} us per "
              f"column step ({card})")

    out_k = phase1.phase1_panel(a, bT, used, w0, K, COLS)
    out_p = phase1.phase1_panel_plain(a, bT, used, w0, K, COLS)
    require_equal("phase1_fused against the split engine",
                  zip(out_k, phase1.phase1_panel_split(a, bT, used, w0, K, COLS)))
    split_ms = cuda_ms(lambda: phase1.phase1_panel_split(a, bT, used, w0, K, COLS), 5)
    res["phase1_fused"] = (require_equal("phase1_fused", zip(out_k, out_p)),
                           cuda_ms(lambda: phase1.phase1_panel(a, bT, used, w0, K, COLS), 5),
                           cuda_ms(lambda: phase1.phase1_panel_plain(a, bT, used, w0, K, COLS), 2))
    print(f"phase1 at panel 20: fused kernel {res['phase1_fused'][1]:.4f} ms, split engine "
          f"(scan + gathers + reconstruct) {split_ms:.4f} ms ({card})")

    # the next panel's slice after this panel's update, as the look-ahead loop has it
    kw = K // 32
    errs, ms_k, ms_p = [], [], []
    scratch = a.clone()
    for w0t in (None, w0):
        nxt = panel_update.update_full_plain(a.clone(), sel, pf) if w0t is None else \
            panel_update.update_trailing_plain(a.clone(), sel, pf, w0t)
        bTn = nxt[:, w0 + kw : w0 + 2 * kw].T.contiguous()
        out_k = panel_update.update_scan(a.clone(), sel, pf, bTn, used, w0 + kw, COLS, w0t)
        out_p = panel_update.update_scan_plain(a.clone(), sel, pf, bTn, used, w0 + kw, COLS, w0t)
        errs.append(require_equal(f"update_scan w0={w0t}", zip(out_k, out_p)))
        ms_k.append(cuda_ms(lambda: panel_update.update_scan(
            scratch, sel, pf, bTn, used, w0 + kw, COLS, w0t), 5))
        ms_p.append(cuda_ms(lambda: panel_update.update_scan_plain(
            scratch, sel, pf, bTn, used, w0 + kw, COLS, w0t), 2))
        upd_ms = cuda_ms((lambda: panel_update.update_full(scratch, sel, pf)) if w0t is None
                         else (lambda: panel_update.update_trailing(scratch, sel, pf, w0t)), 10)
        print(f"update_scan w0={w0t}: fused kernel {ms_k[-1]:.4f} ms against scan "
              f"{scan_ms['scan']:.4f} ms + update {upd_ms:.4f} ms apart; plain "
              f"{ms_p[-1]:.4f} ms ({card})")
    # the fused update + scan's time is the mean of the full and trailing cases
    res["update_scan"] = (max(errs), sum(ms_k) / 2, sum(ms_p) / 2)
    return res


def check_main_path(dev, card: str) -> dict:
    from gf2bv_tpu_torch import LinearSystem
    from gf2bv_tpu_torch.crypto.mt import MT19937
    from gf2bv_tpu_torch.crypto.mt_torch import solve_mt19937
    from gf2bv_tpu_torch.ops import _cuda

    state, outs = mt_outputs(SEED)

    _cuda.reset_launches()
    got = solve_mt19937(outs, 32, device=dev)
    torch.cuda.synchronize()
    launches = check_launches("solve_mt19937", EXPECTED_LAUNCHES)
    if got != state:
        raise AssertionError("solve_mt19937 did not recover the MT19937 state")
    print(f"solve_mt19937: state recovered; launches {launches}")

    lin = LinearSystem([32] * 624, device=dev)
    mt = lin.gens()
    rng = MT19937(list(mt))
    zeros = [rng.getrandbits(32) ^ o for o in outs] + [mt[0] ^ 0x80000000]
    t0 = time.perf_counter()
    _cuda.reset_launches()
    got_ls = lin.solve_one(zeros)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    if got_ls != state:
        raise AssertionError("LinearSystem.solve_one did not recover the MT19937 state")
    check_launches("LinearSystem.solve_one", EXPECTED_LAUNCHES)
    t0 = time.perf_counter()
    lin.solve_one(zeros)
    warm_ls = time.perf_counter() - t0
    print(f"LinearSystem.solve_one: state recovered; first call (trace "
          f"materialization + upload + solve) {cold_s:.3f} s, warm {warm_ls:.4f} s ({card})")

    bad = list(outs)
    bad[0] ^= 1
    if solve_mt19937(bad, 32, device=dev) is not None:
        raise AssertionError("a flipped output bit did not make the system unsat")
    print("flipped output bit: unsat detected")

    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if solve_mt19937(outs, 32, device=dev) != state:
            raise AssertionError("warm solve_mt19937 lost the state")
        times.append(time.perf_counter() - t0)
    print(f"solve_mt19937 warm, best of 3: {min(times):.4f} s "
          f"(all {[round(t, 4) for t in times]}) ({card})")
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"solve_mt19937 peak device memory: {peak:.1f} MiB ({card})")
    return launches, min(times)


def in_span(origin: int, basis: list, raw: int) -> bool:
    """True iff raw = origin ^ (a combination of the basis)."""
    pivots = {}
    for v in basis:
        while v:
            top = v.bit_length() - 1
            if top not in pivots:
                pivots[top] = v
                break
            v ^= pivots[top]
    r = raw ^ origin
    while r and (r.bit_length() - 1) in pivots:
        r ^= pivots[r.bit_length() - 1]
    return r == 0


def state_int(state) -> int:
    return sum(v << (32 * i) for i, v in enumerate(state))


def check_mode1(dev, card: str) -> None:
    from gf2bv_tpu_torch import LinearSystem
    from gf2bv_tpu_torch.core import packing
    from gf2bv_tpu_torch.core.words import u32_to_torch
    from gf2bv_tpu_torch.crypto.mt import MT19937
    from gf2bv_tpu_torch.crypto.mt_torch import solve_mt19937
    from gf2bv_tpu_torch.ops import _cuda, gauss_blocked

    state, outs = mt_outputs(SEED)
    _cuda.reset_launches()
    space = solve_mt19937(outs, 32, mode=1, device=dev)
    torch.cuda.synchronize()
    check_launches("solve_mt19937 mode 1", MODE1_LAUNCHES)
    if space is None or space.dimension != 0 or space.origin != state_int(state):
        raise AssertionError("solve_mt19937(mode=1) is not the dimension-0 space at the state")
    print(f"solve_mt19937 mode 1: dimension 0 at the state; launches {MODE1_LAUNCHES}")

    lin = LinearSystem([32] * 624, device=dev)
    mt = lin.gens()
    rng = MT19937(list(mt))
    zeros = [rng.getrandbits(32) ^ o for o in outs]  # no mt[0] ^ 0x80000000
    _cuda.reset_launches()
    t0 = time.perf_counter()
    space = lin.solve_raw_space(zeros)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    check_launches("solve_raw_space", MODE1_LAUNCHES)
    if space is None or space.dimension != 31:
        raise AssertionError(f"solve_raw_space without the MSB equations: dimension "
                             f"{None if space is None else space.dimension}, expected 31")
    if not in_span(space.origin, space.basis, state_int(state)):
        raise AssertionError("the true state is not in the solution space")
    a = u32_to_torch(gauss_blocked._pad(lin.get_eqs_packed(zeros), K, 128), dev)
    a_hom = a.clone()
    a_hom[:, 0] &= ~1  # the homogeneous system: A.[0|v] = 0 for a basis vector

    def words32(v: int) -> torch.Tensor:
        return u32_to_torch(packing.to_u32(packing.ints_to_rows([v], 624 * 32))[0], dev)

    if bool(gauss_blocked.origin_parity_unsat(a, words32(space.origin))):
        raise AssertionError("the origin does not satisfy the system")
    for v in space.basis:
        if bool(gauss_blocked.origin_parity_unsat(a_hom, words32(v))):
            raise AssertionError("a basis vector does not solve the homogeneous system")
    t0 = time.perf_counter()
    lin.solve_raw_space(zeros)
    warm_s = time.perf_counter() - t0
    print(f"solve_raw_space without the MSB equations: dimension 31, state in the "
          f"space, origin and 31 basis vectors pass the parity check; first call "
          f"{cold_s:.3f} s, warm {warm_s:.4f} s ({card})")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_batches(dev, card: str, single_s: float) -> dict:
    """The batch phases; returns the new kernels' launch counts."""
    from gf2bv_tpu_torch import LinearSystem
    from gf2bv_tpu_torch.crypto.mt import MT19937
    from gf2bv_tpu_torch.crypto.mt_torch import COLS, _state_words, solve_mt19937_batch
    from gf2bv_tpu_torch.ops import _cuda, gauss_batched

    pairs = [mt_outputs(SEED + 100 + b) for b in range(NB)]
    states = [s for s, _ in pairs]
    lin = LinearSystem([32] * 624, device=dev)
    mt = lin.gens()

    def zeros_of(outs):
        rng = MT19937(list(mt))
        return [rng.getrandbits(32) ^ o for o in outs] + [mt[0] ^ 0x80000000]

    zb = [zeros_of(outs) for _, outs in pairs]
    rates = {}

    _cuda.reset_launches()
    gens = lin.solve_all_batch(zb)
    torch.cuda.synchronize()
    mode1 = check_launches("solve_all_batch", BATCH1_LAUNCHES)
    if [list(g) for g in gens] != [[s] for s in states]:
        raise AssertionError("solve_all_batch did not yield exactly each state")
    _, t = timed(lambda: [list(g) for g in lin.solve_all_batch(zb)])
    rates["LinearSystem.solve_all_batch (mode 1, batched kernels)"] = t

    mats = torch.stack([flagship_system(dev, outs) for _, outs in pairs])
    mats[NB - 1, 0, 0] ^= 1  # flip one observed bit of the last system
    want = states[: NB - 1] + [None]

    def batched0():
        got = gauss_batched.solve_batched(mats, COLS, 0, device=dev)
        return [None if o is None else _state_words(o) for o in got]

    _cuda.reset_launches()
    got = batched0()
    mode0 = check_launches("solve_batched mode 0", BATCH0_LAUNCHES)
    if got != want:
        raise AssertionError("solve_batched mode 0 did not give 3 states and None")
    _, t = timed(batched0)
    rates["gauss_batched.solve_batched mode 0 (batched kernels, trailing)"] = t

    got, _ = timed(lambda: lin.solve_one_batch(zb))
    if got != states:
        raise AssertionError("solve_one_batch did not recover the states")
    _, t = timed(lambda: lin.solve_one_batch(zb))
    rates["LinearSystem.solve_one_batch (chained single-system solver)"] = t

    outs_b = [outs for _, outs in pairs]
    if solve_mt19937_batch(outs_b, 32, device=dev) != states:
        raise AssertionError("solve_mt19937_batch did not recover the states")
    _, t = timed(lambda: solve_mt19937_batch(outs_b, 32, device=dev))
    rates["solve_mt19937_batch (chained single-system solver)"] = t

    print(f"batch paths recover their states; single warm solve_mt19937 "
          f"{single_s:.4f} s = {1 / single_s:.3f} recoveries/s ({card})")
    for name, t in rates.items():
        print(f"{name}: B={NB} warm {t:.4f} s = {NB / t:.3f} recoveries/s ({card})")
    return {"scan_batched": mode1["scan_batched"],
            "reconstruct_batched": mode1["reconstruct_batched"],
            "update_trailing": mode0["update_trailing"]}


@contextlib.contextmanager
def engines_env(phase1: str, phase2: str):
    """GF2BV_TPU_PHASE1/2 set for the body, as a user selects engines."""
    saved = {k: os.environ.get(k) for k in ("GF2BV_TPU_PHASE1", "GF2BV_TPU_PHASE2")}
    os.environ["GF2BV_TPU_PHASE1"], os.environ["GF2BV_TPU_PHASE2"] = phase1, phase2
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def warm_best(fn, want, what: str) -> float:
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if fn() != want:
            raise AssertionError(f"{what}: warm run lost the state")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times)


def check_subset_launches(what: str) -> dict:
    from gf2bv_tpu_torch.ops import _cuda, gauss_blocked

    f = gauss_blocked.SUBSET_FALLBACKS["panels"]
    got = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    ok = (set(got) <= {"scan", "reconstruct", "update_full", "update_seg"}
          and got.get("scan") == got.get("reconstruct") == 79 + f
          and got.get("update_full", 0) + got.get("update_seg", 0) == 79 + f)
    if not ok:
        raise AssertionError(f"{what}: launch counts {got} with {f} fallback passes")
    return got


def profile_solve(solve, card: str, what: str, warm_s: float) -> None:
    """Device time by kernel of one warm solve under torch.profiler; the
    idle share is read against the unprofiled warm wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile {what}: wall {1000 * wall:.1f} ms under the profiler, device self "
          f"time {total / 1000:.1f} ms; against the warm {1000 * warm_s:.1f} ms the device "
          f"is idle {100 * max(0.0, 1 - total / 1e6 / warm_s):.1f}% ({card})")
    for dev_us, key, count in rows[:6]:
        print(f"  {dev_us / 1000:9.2f} ms {count:5d}x {key[:90]}")


def check_engines(dev, card: str) -> dict:
    """Every other engine through solve_mt19937, with its launch counts, and
    its full RREF against the default engine's; the tall system."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS, solve_mt19937
    from gf2bv_tpu_torch.ops import _cuda, gauss_blocked

    state, outs = mt_outputs(SEED)
    a = flagship_system(dev, outs)
    rref_d, pof_d, _ = gauss_blocked.rref_blocked(a, COLS, K, False)
    default_s = warm_best(lambda: solve_mt19937(outs, 32, device=dev), state, "default")
    print(f"engine pallas_scan+mxu (default): solve_mt19937 warm best of 3 "
          f"{default_s:.4f} s ({card})")
    # the profiler's first session pays its own start-up; keep it out of the engines'
    profile_solve(lambda: solve_mt19937(outs, 32, device=dev), card, "start-up", default_s)
    launches = {}
    for (p1, p2), want in ENGINE_LAUNCHES.items():
        name = f"{p1}+{p2}"
        with engines_env(p1, p2):
            _cuda.reset_launches()
            gauss_blocked.SUBSET_FALLBACKS["panels"] = 0
            got = solve_mt19937(outs, 32, device=dev)
            torch.cuda.synchronize()
            counts = check_subset_launches(name) if want is None else check_launches(name, want)
            fallbacks = gauss_blocked.SUBSET_FALLBACKS["panels"]
            if got != state:
                raise AssertionError(f"{name}: solve_mt19937 did not recover the state")
            for k, v in counts.items():
                launches[k] = max(launches.get(k, 0), v)
            rref, pof, _ = gauss_blocked.rref_blocked(a, COLS, K, False, phase1=p1, phase2=p2)
            require_equal(f"{name} rref_blocked against the default engine",
                          [(rref, rref_d), (pof, pof_d)])
            best = warm_best(lambda: solve_mt19937(outs, 32, device=dev), state, name)
            profile_solve(lambda: solve_mt19937(outs, 32, device=dev), card, name, best)
        extra = f", {fallbacks} subset fallback passes" if want is None else ""
        print(f"engine {name}: state recovered, full RREF = default; launches {counts}"
              f"{extra}; solve_mt19937 warm best of 3 {best:.4f} s ({card})")
    profile_solve(lambda: solve_mt19937(outs, 32, device=dev), card, "pallas_scan+mxu",
                  default_s)

    tstate, touts = mt_outputs(SEED + 7, TALL_SAMPLES)
    for p1 in ("pallas_scan", "pallas_scanm", "pallas_sub"):
        with engines_env(p1, "mxu"):
            _cuda.reset_launches()
            gauss_blocked.SUBSET_FALLBACKS["panels"] = 0
            got = solve_mt19937(touts, 32, samples=TALL_SAMPLES, device=dev)
            torch.cuda.synchronize()
            if p1 == "pallas_sub":
                counts = check_subset_launches("tall pallas_sub")
            else:  # pallas_scanm runs the 1-pivot scan at 40192 rows
                counts = check_launches(f"tall {p1}", {
                    "scan": 79, "reconstruct": 79, "update_full": 16, "update_seg": 63})
            if got != tstate:
                raise AssertionError(f"tall system, {p1}: state not recovered")
            best = warm_best(lambda: solve_mt19937(touts, 32, samples=TALL_SAMPLES, device=dev),
                             tstate, f"tall {p1}")
        print(f"tall system ({TALL_SAMPLES} outputs, 40192 x 640 words), {p1}+mxu: state "
              f"recovered; launches {counts}, {gauss_blocked.SUBSET_FALLBACKS['panels']} "
              f"subset fallback passes; solve_mt19937 warm best of 3 {best:.4f} s ({card})")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from gf2bv_tpu_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    so = _cuda.build()
    _cuda.lib()
    print(f"kernels built: {so.name} in {time.perf_counter() - t0:.1f} s")

    res = check_kernels(dev, card)
    launches, single_s = check_main_path(dev, card)
    check_mode1(dev, card)
    # the other kernels' counts come from the phases that drive them
    launches.update(check_batches(dev, card, single_s))
    engine_launches = check_engines(dev, card)
    for key in ("scan2", "scan_minkey", "phase1_fused", "update_scan"):
        launches[key] = engine_launches[key]

    kernels = []
    for name, (key, source, replaces) in KERNELS.items():
        err, ms, plain_ms = res[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

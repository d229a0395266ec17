#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gf2bv_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the port's kernels from gf2bv_tpu_torch/csrc with nvcc (sm_90a).
3. Holds each of the fifteen kernels against its plain PyTorch twin on the
   card, bit for bit, at the flagship MT19937 shapes (20224 rows x 640
   words, K = 256, panel 20), and times both with CUDA events: scan,
   reconstruct, full-width update, segmented update (dead_tiles 1..4),
   trailing update (w0 in {0, 160, 320, 632}, whole matrix), batched scan
   and batched rebuild (4 systems), two-pivot scan, min-key scan, fused
   phase 1, fused update + scan (full and trailing); also the batched
   scan's time per step for 1, 4 and 16 systems and each scan's time per
   step.  The update engines' kernels (the table kernel of engine pallas,
   the tensor-core kernels of mxu2 and mxu4) run at panel 20 of the 768-word
   multi-RHS matrix, mxu2 and mxu4 also trailing at w0 = 160 and 632 on 640
   words; the launch probe on (256, 128) words.  Beside each time stands the
   kernel's bound: its bytes (inputs read once, outputs written once) over
   3.35 TB/s, or its operations over the int8 tensor-core peak.
   Then the launch floor: microseconds per launch over 256 chained launches
   of the probe, of torch.bitwise_xor and of the one-tile update.
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

11. Multi-RHS: one captured MT19937 template, 256 instances from
   random.Random seeds through CapturedTrace.solve_one_batch (one
   elimination on 768 words): every state recovered, a flipped output bit
   gives None for that instance only, launch counts 79 scans, 79 rebuilds,
   79 full updates, 0 segmented; warm time, recoveries per second, the device
   time of solve_multi_rhs_device alone, a profile; the same batch under
   GF2BV_TPU_PHASE2 = pallas, mxu2, mxu4 (79 launches of the engine's own
   kernel, none of the default update), answers equal.
12. Sweep: the flagship with 12 state bits pinned, solve_one_sweep over all
   4096 candidates: exactly one solves and it is the true state; warm time,
   candidates per second; the second call reuses the cached device matrix.
13. The update engines pallas, mxu2, mxu4 through solve_mt19937 like the
   engines of phase 9; skip (phase 1 alone: no state comes back) timed warm;
   the portable jnp engines on a small system against the default engine.

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
UPDATE_ENGINES = ("pallas", "mxu2", "mxu4")
for _p2 in UPDATE_ENGINES:
    ENGINE_LAUNCHES[("pallas_scan", _p2)] = {"scan": 79, "reconstruct": 79,
                                             f"update_{_p2}": 79}
MULTI_LAUNCHES = {"scan": 79, "reconstruct": 79, "update_full": 79}
WP_MULTI = WP + 128  # the multi-RHS matrix: one appended 128-word tile
NB_MULTI = 256  # instances of the multi-RHS batch
SWEEP_BITS = 12  # pinned state bits of the sweep: 4096 candidates
HBM_BYTES_PER_MS = 3.35e9  # 3.35 TB/s
INT8_OPS_PER_MS = 1.979e12  # 1,979 TOP/s, dense int8 tensor cores at 700 W
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
    "update_pallas": ("update_pallas", "gf2bv_tpu_torch/csrc/update_table.cu",
                      "gf2bv_tpu/ops/pallas_update.py:35"),
    "update_mxu2": ("update_mxu2", "gf2bv_tpu_torch/csrc/update_mma.cu",
                    "gf2bv_tpu/ops/pallas_update.py:86"),
    "update_mxu4": ("update_mxu4", "gf2bv_tpu_torch/csrc/update_mma.cu",
                    "gf2bv_tpu/ops/pallas_update.py:129"),
    "launch_probe": ("launch_probe", "gf2bv_tpu_torch/csrc/launch_probe.cu",
                     "scripts/bench_launch_floor.py:55"),
}
# name -> (bound_ms, "bytes" or "operations"), filled beside each comparison
BOUNDS: dict = {}
LIBRARY_MS: dict = {}  # name -> ms of the one PyTorch call computing the same function


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def note_bound(name: str, moved_bytes: float, mma_ops: float = 0.0) -> None:
    """The least time the card could take: the bytes the function must move
    (inputs read once, outputs written once) over the memory rate, or, for a
    kernel that issues tensor-core ``mma`` instructions, its product's
    operations over the int8 tensor-core peak, whichever is larger.  The
    kernels on the CUDA cores (mask-and-XOR, tables, scans, rebuilds) have no
    arithmetic peak in the card's data sheet to name: bytes bound them.
    Several cases of one kernel average."""
    by_bytes, by_ops = moved_bytes / HBM_BYTES_PER_MS, mma_ops / INT8_OPS_PER_MS
    ms, by = max((by_bytes, "bytes"), (by_ops, "operations"))
    if name in BOUNDS:
        n, (old, old_by) = BOUNDS[name][2], BOUNDS[name][:2]
        BOUNDS[name] = ((old * n + ms) / (n + 1), by if ms > old else old_by, n + 1)
    else:
        BOUNDS[name] = (ms, by, 1)


def update_bytes(rows: int, kw: int, live_words: int) -> int:
    """Bytes of a rank-K update that touches ``live_words`` words of every
    row: a read and written, sel and pf's live words read."""
    return 4 * (2 * rows * live_words + rows * kw + 32 * kw * live_words)


def product_ops(rows: int, kw: int, live_words: int) -> float:
    """The same update priced as a product on bit planes: 2 * rows * K * 32 *
    live_words operations.  It bounds the kernels that run it on the tensor
    cores; for the others it is printed as a reading beside the byte bound."""
    return 2.0 * rows * 32 * kw * 32 * live_words


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
    note_bound("scan", nbytes(bT, used, *out_k))

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

    note_bound("reconstruct", nbytes(arows, coeff, prow, pf))

    sel = gauss_blocked.selector_from_prow(b_orig, prow)
    note_bound("update_full", update_bytes(ROWS, K // 32, WP))
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
        note_bound("update_seg", update_bytes(ROWS, K // 32, 1 + WP - lo))
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
        live = WP if w0t < 128 else 1 + WP - 128 * (w0t // 128)
        note_bound("update_trailing", update_bytes(ROWS, K // 32, live))
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
    res.update(check_update_engine_kernels(dev, card, a, used, w0, sel, pf))
    for name, (_, ms, plain_ms) in res.items():
        bound_ms, by, _ = BOUNDS[name]
        print(f"kernel {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"by {by} at the flagship shapes ({card})")
    # a reading, not a bound: what the CUDA-core updates' work would take as an int8
    # tensor-core product at the published peak
    for name, words in (("update_full", WP), ("update_pallas", WP_MULTI)):
        as_product = product_ops(ROWS, K // 32, words) / INT8_OPS_PER_MS
        print(f"kernel {name}: {words} words as an int8 tensor-core product at 1,979 TOP/s "
              f"would take {as_product:.4f} ms (no bound: the kernel issues no mma)")
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
    note_bound("scan_batched", nbytes(bT, used, *out_k))
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
    note_bound("reconstruct_batched", nbytes(arows, coeff, prow, pf_k))
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
        note_bound(key, nbytes(bT, used, *out_k))
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
    # the slice, the K pivot rows of a, and pf, prow, used out
    note_bound("phase1_fused", nbytes(bT, used, *out_k) + 4 * K * WP)
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
        upd_bytes = update_bytes(ROWS, kw, WP if w0t is None else 1 + WP - 128 * (w0t // 128))
        note_bound("update_scan", upd_bytes + nbytes(bTn, used, *out_k[1:]))
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


def check_update_engine_kernels(dev, card: str, a, used, w0: int, sel640, pf640) -> dict:
    """The table kernel (engine pallas) and the tensor-core kernels (mxu2,
    mxu4) at panel 20 of the 768-word multi-RHS matrix (the flagship system
    with one appended tile of 256 instances' affine columns), against their
    twins and the default update; mxu2 and mxu4 also trailing on 640 words."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import gauss_blocked, launch_floor, panel_update, phase1

    kw = K // 32
    gen = torch.Generator().manual_seed(SEED + 2)
    rhs = torch.zeros((ROWS, 128), dtype=torch.int32)
    rhs[:, : NB_MULTI // 32] = torch.randint(
        -2**31, 2**31 - 1, (ROWS, NB_MULTI // 32), generator=gen, dtype=torch.int64
    ).to(torch.int32)
    a768 = torch.cat([a, rhs.to(dev)], dim=1).contiguous()
    assert tuple(a768.shape) == (ROWS, WP_MULTI)
    b_orig = a768[:, w0 : w0 + kw].clone()
    pf, prow, _ = phase1.phase1_panel_split(a768, b_orig.T.contiguous(), used, w0, K, COLS)
    sel = gauss_blocked.selector_from_prow(b_orig, prow)
    want = panel_update.update_full(a768.clone(), sel, pf)
    scratch = a768.clone()
    full_ms = cuda_ms(lambda: panel_update.update_full(scratch, sel, pf), 10)
    print(f"update_full on {WP_MULTI} words (the default engine's update there): "
          f"{full_ms:.4f} ms ({card})")
    res = {}
    cases = {
        "update_pallas": (panel_update.update_pallas, panel_update.update_pallas_plain),
        "update_mxu2": (panel_update.update_mxu2, panel_update.update_mxu2_plain),
        "update_mxu4": (panel_update.update_mxu4, panel_update.update_mxu4_plain),
    }
    for name, (kern, twin) in cases.items():
        got = kern(a768.clone(), sel, pf)
        err = require_equal(name, [(got, twin(a768.clone(), sel, pf)), (got, want)])
        res[name] = (err, cuda_ms(lambda: kern(scratch, sel, pf), 10),
                     cuda_ms(lambda: twin(scratch, sel, pf), 1))
        # the table kernel issues no mma: bytes bound it; mxu2 and mxu4 run the product
        note_bound(name, update_bytes(ROWS, kw, WP_MULTI),
                   0.0 if name == "update_pallas" else product_ops(ROWS, kw, WP_MULTI))
    scratch = a.clone()
    for name in ("update_mxu2", "update_mxu4"):
        kern, twin = cases[name]
        for w0t in (160, 632):
            got = kern(a.clone(), sel640, pf640, w0t)
            require_equal(f"{name} w0={w0t}", [(got, twin(a.clone(), sel640, pf640, w0t))])
            ms = cuda_ms(lambda: kern(scratch, sel640, pf640, w0t), 10)
            print(f"{name} trailing w0={w0t} on {WP} words: kernel {ms:.4f} ms ({card})")

    # the probe's times are per launch of a 256-launch chain replayed from a CUDA
    # graph: launched from Python the chain is bound by the host (check_launch_floor).
    # Its count in the kernels line is the wrapper's calls there, not the replays.
    probe_in = a[:256, :128].contiguous()
    got = launch_floor.tiny_call(probe_in)
    one = torch.ones((), dtype=torch.int32, device=dev)
    res["launch_probe"] = (
        require_equal("launch_probe", [(got, launch_floor.tiny_call_plain(probe_in))]),
        launch_floor.chain_us(launch_floor.tiny_call, probe_in, 256, graph=True) / 1000,
        launch_floor.chain_us(launch_floor.tiny_call_plain, probe_in, 256, graph=True) / 1000,
    )
    note_bound("launch_probe", nbytes(probe_in, got))
    LIBRARY_MS["launch_probe"] = launch_floor.chain_us(
        lambda x: torch.bitwise_xor(x, one), probe_in, 256, graph=True) / 1000
    return res


def check_launch_floor(dev, card: str) -> int:
    """Microseconds per launch over chains of 256; returns the probe's
    wrapper calls over the measurement (the Python-launched chain and the
    capture pass of the graph, with their warm-ups)."""
    from gf2bv_tpu_torch.ops import _cuda, launch_floor

    _cuda.reset_launches()
    floor = launch_floor.measure(dev, 256)
    launches = _cuda.LAUNCHES["launch_probe"]
    if launches < 512:
        raise AssertionError(f"the launch-floor chains made {launches} probe launches")
    print(f"launch floor, chains of {floor['n']} replayed from a CUDA graph, us per launch: "
          f"probe {floor['probe_us']:.3f} (launched from Python {floor['probe_python_us']:.3f}), "
          f"torch.bitwise_xor {floor['bitwise_xor_us']:.3f}; latency of the rank-256 update on "
          f"one (256, 128) tile, to read against the floor: {floor['update_tile_us']:.3f} "
          f"({card})")
    print(f"launch_probe: {launches} wrapper calls in this measurement (8 warm-ups + "
          f"{floor['n']} launched from Python, 8 warm-ups + {floor['n']} while the graph was "
          f"captured); a graph replay launches the kernel without the wrapper and adds none")
    return launches


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


def check_multi_rhs(dev, card: str) -> dict:
    """One captured MT19937 template, NB_MULTI instances in one elimination,
    under the default update and under each update engine; returns the
    launch counts of the engines' kernels."""
    from gf2bv_tpu_torch import LinearSystem
    from gf2bv_tpu_torch.crypto.mt import MT19937
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import _cuda, lazy_solve, multi_rhs
    from gf2bv_tpu_torch.core.words import u32_to_torch

    lin = LinearSystem([32] * 624, device=dev)

    def model(ws, p):
        rng = MT19937(list(ws))
        return [rng.getrandbits(32) ^ p[k] for k in range(624)] + [ws[0] ^ 0x80000000]

    tmpl = lin.capture(model)
    pairs = [mt_outputs(91_000 + k) for k in range(NB_MULTI)]
    states = [s for s, _ in pairs]
    batch = [outs for _, outs in pairs]
    t0 = time.perf_counter()
    if tmpl.solve_one(batch[0]) != states[0]:
        raise AssertionError("captured-trace solve_one did not recover the state")
    print(f"captured template: first solve_one (trace, upload, solve) "
          f"{time.perf_counter() - t0:.3f} s ({card})")

    _cuda.reset_launches()
    raws = tmpl.solve_raw_batch(batch)
    torch.cuda.synchronize()
    launches = check_launches("solve_raw_batch", MULTI_LAUNCHES)
    sols = tmpl.solve_one_batch(batch)
    if sols != states or lin._convert_sols_batch(raws) != states:
        raise AssertionError("the multi-RHS batch did not recover every state")
    bad = [list(o) for o in batch]
    bad[5][0] ^= 1
    got = tmpl.solve_one_batch(bad)
    if got[5] is not None or got[:5] + got[6:] != states[:5] + states[6:]:
        raise AssertionError("a flipped output bit must unsat its own instance only")
    times = [timed(lambda: tmpl.solve_one_batch(batch))[1] for _ in range(3)]
    warm = min(times)
    print(f"multi-RHS solve_one_batch B={NB_MULTI}: all states recovered, flipped instance "
          f"None; launches {launches}; warm best of 3 {warm:.4f} s = {NB_MULTI / warm:.1f} "
          f"recoveries/s (all {[round(t, 4) for t in times]}) ({card})")

    cs = lazy_solve.cached_system(lin, tmpl.zeros)
    exprs = [z._expr for z in tmpl.zeros]
    affs = tmpl._affine_matrix(exprs, cs.widths, batch)
    bw = multi_rhs._bw_for(NB_MULTI)
    rhs_dev = u32_to_torch(multi_rhs._pack_rhs(affs[:, cs.kept], cs.a_dev.shape[0], bw), dev)
    if tuple(cs.a_dev.shape) != (ROWS, WP):
        raise AssertionError(f"cached matrix {tuple(cs.a_dev.shape)}")
    dev_ms = cuda_ms(lambda: multi_rhs.solve_multi_rhs_device(cs.a_dev, COLS, rhs_dev, bw), 2)
    print(f"multi-RHS solve_multi_rhs_device alone (elimination on {WP_MULTI} words + "
          f"extraction, CUDA events): {dev_ms:.2f} ms = {1000 * NB_MULTI / dev_ms:.1f} "
          f"recoveries/s on the card ({card})")
    profile_solve(lambda: tmpl.solve_one_batch(batch), card, f"multi-RHS B={NB_MULTI}", warm)

    for p2 in UPDATE_ENGINES:
        with engines_env("pallas_scan", p2):
            _cuda.reset_launches()
            got = tmpl.solve_one_batch(batch)
            torch.cuda.synchronize()
            counts = check_launches(f"multi-RHS under {p2}", {
                "scan": 79, "reconstruct": 79, f"update_{p2}": 79})
            if got != states:
                raise AssertionError(f"multi-RHS under {p2}: states differ from the default's")
            launches[f"update_{p2}"] = counts[f"update_{p2}"]
            t = min(timed(lambda: tmpl.solve_one_batch(batch))[1] for _ in range(2))
            dms = cuda_ms(
                lambda: multi_rhs.solve_multi_rhs_device(cs.a_dev, COLS, rhs_dev, bw), 2)
        print(f"multi-RHS under phase2={p2}: same states; launches {counts}; warm best of 2 "
              f"{t:.4f} s = {NB_MULTI / t:.1f} recoveries/s; device alone {dms:.2f} ms ({card})")
    return launches


def check_sweep(dev, card: str) -> None:
    """The flagship with SWEEP_BITS state bits pinned: every candidate one RHS
    column of a single elimination."""
    from gf2bv_tpu_torch import LinearSystem
    from gf2bv_tpu_torch.core import system
    from gf2bv_tpu_torch.crypto.mt import MT19937
    from gf2bv_tpu_torch.ops import _cuda

    state, outs = mt_outputs(SEED)
    lin = LinearSystem([32] * 624, device=dev)
    mt = lin.gens()
    rng = MT19937(list(mt))
    zeros = [rng.getrandbits(32) ^ o for o in outs] + [mt[0] ^ 0x80000000]
    guesses = [mt[1][i] for i in range(SWEEP_BITS)]
    k_true = state[1] & ((1 << SWEEP_BITS) - 1)
    system._sweep_adev_cache.clear()
    _cuda.reset_launches()
    sols, cold = timed(lambda: lin.solve_one_sweep(zeros, guesses))
    launches = check_launches("solve_one_sweep", MULTI_LAUNCHES)
    if len(sols) != 1 << SWEEP_BITS or sols[k_true] != state:
        raise AssertionError("the sweep did not recover the state at the true candidate")
    if sum(x is not None for x in sols) != 1:
        raise AssertionError("more than one sweep candidate solved")
    (cached,) = system._sweep_adev_cache.values()
    times = [timed(lambda: lin.solve_one_sweep(zeros, guesses))[1] for _ in range(2)]
    if list(system._sweep_adev_cache.values())[0] is not cached:
        raise AssertionError("the second sweep did not reuse the cached device matrix")
    warm = min(times)
    print(f"sweep: {1 << SWEEP_BITS} candidates, 1 solves (the true state); launches "
          f"{launches}; first call {cold:.3f} s, warm (cached device matrix "
          f"{tuple(cached.shape)}) best of 2 {warm:.4f} s = {(1 << SWEEP_BITS) / warm:.0f} "
          f"candidates/s ({card})")
    system._sweep_adev_cache.clear()


def check_skip_and_jnp(dev, card: str) -> None:
    """phase2=skip times phase 1 alone (no state comes back); the portable
    jnp engines run on a small system against the default engine."""
    from gf2bv_tpu_torch.core import packing
    from gf2bv_tpu_torch.core.words import u32_to_torch
    from gf2bv_tpu_torch.crypto.mt_torch import solve_mt19937
    from gf2bv_tpu_torch.ops import _cuda, gauss_blocked

    state, outs = mt_outputs(SEED)
    with engines_env("pallas_scan", "skip"):
        _cuda.reset_launches()
        got = solve_mt19937(outs, 32, device=dev)
        torch.cuda.synchronize()
        check_launches("skip", {"scan": 79, "reconstruct": 79})
        if got == state:
            raise AssertionError("phase2=skip cannot recover the state")
        t = min(timed(lambda: solve_mt19937(outs, 32, device=dev))[1] for _ in range(3))
    print(f"engine pallas_scan+skip (phase 1 alone, no update, no state): solve_mt19937 "
          f"warm best of 3 {t:.4f} s ({card})")

    rng = np.random.default_rng(SEED)
    cols, rows = 300, 400
    bits = rng.integers(0, 2, size=(rows, 1 + cols)).astype(np.uint8)
    bits[:, 0] = (bits[:, 1:] @ rng.integers(0, 2, size=cols)) % 2
    a = u32_to_torch(gauss_blocked._pad(packing.pack_bits(bits, 1 + cols), 64, 128), dev)
    want = gauss_blocked.rref_blocked(a, cols, 64, False)
    _cuda.reset_launches()
    got, t = timed(lambda: gauss_blocked.rref_blocked(a, cols, 64, False,
                                                      phase1="jnp", phase2="jnp"))
    check_launches("jnp engines", {})
    require_equal("jnp engines against the default engine", zip(got[:2], want[:2]))
    o_j, u_j = gauss_blocked.rref_origin_blocked(a, cols, 64, phase1="jnp", phase2="jnp")
    o_d, u_d = gauss_blocked.rref_origin_blocked(a, cols, 64)
    require_equal("jnp engines, trailing origin", [(o_j, o_d)])
    if bool(u_j) or bool(u_d):
        raise AssertionError("the small system must be satisfiable")
    print(f"engines jnp+jnp on a {tuple(a.shape)} system (K = 64): RREF and origin = the "
          f"default engine's, no kernel launched; {t:.3f} s ({card})")


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
    check_skip_and_jnp(dev, card)
    launches["launch_probe"] = check_launch_floor(dev, card)
    # this slice's path: the update engines' counts come from the multi-RHS batches
    multi = check_multi_rhs(dev, card)
    for p2 in UPDATE_ENGINES:
        launches[f"update_{p2}"] = multi[f"update_{p2}"]
    check_sweep(dev, card)

    kernels = []
    for name, (key, source, replaces) in KERNELS.items():
        err, ms, plain_ms = res[name]
        if launches[key] < 1:
            raise AssertionError(f"kernel {name} was launched no time on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": BOUNDS[name][0], "bound_by": BOUNDS[name][1],
            "library_ms": LIBRARY_MS.get(name),
        })
    # the probe's ms is a graph replay's; its launches are the wrapper's calls in the
    # launch-floor measurement (Python-launched chain, capture pass, warm-ups)
    assert kernels[-1]["name"] == "launch_probe"
    kernels[-1]["launches_are"] = "wrapper calls: chain from Python + graph capture + warm-ups"
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

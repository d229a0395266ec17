#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gf2bv_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py
(``--kernels-only`` stops after phase 3 and prints no result line;
``--phases routing,sfmt,incremental,models,sharded`` runs the named phases of
15-19 alone after the build, and prints no result line either.)

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the port's kernels from gf2bv_tpu_torch/csrc with nvcc (sm_90a).
3. Holds each kernel (the ports of the fifteen TPU kernels, the chained scans
   (1-pivot, batched, two-pivot) and the chained fused kernels of slices
   taller than one cluster, and the subset-first scan) against its plain
   PyTorch twin on the card, bit for bit, at the flagship MT19937 shapes
   (20224 rows x 640 words, K = 256, panel 20), and times both with CUDA
   events: scan, reconstruct, full-width update, segmented update
   (dead_tiles 1..4), trailing update (w0 in {0, 160, 320, 632}, whole
   matrix), batched scan and batched rebuild (4 systems), two-pivot scan (a
   cluster kernel, against both twins and its cluster twin, beside the
   1-pivot scan, in microseconds per pair step), min-key scan (a cluster
   kernel, against both twins, beside the 1-pivot scan), fused phase 1 (one
   cluster launch, beside the split engine and the scan alone), fused
   update + scan (full and trailing; beside the scan and the update apart,
   and its update part alone); also the batched scan's time per step for 1,
   4, 8 and 16 systems on each cluster size that holds a slice, beside the
   clusters of each size the card runs at once, and each scan's time per
   step.  The update engines' kernels (the table kernel of engine pallas,
   the tensor-core kernel that mxu2 and mxu4 share under their two rules)
   run at panel 20 of the 768-word multi-RHS matrix, mxu2 and mxu4 also
   trailing at w0 = 160 and 632 on 640 words, the three again from a CUDA
   graph's replay; the launch probe on (256, 128) words.  Beside each time
   stands the kernel's bound: its bytes (inputs read once, outputs written
   once) over 3.35 TB/s (the data sheet names no one-bit tensor-core rate,
   so the product of the mxu updates is printed against the int8 peak as a
   reading only).
   The redesigned kernels are held to more (check_redesign): the rebuild's
   blocked coefficient solve against the plain twin at K = 64, 128 and 256,
   at the first, a middle and the last panel of 640, 768 and 333 words, on
   solver inputs and on arbitrary ones, for one system and for four, the
   solve, the product (table kernel) and the whole rebuild timed apart from
   a CUDA graph's replay; the cluster scan against its twin on a subset
   slice (one block), at an odd row count and on the tall system (40192
   rows), with the route, microseconds per step and the other cluster
   sizes' on the same inputs; the three mxu updates against their twins on
   640 and 768 words, on an unaligned width and on a (rows, 8) slice, each
   timed beside its byte bound.
   The chained scans (check_chunked) at panel 20 of the very tall system
   (67328 rows), one system and two, against their twins in the chain's order
   and the step twins, timed from a CUDA graph's replay under both cuts of the
   rows into chunks (equal chunks, the route's; the largest cluster filled
   first); the chained two-pivot scan the same way, beside its first link
   alone and the 1-pivot chain; at the same panel the chained fused phase 1
   and fused update + scan (full and trailing) against their twins in the
   chain's order, the step twins and the split engine, timed beside the split
   engine, the update apart, the chain alone and its first link alone.
   Then the launch floor: microseconds per launch over 256 chained launches
   of the probe (many blocks, 16-byte accesses), of torch.bitwise_xor and of
   the one-tile update.
4. Drives the mode-0 main path: recovers a random.Random MT19937 state from
   624 outputs through crypto.mt_torch.solve_mt19937 and through
   LinearSystem([32]*624).solve_one, and checks the kernel launch counts of
   one solve (79 cluster scans, 79 reconstructs, 16 full and 63 segmented
   updates).
5. Checks that a flipped output bit makes the system unsatisfiable.
6. Times solve_mt19937 warm (best of 3).
7. Mode 1: solve_mt19937(mode=1) is a space of dimension 0 at the state
   (warm time and a profile); without the known-MSB equations
   LinearSystem.solve_raw_space has dimension 31 (the low 31 bits of mt[0]
   are never read), holds the state, and its origin and basis pass the
   parity check against the system.  Launch counts 79 scans, 79
   reconstructs, 79 full updates.
8. Batches of 4: LinearSystem.solve_all_batch (mode 1, batched kernels;
   80 batched scans and rebuilds, 320 full updates), gauss_batched.
   solve_batched mode 0 with one flipped system (3 states and None; 80/80
   and 320 trailing updates; a profile), LinearSystem.solve_one_batch and
   solve_mt19937_batch (both a loop of the single-system solver), each
   timed warm as recoveries per second; the batched solver's full RREF is
   the default engine's, system by system; two very tall systems through
   solve_batched run the chained batched scan (80 panels x 2 chunks
   launches), timed cold and warm (best of 3) with the
   device time of a profiled call.
9. Engines: for each engine of the blocked solver other than the default
   (pallas_scan2, pallas_scanm, pallas, pallas_sub with mxu; mxu_la and
   mxu_noseg with pallas_scan), chosen through GF2BV_TPU_PHASE1/2,
   solve_mt19937 recovers the flagship state with the engine's launch
   counts (pallas_sub: 79 + f scans, rebuilds and updates, f its fallback
   passes; mxu_la: its first scan under the cluster scan, 79 fused update +
   scan), and rref_blocked(trailing=False) gives the default engine's
   RREF and pivot map word for word; each is timed warm (best of 3) and
   profiled (device time by kernel, device idle share), the default too.
10. A tall system, 1248 outputs (39968 rows, padded to 40192), is recovered
   under the default engine (79 cluster scans), pallas_scanm (which must run
   the 1-pivot scan: the min-key packing takes fewer than 2^15 rows) and
   pallas_sub, each timed warm; a very tall one, 2100 outputs (67328 padded
   rows: more than the largest cluster holds), under the default engine,
   which must run the chained scan (79 panels x 2 chunks launches; timed
   cold and warm, best of 3, with the device time of a profiled call), under
   mxu_la, which must run the chained scan for its first slice and the
   chained fused update + scan 79 x 2 chunks launches, and under phase 1
   pallas, which must run the chained fused phase 1 79 x 2 chunks launches
   (each timed cold and warm, best of 3, and profiled: device time by
   kernel, idle share), and under pallas_scan2, which must run the chained
   two-pivot scan 79 x 2 chunks launches (cold, warm best of 3, profiled).
11. Multi-RHS: one captured MT19937 template, 256 instances from
   random.Random seeds through CapturedTrace.solve_one_batch (one
   elimination on 768 words): every state recovered, a flipped output bit
   gives None for that instance only, launch counts 79 scans, 79 rebuilds,
   79 full updates, 0 segmented; warm time, recoveries per second, the device
   time of solve_multi_rhs_device alone, a profile; the same batch under
   GF2BV_TPU_PHASE2 = pallas, mxu2, mxu4 (79 launches of the engine's own
   kernel, none of the default update), answers equal, each profiled.
12. Sweep: the flagship with 12 state bits pinned, solve_one_sweep over all
   4096 candidates: exactly one solves and it is the true state; warm time,
   candidates per second; the second call reuses the cached device matrix.
13. The update engines pallas, mxu2, mxu4 through solve_mt19937 like the
   engines of phase 9; skip (phase 1 alone: no state comes back) timed warm;
   the portable jnp engines on a small system against the default engine.
14. Quadratic systems at full width: the NLFSR attack of examples/nlfsr.py
   (a 128-bit register, 2^14 + 1000 outputs, 128 + 8128 unknowns) for the
   Galois and the Fibonacci LFSR, each secret from random.Random: the tap
   streams traced on the host, the annihilator rows built on the card by
   ops.quad_device.quad_rows, the selected rows gathered there,
   QuadraticSystem.solve_all_packed (blocked kernels, mode 1: a scan, a
   rebuild and a full update per panel; the consistency filter on the card
   when the space has more than 8 dimensions) and solve_one_packed must
   return the secret; the rows, columns and dimension, and the warm wall,
   CUDA-event and kernel times of quad_rows, the solve and the filter.
15. SFMT19937 recovery at full width (examples/sfmt.py: 2496 low-16 leaks,
   39936 equations over 19968 unknowns) through LinearSystem.solve_one on the
   card: the clone replays the leak and predicts the next 1000 draws; host
   trace, packing, warm wall, CUDA-event and kernel times, launch counts and
   a profile.
16. Online MT19937 recovery through IncrementalSolver: a start of 600
   outputs and the mt[0] equations, adds of 4 outputs (128 rows) to 624, then
   16, 64 and 1 redundant outputs (the 512- and 2048-row buckets, and 32
   rows in the 128-row bucket); each add timed
   (wall, CUDA events, update_full launches) beside a warm from-scratch
   solve_one of the same rows; the state at the end equals a from-scratch
   full RREF and solve_one returns the generator's state.
17. The small models through the public API on the card (auto routing):
   xoshiro256**, xorshift128+ / V8 Math.random, WELL512, Taus88, LFSR113, a
   CRC-64 preimage, a GHASH preimage, and PHP mt_rand in both modes at full
   width (1300 draws, 19968 unknowns); each answer held against the
   generator's true state or preimage.
18. Routing: auto on the card is the blocked solver at every size; both
   backends solve one random consistent system at 16 to 2048 columns, warm
   (best of 3), with their kernel times; the batch route (parallel.batch,
   split at _PER_PIVOT_MAX_COLS columns): the batched per-pivot solver
   against the blocked family, B = 4 and 64, modes 0 and 1.
19. The sharded solvers (parallel/) on meshes of 4 shards on cuda:0 (one
   card: the times are the algorithms' overhead, not scaling), each beside
   the one-device solve of the same run (warm wall and CUDA-event ms): the
   flagship through the tournament (parallel.solve_sharded) in mode 0 (the
   state; 79 x 5 scans, 79 rebuilds, 79 x 4 trailing updates; 79 gathers, 1
   psum, 1 pmax) and mode 1 (dimension 0, the one-device origin; full
   updates), again through torch.distributed on NCCL as a world of one;
   CapturedTrace.solve_raw_batch of 256 instances over a (4, 1) mesh (all
   recovered, a flipped bit None for its instance only, no collective); the
   4096-candidate sweep over the same mesh (one solves); the per-pivot and
   blocked row-sharded solves at 48 and 1024 columns on 2 and 4 shards (a
   pmin and a psum per column); dryrun_multichip(4, device="cuda"); entry()
   on the card against its CPU result; the phase report and a
   torch.profiler trace of a flagship solver.solve.  The launches of rows 1,
   2, 4 and 9 on these paths are each asserted >= 1 and printed in the
   kernel line as "sharded_launches".

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
# (phase1, phase2) -> launch counts of one flagship mode-0 solve, each the
# first call of its engines' graph key, so eager (pallas_sub: checked against
# its fallback count in check_engines)
ENGINE_LAUNCHES = {
    ("pallas_scan2", "mxu"): {"scan2": 79, "reconstruct": 79, "update_full": 16,
                              "update_seg": 63},
    ("pallas_scanm", "mxu"): {"scan_minkey": 79, "reconstruct": 79, "update_full": 16,
                              "update_seg": 63},
    ("pallas", "mxu"): {"phase1_fused": 79, "update_full": 16, "update_seg": 63},
    ("pallas_sub", "mxu"): None,
    ("pallas_scan", "mxu_la"): {"scan": 1, "reconstruct": 79, "update_scan": 79,
                                "update_full": 79},
    ("pallas_scan", "mxu_noseg"): {"scan": 79, "reconstruct": 79, "update_trailing": 79,
                                   "scan_subset": 79, "scan_subset_test": 79},
}
UPDATE_ENGINES = ("pallas", "mxu2", "mxu4")
for _p2 in UPDATE_ENGINES:
    ENGINE_LAUNCHES[("pallas_scan", _p2)] = {"scan": 79, "reconstruct": 79,
                                             f"update_{_p2}": 79, "scan_subset": 79,
                                             "scan_subset_test": 79}
# multi-RHS and the sweep run rref_blocked eager: every panel subset-first
MULTI_LAUNCHES = {"scan": 79, "reconstruct": 79, "update_full": 79, "scan_subset": 79,
                  "scan_subset_test": 79}
WP_MULTI = WP + 128  # the multi-RHS matrix: one appended 128-word tile
NB_MULTI = 256  # instances of the multi-RHS batch
SWEEP_BITS = 12  # pinned state bits of the sweep: 4096 candidates
HBM_BYTES_PER_MS = 3.35e9  # 3.35 TB/s
INT8_OPS_PER_MS = 1.979e12  # 1,979 TOP/s, dense int8 tensor cores at 700 W
TALL_SAMPLES = 1248  # 39968 rows: above the min-key scan's 2^15
TALL_ROWS = 40192  # its padded rows
VERY_TALL_SAMPLES = 2100  # past the largest cluster: the chained kernels
VERY_TALL_ROWS = 67328  # its padded rows
NLFSR_WIDTH = 128  # examples/nlfsr.py: the register, its taps, the combiner's taps
NLFSR_TAPS = 0xD670201BAC7515352A273372B2A95B23
NLFSR_SELECT = (13, 24, 35, 46, 57)
NLFSR_STEPS = 2**14 + 1000
ROUTING_COLS = (16, 32, 64, 128, 256, 512, 1023, 1024, 2048)  # the routing sweep's sizes
ROUTING_BATCHES = (4, 64)  # systems per batch in the sweep of the batch route
SFMT_SEED = 20260819  # examples/sfmt.py: the victim's seed, burned draws, low-16 leaks
SFMT_BURN = 3 * 624
SFMT_LEAKS = 2496
INC_INIT = 600  # check_incremental: outputs in the start, then adds of 4 outputs to 624
INC_EXTRA = (16, 64, 1)  # redundant outputs past 624 added at once: the 512-, 2048- and
# 128-row buckets (the last one 32 rows, a partly filled bucket)
SHARDS = 4  # shards of the sharded phase's meshes, all on the one card
SHARDED_SMALL_COLS = (48, 1024)  # the per-pivot row-sharded solves: the dryrun's size, a mid size
SHARDED_KERNELS = ("scan", "reconstruct", "update_full", "update_trailing")  # rows 1, 2, 4, 9
KERNELS = {
    # name: (wrapper launch-count key, source, TPU kernel it replaces)
    "scan": ("scan", "gf2bv_tpu_torch/csrc/scan.cu",
             "gf2bv_tpu/ops/pallas_phase1.py:233"),
    "scan_chunked": ("scan_chunked", "gf2bv_tpu_torch/csrc/scan_chunked.cu",
                     "gf2bv_tpu/ops/pallas_phase1.py:233"),
    "scan_subset": ("scan_subset", "gf2bv_tpu_torch/csrc/scan_subset.cu",
                    "gf2bv_tpu/ops/pallas_phase1.py:233"),
    "reconstruct": ("reconstruct", "gf2bv_tpu_torch/csrc/reconstruct.cu",
                    "gf2bv_tpu/ops/pallas_phase1.py:278"),
    "update_seg": ("update_seg", "gf2bv_tpu_torch/csrc/update_table.cu",
                   "gf2bv_tpu/ops/pallas_update.py:312"),
    "update_full": ("update_full", "gf2bv_tpu_torch/csrc/update_table.cu",
                    "gf2bv_tpu/ops/pallas_update.py:65"),
    "update_trailing": ("update_trailing", "gf2bv_tpu_torch/csrc/update_table.cu",
                        "gf2bv_tpu/ops/pallas_update.py:261"),
    "scan_batched": ("scan_batched", "gf2bv_tpu_torch/csrc/scan.cu",
                     "gf2bv_tpu/ops/gauss_batched.py:53"),
    "scan_batched_chunked": ("scan_batched_chunked", "gf2bv_tpu_torch/csrc/scan_chunked.cu",
                             "gf2bv_tpu/ops/gauss_batched.py:53"),
    "reconstruct_batched": ("reconstruct_batched", "gf2bv_tpu_torch/csrc/reconstruct.cu",
                            "gf2bv_tpu/ops/gauss_batched.py:107"),
    "scan2": ("scan2", "gf2bv_tpu_torch/csrc/scan2.cu", "gf2bv_tpu/ops/pallas_phase1.py:353"),
    "scan2_chunked": ("scan2_chunked", "gf2bv_tpu_torch/csrc/scan2_chunked.cu",
                      "gf2bv_tpu/ops/pallas_phase1.py:353"),
    "scan_minkey": ("scan_minkey", "gf2bv_tpu_torch/csrc/scan.cu",
                    "gf2bv_tpu/ops/pallas_phase1.py:439"),
    "phase1_fused": ("phase1_fused", "gf2bv_tpu_torch/csrc/phase1_fused.cu",
                     "gf2bv_tpu/ops/pallas_phase1.py:39"),
    "phase1_fused_chunked": ("phase1_fused_chunked", "gf2bv_tpu_torch/csrc/fused_chunked.cu",
                             "gf2bv_tpu/ops/pallas_phase1.py:39"),
    "update_scan": ("update_scan", "gf2bv_tpu_torch/csrc/panel_update.cu",
                    "gf2bv_tpu/ops/pallas_update.py:514"),
    "update_scan_chunked": ("update_scan_chunked", "gf2bv_tpu_torch/csrc/fused_chunked.cu",
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
# name -> (bound_ms, "bytes", cases), filled beside each comparison
BOUNDS: dict = {}
LIBRARY_MS: dict = {}  # name -> ms of the one PyTorch call computing the same function


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def note_bound(name: str, moved_bytes: float) -> None:
    """The least time the card could take: the bytes the function must move
    (inputs read once, outputs written once) over the memory rate.  No kernel
    here has an arithmetic peak in the card's data sheet to name: the scans,
    rebuilds and tables run on the CUDA cores, and the mxu updates' one-bit
    tensor-core products have no published rate (the int8 peak is no bound:
    the mxu2 kernel runs its product faster than that peak would allow).
    Several cases of one kernel average."""
    ms = moved_bytes / HBM_BYTES_PER_MS
    if name in BOUNDS:
        n, old = BOUNDS[name][2], BOUNDS[name][0]
        BOUNDS[name] = ((old * n + ms) / (n + 1), "bytes", n + 1)
    else:
        BOUNDS[name] = (ms, "bytes", 1)


def update_bytes(rows: int, kw: int, live_words: int) -> int:
    """Bytes of a rank-K update that touches ``live_words`` words of every
    row: a read and written, sel and pf's live words read."""
    return 4 * (2 * rows * live_words + rows * kw + 32 * kw * live_words)


def product_ops(rows: int, kw: int, live_words: int) -> float:
    """The same update priced as a product on bit planes: 2 * rows * K * 32 *
    live_words operations, printed against the int8 tensor-core peak as a
    reading beside the byte bound."""
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


def graph_ms(fn, n: int = 64) -> float:
    """Milliseconds per call of ``fn`` over ``n`` calls replayed from a CUDA
    graph: the card's time alone, for kernels shorter than the host's pace."""
    from gf2bv_tpu_torch.ops import launch_floor

    x = torch.zeros(1, device="cuda")
    return launch_floor.chain_us(lambda y: (fn(), y)[1], x, n, graph=True) / 1000


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


def flagship_system(dev, outs, rows: int = ROWS) -> torch.Tensor:
    """The (rows, WP) padded MT19937 recovery system of ``outs`` (624 of them
    at the flagship's ROWS; more outputs make a taller system)."""
    from gf2bv_tpu_torch.core.words import u32_to_torch
    from gf2bv_tpu_torch.crypto.mt_torch import mt19937_system_device

    eqs = mt19937_system_device(u32_to_torch(np.array(outs, np.uint32), dev), 32, len(outs))
    a = torch.nn.functional.pad(eqs, (0, 0, 0, rows - eqs.shape[0])).contiguous()
    assert tuple(a.shape) == (rows, WP), a.shape
    return a


def check_launches(what: str, want: dict) -> dict:
    """The nonzero launch counts since the last reset, which must be ``want``."""
    from gf2bv_tpu_torch.ops import _cuda

    got = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if got != want:
        raise AssertionError(f"{what}: launch counts {got}, expected {want}")
    return got


def subset_first(want: dict, panels: int) -> dict:
    """``want`` with ``panels`` panels scanned subset-first: a subset kernel
    and a test each, beside the gated full scan ``want`` counts.  A shape's
    eager first call scans every panel so; a replay only the panels its
    first call's subset decided (the flagship's MT19937 systems: all but
    panel 0)."""
    return {**want, "scan_subset": panels, "scan_subset_test": panels}


def with_order(want: dict) -> dict:
    """``want`` plus the eager mode-0 elimination that caching a lazily
    traced system on the card runs once, to store its rows in pivot order
    (``ops/lazy_solve``): every panel subset-first, the flagship's updates."""
    order = subset_first(EXPECTED_LAUNCHES, 79)
    return {k: want.get(k, 0) + order.get(k, 0) for k in {**want, **order}}


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
    check_redesign(dev, card, a, bT, used, w0, sel, pf)
    res.update(check_chunked(dev, card, w0))
    res.update(check_subset_scans(dev, card, a))
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
    """The batched scan (one cluster per system) and the batched rebuild on
    NB systems from different seeds, at panel 20, each system with its own
    pre-used rows; the scan timed from a CUDA graph's replay, for 1, NB, 8
    and 16 systems on each cluster size that holds a slice."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import gauss_batched, phase1

    kw = K // 32
    mats = torch.stack([flagship_system(dev, mt_outputs(SEED + 10 + b)[1]) for b in range(NB)])
    bT = mats[:, :, w0 : w0 + kw].transpose(1, 2).contiguous()
    gen = torch.Generator().manual_seed(SEED + 6)
    used = torch.cat([used0] + [
        (torch.rand((1, ROWS), generator=gen) < 0.25).to(torch.int32).to(dev)
        for _ in range(NB - 1)])
    res = {}
    out_k = gauss_batched.scan_batched(bT, used, w0, K, COLS)
    out_p = gauss_batched.scan_batched_plain(bT, used, w0, K, COLS)
    res["scan_batched"] = (
        require_equal("scan_batched", zip(out_k, out_p)),
        graph_ms(lambda: gauss_batched.scan_batched(bT, used, w0, K, COLS), 16),
        cuda_ms(lambda: gauss_batched.scan_batched_plain(bT, used, w0, K, COLS), 2),
    )
    prow, _, cT = out_k
    if int((prow >= 0).sum(dim=1).min()) == 0:
        raise AssertionError("a batched scan system has no pivots")
    note_bound("scan_batched", nbytes(bT, used, *out_k))
    sizes = [nb for nb in phase1.SCAN_CLUSTER_SIZES if phase1.scan_fits(-(-ROWS // nb), kw)]
    print(f"clusters holding a ({kw}, {ROWS}) slice that the card runs at once "
          f"(cudaOccupancyMaxActiveClusters): "
          + ", ".join(f"{phase1.scan_occupancy(ROWS, kw, nb)} of {nb} blocks" for nb in sizes)
          + f" ({card})")
    for nb in (1, NB, 8, 16):
        reps = -(-nb // NB)
        bTn = bT.repeat(reps, 1, 1)[:nb].contiguous()
        usedn = used.repeat(reps, 1)[:nb].contiguous()
        want = gauss_batched.scan_batched_plain(bTn, usedn, w0, K, COLS)
        route = phase1.scan_batched_route(nb, ROWS, kw)
        per_size = []
        for c in sizes:
            require_equal(f"scan_batched B={nb} on {c} blocks", zip(
                gauss_batched.scan_batched_cluster(bTn, usedn, w0, K, COLS, c), want))
            ms = graph_ms(
                lambda: gauss_batched.scan_batched_cluster(bTn, usedn, w0, K, COLS, c), 16)
            per_size.append(f"{c} blocks a system {ms:.4f} ms ({1000 * ms / K:.3f} us per step)")
        print(f"scan_batched B={nb}: route {route.kernel} on {route.nblocks} blocks a system; "
              + "; ".join(per_size) + f" ({card})")

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


def check_chunked(dev, card: str, w0: int) -> dict:
    """The chained kernels at panel 20 of the very tall system, each system
    with a quarter of its rows used: the chained scans, one system and two,
    held against their twins in the chain's order and the step twins, timed
    from a CUDA graph's replay under both cuts of the rows into chunks; then
    the chained two-pivot scan (check_scan2_chunked) and the chained fused
    phase 1 and fused update + scan (check_fused_chunked)."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import gauss_batched, phase1

    kw = K // 32
    mats = torch.stack([flagship_system(dev, mt_outputs(SEED + 20 + b, VERY_TALL_SAMPLES)[1],
                                        VERY_TALL_ROWS) for b in range(2)])
    bT2 = mats[:, :, w0 : w0 + kw].transpose(1, 2).contiguous()
    a = mats[0].contiguous()
    del mats
    gen = torch.Generator().manual_seed(SEED + 21)
    used2 = (torch.rand((2, VERY_TALL_ROWS), generator=gen) < 0.25).to(torch.int32).to(dev)
    bT, used = bT2[0].contiguous(), used2[:1].contiguous()
    route = phase1.scan_route(VERY_TALL_ROWS, kw)
    cuts = {"equal chunks (the route's)": route.chunk_rows,
            "largest cluster first": phase1.scan_max_rows(kw, chained=True)}
    res = {}
    for name, x, u, scan, plain, step in (
            ("scan_chunked", bT, used, phase1.scan_chunked, phase1.scan_chunked_plain,
             phase1.scan_plain),
            ("scan_batched_chunked", bT2, used2, gauss_batched.scan_batched_chunked,
             gauss_batched.scan_batched_chunked_plain, gauss_batched.scan_batched_plain)):
        want = step(x, u, w0, K, COLS)
        times = []
        for cut, rows_c in cuts.items():
            out = scan(x, u, w0, K, COLS, rows_c)
            err = require_equal(f"{name}, {cut}", zip(out, plain(x, u, w0, K, COLS, rows_c)))
            require_equal(f"{name}, {cut}, against the step twin", zip(out, want))
            times.append(graph_ms(lambda: scan(x, u, w0, K, COLS, rows_c), 16))
        if int((want[0] >= 0).sum()) == 0:
            raise AssertionError(f"{name}: the very tall panel has no pivots")
        note_bound(name, nbytes(x, u, *want))
        res[name] = (err, times[0], cuda_ms(lambda: plain(x, u, w0, K, COLS, route.chunk_rows), 1))
        print(f"{name} at the very tall panel 20 ({x.shape[0] if x.dim() == 3 else 1} x "
              f"{VERY_TALL_ROWS} rows, graph replay): "
              + "; ".join(f"{cut} {t:.4f} ms ({1000 * t / K:.3f} us a step)"
                          for cut, t in zip(cuts, times))
              + f"; twin {res[name][2]:.1f} ms; route "
              f"{route.chunks} chunks of {route.chunk_rows} rows on {route.nblocks} blocks "
              f"({card})")
    res.update(check_scan2_chunked(card, bT, used, w0, res["scan_chunked"][1]))
    res.update(check_fused_chunked(dev, card, a, bT, used, w0, res["scan_chunked"][1]))
    return res


def subset_panel_inputs(a, cols: int, panels, trailing: bool = True) -> dict:
    """{t: (bT, used, w0)}: the inputs of panel t's subset-first scan in the
    default engine's eager elimination of ``a`` (every panel subset-first)."""
    from gf2bv_tpu_torch.ops import gauss_blocked

    seen = {}
    real = gauss_blocked.scan_subset

    def spy(bT, used, w0, k, c, decided):
        if w0 // (k // 32) in panels:
            seen[w0 // (k // 32)] = (bT.clone(), used.clone(), w0)
        return real(bT, used, w0, k, c, decided)

    gauss_blocked.scan_subset = spy
    try:
        gauss_blocked.rref_blocked(a, cols, K, trailing)
    finally:
        gauss_blocked.scan_subset = real
    torch.cuda.synchronize()
    return seen


def subset_case(card: str, what: str, bT, used, w0: int, cols: int, want_decided=None):
    """``phase1.launch_scan_subset`` on one panel's inputs against its twin
    (``scan_subset_plain`` on the CPU, the chained scan's twin as the
    fallback past the largest cluster) and against ``scan_plain``: prow,
    used', ``decided`` and cT at the pivot rows, bit for bit; its launches;
    its time beside the full scan's on the same inputs.  Returns (err, ms,
    full scan's ms, decided)."""
    from gf2bv_tpu_torch.ops import _cuda, phase1

    kw, rows = bT.shape
    route = phase1.scan_route(rows, kw)
    chained = route.kernel == "scan_chunked"
    decided = torch.full((1,), 7, dtype=torch.int32, device=bT.device)
    _cuda.reset_launches()
    prow, used_o, cT, _ = phase1.launch_scan_subset(bT, used, w0, K, cols, decided)
    torch.cuda.synchronize()
    check_launches(f"subset-first scan, {what}", {
        "scan_subset": 1, "scan_subset_test": 1, route.kernel: route.chunks if chained else 1})
    got = int(decided)
    twin = phase1.scan_subset_plain(bT.cpu(), used.cpu(), w0, K, cols,
                                    chunk_rows=route.chunk_rows if chained else None)
    full = phase1.scan_plain(bT, used, w0, K, cols)
    piv = full[0].clamp(min=0).long()[full[0] >= 0]
    if got != int(twin[3]) or (want_decided is not None and got != int(want_decided)):
        raise AssertionError(f"subset-first scan, {what}: decided {got}, its twin "
                             f"{int(twin[3])}, expected {want_decided}")
    dev = bT.device
    err = require_equal(f"subset-first scan, {what}, against its twin", [
        (prow, twin[0].to(dev)), (used_o, twin[1].to(dev)), (cT[:, piv], twin[2].to(dev)[:, piv])])
    require_equal(f"subset-first scan, {what}, against scan_plain", [
        (prow, full[0]), (used_o, full[1]), (cT[:, piv], full[2][:, piv])])
    if int(piv.numel()) == 0:
        raise AssertionError(f"subset-first scan, {what}: the panel has no pivots")
    ms = cuda_ms(lambda: phase1.launch_scan_subset(bT, used, w0, K, cols, decided), 5)
    full_ms = cuda_ms(lambda: phase1.scan(bT, used, w0, K, cols), 5)
    print(f"subset-first scan, {what} ({rows} rows, {int(piv.numel())} pivots): "
          f"{'decided by the subset' if got else 'missed: the ' + route.kernel + ' fallback ran'}"
          f"; = its twin and scan_plain; {ms:.4f} ms a panel (subset kernel, test and gated "
          f"{route.kernel}), the full scan alone {full_ms:.4f} ms ({card})")
    return err, ms, full_ms, got


def check_subset_scans(dev, card: str, a) -> dict:
    """The subset-first scan on real panels of the solver (the inputs the
    eager elimination hands it): flagship panels 0 (the subset misses: the
    cluster scan runs), 1, 20 and 78 (the subset decides), and panels 0 and
    20 of the very tall system (its fallback the chained scan).  Returns the
    kernels-line entry: flagship panel 20, its plain twin's time, and the
    bound of the bytes a decided panel must move (used read, used' written,
    the subset's words read and their coefficient words written, prow and
    the record written)."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import phase1

    S = phase1.SCAN_SUBSET_ROWS
    res = {}
    for t, (bT, used, w0) in sorted(subset_panel_inputs(a, COLS, (0, 1, 20, 78)).items()):
        err, ms, _, _ = subset_case(card, f"flagship panel {t}", bT, used, w0, COLS, t != 0)
        if t == 20:
            plain_ms = cuda_ms(lambda: phase1.scan_subset_plain(bT, used, w0, K, COLS), 1)
            res["scan_subset"] = (err, ms, plain_ms)
            note_bound("scan_subset", 2 * nbytes(used) + 2 * 4 * (K // 32) * S
                       + 4 * (K + phase1.subset_scratch_words(K)))
    vouts = mt_outputs(SEED + 8, VERY_TALL_SAMPLES)[1]
    tall = flagship_system(dev, vouts, VERY_TALL_ROWS)
    for t, (bT, used, w0) in sorted(subset_panel_inputs(tall, COLS, (0, 20)).items()):
        subset_case(card, f"very tall panel {t}", bT, used, w0, COLS, t != 0)
    return res


def check_scan2_chunked(card: str, bT, used, w0: int, chain_ms: float) -> dict:
    """The chained two-pivot scan at panel 20 of the very tall system, by its
    route, against its twin in the chain's order and the step twins; timed
    from a CUDA graph's replay under both cuts of the rows, beside its first
    link alone (the first chunk's rows scanned as a slice of their own) and
    the 1-pivot chain on the same inputs."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import phase1

    kw = K // 32
    route = phase1.scan2_route(VERY_TALL_ROWS, kw)
    if route.kernel != "scan2_chunked":
        raise AssertionError(f"very tall two-pivot scan routed to {route.kernel}")
    chunk = route.chunk_rows
    out_k = phase1.scan2(bT, used, w0, K, COLS)
    require_equal("scan2_chunked against the step twin",
                  zip(out_k, phase1.scan2_plain(bT, used, w0, K, COLS)))
    require_equal("scan2_chunked against the 1-pivot twin",
                  zip(out_k, phase1.scan_plain(bT, used, w0, K, COLS)))
    pivots = out_k[0][out_k[0] >= 0]
    if pivots.numel() == 0:
        raise AssertionError("scan2_chunked: the very tall panel has no pivots")
    note_bound("scan2_chunked", nbytes(bT, used, *out_k))
    err = require_equal("scan2_chunked", zip(out_k, phase1.scan2_chunked_plain(
        bT, used, w0, K, COLS, chunk)))
    most = phase1.scan_max_rows(kw, chained=True, pairs=True)
    require_equal("scan2_chunked, largest cluster first", zip(
        phase1.scan2_chunked(bT, used, w0, K, COLS, most), out_k))
    ms = graph_ms(lambda: phase1.scan2(bT, used, w0, K, COLS), 16)
    res = {"scan2_chunked": (err, ms, cuda_ms(
        lambda: phase1.scan2_chunked_plain(bT, used, w0, K, COLS, chunk), 1))}
    again = graph_ms(lambda: phase1.scan2(bT, used, w0, K, COLS), 16)
    cut_b = graph_ms(lambda: phase1.scan2_chunked(bT, used, w0, K, COLS, most), 16)
    first = bT[:, :chunk].contiguous(), used[:, :chunk].contiguous()
    link0 = graph_ms(lambda: phase1.scan2_chunked(*first, w0, K, COLS), 16)
    chain1 = graph_ms(lambda: phase1.scan_chunked(bT, used, w0, K, COLS), 16)
    print(f"scan2_chunked at the very tall panel 20 ({VERY_TALL_ROWS} rows, graph replay): "
          f"{ms:.4f} ms (again {again:.4f}; {2000 * ms / K:.3f} us a pair), {route.chunks} "
          f"chunks of {chunk} rows on {route.nblocks} / {route.nblocks_last} blocks, pivot rows "
          f"in chunks {sorted(set((pivots // chunk).tolist()))}; largest cluster first "
          f"{cut_b:.4f} ms; its first link alone {link0:.4f} ms; the 1-pivot "
          f"chain (scan_chunked) {chain1:.4f} ms (earlier in this run {chain_ms:.4f}); twin "
          f"{res['scan2_chunked'][2]:.1f} ms ({card})")
    return res


def check_fused_chunked(dev, card: str, a, bT, used, w0: int, chain_ms: float) -> dict:
    """The chained fused phase 1 and fused update + scan at panel 20 of the
    very tall system, by their routes, against their twins in the chain's
    order, the step twins and (phase 1) the split engine; each timed from a
    CUDA graph's replay beside the split engine or the update apart, the
    chain alone and its first link alone (the first chunk's rows scanned as a
    slice of their own)."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import gauss_blocked, panel_update, phase1

    kw = K // 32
    res = {}
    froute = phase1.phase1_fused_route(VERY_TALL_ROWS, kw)
    if froute.kernel != "phase1_fused_chunked":
        raise AssertionError(f"very tall fused phase 1 routed to {froute.kernel}")
    chunk = froute.chunk_rows
    args = (a, bT, used, w0, K, COLS)
    out_k = phase1.phase1_panel(*args)
    out_p = phase1.phase1_panel_chunked_plain(*args, chunk)
    require_equal("phase1_fused_chunked against the step twin",
                  zip(out_k, phase1.phase1_panel_plain(*args)))
    require_equal("phase1_fused_chunked against the split engine",
                  zip(out_k, phase1.phase1_panel_split(*args)))
    pivots = out_k[1][out_k[1] >= 0]
    if pivots.numel() == 0:
        raise AssertionError("phase1_fused_chunked: the very tall panel has no pivots")
    note_bound("phase1_fused_chunked", nbytes(bT, used, *out_k) + 4 * K * WP)
    res["phase1_fused_chunked"] = (
        require_equal("phase1_fused_chunked", zip(out_k, out_p)),
        graph_ms(lambda: phase1.phase1_panel(*args), 16),
        cuda_ms(lambda: phase1.phase1_panel_chunked_plain(*args, chunk), 1))
    split_ms = graph_ms(lambda: phase1.phase1_panel_split(*args), 16)
    first = bT[:, :chunk].contiguous(), used[:, :chunk].contiguous()
    link0_ms = graph_ms(lambda: phase1.scan_chunked(*first, w0, K, COLS), 16)
    again = graph_ms(lambda: phase1.phase1_panel(*args), 16)
    nocol = graph_ms(lambda: phase1.phase1_panel(a, bT, used, w0, K, 0), 16)
    print(f"phase1_fused_chunked at the very tall panel 20 ({VERY_TALL_ROWS} rows, graph "
          f"replay): {res['phase1_fused_chunked'][1]:.4f} ms (again {again:.4f}), "
          f"{froute.chunks} chunks of {chunk} rows on {froute.nblocks} / {froute.nblocks_last} "
          f"blocks, pivot rows in chunks {sorted(set((pivots // chunk).tolist()))}; split "
          f"engine (chained scan + gathers + reconstruct) {split_ms:.4f} ms; the chained scan alone {chain_ms:.4f} "
          f"ms, its first link alone {link0_ms:.4f} ms; no valid column {nocol:.4f} ms; twin "
          f"{res['phase1_fused_chunked'][2]:.1f} ms ({card})")


    # the next panel's slice after this panel's update, as the look-ahead loop has it
    pf, prow = out_k[0], out_k[1]
    sel = gauss_blocked.selector_from_prow(bT.T.contiguous(), prow)
    uroute = panel_update.update_scan_route(VERY_TALL_ROWS, kw)
    if uroute.kernel != "update_scan_chunked":
        raise AssertionError(f"very tall fused update + scan routed to {uroute.kernel}")
    errs, ms_k, ms_p = [], [], []
    scratch = a.clone()
    for w0t in (None, w0):
        nxt = panel_update.update_full_plain(a.clone(), sel, pf) if w0t is None else \
            panel_update.update_trailing_plain(a.clone(), sel, pf, w0t)
        bTn = nxt[:, w0 + kw : w0 + 2 * kw].T.contiguous()
        del nxt
        uargs = (sel, pf, bTn, used, w0 + kw, COLS, w0t)
        out_k = panel_update.update_scan(a.clone(), *uargs)
        out_p = panel_update.update_scan_chunked_plain(a.clone(), *uargs, uroute.chunk_rows)
        require_equal(f"update_scan_chunked w0={w0t} against the step twin",
                      zip(out_k, panel_update.update_scan_plain(a.clone(), *uargs)))
        upd_bytes = update_bytes(VERY_TALL_ROWS, kw,
                                 WP if w0t is None else 1 + WP - 128 * (w0t // 128))
        note_bound("update_scan_chunked", upd_bytes + nbytes(bTn, used, *out_k[1:]))
        errs.append(require_equal(f"update_scan_chunked w0={w0t}", zip(out_k, out_p)))
        ms_k.append(graph_ms(lambda: panel_update.update_scan(scratch, *uargs), 16))
        ms_p.append(cuda_ms(lambda: panel_update.update_scan_chunked_plain(
            scratch, *uargs, uroute.chunk_rows), 1))
        upd_ms = graph_ms((lambda: panel_update.update_full(scratch, sel, pf)) if w0t is None
                          else (lambda: panel_update.update_trailing(scratch, sel, pf, w0t)), 16)
        scan_ms = graph_ms(lambda: phase1.scan(bTn, used, w0 + kw, K, COLS), 16)
        firstn = bTn[:, : uroute.chunk_rows].contiguous(), used[:, : uroute.chunk_rows].contiguous()
        link0_ms = graph_ms(lambda: phase1.scan_chunked(*firstn, w0 + kw, K, COLS), 16)
        part = graph_ms(lambda: panel_update.update_scan(
            scratch, sel, pf, bTn, used, w0 + kw, 0, w0t), 16)
        print(f"update_scan_chunked w0={w0t} at the very tall panel 20 ({VERY_TALL_ROWS} rows, "
              f"graph replay): {ms_k[-1]:.4f} ms, {uroute.chunks} launches (a link each, "
              f"{panel_update.update_scan_first_rows(VERY_TALL_ROWS)} of the update's rows "
              f"beside the first, the rest beside the others); apart: the chained scan {scan_ms:.4f} ms (its first link "
              f"alone {link0_ms:.4f} ms) and the update {upd_ms:.4f} ms; its update with no "
              f"valid column {part:.4f} ms; twin {ms_p[-1]:.1f} ms ({card})")
    # the time is the mean of the full and trailing cases
    res["update_scan_chunked"] = (max(errs), sum(ms_k) / 2, sum(ms_p) / 2)
    return res


def check_engine_kernels(dev, card: str, a, bT, used, w0: int, sel, pf) -> dict:
    """The scan variants, the fused phase 1 and the fused update + scan at
    panel 20 of the flagship system, against their twins; the min-key scan and
    the fused phase 1 (cluster kernels) timed from a CUDA graph's replay
    beside the 1-pivot scan and the split engine."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import panel_update, phase1

    res = {}
    scan_ms = {"scan": None}
    kw = K // 32
    # the two-pivot scan: the cluster kernel (its route) against both twins and
    # its cluster twin, timed from a CUDA graph's replay beside the 1-pivot
    # cluster scan on the same inputs
    route2 = phase1.scan2_route(ROWS, kw)
    out_k = phase1.scan2(bT, used, w0, K, COLS)
    out_p = phase1.scan2_plain(bT, used, w0, K, COLS)
    require_equal("scan2 against the 1-pivot twin",
                  zip(out_k, phase1.scan_plain(bT, used, w0, K, COLS)))
    require_equal("scan2 against its cluster twin", zip(out_k, (
        x.to(dev) for x in phase1.scan2_cluster_plain(
            bT.cpu(), used.cpu(), w0, K, COLS, route2.nblocks))))
    scan2_plain_ms = cuda_ms(lambda: phase1.scan2_plain(bT, used, w0, K, COLS), 2)
    res["scan2"] = (require_equal("scan2", zip(out_k, out_p)),
                    graph_ms(lambda: phase1.scan2(bT, used, w0, K, COLS), 32), scan2_plain_ms)
    note_bound("scan2", nbytes(bT, used, *out_k))
    scan2_g = graph_ms(lambda: phase1.scan(bT, used, w0, K, COLS), 32)
    scan2_again = graph_ms(lambda: phase1.scan2(bT, used, w0, K, COLS), 32)
    print(f"scan2 at panel 20, replayed from a CUDA graph: cluster kernel on {route2.nblocks} "
          f"blocks {res['scan2'][1]:.4f} ms (again {scan2_again:.4f}; "
          f"{2000 * res['scan2'][1] / K:.3f} us a pair step), the 1-pivot cluster scan "
          f"{scan2_g:.4f} ms "
          f"({2000 * scan2_g / K:.3f} us a pair of steps) ({card})")
    scan_ms["scan2"] = res["scan2"][1]

    # the min-key scan: the cluster kernel (its route) against both twins; both
    # scans timed from a CUDA graph's replay
    route = phase1.scan_minkey_route(ROWS, kw)
    out_k = phase1.scan_minkey(bT, used, w0, K, COLS)
    out_p = phase1.scan_minkey_plain(bT, used, w0, K, COLS)
    require_equal("scan_minkey against the 1-pivot twin",
                  zip(out_k, phase1.scan_plain(bT, used, w0, K, COLS)))
    require_equal("scan_minkey against its cluster twin", zip(out_k, (
        x.to(dev) for x in phase1.scan_minkey_cluster_plain(
            bT.cpu(), used.cpu(), w0, K, COLS, route.nblocks))))
    minkey_plain_ms = cuda_ms(lambda: phase1.scan_minkey_plain(bT, used, w0, K, COLS), 2)
    res["scan_minkey"] = (require_equal("scan_minkey", zip(out_k, out_p)),
                          graph_ms(lambda: phase1.scan_minkey(bT, used, w0, K, COLS), 32),
                          minkey_plain_ms)
    note_bound("scan_minkey", nbytes(bT, used, *out_k))
    scan_g = graph_ms(lambda: phase1.scan(bT, used, w0, K, COLS), 32)
    minkey_again = graph_ms(lambda: phase1.scan_minkey(bT, used, w0, K, COLS), 32)
    print(f"scan_minkey at panel 20, replayed from a CUDA graph: cluster kernel on "
          f"{route.nblocks} blocks {res['scan_minkey'][1]:.4f} ms (again {minkey_again:.4f}; "
          f"{1000 * res['scan_minkey'][1] / K:.3f} us a step), the 1-pivot cluster scan "
          f"{scan_g:.4f} ms ({card})")
    scan_ms["scan_minkey"] = res["scan_minkey"][1]
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

    # the fused phase 1: the cluster kernel (its route) against the twin and the
    # split engine, both timed from a CUDA graph's replay
    froute = phase1.phase1_fused_route(ROWS, kw)
    out_k = phase1.phase1_panel(a, bT, used, w0, K, COLS)
    out_p = phase1.phase1_panel_plain(a, bT, used, w0, K, COLS)
    # the slice, the K pivot rows of a, and pf, prow, used out
    note_bound("phase1_fused", nbytes(bT, used, *out_k) + 4 * K * WP)
    require_equal("phase1_fused against the split engine",
                  zip(out_k, phase1.phase1_panel_split(a, bT, used, w0, K, COLS)))
    fused_plain_ms = cuda_ms(lambda: phase1.phase1_panel_plain(a, bT, used, w0, K, COLS), 2)
    res["phase1_fused"] = (require_equal("phase1_fused", zip(out_k, out_p)),
                           graph_ms(lambda: phase1.phase1_panel(a, bT, used, w0, K, COLS), 32),
                           fused_plain_ms)
    split_ms = graph_ms(lambda: phase1.phase1_panel_split(a, bT, used, w0, K, COLS), 32)
    fused_again = graph_ms(lambda: phase1.phase1_panel(a, bT, used, w0, K, COLS), 32)
    nocol = graph_ms(lambda: phase1.phase1_panel(a, bT, used, w0, K, 0), 32)
    print(f"phase1 at panel 20, replayed from a CUDA graph: fused cluster kernel on "
          f"{froute.nblocks} blocks ({froute.smem_bytes} B shared memory a block) "
          f"{res['phase1_fused'][1]:.4f} ms (again {fused_again:.4f}), split engine (scan + "
          f"gathers + reconstruct) {split_ms:.4f} ms, the 1-pivot scan alone {scan_g:.4f} ms; "
          f"the fused kernel with no valid column (slice loads, solve and product with no "
          f"pivot) {nocol:.4f} ms ({card})")

    # the next panel's slice after this panel's update, as the look-ahead loop has it;
    # the fused kernel (cluster scan beside table updates) against the twin, timed
    # from a CUDA graph's replay
    errs, ms_k, ms_p = [], [], []
    scratch = a.clone()
    for w0t in (None, w0):
        nxt = panel_update.update_full_plain(a.clone(), sel, pf) if w0t is None else \
            panel_update.update_trailing_plain(a.clone(), sel, pf, w0t)
        bTn = nxt[:, w0 + kw : w0 + 2 * kw].T.contiguous()
        args = (sel, pf, bTn, used, w0 + kw, COLS, w0t)
        out_k = panel_update.update_scan(a.clone(), *args)
        out_p = panel_update.update_scan_plain(a.clone(), *args)
        upd_bytes = update_bytes(ROWS, kw, WP if w0t is None else 1 + WP - 128 * (w0t // 128))
        note_bound("update_scan", upd_bytes + nbytes(bTn, used, *out_k[1:]))
        errs.append(require_equal(f"update_scan w0={w0t}", zip(out_k, out_p)))
        ms_k.append(graph_ms(lambda: panel_update.update_scan(scratch, *args), 16))
        ms_p.append(cuda_ms(lambda: panel_update.update_scan_plain(scratch, *args), 2))
        # cols = 0: no column is valid, so the scan cluster only loads and stores
        part = graph_ms(lambda: panel_update.update_scan(
            scratch, sel, pf, bTn, used, w0 + kw, 0, w0t), 16)
        upd_ms = graph_ms((lambda: panel_update.update_full(scratch, sel, pf)) if w0t is None
                          else (lambda: panel_update.update_trailing(scratch, sel, pf, w0t)), 16)
        print(f"update_scan w0={w0t}: fused kernel {ms_k[-1]:.4f} ms against scan "
              f"{scan_g:.4f} ms + update "
              f"{upd_ms:.4f} ms apart; its update part alone (a scan with no valid column) "
              f"{part:.4f} ms; plain {ms_p[-1]:.4f} ms ({card})")
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
        # the card's data sheet names no one-bit tensor-core rate, and the mxu2
        # kernel runs the product faster than the int8 peak would allow: bytes
        # bound all three
        note_bound(name, update_bytes(ROWS, kw, WP_MULTI))
    # the three kernels on the same inputs replayed from a CUDA graph
    t = {name: graph_ms(lambda: kern(scratch, sel, pf), 32) for name, (kern, _) in cases.items()}
    t["update_mxu2 again"] = graph_ms(lambda: panel_update.update_mxu2(scratch, sel, pf), 32)
    as_product = product_ops(ROWS, kw, WP_MULTI) / INT8_OPS_PER_MS
    print(f"updates on {WP_MULTI} words replayed from a CUDA graph: "
          + "; ".join(f"{k} {v:.4f} ms" for k, v in t.items())
          + f"; the product as int8 tensor-core operations at 1,979 TOP/s would take "
          f"{as_product:.4f} ms (a reading: no one-bit rate is published) ({card})")
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


def scan_case(card: str, what: str, bT, used, w0: int) -> tuple:
    """The scan the route picks for this slice against its twin, timed beside
    the other cluster sizes on the same inputs."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import _cuda, phase1

    kw, rows = bT.shape
    route = phase1.scan_route(rows, kw)
    _cuda.reset_launches()
    out_k = phase1.scan(bT, used, w0, K, COLS)
    torch.cuda.synchronize()
    check_launches(f"scan route, {what}", {route.kernel: 1})
    out_p = phase1.scan_plain(bT, used, w0, K, COLS)
    err = require_equal(f"scan, {what}", zip(out_k, out_p))
    if int((out_k[0] >= 0).sum()) == 0:
        raise AssertionError(f"scan, {what}: the panel has no pivots")
    ms = cuda_ms(lambda: phase1.scan(bT, used, w0, K, COLS), 5)
    others = []
    for nb in phase1.SCAN_CLUSTER_SIZES:
        if nb == route.nblocks or not phase1.scan_fits(-(-rows // nb), kw) or rows < 32 * nb:
            continue
        require_equal(f"scan on {nb} blocks, {what}",
                      zip(phase1.scan_cluster(bT, used, w0, K, COLS, nb), out_p))
        t = cuda_ms(lambda: phase1.scan_cluster(bT, used, w0, K, COLS, nb), 5)
        others.append(f"{nb} blocks {1000 * t / K:.3f}")
    print(f"scan, {what} ({rows} rows): route {route.kernel} on {route.nblocks} blocks of "
          f"{route.rows_per_block} rows, {route.smem_bytes} B shared memory each: {ms:.4f} ms "
          f"per panel, {1000 * ms / K:.3f} us per step; other cluster sizes, us per step: {', '.join(others) or 'none'} ({card})")
    return err, ms, out_k, out_p


def update_case(card: str, what: str, a, sel, pf) -> None:
    """The three mxu updates on this matrix against their twins, each timed
    beside its byte bound."""
    from gf2bv_tpu_torch.ops import panel_update as pu

    rows, wp = a.shape
    kw = sel.shape[1]
    cases = [("update_full", lambda x: pu.update_full(x, sel, pf),
              lambda x: pu.update_full_plain(x, sel, pf), 0, False)]
    if wp % 128 == 0 and wp >= 256:
        for dead in sorted({1, wp // 128 - 1}):
            cases.append((f"update_seg dead_tiles={dead}",
                          lambda x, d=dead: pu.update_seg(x, sel, pf, d),
                          lambda x, d=dead: pu.update_seg_plain(x, sel, pf, d), 128 * dead, True))
    for w0t in sorted({0, min(160, wp - kw), wp - kw}):
        lo = pu._trailing_range(wp, w0t)
        cases.append((f"update_trailing w0={w0t}",
                      lambda x, w=w0t: pu.update_trailing(x, sel, pf, w),
                      lambda x, w=w0t: pu.update_trailing_plain(x, sel, pf, w), lo, lo > 0))
    scratch = a.clone()
    for name, kern, twin, lo, const in cases:
        require_equal(f"{name}, {what}", [(kern(a.clone()), twin(a.clone()))])
        ms = cuda_ms(lambda: kern(scratch), 10)
        live = wp - lo + (1 if const else 0)
        bound = update_bytes(rows, kw, live) / HBM_BYTES_PER_MS
        print(f"{name}, {what} ({rows} x {wp} words, {live} live): table kernel {ms:.4f} ms, "
              f"byte bound {bound:.4f} ms ({card})")


def rebuild_inputs(dev, k: int, w0: int, wp: int, kind: str, nb: int, gen):
    """arows (nb, k, wp), coeff (nb, k, kw), prow (nb, k) of ``nb`` systems.
    ``solver``: a random matrix is scanned and its pivot rows and their
    coefficients gathered, as the solver does (the panel crosses cols, so its
    last columns have no pivot); ``arbitrary``: random rows, random
    coefficients, about a tenth of prow at -1."""
    from gf2bv_tpu_torch.ops import gauss_batched

    def rand(shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32).to(dev)

    kw = k // 32
    if kind == "arbitrary":
        prow = torch.where(torch.rand((nb, k), generator=gen) < 0.1, -1, 3)
        return rand((nb, k, wp)), rand((nb, k, kw)), prow.to(torch.int32).to(dev)
    rows = 1536
    a = rand((nb, rows, wp))
    bT = a[:, :, w0 : w0 + kw].transpose(1, 2).contiguous()
    used = torch.zeros((nb, rows), dtype=torch.int32, device=dev)
    prow, _, cT = gauss_batched.scan_batched(bT, used, w0, k, 32 * (w0 + kw) - 9)
    ps = prow.clamp(min=0).long()
    arows = torch.gather(a, 1, ps[:, :, None].expand(nb, k, wp)).contiguous()
    coeff = torch.gather(cT, 2, ps[:, None, :].expand(nb, kw, k)).transpose(1, 2).contiguous()
    return arows, coeff, prow


def rebuild_case(what: str, arows, coeff, prow, w0: int) -> None:
    """The blocked coefficient solve, and the rebuild that runs it, against
    their plain twins; arows (K, wp) for one system or (B, K, wp) for a
    batch."""
    from gf2bv_tpu_torch.ops import gauss_batched, phase1

    new = phase1.reconstruct_coeff(arows, coeff, prow, w0)
    # on CPU tensors the wrapper runs the step-by-step twin
    twin = phase1.reconstruct_coeff(arows.cpu(), coeff.cpu(), prow.cpu(), w0)
    require_equal(f"coefficient solve against its twin, {what}", [(new, twin.to(new.device))])
    if arows.dim() == 2:
        pf, pf_p = (phase1.reconstruct(arows, coeff, prow, w0),
                    phase1.reconstruct_plain(arows, coeff, prow, w0))
    else:
        pf, pf_p = (gauss_batched.reconstruct_batched(arows, coeff, prow, w0),
                    gauss_batched.reconstruct_batched_plain(arows, coeff, prow, w0))
    require_equal(f"rebuild against its twin, {what}", [(pf, pf_p)])


def check_rebuild(dev, card: str, a, bT, used, w0: int) -> None:
    """The rebuild's blocked coefficient solve beyond the flagship panel, and
    the coefficient solve, the product and the whole rebuild timed on the
    card alone (a CUDA graph's replay) at the flagship panel, for one system
    and for NB."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.ops import gauss_batched, launch_floor, phase1
    from gf2bv_tpu_torch.ops import panel_update as pu

    gen = torch.Generator().manual_seed(SEED + 4)
    cases = 0
    for k in (64, 128, 256):
        kw = k // 32
        for wp in (WP, WP_MULTI, 333):
            for w0c in sorted({0, (wp // 2) // kw * kw, wp - kw}):
                for kind in ("solver", "arbitrary"):
                    arows, coeff, prow = rebuild_inputs(dev, k, w0c, wp, kind, NB, gen)
                    if kind == "solver" and int((prow >= 0).sum(dim=1).min()) < k // 2:
                        raise AssertionError(f"K={k} wp={wp} w0={w0c}: too few pivots")
                    what = f"K={k}, {wp} words, w0={w0c}, {kind} inputs"
                    rebuild_case(what + ", one system", arows[0].contiguous(),
                                 coeff[0].contiguous(), prow[0].contiguous(), w0c)
                    rebuild_case(what + f", B={NB}", arows, coeff, prow, w0c)
                    cases += 2
    print(f"rebuild: the blocked coefficient solve and the rebuild = their plain twins, "
          f"in {cases} cases (K 64/128/256; 640, 768 and 333 words; "
          f"first, middle and last panel; solver and arbitrary inputs; one system and "
          f"B={NB}), max_abs_err 0")

    # the flagship panel: one system, and NB systems that differ in their used rows
    kw = K // 32
    useds = torch.cat([used] + [
        (torch.rand((1, ROWS), generator=gen) < 0.25).to(torch.int32).to(dev)
        for _ in range(NB - 1)])
    prow, _, cT = gauss_batched.scan_batched(bT.expand(NB, kw, ROWS).contiguous(), useds,
                                             w0, K, COLS)
    ps = prow.clamp(min=0).long()
    arows = a[ps]  # (NB, K, WP)
    coeff = torch.gather(cT, 2, ps[:, None, :].expand(NB, kw, K)).transpose(1, 2).contiguous()
    rebuild_case("flagship panel 20, one system", arows[0], coeff[0], prow[0], w0)
    rebuild_case(f"flagship panel 20, B={NB}", arows, coeff, prow, w0)
    one = (arows[0], coeff[0], prow[0], w0)
    many = (arows, coeff, prow, w0)
    tbits = phase1.reconstruct_coeff(*one)
    pf0 = torch.zeros_like(arows[0])
    t = {
        "new": graph_ms(lambda: phase1.reconstruct_coeff(*one)),
        "new again": graph_ms(lambda: phase1.reconstruct_coeff(*one)),
        "new B": graph_ms(lambda: phase1.reconstruct_coeff(*many)),
        "table": graph_ms(lambda: pu.update_full(pf0, tbits, arows[0])),
        "whole": graph_ms(lambda: phase1.reconstruct(*one)),
        "whole B": graph_ms(lambda: gauss_batched.reconstruct_batched(*many)),
    }
    print(f"coefficient solve at K = {K}, flagship panel 20, per launch replayed from a CUDA "
          f"graph: blocked kernel {t['new']:.4f} ms (again {t['new again']:.4f}); B={NB} "
          f"{t['new B']:.4f} ms ({card})")
    print(f"the rebuild's product pf = T.arows on ({K}, {WP}) words, timed as an update in "
          f"place on a zeroed pf: the table kernel (whose body is the rebuild's second "
          f"launch) {t['table']:.4f} ms; the whole rebuild (both launches) {t['whole']:.4f} ms, "
          f"B={NB} {t['whole B']:.4f} ms ({card})")
    for k in (64, 128):
        ak, ck, pk = (x[0].contiguous() for x in rebuild_inputs(dev, k, 8, WP, "solver", 1, gen))
        print(f"coefficient solve at K = {k} ({2 * k} steps): blocked kernel "
              f"{graph_ms(lambda: phase1.reconstruct_coeff(ak, ck, pk, 8)):.4f} ms ({card})")
    # a reading, not a bound: the chain as groups x one group's 32 steps alone.  At
    # K = 32 the kernel is one forward and one back group of 32 steps, each step a
    # broadcast and the thread's one row to serve.
    gen32 = torch.Generator().manual_seed(SEED + 5)
    a32, c32, p32 = (x[0].contiguous() for x in rebuild_inputs(dev, 32, 8, WP, "solver", 1, gen32))
    t32 = graph_ms(lambda: phase1.reconstruct_coeff(a32, c32, p32, 8))
    floor = launch_floor.chain_us(launch_floor.tiny_call, a[:256, :128].contiguous(), 64,
                                  graph=True) / 1000
    group = max(0.0, t32 - floor) / 2
    print(f"coefficient solve, a reading and no bound: at K = 32 (one group forward, one "
          f"back, a row a thread) {t32:.4f} ms a launch against the launch floor "
          f"{floor:.4f} ms, so a group's 32 steps alone {1000 * group:.3f} us "
          f"({1e6 * group / 32:.1f} ns a step); {2 * kw} groups x that = "
          f"{2 * kw * group:.4f} ms of the {t['new']:.4f} ms at K = {K}, the rest being the "
          f"other rows each step serves ({card})")


def check_redesign(dev, card: str, a, bT, used, w0: int, sel, pf) -> None:
    """The redesigned kernels beyond the flagship panel: the rebuild's
    coefficient solve (check_rebuild); the cluster scan on one block (768
    rows), at an odd row count and on the tall system; the table kernel under
    the mxu rules on 768 words, on an unaligned width and on a (rows, 8)
    slice, each against its twin and timed."""
    from gf2bv_tpu_torch.crypto.mt_torch import mt19937_system_device
    from gf2bv_tpu_torch.core.words import u32_to_torch
    from gf2bv_tpu_torch.ops import phase1

    kw = K // 32
    check_rebuild(dev, card, a, bT, used, w0)
    scan_case(card, "flagship panel 20", bT, used, w0)
    # SUBSET_ROWS unused rows, those with a bit in the slice first (the first
    # SUBSET_ROWS unused rows of the raw system hold no pivot of this panel)
    unused = torch.nonzero(used[0] == 0)[:, 0]
    order = torch.argsort((bT[:, unused] == 0).all(dim=0).to(torch.int32), stable=True)
    free = unused[order[: phase1.SUBSET_ROWS]].sort().values
    scan_case(card, "a subset slice", bT[:, free].contiguous(),
              torch.zeros((1, free.numel()), dtype=torch.int32, device=dev), w0)
    odd = ROWS - 213
    scan_case(card, "an odd row count", bT[:, :odd].contiguous(), used[:, :odd].contiguous(), w0)
    touts = u32_to_torch(np.array(mt_outputs(SEED + 7, TALL_SAMPLES)[1], np.uint32), dev)
    tall = mt19937_system_device(touts, 32, TALL_SAMPLES)
    tall = torch.nn.functional.pad(tall, (0, 0, 0, TALL_ROWS - tall.shape[0]))
    gen = torch.Generator().manual_seed(SEED + 3)
    tused = (torch.rand((1, TALL_ROWS), generator=gen) < 0.25).to(torch.int32).to(dev)
    scan_case(card, "the tall system, panel 20", tall[:, w0 : w0 + kw].T.contiguous(), tused, w0)
    del tall

    rhs = torch.randint(-2**31, 2**31 - 1, (ROWS, 128), generator=gen,
                        dtype=torch.int64).to(torch.int32).to(dev)
    a768 = torch.cat([a, rhs], dim=1).contiguous()
    pf768 = torch.cat([pf, rhs[:K]], dim=1).contiguous()
    update_case(card, "the flagship width", a, sel, pf)
    update_case(card, "the multi-RHS width", a768, sel, pf768)
    update_case(card, "an unaligned width", a[:, : WP - 2].contiguous(), sel,
                pf[:, : WP - 2].contiguous())
    update_case(card, "the look-ahead engine's slice", a[:, w0 : w0 + kw].contiguous(), sel,
                pf[:, w0 : w0 + kw].contiguous())


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
    launches = check_launches("solve_mt19937", subset_first(EXPECTED_LAUNCHES, 79))
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
    # the structure's ordering at build, then the shape's second call: captured,
    # and replayed under the first call's plan
    check_launches("LinearSystem.solve_one", with_order(subset_first(EXPECTED_LAUNCHES, 78)))
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
    check_launches("solve_mt19937 mode 1", subset_first(MODE1_LAUNCHES, 79))
    if space is None or space.dimension != 0 or space.origin != state_int(state):
        raise AssertionError("solve_mt19937(mode=1) is not the dimension-0 space at the state")
    print(f"solve_mt19937 mode 1: dimension 0 at the state; launches {MODE1_LAUNCHES}")

    def mode1():
        return solve_mt19937(outs, 32, mode=1, device=dev)

    times = [timed(mode1)[1] for _ in range(3)]
    print(f"solve_mt19937 mode 1 warm, best of 3: {min(times):.4f} s "
          f"(all {[round(t, 4) for t in times]}) ({card})")
    profile_solve(mode1, card, "solve_mt19937 mode 1", min(times))

    lin = LinearSystem([32] * 624, device=dev)
    mt = lin.gens()
    rng = MT19937(list(mt))
    zeros = [rng.getrandbits(32) ^ o for o in outs]  # no mt[0] ^ 0x80000000
    _cuda.reset_launches()
    t0 = time.perf_counter()
    space = lin.solve_raw_space(zeros)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    # the structure's ordering at build; 19968 equations: a row bucket of its
    # own, so an eager first call
    check_launches("solve_raw_space", with_order(subset_first(MODE1_LAUNCHES, 79)))
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
    from gf2bv_tpu_torch.ops import _cuda, gauss_batched, gauss_blocked, phase1

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
    t = min(timed(batched0)[1] for _ in range(3))
    rates["gauss_batched.solve_batched mode 0 (batched kernels, trailing; best of 3)"] = t
    profile_solve(batched0, card, f"solve_batched mode 0 B={NB}", t)
    # the batched solver's full RREF and pivot map, system by system, are the
    # single-system default engine's
    rref_b, pof_b, _ = gauss_batched.rref_blocked_batched(mats, COLS)
    for b in range(NB):
        rref_d, pof_d, _ = gauss_blocked.rref_blocked(mats[b], COLS, K, False)
        require_equal(f"rref_blocked_batched system {b} against the default engine",
                      [(rref_b[b], rref_d), (pof_b[b], pof_d)])
    del rref_b, pof_b

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

    print(f"batch paths recover their states, the batched solver's full RREF = the default "
          f"engine's; single warm solve_mt19937 {single_s:.4f} s = {1 / single_s:.3f} "
          f"recoveries/s ({card})")
    for name, t in rates.items():
        print(f"{name}: B={NB} warm {t:.4f} s = {NB / t:.3f} recoveries/s ({card})")

    # two very tall systems (more rows than the largest cluster holds): the batch
    # takes the chained scan, a cluster a system in each of a panel's launches
    del mats
    vpairs = [mt_outputs(SEED + 200 + b, VERY_TALL_SAMPLES) for b in range(2)]
    vmats = torch.stack([flagship_system(dev, outs, VERY_TALL_ROWS) for _, outs in vpairs])
    chunks = phase1.scan_batched_route(2, VERY_TALL_ROWS, K // 32).chunks

    def tall_batch():
        return [_state_words(o) for o in gauss_batched.solve_batched(vmats, COLS, 0, device=dev)]

    _cuda.reset_launches()
    got, t = timed(tall_batch)
    tall = check_launches("solve_batched mode 0, very tall", {
        "scan_batched_chunked": 80 * chunks, "reconstruct_batched": 80,
        "update_trailing": 160})
    if got != [s for s, _ in vpairs]:
        raise AssertionError("solve_batched on the very tall systems did not recover the states")
    warm = warm_best(tall_batch, got, "solve_batched, very tall")
    print(f"solve_batched mode 0 on 2 very tall systems ({VERY_TALL_ROWS} x {WP} words): "
          f"states recovered; launches {tall}; cold {t:.4f} s, warm best of 3 {warm:.4f} s "
          f"({card})")
    profile_solve(tall_batch, card, "solve_batched mode 0, 2 very tall", warm)
    return {"scan_batched": mode1["scan_batched"],
            "scan_batched_chunked": tall["scan_batched_chunked"],
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


def device_rows(prof) -> list:
    """(device µs, name, count) of each kernel and copy in a torch.profiler
    run, largest first.  The CPU-side operators are left out: their device
    time is that of the kernels they launched, which are rows of their own."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    return sorted(rows, reverse=True)


def profile_solve(solve, card: str, what: str, warm_s: float) -> None:
    """Device time by kernel of one warm solve under torch.profiler.  The
    idle share is read from the same profile: the union of the device's
    intervals against the profiled stretch (first event to last); the warm
    unprofiled wall is printed beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    total = sum(r[0] for r in rows)
    events = prof.profiler.kineto_results.events()
    host_names = {ev.name() for ev in events if ev.device_type() != DeviceType.CUDA}
    busy, at = 0, None
    for s, e in sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in events
                       if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation()
                       and ev.name() not in host_names):
        if at is None or s > at:
            busy += e - s
            at = e
        elif e > at:
            busy += e - at
            at = e
    wall = (max(ev.start_ns() + ev.duration_ns() for ev in events)
            - min(ev.start_ns() for ev in events)) / 1e9
    print(f"profile {what}: device time (kernels and copies) {total / 1000:.1f} ms; busy "
          f"{busy / 1e6:.1f} ms of the profiled {1000 * wall:.1f} ms, idle "
          f"{100 * (1 - busy / 1e9 / wall):.1f}%; warm unprofiled wall {1000 * warm_s:.1f} ms "
          f"({card})")
    for dev_us, key, count in rows[:8]:
        print(f"  {dev_us / 1000:9.2f} ms {count:5d}x {key[:90]}")


def check_engines(dev, card: str) -> dict:
    """Every other engine through solve_mt19937, with its launch counts, and
    its full RREF against the default engine's; the tall system."""
    from gf2bv_tpu_torch.crypto.mt_torch import COLS, solve_mt19937
    from gf2bv_tpu_torch.ops import _cuda, gauss_blocked, phase1

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
                want = {"scan": 79, "reconstruct": 79, "update_full": 16, "update_seg": 63}
                counts = check_launches(f"tall {p1}", subset_first(want, 79)
                                        if p1 == "pallas_scan" else want)
            if got != tstate:
                raise AssertionError(f"tall system, {p1}: state not recovered")
            best = warm_best(lambda: solve_mt19937(touts, 32, samples=TALL_SAMPLES, device=dev),
                             tstate, f"tall {p1}")
        print(f"tall system ({TALL_SAMPLES} outputs, 40192 x 640 words), {p1}+mxu: state "
              f"recovered; launches {counts}, {gauss_blocked.SUBSET_FALLBACKS['panels']} "
              f"subset fallback passes; solve_mt19937 warm best of 3 {best:.4f} s ({card})")
    vstate, vouts = mt_outputs(SEED + 8, VERY_TALL_SAMPLES)
    chunks = phase1.scan_route(VERY_TALL_ROWS, K // 32).chunks

    def very_tall():
        return solve_mt19937(vouts, 32, samples=VERY_TALL_SAMPLES, device=dev)

    _cuda.reset_launches()
    got, cold = timed(very_tall)
    counts = check_launches("very tall system", subset_first({
        "scan_chunked": 79 * chunks, "reconstruct": 79, "update_full": 16, "update_seg": 63},
        79))
    if got != vstate:
        raise AssertionError("very tall system: state not recovered")
    launches["scan_chunked"] = counts["scan_chunked"]
    warm = warm_best(very_tall, vstate, "very tall system")
    print(f"very tall system ({VERY_TALL_SAMPLES} outputs, {VERY_TALL_ROWS} x {WP} words: more "
          f"rows than the largest cluster holds), default engine: state recovered; launches "
          f"{counts}; solve_mt19937 cold {cold:.4f} s, warm best of 3 {warm:.4f} s ({card})")
    profile_solve(very_tall, card, "very tall system, pallas_scan+mxu", warm)
    # the fused engines run their chained kernels: a launch a chunk of every panel
    for p1, p2, want in (
            ("pallas_scan", "mxu_la", {"scan_chunked": chunks, "reconstruct": 79,
                                       "update_scan_chunked": 79 * chunks, "update_full": 79}),
            ("pallas", "mxu", {"phase1_fused_chunked": 79 * chunks, "update_full": 16,
                               "update_seg": 63})):
        with engines_env(p1, p2):
            _cuda.reset_launches()
            got, cold = timed(very_tall)
            counts = check_launches(f"very tall system, {p1}+{p2}", want)
            if got != vstate:
                raise AssertionError(f"very tall system, {p1}+{p2}: state not recovered")
            launches.update({k: counts[k] for k in want if k.endswith("_chunked")
                             and k != "scan_chunked"})
            warm = warm_best(very_tall, vstate, f"very tall system, {p1}+{p2}")
            print(f"very tall system, {p1}+{p2}: state recovered; launches {counts}; "
                  f"solve_mt19937 cold {cold:.4f} s, warm best of 3 {warm:.4f} s ({card})")
            profile_solve(very_tall, card, f"very tall system, {p1}+{p2}", warm)
    # the two-pivot engine runs its chained scan: a launch a chunk of every panel
    with engines_env("pallas_scan2", "mxu"):
        _cuda.reset_launches()
        got, cold = timed(very_tall)
        counts = check_launches("very tall system, pallas_scan2", {
            "scan2_chunked": 79 * chunks, "reconstruct": 79, "update_full": 16,
            "update_seg": 63})
        if got != vstate:
            raise AssertionError("very tall system, pallas_scan2: state not recovered")
        launches["scan2_chunked"] = counts["scan2_chunked"]
        warm = warm_best(very_tall, vstate, "very tall system, pallas_scan2+mxu")
        print(f"very tall system, pallas_scan2+mxu: state recovered; launches {counts}; "
              f"solve_mt19937 cold {cold:.4f} s, warm best of 3 {warm:.4f} s ({card})")
        profile_solve(very_tall, card, "very tall system, pallas_scan2+mxu", warm)
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
            counts = check_launches(f"multi-RHS under {p2}", subset_first({
                "scan": 79, "reconstruct": 79, f"update_{p2}": 79}, 79))
            if got != states:
                raise AssertionError(f"multi-RHS under {p2}: states differ from the default's")
            launches[f"update_{p2}"] = counts[f"update_{p2}"]
            t = min(timed(lambda: tmpl.solve_one_batch(batch))[1] for _ in range(2))
            dms = cuda_ms(
                lambda: multi_rhs.solve_multi_rhs_device(cs.a_dev, COLS, rhs_dev, bw), 2)
            print(f"multi-RHS under phase2={p2}: same states; launches {counts}; warm best of "
                  f"2 {t:.4f} s = {NB_MULTI / t:.1f} recoveries/s; device alone {dms:.2f} ms "
                  f"({card})")
            profile_solve(lambda: tmpl.solve_one_batch(batch), card,
                          f"multi-RHS B={NB_MULTI} under {p2}", t)
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
        check_launches("skip", subset_first({"scan": 79, "reconstruct": 79}, 79))
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


def device_ms(fn) -> float:
    """Milliseconds of device time (kernels and copies) in one call of
    ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in device_rows(prof)) / 1000


def event_ms(fn):
    """(result, wall ms, CUDA-event ms) of one warm call of ``fn``."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, 1000 * (time.perf_counter() - t0), start.elapsed_time(end)


def nlfsr_attack(dev, lfsr_cls, secret: int) -> dict:
    """examples/nlfsr.py through the port on ``dev``: the filtered keystream
    of ``secret``, the three annihilator tap streams traced against a
    LinearSystem on the host, and ``build()``, which makes the annihilator
    rows with quad_rows on the system's device and gathers there the rows of
    the outputs that are 1."""
    from gf2bv_tpu_torch import BitVec, LinearSystem, QuadraticSystem
    from gf2bv_tpu_torch.core.lazy import materialize_pending
    from gf2bv_tpu_torch.ops import quad_device

    width, taps, select, steps = NLFSR_WIDTH, NLFSR_TAPS, NLFSR_SELECT, NLFSR_STEPS
    reg = lfsr_cls(width, taps, secret)
    out = []
    for _ in range(steps):
        reg()
        x0, x1, x2, x3, x4 = ((reg.state >> i) & 1 for i in select)
        out.append((x0 * x1) ^ (x0 * x1 * x3 * x4) ^ x0 ^ x1 ^ x2)
    out = np.array(out, dtype=bool)

    t0 = time.perf_counter()
    lin = LinearSystem([width], device=dev)
    reg = lfsr_cls(width, taps, BitVec.stack(lin.gens()))
    streams = ([], [], [])
    for _ in range(steps):
        reg()
        for bits, tap in zip(streams, select[:3]):
            bits.append(reg.state[tap])
    x0, x1, x2 = (BitVec.stack(bits) for bits in streams)
    materialize_pending([x0, x1, x2])  # the host trace, outside quad_rows' time
    trace_s = time.perf_counter() - t0

    qsys = QuadraticSystem([width], device=dev)
    sel = np.flatnonzero(out)
    sel = np.concatenate([sel, np.full(-len(sel) % 256, sel[0])])  # duplicates are inert
    sel_dev = torch.as_tensor(sel, device=dev)

    def build():
        eqs = quad_device.quad_rows(qsys, pairs=[(x0, x1), (x1, x2)], linear=[x0, x1, x2],
                                    const=(1 << steps) - 1)
        return eqs[sel_dev]

    return {"qsys": qsys, "build": build, "equations": int(out.sum()), "trace_s": trace_s}


def check_quadratic(dev, card: str) -> dict:
    """The NLFSR attack of examples/nlfsr.py at full width through the port:
    the annihilator rows built on the card by quad_rows, the selection
    gathered there, solve_all_packed (the blocked kernels, mode 1; the
    consistency filter on the card past 8 dimensions) and solve_one_packed,
    for both LFSR forms."""
    from gf2bv_tpu_torch.crypto.lfsr import FibonacciLFSR, GaloisLFSR
    from gf2bv_tpu_torch.ops import _cuda, enumerate as enum_ops

    launches = {}
    for k, lfsr_cls in enumerate((GaloisLFSR, FibonacciLFSR)):
        name = lfsr_cls.__name__
        secret = random.Random(SEED + 300 + k).getrandbits(NLFSR_WIDTH)
        attack = nlfsr_attack(dev, lfsr_cls, secret)
        qsys, build = attack["qsys"], attack["build"]

        _cuda.reset_launches()
        eqs_sel = build()
        if eqs_sel.device.type != "cuda" or eqs_sel.dtype != torch.int32:
            raise AssertionError(f"{name}: quad_rows did not build an int32 matrix on the card")
        solutions = [s for (s,) in qsys.solve_all_packed(eqs_sel)]
        torch.cuda.synchronize()
        panels = -(-(qsys.cols + 1) // K)
        launches[name] = check_launches(f"NLFSR {name} solve_all_packed", subset_first({
            "scan": panels, "reconstruct": panels, "update_full": panels}, panels))
        if not solutions or any(s != secret for s in solutions):
            raise AssertionError(f"{name}: solve_all_packed did not recover the secret "
                                 f"({len(solutions)} solutions)")
        if qsys.solve_one_packed(eqs_sel) != (secret,):
            raise AssertionError(f"{name}: solve_one_packed did not recover the secret")
        if k == 0:  # the subset-first scan on this bucket's real panels (mode 1)
            from gf2bv_tpu_torch.ops import gauss_blocked

            padded = gauss_blocked._pad_device(eqs_sel, K)  # as the solver pads it
            for t, (bT, used, w0) in sorted(subset_panel_inputs(
                    padded, qsys.cols, (0, panels // 2, panels - 1), False).items()):
                subset_case(card, f"NLFSR {name} panel {t}", bT, used, w0, qsys.cols)

        _, build_wall, build_ev = event_ms(build)
        build_dev = device_ms(build)
        if k == 0:  # where quad_rows' time goes, by operator and kernel
            profile_solve(build, card, f"quad_rows + gather, NLFSR {name}", build_wall / 1000)
        space, solve_wall, solve_ev = event_ms(lambda: qsys.solve_raw_packed(eqs_sel, 1))
        solve_dev = device_ms(lambda: qsys.solve_raw_packed(eqs_sel, 1))

        def filt():
            return list(enum_ops.iter_quad_filtered(space, NLFSR_WIDTH, device=dev))

        kept, filt_wall, filt_ev = event_ms(filt)
        filt_dev = device_ms(filt)
        if not kept or any(qsys.convert_sol(s) != (secret,) for s in kept):
            raise AssertionError(f"{name}: the card's consistency filter kept {len(kept)} points")
        all_s = timed(lambda: list(qsys.solve_all_packed(eqs_sel)))[1]
        print(f"NLFSR {name} (WIDTH {NLFSR_WIDTH}, {NLFSR_STEPS} outputs): secret recovered by "
              f"solve_all_packed ({len(solutions)} solution) and solve_one_packed; "
              f"{attack['equations']} equations, rows {eqs_sel.shape[0]} x {eqs_sel.shape[1]} "
              f"words, columns {qsys.cols}, space dimension {space.dimension} "
              f"({'filtered on the card' if space.dimension > 8 else 'filtered on the host'} in "
              f"solve_all); launches {launches[name]}; host trace {attack['trace_s']:.2f} s "
              f"({card})")
        print(f"  warm: quad_rows + gather wall {build_wall:.3f} ms, events {build_ev:.3f} ms, "
              f"kernels {build_dev:.3f} ms; solve (mode 1) wall {solve_wall:.3f} ms, events "
              f"{solve_ev:.3f} ms, kernels {solve_dev:.3f} ms; filter on the card "
              f"({space.size} points) wall {filt_wall:.3f} ms, events {filt_ev:.3f} ms, "
              f"kernels {filt_dev:.3f} ms; solve_all_packed {1000 * all_s:.3f} ms ({card})")
    return launches


def check_sfmt(dev, card: str) -> dict:
    """examples/sfmt.py at full width through LinearSystem([32]*624).solve_one
    on the card: SFMT19937 seeded with SFMT_SEED, SFMT_BURN draws burned, the
    low 16 bits of SFMT_LEAKS draws leaked (39936 equations over 19968
    unknowns, padded to 40192 rows x 640 words).  The clone must replay the
    leak and predict the next 1000 draws exactly."""
    from gf2bv_tpu_torch import LinearSystem
    from gf2bv_tpu_torch.crypto.sfmt import SFMT19937
    from gf2bv_tpu_torch.ops import _cuda

    victim = SFMT19937.from_seed(SFMT_SEED)
    for _ in range(SFMT_BURN):
        victim()
    observed = [victim() & 0xFFFF for _ in range(SFMT_LEAKS)]

    t0 = time.perf_counter()
    lin = LinearSystem([32] * 624, device=dev)
    sym = SFMT19937(list(lin.gens()), index=624)
    zeros = [(sym() & 0xFFFF) ^ o for o in observed]
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eqs = lin.get_eqs_packed(zeros)
    pack_s = time.perf_counter() - t0

    _cuda.reset_launches()
    state, cold_s = timed(lambda: lin.solve_one(zeros))
    # the structure's ordering at build; the shape's graph (the tall MT19937
    # system's) was evicted since: eager
    launches = check_launches("SFMT19937 solve_one",
                              with_order(subset_first(EXPECTED_LAUNCHES, 79)))
    if state is None:
        raise AssertionError("SFMT19937: solve_one found the system unsatisfiable")
    clone = SFMT19937(list(state), index=624)
    if [clone() & 0xFFFF for _ in range(SFMT_LEAKS)] != observed:
        raise AssertionError("SFMT19937: the clone does not replay the leak")
    if any(clone() != victim() for _ in range(1000)):
        raise AssertionError("SFMT19937: the clone does not predict the next 1000 draws")
    walls = []
    for _ in range(3):
        got, wall, ev = event_ms(lambda: lin.solve_one(zeros))
        if got != state:
            raise AssertionError("SFMT19937: a warm solve_one changed its answer")
        walls.append((wall, ev))
    kern = device_ms(lambda: lin.solve_one(zeros))
    wall, ev = min(walls)
    print(f"SFMT19937 (seed {SFMT_SEED}, {SFMT_BURN} burned, {SFMT_LEAKS} low-16 leaks): "
          f"{eqs.shape[0]} equations x {lin.cols} unknowns; clone replays the leak and "
          f"predicts the next 1000 draws; launches {launches} ({card})")
    print(f"  host trace {trace_s:.3f} s, packing (get_eqs_packed) {pack_s:.3f} s, first "
          f"solve_one (its own packing + upload + solve) {cold_s:.3f} s; warm solve_one best "
          f"of 3: wall {wall:.3f} ms, events {ev:.3f} ms, kernels {kern:.3f} ms ({card})")
    profile_solve(lambda: lin.solve_one(zeros), card, "SFMT19937 solve_one", wall / 1000)
    return launches


def check_incremental(dev, card: str) -> dict:
    """Online MT19937 recovery through IncrementalSolver at the flagship shape:
    the start holds INC_INIT outputs of random.Random and the mt[0] equations;
    the other outputs to 624 arrive four at a time (128 rows, the smallest
    bucket), then INC_EXTRA redundant outputs past 624 in one add each (the
    512- and 2048-row buckets, then 32 rows in the 128-row bucket).  The state at the end equals a from-scratch
    rref_blocked(trailing=False) of all rows (the pivot-column set and each
    pivot column's row), and solve_one returns the generator's state.  Each
    add is timed (wall, CUDA events) beside a warm from-scratch solve_one of
    the same rows; the update_full launches of the adds are counted."""
    from gf2bv_tpu_torch import IncrementalSolver, LinearSystem
    from gf2bv_tpu_torch.core.words import u32_to_torch
    from gf2bv_tpu_torch.crypto.mt import MT19937
    from gf2bv_tpu_torch.ops import _cuda
    from gf2bv_tpu_torch.ops.gauss_blocked import _pad, rref_blocked

    n_out = 624 + sum(INC_EXTRA)
    state, outs = mt_outputs(SEED + 400, n_out)
    lin = LinearSystem([32] * 624, device=dev)
    mt = lin.gens()
    rng = MT19937(list(mt))
    zeros = [rng.getrandbits(32) ^ o for o in outs]
    msb = [mt[0] ^ 0x80000000]

    _cuda.reset_launches()
    inc, init_s = timed(lambda: IncrementalSolver(lin, zeros[:INC_INIT] + msb))
    init_launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    print(f"incremental start: {32 * INC_INIT + 32} rows, rank {inc.rank}, dimension "
          f"{inc.dimension}, {init_s:.3f} s (trace materialization + upload + full RREF); "
          f"launches {init_launches} ({card})")
    adds = [(f"4 outputs ({k}-{k + 4})", zeros[k : k + 4]) for k in range(INC_INIT, 624, 4)]
    lo = 624
    for extra in INC_EXTRA:
        adds.append((f"{extra} redundant outputs ({lo}-{lo + extra})", zeros[lo : lo + extra]))
        lo += extra
    _cuda.reset_launches()
    per_add = []
    for what, batch in adds:
        eqs = lin.get_eqs_packed(batch)  # the trace's packing, outside the add's time
        before = _cuda.LAUNCHES["update_full"]
        _, wall, ev = event_ms(lambda: inc.add_packed(eqs))
        per_add.append((what, eqs.shape[0], wall, ev, _cuda.LAUNCHES["update_full"] - before))
        print(f"  add {what}: {eqs.shape[0]} rows, wall {wall:.3f} ms, events {ev:.3f} ms, "
              f"update_full launches {per_add[-1][4]}; rank {inc.rank}, dimension "
              f"{inc.dimension}, unsat {inc.unsat} ({card})")
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    if set(launches) != {"update_full"}:
        raise AssertionError(f"incremental adds launched {launches}, not update_full alone")
    if inc.unsat or inc.dimension != 0 or inc.solve_one() != state:
        raise AssertionError("IncrementalSolver did not recover the MT19937 state")

    eqs_all = lin.get_eqs_packed(zeros + msb)
    rref, pof, bad = rref_blocked(u32_to_torch(_pad(eqs_all, K, word_align=128), dev),
                                  lin.cols, K, trailing=False)
    ipof = inc._pof
    if bool(bad) or not torch.equal(pof >= 0, ipof >= 0):
        raise AssertionError("incremental: the pivot-column set differs from the fresh RREF")
    piv = pof >= 0
    mine = inc._M[ipof.clamp(min=0).long()][piv]
    fresh = rref[pof.clamp(min=0).long()][piv]
    width = min(mine.shape[1], fresh.shape[1])
    if not torch.equal(mine[:, :width], fresh[:, :width]):
        raise AssertionError("incremental: a pivot column's row differs from the fresh RREF")
    nonzero = int((inc._M != 0).any(dim=1).sum())
    if nonzero != inc.rank or inc.rank != int(piv.sum()):
        raise AssertionError(f"incremental: {nonzero} nonzero rows at rank {inc.rank}")

    lin.solve_one(zeros + msb)  # cold: trace materialization and upload
    scratch = [event_ms(lambda: lin.solve_one(zeros + msb)) for _ in range(3)]
    if any(s[0] != state for s in scratch):
        raise AssertionError("from-scratch solve_one lost the state")
    _, s_wall, s_ev = min(scratch, key=lambda s: s[1])
    s_kern = device_ms(lambda: lin.solve_one(zeros + msb))
    print(f"incremental MT19937: state recovered, the maintained matrix equals the fresh "
          f"full RREF ({eqs_all.shape[0]} rows, rank {inc.rank}); update_full launches of "
          f"the adds {launches['update_full']}; a warm from-scratch solve_one of the same "
          f"rows: wall {s_wall:.3f} ms, events {s_ev:.3f} ms, kernels {s_kern:.3f} ms ({card})")
    for rows in sorted({r for _, r, *_ in per_add}):
        walls = [w for _, r, w, _, _ in per_add if r == rows]
        evs = [e for _, r, _, e, _ in per_add if r == rows]
        print(f"  bucket of {rows} rows: {len(walls)} adds, wall {min(walls):.3f}-"
              f"{max(walls):.3f} ms, events {min(evs):.3f}-{max(evs):.3f} ms ({card})")
    big = max(range(len(adds)), key=lambda i: per_add[i][1])
    eqs_big = lin.get_eqs_packed(adds[big][1])  # where one more add of the largest bucket goes
    profile_solve(lambda: inc.add_packed(eqs_big), card,
                  f"incremental add of {eqs_big.shape[0]} rows", per_add[big][2] / 1000)
    return launches


def check_models(dev, card: str) -> None:
    """The small models and PHP mt_rand through the public API on the card,
    auto routing; each answer is held against the generator's true state or
    preimage."""
    from gf2bv_tpu_torch import LinearSystem
    from gf2bv_tpu_torch.crypto.crc import CRC64_XZ
    from gf2bv_tpu_torch.crypto.gf2m import GHASH
    from gf2bv_tpu_torch.crypto.php import MT_RAND_MT19937, MT_RAND_PHP, PHPMtRand
    from gf2bv_tpu_torch.crypto.taus import (
        LFSR113, LFSR113_PARAMS, TAUS88_PARAMS, Taus88, dont_care_dims,
    )
    from gf2bv_tpu_torch.crypto.well import Well512
    from gf2bv_tpu_torch.crypto.xorshift import V8MathRandom, Xorshift128Plus
    from gf2bv_tpu_torch.crypto.xoshiro import Xoshiro256starstar
    from gf2bv_tpu_torch.ops import _cuda, solver

    rnd = random.Random(SEED + 500)

    def report(name, lin, fn, check):
        _cuda.reset_launches()
        got, wall, ev = event_ms(fn)
        if not check(got):
            raise AssertionError(f"model {name}: wrong answer on the card")
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        warm = min(event_ms(fn)[1] for _ in range(3))
        print(f"model {name}: {lin.cols} unknowns, auto = "
              f"{solver._auto_backend(lin.cols, dev)}; answer checked; first call "
              f"{wall:.3f} ms, warm best of 3 {warm:.3f} ms; launches {launches} ({card})")

    s = [rnd.getrandbits(64) for _ in range(4)]
    src = Xoshiro256starstar(list(s))
    outs = [src() for _ in range(10)]
    lin = LinearSystem([64] * 4, device=dev)
    sym = Xoshiro256starstar(list(lin.gens()))
    zeros = [sym.step() ^ Xoshiro256starstar.untemper(o) for o in outs]
    def xoshiro_ok(sols):
        replays = [Xoshiro256starstar(list(x)) for x in sols]
        return tuple(s) in sols and all([r() for _ in range(10)] == outs for r in replays)

    report("xoshiro256** (10 outputs)", lin, lambda: list(lin.solve_all(zeros)), xoshiro_ok)

    s0, s1 = rnd.getrandbits(64), rnd.getrandbits(64)
    victim = V8MathRandom(s0, s1)
    observed = [victim.random() for _ in range(5)]
    lin = LinearSystem([64, 64], device=dev)
    sym = Xorshift128Plus(*lin.gens())
    sym_outs = [sym.step() for _ in range(V8MathRandom.CACHE_SIZE)]
    zeros = [sym_outs[V8MathRandom.CACHE_SIZE - 1 - i][12:] ^ V8MathRandom.mantissa(d)
             for i, d in enumerate(observed)]
    future = [victim.random() for _ in range(3)]

    def v8_ok(sol):
        clone = V8MathRandom(*sol)
        return sol == (s0, s1) and [clone.random() for _ in range(8)] == observed + future

    report("xorshift128+ / V8 Math.random (5 doubles)", lin, lambda: lin.solve_one(zeros), v8_ok)

    seed = [rnd.getrandbits(32) for _ in range(16)]
    src = Well512(list(seed))
    outs = [src() for _ in range(20)]
    lin = LinearSystem([32] * 16, device=dev)
    sym = Well512(list(lin.gens()))
    zeros = [sym() ^ o for o in outs]
    report("WELL512 (20 outputs)", lin, lambda: lin.solve_one(zeros),
           lambda sol: sol is not None and list(sol) == seed)

    for cls, mins, params in ((Taus88, (2, 8, 16), TAUS88_PARAMS),
                              (LFSR113, (2, 8, 16, 128), LFSR113_PARAMS)):
        secret = [rnd.getrandbits(32) | m for m in mins]
        victim = cls(list(secret))
        observed = [victim() for _ in range(6)]
        future = [victim() for _ in range(16)]
        lin = LinearSystem([32] * len(mins), device=dev)
        sym = cls(list(lin.gens()))
        zeros = [sym() ^ o for o in observed]

        def taus_ok(space, cls=cls, params=params, lin=lin, observed=observed, future=future):
            if space is None or space.dimension != dont_care_dims(params):
                return False
            clone = cls(list(lin.convert_sol(space.origin)))
            return [clone() for _ in range(22)] == observed + future

        report(f"{cls.__name__} (6 outputs, space of dimension {dont_care_dims(params)})", lin,
               lambda lin=lin, zeros=zeros: lin.solve_raw_space(zeros), taus_ok)

    secret = rnd.getrandbits(64)
    target = CRC64_XZ().process(secret, 64)
    lin = LinearSystem([64], device=dev)
    (x,) = lin.gens()
    zeros = [CRC64_XZ().process(x) ^ target]
    report("CRC-64/XZ preimage", lin, lambda: lin.solve_one(zeros),
           lambda sol: sol == (secret,))

    h, b0, b1, b2 = (rnd.getrandbits(128) for _ in range(4))
    g = GHASH(h)
    target = g.process([b0, b1, b2])
    lin = LinearSystem([128], device=dev)
    (x,) = lin.gens()
    zeros = [g.process([b0, x, b2]) ^ target]
    report("GHASH preimage", lin, lambda: lin.solve_one(zeros), lambda sol: sol == (b1,))

    for mode in (MT_RAND_MT19937, MT_RAND_PHP):
        victim = PHPMtRand.from_seed(rnd.getrandbits(32), mode)
        observed = [victim() for _ in range(1300)]
        future = [victim() for _ in range(5)] + [victim.mt_rand(1, 6) for _ in range(8)]
        t0 = time.perf_counter()
        lin = LinearSystem([32] * 624, device=dev)
        sym = PHPMtRand(list(lin.gens()), mode)
        zeros = [sym() ^ o for o in observed]
        lin.get_eqs_packed(zeros)
        trace_s = time.perf_counter() - t0

        def php_ok(sol, mode=mode, observed=observed, future=future):
            if sol is None:
                return False
            clone = PHPMtRand(list(sol), mode)
            return ([clone() for _ in range(1300)] == observed
                    and [clone() for _ in range(5)] + [clone.mt_rand(1, 6) for _ in range(8)]
                    == future)

        print(f"model PHP mt_rand mode {mode}: host trace and packing of 1300 draws "
              f"{trace_s:.3f} s ({card})")
        report(f"PHP mt_rand mode {mode} (1300 draws)", lin, lambda lin=lin, zeros=zeros:
               lin.solve_one(zeros), php_ok)


def random_system(rng, cols: int, rows: int, coeff=None):
    """(packed eqs, the secret as an int) of a random consistent system;
    ``coeff`` (rows, cols) 0/1 may be given to share the coefficients."""
    from gf2bv_tpu_torch.core import packing

    if coeff is None:
        coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    rhs = ((coeff.astype(np.int32) @ secret.astype(np.int32)) % 2).astype(np.uint8)
    eqs = packing.pack_bits(np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols)
    return eqs, int(sum(int(b) << i for i, b in enumerate(secret)))


@contextlib.contextmanager
def batch_route(limit: int):
    """The batch route forced: the blocked family from ``limit`` columns
    (0: always; 1 << 30: never)."""
    from gf2bv_tpu_torch.parallel import batch as pbatch

    old = pbatch._PER_PIVOT_MAX_COLS
    pbatch._PER_PIVOT_MAX_COLS = limit
    try:
        yield
    finally:
        pbatch._PER_PIVOT_MAX_COLS = old


def check_routing(dev, card: str) -> None:
    """auto on the card: the blocked kernels at every size; both backends
    timed warm (best of 3) on one random consistent system per size, with
    their kernel times.  Then the batch route (parallel.batch.solve_batch,
    split at _PER_PIVOT_MAX_COLS columns): the batched per-pivot solver
    against the blocked family (mode 0 solve_chained, mode 1 solve_batched)
    on B systems that share their coefficients, warm best of 3."""
    from gf2bv_tpu_torch.core import packing
    from gf2bv_tpu_torch.ops import _cuda, solver
    from gf2bv_tpu_torch.parallel import batch as pbatch

    for cols in (1, 16, 1023, 1024, 4096):
        if solver._auto_backend(cols, dev) != "blocked":
            raise AssertionError(f"auto at {cols} columns on the card is not blocked")
    rng = np.random.default_rng(SEED)
    for cols in ROUTING_COLS:
        rows = cols + 64
        eqs, want = random_system(rng, cols, rows)
        line = []
        for backend in ("jax", "blocked"):
            def run():
                return solver.solve(eqs, cols, 0, backend=backend, device=dev)

            _cuda.reset_launches()
            if run() != want:
                raise AssertionError(f"backend {backend} at {cols} columns lost the secret")
            if (backend == "blocked") != bool(_cuda.LAUNCHES["scan"]):
                raise AssertionError(f"backend {backend} at {cols} columns: launches "
                                     f"{ {k: v for k, v in _cuda.LAUNCHES.items() if v} }")
            walls = [event_ms(run)[1] for _ in range(3)]
            line.append(f"{backend} warm best of 3 {min(walls):.3f} ms, kernels "
                        f"{device_ms(run):.3f} ms")
        print(f"routing {cols} columns ({rows} rows, auto = "
              f"{solver._auto_backend(cols, dev)}): {'; '.join(line)} ({card})")
        coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
        for nb in ROUTING_BATCHES:
            systems = [random_system(rng, cols, rows, coeff) for _ in range(nb)]
            mats, secrets = [m for m, _ in systems], [s for _, s in systems]
            for mode in (0, 1):
                line = []
                for route, limit in (("per-pivot", 1 << 30), ("blocked", 0)):
                    def run():
                        with batch_route(limit):
                            return pbatch.solve_batch(mats, cols, mode, device=dev)

                    got = run()
                    origins = [packing.words_to_int(r if mode == 0 else r[0]) for r in got]
                    if origins != secrets or (mode == 1 and any(len(r[1]) for r in got)):
                        raise AssertionError(f"batch route {route} at {cols} columns, B={nb}, "
                                             f"mode {mode} lost a secret")
                    walls = [event_ms(run)[1] for _ in range(3)]
                    line.append(f"{route} {min(walls):.3f} ms")
                auto = "blocked" if cols >= pbatch._PER_PIVOT_MAX_COLS else "per-pivot"
                print(f"routing batch B={nb} mode {mode}, {cols} columns (auto = {auto}): "
                      f"warm best of 3 {'; '.join(line)} ({card})")


def best_of(fn, n: int = 3):
    """(result, best warm wall ms, CUDA-event ms of that call) over ``n`` calls."""
    runs = [event_ms(fn) for _ in range(n)]
    out, wall, ev = min(runs, key=lambda r: r[1])
    return out, wall, ev


def check_sharded(dev, card: str) -> dict:
    """The sharded solvers (parallel/) on meshes of SHARDS shards, all on the
    one card: the tournament at full width (the flagship MT19937 in modes 0
    and 1, and through an NCCL world of one), mesh-sharded multi-RHS at
    B = NB_MULTI, the sweep over the batch axis, the per-pivot and blocked
    row-sharded solves at the dryrun's size and a mid size, the dryrun, the
    entry step and the phase report; each against the one-device solve of
    the same run.  Returns the launches of rows 1, 2, 4 and 9 on these
    paths, each counted from 0 just before its path and read just after."""
    from gf2bv_tpu_torch import LinearSystem
    from gf2bv_tpu_torch.core import packing
    from gf2bv_tpu_torch.core.words import torch_to_u32
    from gf2bv_tpu_torch.crypto.mt import MT19937
    from gf2bv_tpu_torch.crypto.mt_torch import COLS
    from gf2bv_tpu_torch.entry import dryrun_multichip, entry
    from gf2bv_tpu_torch.ops import _cuda, gauss_blocked, solver
    from gf2bv_tpu_torch.parallel import collectives, distributed, solve_sharded
    from gf2bv_tpu_torch.parallel import mesh as meshlib
    from gf2bv_tpu_torch.parallel.rowshard import solve_rowsharded
    from gf2bv_tpu_torch.parallel.rowshard_blocked import solve_rowsharded_blocked
    from gf2bv_tpu_torch.utils import profiling

    rows_mesh = meshlib.make_mesh(batch=1, rows=SHARDS, devices=[dev] * SHARDS)
    batch_mesh = meshlib.make_mesh(batch=SHARDS, rows=1, devices=[dev] * SHARDS)
    print(f"sharded: rows mesh {rows_mesh}; batch mesh {batch_mesh}; {SHARDS} shards on "
          f"one card: the times measure the algorithms' overhead, not scaling ({card})")
    counts = {k: 0 for k in SHARDED_KERNELS}

    def counted(what: str, fn, want_launches=None, want_rounds=None):
        _cuda.reset_launches()
        collectives.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        rounds = dict(collectives.COUNTS)
        for k in SHARDED_KERNELS:
            counts[k] += _cuda.LAUNCHES[k]
        print(f"{what}: launches {got}; collective rounds {rounds}")
        if want_launches is not None and got != want_launches:
            raise AssertionError(f"{what}: launches {got}, expected {want_launches}")
        if want_rounds is not None and rounds != want_rounds:
            raise AssertionError(f"{what}: rounds {rounds}, expected {want_rounds}")
        return out

    def compare(what: str, sharded_fn, single_fn, n: int = 3) -> None:
        _, wall, ev = best_of(sharded_fn, n)
        _, wall1, ev1 = best_of(single_fn, n)
        print(f"{what}: warm best of {n} {wall:.2f} ms (CUDA events {ev:.2f} ms); one device "
              f"{wall1:.2f} ms ({ev1:.2f} ms) ({card})")

    # -- the tournament at full width: the flagship MT19937 ---------------------
    state, outs = mt_outputs(SEED)
    eqs = packing.from_u32(torch_to_u32(flagship_system(dev, outs)))
    want = state_int(state)
    panels = -(-(1 + COLS) // K)
    tour_rounds = {"pmin": 0, "psum": 1, "pmax": 1, "all_gather": panels, "readout": 0}
    got = counted("tournament mode 0, flagship", lambda: solve_sharded(eqs, COLS, 0, rows_mesh),
                  {"scan": (SHARDS + 1) * panels, "reconstruct": panels,
                   "update_trailing": SHARDS * panels}, tour_rounds)
    if got is None or packing.words_to_int(got) != want:
        raise AssertionError("the sharded tournament did not recover the MT19937 state")
    space = counted("tournament mode 1, flagship", lambda: solve_sharded(eqs, COLS, 1, rows_mesh),
                    {"scan": (SHARDS + 1) * panels, "reconstruct": panels,
                     "update_full": SHARDS * panels},
                    dict(tour_rounds, psum=0, pmax=0))
    single = gauss_blocked.solve_blocked(eqs, COLS, 1, device=dev)
    if (space[1].shape[0] != 0 or not np.array_equal(space[0], single[0])
            or single[1].shape[0] != 0 or packing.words_to_int(space[0]) != want):
        raise AssertionError("the sharded mode-1 space is not the one-device space")
    print(f"tournament: state recovered (mode 0); mode 1 dimension 0, origin = the one-device "
          f"solve's ({card})")
    compare("tournament mode 0 (flagship)", lambda: solve_sharded(eqs, COLS, 0, rows_mesh),
            lambda: gauss_blocked.solve_blocked(eqs, COLS, 0, device=dev))
    compare("tournament mode 1 (flagship)", lambda: solve_sharded(eqs, COLS, 1, rows_mesh),
            lambda: gauss_blocked.solve_blocked(eqs, COLS, 1, device=dev), 2)
    for what, fn in (("tournament mode 0, 4 shards", lambda: solve_sharded(eqs, COLS, 0, rows_mesh)),
                     ("solve_blocked mode 0, one device",
                      lambda: gauss_blocked.solve_blocked(eqs, COLS, 0, device=dev))):
        profile_solve(fn, card, what, best_of(fn)[1] / 1000)

    # -- mesh-sharded multi-RHS and the sweep over the batch axis -----------------
    lin = LinearSystem([32] * 624, device=dev)

    def model(ws, p):
        rng = MT19937(list(ws))
        return [rng.getrandbits(32) ^ p[k] for k in range(624)] + [ws[0] ^ 0x80000000]

    tmpl = lin.capture(model)
    pairs = [mt_outputs(91_000 + k) for k in range(NB_MULTI)]
    states = [s for s, _ in pairs]
    batch = [o for _, o in pairs]
    if tmpl.solve_one(batch[0]) != states[0]:
        raise AssertionError("captured-trace solve_one did not recover the state")
    # each shard's eliminations run rref_blocked eager: every panel subset-first
    per_shard = subset_first({"scan": SHARDS * panels, "reconstruct": SHARDS * panels,
                              "update_full": SHARDS * panels}, SHARDS * panels)
    no_rounds = {k: 0 for k in collectives.COUNTS}
    raws = counted(f"sharded multi-RHS B={NB_MULTI}",
                   lambda: tmpl.solve_raw_batch(batch, 0, mesh=batch_mesh), per_shard, no_rounds)
    if lin._convert_sols_batch(raws) != states:
        raise AssertionError("sharded multi-RHS did not recover every state")
    bad = [list(o) for o in batch]
    bad[5][0] ^= 1
    sols = lin._convert_sols_batch(tmpl.solve_raw_batch(bad, 0, mesh=batch_mesh))
    if sols[5] is not None or sols[:5] + sols[6:] != states[:5] + states[6:]:
        raise AssertionError("sharded multi-RHS: a flipped bit must unsat its instance only")
    print(f"sharded multi-RHS B={NB_MULTI} over {SHARDS} shards: all states recovered, "
          f"flipped instance None ({card})")
    compare(f"sharded multi-RHS B={NB_MULTI}",
            lambda: tmpl.solve_raw_batch(batch, 0, mesh=batch_mesh),
            lambda: tmpl.solve_raw_batch(batch, 0))

    lin_s = LinearSystem([32] * 624, device=dev)
    mt = lin_s.gens()
    gen = MT19937(list(mt))
    zeros = [gen.getrandbits(32) ^ o for o in outs] + [mt[0] ^ 0x80000000]
    guesses = [mt[1][i] for i in range(SWEEP_BITS)]
    k_true = state[1] & ((1 << SWEEP_BITS) - 1)
    sols = counted(f"sharded sweep of {1 << SWEEP_BITS}",
                   lambda: lin_s.solve_one_sweep(zeros, guesses, mesh=batch_mesh),
                   per_shard, no_rounds)
    if sols[k_true] != state or sum(s is not None for s in sols) != 1:
        raise AssertionError("the sharded sweep must solve exactly the true candidate")
    print(f"sharded sweep: {1 << SWEEP_BITS} candidates, 1 solves (the true state) ({card})")
    compare(f"sharded sweep of {1 << SWEEP_BITS}",
            lambda: lin_s.solve_one_sweep(zeros, guesses, mesh=batch_mesh),
            lambda: lin_s.solve_one_sweep(zeros, guesses), 2)

    # -- the per-pivot and blocked row-sharded solves: the dryrun's size, a mid size
    rng = np.random.default_rng(SEED)
    for cols in SHARDED_SMALL_COLS:
        eqs_s, secret = random_system(rng, cols, cols + 64)
        one = solver.solve(eqs_s, cols, 0, backend="blocked", device=dev)
        if one != secret:
            raise AssertionError(f"one-device solve at {cols} columns is wrong")
        for n in (2, SHARDS):
            mesh = meshlib.make_mesh(batch=1, rows=n, devices=[dev] * n)
            for name, fn in (("rowshard", solve_rowsharded),
                             ("rowshard_blocked", solve_rowsharded_blocked)):
                got = counted(f"{name} {cols} columns on {n} shards",
                              lambda: fn(eqs_s, cols, 0, mesh),
                              want_rounds={"pmin": cols, "psum": cols, "pmax": 0,
                                           "all_gather": 0, "readout": 0})
                if got is None or packing.words_to_int(got) != secret:
                    raise AssertionError(f"{name} at {cols} columns on {n} shards is wrong")
                compare(f"{name} {cols} columns on {n} shards", lambda: fn(eqs_s, cols, 0, mesh),
                        lambda: solver.solve(eqs_s, cols, 0, backend="blocked", device=dev), 1)

    # -- the entry points ------------------------------------------------------------
    _, s = timed(lambda: counted(f"dryrun_multichip({SHARDS}, cuda)",
                                 lambda: dryrun_multichip(SHARDS, device=dev)))
    print(f"dryrun_multichip({SHARDS}, device='cuda'): passed in {s:.2f} s ({card})")

    init = Path(__file__).resolve().parent / "build" / f"nccl_init_{os.getpid()}"
    init.parent.mkdir(exist_ok=True)
    init.unlink(missing_ok=True)
    distributed.initialize(f"file://{init}", 1, 0, device=dev)
    try:
        import torch.distributed as dist

        nccl_mesh = meshlib.make_mesh(batch=1, rows=SHARDS, devices=[dev] * SHARDS)
        got = counted(f"tournament mode 0 through {dist.get_backend()}, a world of one",
                      lambda: solve_sharded(eqs, COLS, 0, nccl_mesh), want_rounds=tour_rounds)
        if got is None or packing.words_to_int(got) != want:
            raise AssertionError("the tournament through NCCL did not recover the state")
        compare(f"tournament mode 0 through {dist.get_backend()}",
                lambda: solve_sharded(eqs, COLS, 0, nccl_mesh),
                lambda: gauss_blocked.solve_blocked(eqs, COLS, 0, device=dev))
        fn = lambda: solve_sharded(eqs, COLS, 0, nccl_mesh)  # noqa: E731
        profile_solve(fn, card, f"tournament mode 0 through {dist.get_backend()}",
                      best_of(fn)[1] / 1000)
    finally:
        distributed.shutdown()
        init.unlink(missing_ok=True)

    fn, args = entry(device=dev)
    origin, unsat = fn(*args)
    fn_c, args_c = entry(device="cpu")
    origin_c, unsat_c = fn_c(*args_c)
    if bool(unsat) or bool(unsat_c) or not np.array_equal(torch_to_u32(origin),
                                                          torch_to_u32(origin_c)):
        raise AssertionError("entry() on the card differs from its CPU result")
    _, wall, ev = best_of(lambda: fn(*args))
    print(f"entry(): the card's origin = the CPU's; warm step {wall:.2f} ms (CUDA events "
          f"{ev:.2f} ms) ({card})")

    profiling.reset()
    if solver.solve(eqs, COLS, 0, device=dev) != want:
        raise AssertionError("solver.solve lost the flagship state")
    report = profiling.phase_report()
    if set(report) != {"solve[blocked]", "pad", "h2d", "rref+origin"}:
        raise AssertionError(f"phase_report {report}")
    print("phase_report after a flagship solver.solve: " + ", ".join(
        f"{k} {1000 * v['total_s']:.2f} ms x{v['count']}" for k, v in report.items())
        + f" ({card})")
    trace_dir = Path(__file__).resolve().parent / "build" / f"trace_{os.getpid()}"
    with profiling.device_trace(str(trace_dir)):
        solver.solve(eqs, COLS, 0, device=dev)
    (trace,) = trace_dir.iterdir()
    events = json.loads(trace.read_text()).get("traceEvents", [])
    ours = [e for e in events if e.get("cat") == "kernel"
            and "scan_cluster_kernel" in e.get("name", "")]
    # the profiler may drop a record (78 of 79 scans in some profiles), so one
    # scan may be missing, but the trace must cover the solve
    if len(ours) < panels - 1:
        raise AssertionError(f"device_trace recorded {len(ours)} of the solve's {panels} "
                             "cluster scans")
    print(f"device_trace: {trace.name}, {trace.stat().st_size} bytes, {len(ours)} of the "
          f"solve's {panels} cluster scans in it ({card})")
    trace.unlink()
    trace_dir.rmdir()

    for k, v in counts.items():
        if v < 1:
            raise AssertionError(f"kernel {k} was launched no time on the sharded paths")
    print(f"sharded paths: launches of rows 1, 2, 4, 9 {counts} ({card})")
    return counts


def check_native_build(card: str) -> None:
    """The host engine's first use, which any host enumeration (solve_all's
    points) also pays: gcc builds both NSUB variants into build/, as the
    reference builds them at its first use."""
    from gf2bv_tpu_torch import _native

    before = set(_native.BUILD_DIR.glob("libgf2native_*.so"))
    t0 = time.perf_counter()
    ok = _native.available()
    build_s = time.perf_counter() - t0
    new = sorted(p.name for p in set(_native.BUILD_DIR.glob("libgf2native_*.so")) - before)
    print(f"native host engine: available {ok}, first use {build_s:.2f} s, built "
          f"{new or 'nothing (cached)'} ({card})")


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
    check_native_build(card)

    args = sys.argv[1:]
    if "--phases" in args:  # the named phases alone, after the build: no result line
        phases = {"routing": check_routing, "sfmt": check_sfmt,
                  "incremental": check_incremental, "models": check_models,
                  "sharded": check_sharded}
        for name in args[args.index("--phases") + 1].split(","):
            phases[name](dev, card)
        return 0
    res = check_kernels(dev, card)
    if "--kernels-only" in args:  # the comparisons and kernel times alone
        return 0
    launches, single_s = check_main_path(dev, card)
    check_mode1(dev, card)
    # the other kernels' counts come from the phases that drive them
    launches.update(check_batches(dev, card, single_s))
    engine_launches = check_engines(dev, card)
    for key in ("scan2", "scan2_chunked", "scan_minkey", "phase1_fused", "phase1_fused_chunked",
                "update_scan", "scan_chunked", "update_scan_chunked"):
        launches[key] = engine_launches[key]
    check_skip_and_jnp(dev, card)
    launches["launch_probe"] = check_launch_floor(dev, card)
    # this slice's path: the update engines' counts come from the multi-RHS batches
    multi = check_multi_rhs(dev, card)
    for p2 in UPDATE_ENGINES:
        launches[f"update_{p2}"] = multi[f"update_{p2}"]
    check_sweep(dev, card)
    check_quadratic(dev, card)
    check_sfmt(dev, card)
    check_incremental(dev, card)
    check_models(dev, card)
    check_routing(dev, card)
    sharded = check_sharded(dev, card)

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
        if key in sharded:  # the sharded paths' own count (check_sharded)
            kernels[-1]["sharded_launches"] = sharded[key]
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

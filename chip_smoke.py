#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gf2bv_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the port's kernels from gf2bv_tpu_torch/csrc with nvcc (sm_90a).
3. Holds each of the four kernels (scan, reconstruct, full-width update,
   segmented update at dead_tiles 1..4) against its plain PyTorch twin on
   the card, bit for bit, at the flagship MT19937 shapes (20224 rows x 640
   words, K = 256), and times both with CUDA events.
4. Drives the main path: recovers a random.Random MT19937 state from 624
   outputs through crypto.mt_torch.solve_mt19937 and through
   LinearSystem([32]*624).solve_one, and checks the kernel launch counts of
   one solve (79 scans, 79 reconstructs, 16 full and 63 segmented updates).
5. Checks that a flipped output bit makes the system unsatisfiable.
6. Times solve_mt19937 warm (best of 3).

Any failure raises (non-zero exit).  The line before the last is a JSON
object with the per-kernel results; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20240531
ROWS, WP, K = 20224, 640, 256  # flagship padded shape and panel width
EXPECTED_LAUNCHES = {"scan": 79, "reconstruct": 79, "update_full": 16, "update_seg": 63}
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


def mt_outputs(seed: int):
    rand = random.Random(seed)
    state = tuple(rand.getstate()[1][:-1])
    return state, [rand.getrandbits(32) for _ in range(624)]


def check_kernels(dev, card: str) -> dict:
    """Each kernel against its plain twin at the flagship shapes."""
    from gf2bv_tpu_torch.core.words import u32_to_torch
    from gf2bv_tpu_torch.crypto.mt_torch import COLS, mt19937_system_device
    from gf2bv_tpu_torch.ops import gauss_blocked, panel_update, phase1

    _, outs = mt_outputs(SEED + 1)
    eqs = mt19937_system_device(u32_to_torch(np.array(outs, np.uint32), dev), 32, 624)
    a = torch.nn.functional.pad(eqs, (0, 0, 0, ROWS - eqs.shape[0])).contiguous()
    assert tuple(a.shape) == (ROWS, WP), a.shape
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
    for name, (_, ms, plain_ms) in res.items():
        print(f"kernel {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"at the flagship shapes ({card})")
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
    launches = dict(_cuda.LAUNCHES)
    if got != state:
        raise AssertionError("solve_mt19937 did not recover the MT19937 state")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {launches}, expected {EXPECTED_LAUNCHES}")
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
    if _cuda.LAUNCHES != EXPECTED_LAUNCHES:
        raise AssertionError(
            f"solve_one launch counts {_cuda.LAUNCHES}, expected {EXPECTED_LAUNCHES}"
        )
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
    launches = check_main_path(dev, card)

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

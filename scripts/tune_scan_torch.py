#!/usr/bin/env python3
"""Time the cluster scan over cluster sizes on one NVIDIA GPU:  python3 scripts/tune_scan_torch.py

Random slices (half the bits set: the densest a solver's slice gets), K = 256,
25% of the rows used.  Every configuration is held against the plain twin
first.  Prints microseconds per step."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gf2bv_tpu_torch.core.words import u32_to_torch  # noqa: E402
from gf2bv_tpu_torch.ops import phase1  # noqa: E402

K = 256


def ms_of(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    rng = np.random.default_rng(5)
    for rows in (768, 2560, 20224, 40192):
        bT = u32_to_torch(rng.integers(0, 2**32, size=(K // 32, rows), dtype=np.uint32), dev)
        used = u32_to_torch((rng.random((1, rows)) < 0.25).astype(np.uint32), dev)
        want = phase1.scan_plain(bT, used, 8, K, 10**6)
        print(f"rows {rows}: route {phase1.scan_route(rows, K // 32)} ({card})")
        for nb in phase1.SCAN_CLUSTER_SIZES:
            rpb = -(-rows // nb)
            if not phase1.scan_fits(rpb, K // 32) or rows < 64 * nb:
                continue
            got = phase1.scan_cluster(bT, used, 8, K, 10**6, nb)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"rows {rows}, {nb} blocks differ")
            t = ms_of(lambda: phase1.scan_cluster(bT, used, 8, K, 10**6, nb))
            print(f"  {nb:2d} blocks x {rpb} rows: {1000 * t / K:.3f} us per step")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the kernels that carry the cluster scan inside another launch, on one NVIDIA GPU:  python3 scripts/tune_scan_batched_torch.py [--ptxas]

* the 1-pivot scan (`phase1.scan`) at the flagship slice, for comparing two
  checkouts in one run;
* the batched scan for B = 1, 4, 8, 16 systems on every cluster size that
  holds a slice, with the number of clusters of each size the card runs at
  once;
* the fused update + scan, full and trailing, beside the scan alone and the
  update alone, and its update part alone (a scan whose columns are all
  invalid).

Random slices (half the bits set: the densest a solver's slice gets), K = 256,
25% of the rows used.  Every configuration is held against the plain twin
first.  ``--ptxas`` also prints what ``nvcc -Xptxas -v`` says of the two
sources that hold the cluster scan (registers, spills)."""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gf2bv_tpu_torch.core.words import u32_to_torch  # noqa: E402
from gf2bv_tpu_torch.ops import _cuda, gauss_batched, panel_update, phase1  # noqa: E402

K, KW, COLS = 256, 8, 10**6
ROWS, WP = 20224, 640


def ms_of(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def same(got, want, what):
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: kernel differs from its plain twin")


def ptxas():
    for name in ("scan.cu", "panel_update.cu"):
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-Xptxas", "-v", "-c",
               "-o", "/dev/null", str(_cuda.CSRC / name)]
        t0 = time.perf_counter()
        err = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
        print(f"{name}: compiled in {time.perf_counter() - t0:.1f} s")
        lines = err.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and ("cluster" in line or "update_scan" in line):
                print(name, line.split("'")[1][:70], "|", lines[i + 2].strip(), "|",
                      lines[i + 3].strip())


def batched(dev, card, rng):
    for rows in (ROWS, 5000, 768):
        for nb in phase1.SCAN_CLUSTER_SIZES:
            if phase1.scan_fits(-(-rows // nb), KW) and rows >= 64 * nb:
                print(f"clusters of {nb} blocks holding a ({KW}, {rows}) slice that the card "
                      f"runs at once: {phase1.scan_occupancy(rows, KW, nb)} ({card})")
    for rows in (ROWS, 40192):
        for B in (1, 4, 8, 16):
            bT = u32_to_torch(rng.integers(0, 2**32, size=(B, KW, rows), dtype=np.uint32), dev)
            used = u32_to_torch((rng.random((B, rows)) < 0.25).astype(np.uint32), dev)
            want = gauss_batched.scan_batched_plain(bT, used, 8, K, COLS)
            route = phase1.scan_batched_route(B, rows, KW)
            line = []
            for nb in phase1.SCAN_CLUSTER_SIZES:
                if not phase1.scan_fits(-(-rows // nb), KW):
                    continue
                got = gauss_batched.scan_batched_cluster(bT, used, 8, K, COLS, nb)
                same(got, want, f"B={B} rows={rows} on {nb} blocks")
                t = ms_of(lambda: gauss_batched.scan_batched_cluster(bT, used, 8, K, COLS, nb))
                line.append(f"{nb} blocks {t:.4f} ms ({1000 * t / K:.3f} us a step)")
            print(f"scan_batched B={B}, {rows} rows, route {route.kernel} on {route.nblocks}: "
                  + "; ".join(line) + f" ({card})")


def fused(dev, card, rng):
    a = u32_to_torch(rng.integers(0, 2**32, size=(ROWS, WP), dtype=np.uint32), dev)
    sel = u32_to_torch(rng.integers(0, 2**32, size=(ROWS, KW), dtype=np.uint32), dev)
    pf = u32_to_torch(rng.integers(0, 2**32, size=(K, WP), dtype=np.uint32), dev)
    bTn = u32_to_torch(rng.integers(0, 2**32, size=(KW, ROWS), dtype=np.uint32), dev)
    used = u32_to_torch((rng.random((1, ROWS)) < 0.25).astype(np.uint32), dev)
    scratch = a.clone()
    scan_ms = ms_of(lambda: phase1.scan(bTn, used, 168, K, COLS))
    for w0 in (None, 160):
        want = panel_update.update_scan_plain(a.clone(), sel, pf, bTn, used, 168, COLS, w0)
        same(panel_update.update_scan(a.clone(), sel, pf, bTn, used, 168, COLS, w0), want,
             f"update_scan w0={w0}")
        new = ms_of(lambda: panel_update.update_scan(scratch, sel, pf, bTn, used, 168, COLS, w0))
        # cols = 0: no column is valid, the scan cluster only loads and stores
        part = ms_of(lambda: panel_update.update_scan(scratch, sel, pf, bTn, used, 168, 0, w0))
        alone = ms_of((lambda: panel_update.update_full(scratch, sel, pf)) if w0 is None else
                      (lambda: panel_update.update_trailing(scratch, sel, pf, w0)))
        sizes = []
        for nb in (4, 8):
            if phase1.scan_fits(-(-ROWS // nb), KW):
                same(panel_update.update_scan_cluster(a.clone(), sel, pf, bTn, used, 168, COLS,
                                                      w0, nb), want, f"update_scan on {nb}")
                t = ms_of(lambda: panel_update.update_scan_cluster(
                    scratch, sel, pf, bTn, used, 168, COLS, w0, nb))
                sizes.append(f"{nb} blocks {t:.4f}")
        print(f"update_scan w0={w0}: fused {new:.4f} ms; scan alone {scan_ms:.4f} ms, update alone {alone:.4f} ms, the update part alone "
              f"inside the fused kernel {part:.4f} ms; scan cluster of other sizes, ms: "
              f"{', '.join(sizes) or 'none'} ({card})")


def main():
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    _cuda.lib()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    if "--ptxas" in sys.argv[1:]:
        ptxas()
    rng = np.random.default_rng(7)
    bT = u32_to_torch(rng.integers(0, 2**32, size=(KW, ROWS), dtype=np.uint32), dev)
    used = u32_to_torch((rng.random((1, ROWS)) < 0.25).astype(np.uint32), dev)
    same(phase1.scan(bT, used, 8, K, COLS), phase1.scan_plain(bT, used, 8, K, COLS), "scan")
    for _ in range(3):
        t = ms_of(lambda: phase1.scan(bT, used, 8, K, COLS), 20)
        print(f"scan, ({KW}, {ROWS}) slice: {t:.4f} ms, {1000 * t / K:.3f} us a step ({card})")
    if not hasattr(phase1, "scan_batched_route"):  # an earlier checkout: the scan alone
        return
    batched(dev, card, rng)
    fused(dev, card, rng)


if __name__ == "__main__":
    main()

"""Time the min-key scan and the fused phase 1 as cluster kernels, on one NVIDIA GPU:

    python3 scripts/tune_phase1_cluster_torch.py [--ptxas] [--parity] [--repo DIR]

* the min-key cluster scan on every cluster size that holds the slice, beside
  the 1-pivot cluster scan on the same inputs;
* the fused phase 1 (one cluster launch) beside the split engine (scan +
  gathers + rebuild) and the 1-pivot scan alone, on every cluster size that
  holds the slice.

Random (rows, 640) matrices (half the bits set: the densest a solver's slice
gets), K = 256, panel 20, 25% of the rows used; each launch replayed from a
CUDA graph, every configuration held against its plain twin first.

``--parity`` times instead, on the same inputs, the kernels this work must
leave as they were (the 1-pivot scan, the batched scan at B = 4, the fused
update + scan, the rebuild one system and B = 4), for comparing two
checkouts in one call: run it with ``--repo`` naming each checkout in turn.
``--ptxas`` also prints what ``nvcc -Xptxas -v`` says of the sources that
hold the cluster kernels and the coefficient solve (registers, spills)."""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROWS, WP, K = 20224, 640, 256
W0 = 20 * (K // 32)
COLS = 19968


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def ptxas(_cuda):
    for name in ("scan.cu", "phase1_fused.cu", "reconstruct.cu"):
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-Xptxas", "-v", "-c",
               "-o", "/dev/null", str(_cuda.CSRC / name)]
        t0 = time.perf_counter()
        err = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
        print(f"{name}: compiled in {time.perf_counter() - t0:.1f} s")
        lines = err.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(
                    k in line for k in ("cluster", "fused", "coeff_blocked")):
                mangled = line.split("'")[1]
                at = max(mangled.find(k) for k in ("scan_cluster", "phase1_fused", "coeff_blocked"))
                print(name, mangled[at:], "|", lines[i + 2].strip(), "|", lines[i + 3].strip())


def graph_ms(fn, n: int = 32) -> float:
    from gf2bv_tpu_torch.ops import launch_floor

    x = torch.zeros(1, device="cuda")
    return launch_floor.chain_us(lambda y: (fn(), y)[1], x, n, graph=True) / 1000


def same(got, want, what: str) -> None:
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel differs from its twin")


def inputs(rows: int, seed: int):
    from gf2bv_tpu_torch.core.words import u32_to_torch

    rng = np.random.default_rng(seed)
    a = u32_to_torch(rng.integers(0, 2**32, size=(rows, WP), dtype=np.uint32), "cuda")
    used = torch.from_numpy((rng.random((1, rows)) < 0.25).astype(np.int32)).cuda()
    bT = a[:, W0 : W0 + K // 32].T.contiguous()
    return a, bT, used


def tune(tag: str) -> None:
    from gf2bv_tpu_torch.ops import phase1

    kw = K // 32
    for rows in (2560, ROWS, 32767):
        a, bT, used = inputs(rows, rows)
        want = phase1.scan_minkey_plain(bT, used, W0, K, COLS)
        route = phase1.scan_minkey_route(rows, kw)
        parts = []
        for nb in phase1.SCAN_CLUSTER_SIZES:
            if not phase1.scan_fits(-(-rows // nb), kw, minkey=True) or rows < 32 * nb:
                continue
            same(phase1.scan_minkey_cluster(bT, used, W0, K, COLS, nb), want, f"minkey {nb}")
            ms = graph_ms(lambda: phase1.scan_minkey_cluster(bT, used, W0, K, COLS, nb))
            parts.append(f"{nb} blocks {ms:.4f} ms ({1000 * ms / K:.3f} us a step)")
        one = graph_ms(lambda: phase1.scan(bT, used, W0, K, COLS))
        print(f"min-key scan, {rows} rows (route: {route.nblocks} blocks): " + "; ".join(parts)
              + f"; 1-pivot cluster scan {one:.4f} ms ({tag})")
    for rows in (ROWS, 40192):
        a, bT, used = inputs(rows, rows + 1)
        want = phase1.phase1_panel_plain(a, bT, used, W0, K, COLS)
        route = phase1.phase1_fused_route(rows, kw)
        parts = []
        for nb in phase1.SCAN_CLUSTER_SIZES:
            if not phase1.scan_fits(-(-rows // nb), kw):
                continue
            same(phase1.phase1_panel_cluster(a, bT, used, W0, K, COLS, nb), want, f"fused {nb}")
            ms = graph_ms(lambda: phase1.phase1_panel_cluster(a, bT, used, W0, K, COLS, nb))
            parts.append(f"{nb} blocks {ms:.4f} ms")
        split = graph_ms(lambda: phase1.phase1_panel_split(a, bT, used, W0, K, COLS))
        scan = graph_ms(lambda: phase1.scan(bT, used, W0, K, COLS))
        nocol = graph_ms(lambda: phase1.phase1_panel(a, bT, used, W0, K, 0))
        print(f"fused phase 1, {rows} rows (route: {route.nblocks} blocks, "
              f"{route.smem_bytes} B a block): " + "; ".join(parts)
              + f"; split engine {split:.4f} ms; 1-pivot scan "
              f"alone {scan:.4f} ms; the fused kernel with no valid column (scan loads, "
              f"solve, product of zeros) {nocol:.4f} ms ({tag})")


def parity(tag: str) -> None:
    from gf2bv_tpu_torch.ops import gauss_batched, panel_update, phase1

    kw = K // 32
    a, bT, used = inputs(ROWS, 7)
    rng = np.random.default_rng(8)
    t = {"scan": graph_ms(lambda: phase1.scan(bT, used, W0, K, COLS))}
    bT4 = bT.expand(4, kw, ROWS).contiguous()
    used4 = used.expand(4, ROWS).contiguous()
    t["scan_batched B=4"] = graph_ms(lambda: gauss_batched.scan_batched(bT4, used4, W0, K, COLS))
    prow, _, cT = phase1.scan(bT, used, W0, K, COLS)
    ps = prow.clamp(min=0).long()
    arows, coeff = a[ps].contiguous(), cT[:, ps].T.contiguous()
    t["reconstruct"] = graph_ms(lambda: phase1.reconstruct(arows, coeff, prow, W0))
    many = (arows.expand(4, K, WP).contiguous(), coeff.expand(4, K, kw).contiguous(),
            prow.expand(4, K).contiguous(), W0)
    t["reconstruct_batched B=4"] = graph_ms(lambda: gauss_batched.reconstruct_batched(*many))
    t["reconstruct_coeff"] = graph_ms(lambda: phase1.reconstruct_coeff(arows, coeff, prow, W0))
    sel = torch.from_numpy(rng.integers(-2**31, 2**31, size=(ROWS, kw),
                                        dtype=np.int64).astype(np.int32)).cuda()
    pf = phase1.reconstruct(arows, coeff, prow, W0)
    scratch = a.clone()
    bTn = a[:, W0 + kw : W0 + 2 * kw].T.contiguous()
    for w0t in (None, W0):
        t[f"update_scan w0={w0t}"] = graph_ms(lambda: panel_update.update_scan(
            scratch, sel, pf, bTn, used, W0 + kw, COLS, w0t))
    print(f"parity ({tag}): " + "; ".join(f"{k} {v:.4f} ms" for k, v in t.items()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from gf2bv_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.lib()
    tag = f"{args.repo}; {card()}"
    print(f"kernels built in {time.perf_counter() - t0:.1f} s ({tag})")
    if args.ptxas:
        ptxas(_cuda)
    if args.parity:
        parity(tag)
    else:
        tune(tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())

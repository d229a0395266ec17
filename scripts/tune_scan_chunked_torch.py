"""Time the chained scan of slices taller than one cluster, on one NVIDIA GPU:

    python3 scripts/tune_scan_chunked_torch.py [--ptxas] [--check] [--solve] [--repo DIR]

* the chained scan (``gf2_scan_chunked``, ``gf2_scan_batched_chunked``) at
  panel 20 of the very tall MT19937 system (2100 outputs: 67328 x 640 words,
  K = 256, 25% of the rows used), single and for B = 2 systems, under the two
  cuts of the rows into chunks: (a) equal chunks, the fewest a cluster holds
  (``phase1.scan_chunk_rows``, the route's), and (b) the largest cluster filled
  first; beside the plain twin, each launch replayed from a CUDA graph after
  the kernel is held against its twin;
* ``--check``: the chained kernels against their twins at the shapes the card
  tests use, before any timing (a first run of a new build);
* ``--solve``: the very tall system's warm ``solve_mt19937`` and
  ``gauss_batched.solve_batched`` (mode 0) on two such systems, best of 3 wall
  time and the device time of one more call under ``torch.profiler`` (the sum
  of its kernels), through the public entry points alone, so that it runs in
  any checkout: name each with ``--repo`` in turn to compare two;
* ``--ptxas``: what ``nvcc -Xptxas -v`` says of ``scan_chunked.cu``
  (registers, shared memory, spills) and how long it takes to compile."""

import argparse
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

WP, K = 640, 256
W0 = 20 * (K // 32)
VERY_TALL_SAMPLES, VERY_TALL_ROWS = 2100, 67328
SEED = 20240531


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def ptxas(_cuda):
    name = "scan_chunked.cu"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-Xptxas", "-v", "-c",
           "-o", "/dev/null", str(_cuda.CSRC / name)]
    t0 = time.perf_counter()
    err = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
    print(f"{name}: compiled in {time.perf_counter() - t0:.1f} s")
    lines = err.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            print(name, line.split("'")[1], "|", lines[i + 2].strip(), "|",
                  lines[i + 3].strip())


def graph_ms(fn, n: int = 16) -> float:
    from gf2bv_tpu_torch.ops import launch_floor

    x = torch.zeros(1, device="cuda")
    return launch_floor.chain_us(lambda y: (fn(), y)[1], x, n, graph=True) / 1000


def same(got, want, what: str) -> None:
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel differs from its twin")


def mt_outputs(seed: int, n: int):
    rand = random.Random(seed)
    state = tuple(rand.getstate()[1][:-1])
    return state, [rand.getrandbits(32) for _ in range(n)]


def very_tall(seed: int) -> torch.Tensor:
    from gf2bv_tpu_torch.core.words import u32_to_torch
    from gf2bv_tpu_torch.crypto.mt_torch import mt19937_system_device

    outs = mt_outputs(seed, VERY_TALL_SAMPLES)[1]
    eqs = mt19937_system_device(u32_to_torch(np.array(outs, np.uint32), "cuda"), 32,
                                VERY_TALL_SAMPLES)
    return torch.nn.functional.pad(eqs, (0, 0, 0, VERY_TALL_ROWS - eqs.shape[0])).contiguous()


def check(tag: str) -> None:
    """The chained kernels against their twins at the card tests' shapes."""
    from gf2bv_tpu_torch.core.words import u32_to_torch
    from gf2bv_tpu_torch.ops import gauss_batched, phase1

    rng = np.random.default_rng(3)
    cases = [(1, 65537, 8, None), (1, 67328, 8, None), (1, 140000, 8, None),
             (1, 70000, 1, None), (1, 70000, 3, None), (1, 5000, 8, 1024),
             (2, 67328, 8, None), (4, 67328, 8, None), (2, 140000, 8, None)]
    for batch, rows, kw, chunk in cases:
        bT = u32_to_torch(rng.integers(0, 2**32, size=(batch, kw, rows), dtype=np.uint32),
                          "cuda")
        used = torch.from_numpy((rng.random((batch, rows)) < 0.25).astype(np.int32)).cuda()
        route = phase1.scan_chunked_route(rows, kw, chunk, batch)
        t0 = time.perf_counter()
        if batch == 1:
            got = phase1.scan_chunked(bT[0], used, 8, 32 * kw, 10**6, chunk)
            want = phase1.scan_plain(bT[0], used, 8, 32 * kw, 10**6)
        else:
            got = gauss_batched.scan_batched_chunked(bT, used, 8, 32 * kw, 10**6, chunk)
            want = gauss_batched.scan_batched_plain(bT, used, 8, 32 * kw, 10**6)
        torch.cuda.synchronize()
        same(got, want, f"B={batch} rows={rows} kw={kw} chunk={chunk}")
        print(f"chained scan B={batch} rows={rows} kw={kw}: {route.chunks} chunks of "
              f"{route.chunk_rows} rows on {route.nblocks} blocks (last {route.nblocks_last}) = "
              f"twin ({time.perf_counter() - t0:.2f} s) ({tag})")


def tune(tag: str) -> None:
    from gf2bv_tpu_torch.ops import gauss_batched, phase1

    kw = K // 32
    gen = torch.Generator().manual_seed(SEED)
    mats = torch.stack([very_tall(SEED + 8 + b) for b in range(2)])
    bT2 = mats[:, :, W0 : W0 + kw].transpose(1, 2).contiguous()
    used2 = (torch.rand((2, VERY_TALL_ROWS), generator=gen) < 0.25).to(torch.int32).cuda()
    bT, used = bT2[0].contiguous(), used2[:1].contiguous()
    cuts = {"(a) equal chunks": phase1.scan_chunk_rows(VERY_TALL_ROWS, kw),
            "(b) largest cluster first": phase1.scan_max_rows(kw, chained=True)}
    want = phase1.scan_plain(bT, used, W0, K, 19968)
    want2 = gauss_batched.scan_batched_plain(bT2, used2, W0, K, 19968)
    t = {}
    for cut, rows_c in cuts.items():
        route = phase1.scan_chunked_route(VERY_TALL_ROWS, kw, rows_c)
        same(phase1.scan_chunked(bT, used, W0, K, 19968, rows_c), want, cut)
        same(gauss_batched.scan_batched_chunked(bT2, used2, W0, K, 19968, rows_c), want2, cut)
        ms = graph_ms(lambda: phase1.scan_chunked(bT, used, W0, K, 19968, rows_c))
        ms2 = graph_ms(lambda: gauss_batched.scan_batched_chunked(bT2, used2, W0, K, 19968,
                                                                  rows_c))
        parts = []
        for c in range(route.chunks):  # each link alone: a one-chunk chain of its rows
            lo = c * rows_c
            hi = min(VERY_TALL_ROWS, lo + rows_c)
            sub, usub = bT[:, lo:hi].contiguous(), used[:, lo:hi].contiguous()
            parts.append(graph_ms(lambda: phase1.scan_chunked(sub, usub, W0, K, 19968)))
        t[cut] = ms
        print(f"chained scan {cut}: {route.chunks} chunks of {rows_c} rows on "
              f"{route.nblocks} / {route.nblocks_last} blocks: single {ms:.4f} ms "
              f"({1000 * ms / K:.3f} us a step), B=2 {ms2:.4f} ms; each chunk scanned alone "
              f"from the start (no record): "
              + ", ".join(f"{p:.4f}" for p in parts) + f" ms ({tag})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phase1.scan_chunked_plain(bT, used, W0, K, 19968, cuts["(a) equal chunks"])
    torch.cuda.synchronize()
    plain = 1000 * (time.perf_counter() - t0)
    print(f"very tall panel 20 ({VERY_TALL_ROWS} rows): chained twin {plain:.1f} ms ({tag})")


def solve(tag: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gf2bv_tpu_torch.crypto.mt_torch import COLS, _state_words, solve_mt19937
    from gf2bv_tpu_torch.ops import gauss_batched

    state, outs = mt_outputs(SEED + 8, VERY_TALL_SAMPLES)
    pairs = [mt_outputs(SEED + 200 + b, VERY_TALL_SAMPLES) for b in range(2)]
    mats = torch.stack([very_tall(SEED + 200 + b) for b in range(2)])
    runs = {
        "solve_mt19937 (very tall)": (
            lambda: solve_mt19937(outs, 32, samples=VERY_TALL_SAMPLES, device="cuda"), state),
        "solve_batched mode 0, 2 very tall": (
            lambda: [_state_words(o) for o in gauss_batched.solve_batched(
                mats, COLS, 0, device="cuda")], [s for s, _ in pairs]),
    }
    for what, (fn, want) in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if fn() != want:
            raise AssertionError(f"{what}: state not recovered")
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if fn() != want:
                raise AssertionError(f"{what}: warm call lost the state")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) != DeviceType.CUDA:
                continue  # a CPU operator: its device time is its kernels' rows
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            if us > 0:
                rows.append((us, ev.key, ev.count))
        rows.sort(reverse=True)
        dev_ms = sum(r[0] for r in rows) / 1000
        print(f"{what}: cold {cold:.4f} s, warm best of 3 {min(walls):.4f} s (all "
              f"{[round(w, 4) for w in walls]}); device time {dev_ms:.1f} ms; top kernels: "
              + "; ".join(f"{us / 1000:.2f} ms {n}x {k[:60]}" for us, k, n in rows[:4])
              + f" ({tag})")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--solve", action="store_true")
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
    if args.solve:
        solve(tag)
        return 0
    if args.check:
        check(tag)
    tune(tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())

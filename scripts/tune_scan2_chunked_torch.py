"""Time the chained two-pivot scan and the mxu4 update on the strip kernel, on
one NVIDIA GPU:

    python3 scripts/tune_scan2_chunked_torch.py [--ptxas] [--check] [--parity]
        [--solve] [--repo DIR]

* the chained two-pivot scan (``gf2_scan2_chunked``) at panel 20 of the very
  tall MT19937 system (2100 outputs: 67328 x 640 words, K = 256, a quarter of
  the rows used) under the two cuts of the rows into chunks (equal chunks, the
  route's; the largest cluster filled first), each link alone (a one-chunk
  chain of its rows), beside the 1-pivot chain (``scan_chunked``);
* the mxu4 and mxu2 updates (one kernel under two rules) on 768 words and
  trailing on 640 words at w0 = 160 and 632, beside the table kernel;
  each launch replayed from a CUDA graph after it is held against its twin.

``--check``: the new kernels against their twins at the card tests' shapes
first (a first run of a new build).  ``--parity``: instead, the kernels whose
code this change touched and that must keep their times (``gf2_scan2`` at the
flagship panel, ``gf2_scan_chunked`` at the very tall panel, ``gf2_update_mxu2``
on 768 words and trailing), through entry points every checkout has: run it with ``--repo`` naming each checkout in turn.
``--solve``: the very tall system's warm ``solve_mt19937`` under phase 1
``pallas_scan2`` and the flagship's under phase 2 ``mxu4``, best of 3 wall
time and the device time of one more call under ``torch.profiler`` by kernel.
``--ptxas``: what ``nvcc -Xptxas -v`` says of the changed sources (registers,
spills) and how long each takes to compile alone."""

import argparse
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROWS, WP, K = 20224, 640, 256
W0 = 20 * (K // 32)
COLS = 19968
VERY_TALL_SAMPLES, VERY_TALL_ROWS = 2100, 67328
SEED = 20240531
SOURCES = ("scan2_chunked.cu", "scan2.cu", "scan_chunked.cu", "update_mma.cu")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def ptxas(_cuda) -> None:
    for name in SOURCES:
        if not (_cuda.CSRC / name).exists():
            continue
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-Xptxas", "-v", "-c",
               "-o", "/dev/null", str(_cuda.CSRC / name)]
        t0 = time.perf_counter()
        err = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
        print(f"{name}: compiled alone in {time.perf_counter() - t0:.1f} s")
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


def very_tall_panel():
    """Panel 20 of the very tall system, a quarter of its rows used."""
    from gf2bv_tpu_torch.core.words import u32_to_torch
    from gf2bv_tpu_torch.crypto.mt_torch import mt19937_system_device

    outs = mt_outputs(SEED + 8, VERY_TALL_SAMPLES)[1]
    eqs = mt19937_system_device(u32_to_torch(np.array(outs, np.uint32), "cuda"), 32,
                                VERY_TALL_SAMPLES)
    a = torch.nn.functional.pad(eqs, (0, 0, 0, VERY_TALL_ROWS - eqs.shape[0]))
    bT = a[:, W0 : W0 + K // 32].T.contiguous()
    gen = torch.Generator().manual_seed(SEED)
    used = (torch.rand((1, VERY_TALL_ROWS), generator=gen) < 0.25).to(torch.int32).cuda()
    return bT, used


def update_inputs(rows: int, wp: int, seed: int):
    rng = np.random.default_rng(seed)

    def words(shape):
        return torch.from_numpy(rng.integers(-2**31, 2**31, size=shape,
                                             dtype=np.int64).astype(np.int32)).cuda()

    return words((rows, wp)), words((rows, K // 32)), words((K, wp))


def check(tag: str) -> None:
    """The chained two-pivot scan and mxu4 against their twins at the card
    tests' shapes."""
    from gf2bv_tpu_torch.core.words import u32_to_torch
    from gf2bv_tpu_torch.ops import panel_update as pu
    from gf2bv_tpu_torch.ops import phase1

    rng = np.random.default_rng(3)
    for rows, kw, chunk, w0, cols in ((67328, 8, None, 160, 19968), (67328, 8, 65536, 8, 10**6),
                                      (67328, 8, 8192, 160, 19968), (5000, 8, 1024, 8, 10**6),
                                      (70000, 3, None, 2, 150), (65537, 8, None, 0, 10**6)):
        bT = u32_to_torch(rng.integers(0, 2**32, size=(kw, rows), dtype=np.uint32), "cuda")
        for frac in (0.25, 1.0):
            used = torch.from_numpy((rng.random((1, rows)) < frac).astype(np.int32)).cuda()
            route = phase1.scan_chunked_route(rows, kw, chunk, kernel="scan2_chunked")
            got = phase1.scan2_chunked(bT, used, w0, 32 * kw, cols, chunk)
            torch.cuda.synchronize()
            same(got, phase1.scan2_chunked_plain(bT, used, w0, 32 * kw, cols, route.chunk_rows),
                 f"scan2_chunked rows={rows} kw={kw} chunk={chunk} used={frac}")
            same(got, phase1.scan_plain(bT, used, w0, 32 * kw, cols), "against scan_plain")
        print(f"scan2_chunked rows={rows} kw={kw}: {route.chunks} chunks of {route.chunk_rows} "
              f"rows on {route.nblocks} blocks (last {route.nblocks_last}) = twin ({tag})")
    for rows, wp in ((ROWS, 640), (ROWS, 768), (ROWS, 638), (ROWS, 8), (1000, 389)):
        a, sel, pf = update_inputs(rows, wp, rows + wp)
        for w0 in [None] + sorted({0, 127, 128, 160, 632} & set(range(wp))):
            for name in ("mxu4", "mxu2"):
                got = getattr(pu, f"update_{name}")(a.clone(), sel, pf, w0)
                want = getattr(pu, f"update_{name}_plain")(a.clone(), sel, pf, w0)
                same([got], [want], f"{name} rows={rows} wp={wp} w0={w0}")
        print(f"update_mxu4 / update_mxu2 on {rows} x {wp} words = twins at every w0 ({tag})")


def tune(tag: str) -> None:
    from gf2bv_tpu_torch.ops import panel_update as pu
    from gf2bv_tpu_torch.ops import phase1

    kw = K // 32
    bT, used = very_tall_panel()
    want = phase1.scan_plain(bT, used, W0, K, COLS)
    cuts = {"(a) equal chunks": phase1.scan2_route(VERY_TALL_ROWS, kw).chunk_rows,
            "(b) largest cluster first": phase1.scan_max_rows(kw, chained=True, pairs=True)}
    for cut, rows_c in cuts.items():
        route = phase1.scan_chunked_route(VERY_TALL_ROWS, kw, rows_c, kernel="scan2_chunked")
        same(phase1.scan2_chunked(bT, used, W0, K, COLS, rows_c), want, cut)
        ms = graph_ms(lambda: phase1.scan2_chunked(bT, used, W0, K, COLS, rows_c))
        parts = []
        for c in range(route.chunks):
            lo, hi = c * rows_c, min(VERY_TALL_ROWS, (c + 1) * rows_c)
            sub, usub = bT[:, lo:hi].contiguous(), used[:, lo:hi].contiguous()
            parts.append(graph_ms(lambda: phase1.scan2_chunked(sub, usub, W0, K, COLS)))
        print(f"scan2_chunked {cut}: {route.chunks} chunks of {rows_c} rows on "
              f"{route.nblocks} / {route.nblocks_last} blocks: {ms:.4f} ms "
              f"({2000 * ms / K:.3f} us a pair); each chunk alone from the start (no record): "
              + ", ".join(f"{p:.4f}" for p in parts) + f" ms ({tag})")
    chain1 = graph_ms(lambda: phase1.scan_chunked(bT, used, W0, K, COLS))
    print(f"very tall panel 20: scan_chunked {chain1:.4f} ms ({tag})")
    for wp, w0 in ((768, None), (640, None), (640, 160), (640, 632)):
        a, sel, pf = update_inputs(ROWS, wp, wp + (w0 or 0))
        same([pu.update_mxu4(a.clone(), sel, pf, w0)], [pu.update_mxu4_plain(a.clone(), sel, pf,
                                                                             w0)], "mxu4")
        scratch = a.clone()
        t = {"mxu4": graph_ms(lambda: pu.update_mxu4(scratch, sel, pf, w0), 32),
             "mxu2": graph_ms(lambda: pu.update_mxu2(scratch, sel, pf, w0), 32),
             "mxu4 again": graph_ms(lambda: pu.update_mxu4(scratch, sel, pf, w0), 32)}
        if w0 is None:
            t["table (update_pallas)"] = graph_ms(lambda: pu.update_pallas(scratch, sel, pf), 32)
        print(f"update on {ROWS} x {wp} words, w0={w0}: "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in t.items()) + f" ({tag})")


def parity(tag: str) -> None:
    from gf2bv_tpu_torch.ops import panel_update as pu
    from gf2bv_tpu_torch.ops import phase1

    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, size=(ROWS, WP),
                                      dtype=np.int64).astype(np.int32)).cuda()
    bT = a[:, W0 : W0 + K // 32].T.contiguous()
    used = torch.from_numpy((rng.random((1, ROWS)) < 0.25).astype(np.int32)).cuda()
    t = {"scan2 (flagship, random)": graph_ms(lambda: phase1.scan2(bT, used, W0, K, COLS), 32)}
    vbT, vused = very_tall_panel()
    t["scan_chunked (very tall)"] = graph_ms(
        lambda: phase1.scan_chunked(vbT, vused, W0, K, COLS))
    a768, sel, pf768 = update_inputs(ROWS, 768, 11)
    t["mxu2 768 words"] = graph_ms(lambda: pu.update_mxu2(a768, sel, pf768), 32)
    a640, pf640 = a768[:, :640].contiguous(), pf768[:, :640].contiguous()
    t["mxu2 w0=160"] = graph_ms(lambda: pu.update_mxu2(a640, sel, pf640, 160), 32)
    print(f"parity ({tag}): " + "; ".join(f"{k} {v:.4f} ms" for k, v in t.items()))


def profiled(what: str, fn, want, tag: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
          f"{[round(w, 4) for w in walls]}); device time {dev_ms:.1f} ms, idle "
          f"{100 * max(0.0, 1 - dev_ms / 1000 / min(walls)):.1f}%; top kernels: "
          + "; ".join(f"{us / 1000:.2f} ms {n}x {k[:60]}" for us, k, n in rows[:5])
          + f" ({tag})")


def solve(tag: str) -> None:
    from gf2bv_tpu_torch.crypto.mt_torch import solve_mt19937

    vstate, vouts = mt_outputs(SEED + 8, VERY_TALL_SAMPLES)
    state, outs = mt_outputs(SEED, 624)
    for var, engine, what, fn, want in (
            ("GF2BV_TPU_PHASE1", "pallas_scan2", "very tall solve_mt19937, pallas_scan2",
             lambda: solve_mt19937(vouts, 32, samples=VERY_TALL_SAMPLES, device="cuda"),
             vstate),
            ("GF2BV_TPU_PHASE2", "mxu4", "flagship solve_mt19937, mxu4",
             lambda: solve_mt19937(outs, 32, device="cuda"), state)):
        os.environ[var] = engine
        try:
            profiled(what, fn, want, tag)
        finally:
            del os.environ[var]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--parity", action="store_true")
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
    if args.parity:
        parity(tag)
        return 0
    if args.solve:
        solve(tag)
        return 0
    if args.check:
        check(tag)
    tune(tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the chained fused kernels of slices taller than one cluster, on one
NVIDIA GPU:

    python3 scripts/tune_fused_chunked_torch.py [--ptxas] [--parity] [--solve] [--repo DIR]

* the chained fused phase 1 (``gf2_phase1_fused_chunked``) and fused update +
  scan (``gf2_update_scan_chunked``, full and trailing, with 8/8 to 4/8 of
  the update's rows beside the chain's first link) at panel 20 of the very
  tall MT19937 system (2100 outputs: 67328 x 640 words, K = 256, 25% of the
  rows used), under the route's cut (two equal chunks) and with the largest
  cluster filled first; beside the split engine (chained scan + gathers +
  rebuild), the update apart, the chained scan alone and each of its links
  alone (a chunk's rows scanned as a slice of their own); each launch
  replayed from a CUDA graph after the kernel is held against its twin;
* ``--parity``: instead, the kernels that share code with this change and
  must keep their times: the fused phase 1 and the fused update + scan
  (full and trailing) on random 20224 x 640 inputs, the chained scan and the
  batched chained scan (B = 2) at the very tall panel; run it once per
  checkout, naming each with ``--repo``, in turns within one call;
* ``--solve``: the very tall system's ``solve_mt19937`` under the default
  engine, phase 1 ``pallas`` and phase 2 ``mxu_la``: cold, warm best of 3,
  the device time of one more call under ``torch.profiler`` (the sum of its
  kernels, the three largest) and the card's idle share against the warm
  wall; through the public entry points alone, so that it runs in any
  checkout (``--repo``);
* ``--ptxas``: what ``nvcc -Xptxas -v`` says of ``fused_chunked.cu``
  (registers, shared memory, spills) and how long each source takes to
  compile alone."""

import argparse
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

WP, K = 640, 256
W0 = 20 * (K // 32)
COLS = 19968
VERY_TALL_SAMPLES, VERY_TALL_ROWS = 2100, 67328
SEED = 20240531
SPLITS = (8, 7, 6, 5, 4)  # eighths of the update's rows beside the chain's first link


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def ptxas(_cuda):
    """Each source compiled alone (the build runs them side by side), and
    the registers and spills of fused_chunked.cu's kernels."""
    for src in sorted(_cuda.CSRC.glob("*.cu")):
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-c", "-o",
               "/dev/null", str(src)]
        if src.name == "fused_chunked.cu":
            cmd[-4:-4] = ["-Xptxas", "-v"]
        t0 = time.perf_counter()
        err = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
        print(f"{src.name}: compiled in {time.perf_counter() - t0:.1f} s")
        lines = err.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                print(src.name, line.split("'")[1], "|", lines[i + 2].strip(), "|",
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


def panel_inputs():
    """The very tall system's panel 20 with a quarter of the rows used."""
    kw = K // 32
    a = very_tall(SEED + 8)
    bT = a[:, W0 : W0 + kw].T.contiguous()
    gen = torch.Generator().manual_seed(SEED)
    used = (torch.rand((1, VERY_TALL_ROWS), generator=gen) < 0.25).to(torch.int32).cuda()
    return a, bT, used


def links_alone(bT, used, w0: int, chunk: int) -> list:
    """Each chunk's rows scanned alone (a one-link chain of its own rows)."""
    from gf2bv_tpu_torch.ops import phase1

    out = []
    for lo in range(0, bT.shape[1], chunk):
        sub = bT[:, lo : lo + chunk].contiguous(), used[:, lo : lo + chunk].contiguous()
        out.append(graph_ms(lambda: phase1.scan_chunked(*sub, w0, K, COLS)))
    return out


def tune(tag: str) -> None:
    from gf2bv_tpu_torch.ops import gauss_blocked, panel_update, phase1

    kw = K // 32
    a, bT, used = panel_inputs()
    args = (a, bT, used, W0, K, COLS)
    cuts = {"(a) equal chunks": phase1.scan_chunk_rows(VERY_TALL_ROWS, kw),
            "(b) largest cluster first": phase1.scan_max_rows(kw, chained=True)}
    want = phase1.phase1_panel_plain(*args)
    t = {}
    for cut, rows_c in cuts.items():
        same(phase1.phase1_panel_chunked(*args, rows_c), want, f"phase1 {cut}")
        t[cut] = graph_ms(lambda: phase1.phase1_panel_chunked(*args, rows_c))
        print(f"phase1_fused_chunked {cut}: {t[cut]:.4f} ms; links alone "
              + ", ".join(f"{x:.4f}" for x in links_alone(bT, used, W0, rows_c)) + f" ms ({tag})")
    split = graph_ms(lambda: phase1.phase1_panel_split(*args))
    chain = graph_ms(lambda: phase1.scan(bT, used, W0, K, COLS))
    nocol = graph_ms(lambda: phase1.phase1_panel(a, bT, used, W0, K, 0))
    print(f"very tall panel 20: split engine {split:.4f} ms, chained scan alone {chain:.4f} ms, "
          f"fused with no valid column {nocol:.4f} ms ({tag})")

    pf, prow = want[0], want[1]
    sel = gauss_blocked.selector_from_prow(bT.T.contiguous(), prow)
    scratch = a.clone()
    for w0t in (None, W0):
        nxt = panel_update.update_full_plain(a.clone(), sel, pf) if w0t is None else \
            panel_update.update_trailing_plain(a.clone(), sel, pf, w0t)
        bTn = nxt[:, W0 + kw : W0 + 2 * kw].T.contiguous()
        del nxt
        uargs = (sel, pf, bTn, used, W0 + kw, COLS, w0t)
        uwant = panel_update.update_scan_plain(a.clone(), *uargs)
        for cut, rows_c in cuts.items():
            times = []
            for eighths in SPLITS:
                first = VERY_TALL_ROWS * eighths // 8 // 32 * 32
                same(panel_update.update_scan_chunked(a.clone(), *uargs, rows_c, first), uwant,
                     f"update_scan_chunked w0={w0t} {cut} first_rows={first}")
                times.append(graph_ms(lambda: panel_update.update_scan_chunked(
                    scratch, *uargs, rows_c, first)))
            print(f"update_scan_chunked w0={w0t} {cut}, by the update's share beside link 0: "
                  + ", ".join(f"{e}/8 {t:.4f} ms" for e, t in zip(SPLITS, times))
                  + "; links alone "
                  + ", ".join(f"{x:.4f}" for x in links_alone(bTn, used, W0 + kw, rows_c))
                  + f" ms ({tag})")
        upd = graph_ms((lambda: panel_update.update_full(scratch, sel, pf)) if w0t is None
                       else (lambda: panel_update.update_trailing(scratch, sel, pf, w0t)))
        chain = graph_ms(lambda: phase1.scan(bTn, used, W0 + kw, K, COLS))
        part = graph_ms(lambda: panel_update.update_scan(scratch, sel, pf, bTn, used, W0 + kw,
                                                         0, w0t))
        print(f"update_scan w0={w0t} at the very tall panel 20, apart: update {upd:.4f} ms, "
              f"chained scan {chain:.4f} ms; fused with no valid column {part:.4f} ms ({tag})")


def random_inputs(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, size=(rows, WP),
                                      dtype=np.int64).astype(np.int32)).cuda()
    used = torch.from_numpy((rng.random((1, rows)) < 0.25).astype(np.int32)).cuda()
    return a, a[:, W0 : W0 + K // 32].T.contiguous(), used


def parity(tag: str) -> None:
    """The kernels whose code this change moved or shares, through entry
    points that every checkout since the chained scan has."""
    from gf2bv_tpu_torch.ops import gauss_batched, panel_update, phase1

    kw = K // 32
    a, bT, used = random_inputs(20224, 7)
    rng = np.random.default_rng(8)
    t = {"phase1_fused": graph_ms(lambda: phase1.phase1_panel(a, bT, used, W0, K, COLS), 32)}
    sel = torch.from_numpy(rng.integers(-2**31, 2**31, size=(20224, kw),
                                        dtype=np.int64).astype(np.int32)).cuda()
    pf, _, _ = phase1.phase1_panel(a, bT, used, W0, K, COLS)
    scratch = a.clone()
    bTn = a[:, W0 + kw : W0 + 2 * kw].T.contiguous()
    for w0t in (None, W0):
        t[f"update_scan w0={w0t}"] = graph_ms(lambda: panel_update.update_scan(
            scratch, sel, pf, bTn, used, W0 + kw, COLS, w0t), 32)
    va, vbT, vused = panel_inputs()
    t["scan_chunked"] = graph_ms(lambda: phase1.scan_chunked(vbT, vused, W0, K, COLS))
    vbT2 = torch.stack([vbT, very_tall(SEED + 9)[:, W0 : W0 + kw].T]).contiguous()
    vused2 = torch.cat([vused, vused.flip(1)]).contiguous()
    t["scan_batched_chunked B=2"] = graph_ms(lambda: gauss_batched.scan_batched_chunked(
        vbT2, vused2, W0, K, COLS))
    print(f"parity ({tag}): " + "; ".join(f"{k} {v:.4f} ms" for k, v in t.items()))


def solve(tag: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gf2bv_tpu_torch.crypto.mt_torch import solve_mt19937

    state, outs = mt_outputs(SEED + 8, VERY_TALL_SAMPLES)

    def fn():
        return solve_mt19937(outs, 32, samples=VERY_TALL_SAMPLES, device="cuda")

    for p1, p2 in (("pallas_scan", "mxu"), ("pallas", "mxu"), ("pallas_scan", "mxu_la")):
        os.environ["GF2BV_TPU_PHASE1"], os.environ["GF2BV_TPU_PHASE2"] = p1, p2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if fn() != state:
            raise AssertionError(f"{p1}+{p2}: state not recovered")
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if fn() != state:
                raise AssertionError(f"{p1}+{p2}: warm call lost the state")
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
        idle = 100 * max(0.0, 1 - dev_ms / 1000 / min(walls))
        print(f"very tall solve_mt19937 {p1}+{p2}: cold {cold:.4f} s, warm best of 3 "
              f"{min(walls):.4f} s (all {[round(w, 4) for w in walls]}); device time "
              f"{dev_ms:.1f} ms, idle {idle:.1f}%; top kernels: "
              + "; ".join(f"{us / 1000:.2f} ms {n}x {k[:60]}" for us, k, n in rows[:3])
              + f" ({tag})")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
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
    elif args.solve:
        solve(tag)
    else:
        tune(tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())

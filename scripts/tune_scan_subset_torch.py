#!/usr/bin/env python3
"""Check and time the subset-first scan on one NVIDIA GPU:

    python3 scripts/tune_scan_subset_torch.py [--check] [--time] [--solve]

With no flag, all three.  The inputs are real panels: the (bT, used) that
the default engine's eager mode-0 elimination hands ``phase1.scan_subset``
at a few panels of the flagship MT19937 system (624 outputs, 20224 rows), of
the very tall one (2100 outputs, 67328 rows: the chained scan is the
fallback) and of random systems, plus random slices.

``--check``: ``phase1.launch_scan_subset`` on the card against its plain
twins on the CPU (``scan_subset_steps_plain`` at the kernel's S, the miss
test, the composition with its fallback) and against ``scan_plain``.  The
kernel's S is ``phase1.SCAN_SUBSET_ROWS`` (``kSubsetRows`` in
``csrc/scan_subset.cu``, a compile-time constant).
``--time``: the device time of each kernel of a call (the subset kernel, the
test, the gated fallback) by ``torch.profiler``, and of the whole call
against the route's full scan, replayed from a CUDA graph of 20 calls.
``--solve``: the flagship and very tall eliminations replayed from a graph
under the subset-first plan and under the full scan on every panel (the
parent's path): bit for bit, and the device time of a replay."""

import argparse
import random
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gf2bv_tpu_torch.core.words import u32_to_torch  # noqa: E402
from gf2bv_tpu_torch.ops import gauss_blocked, phase1  # noqa: E402

K = 256
COLS = 19968
PANELS = (0, 1, 20, 40, 60, 78)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def mt_matrix(samples, seed, dev):
    from gf2bv_tpu_torch.crypto import mt_torch

    rng = random.Random(seed)
    outs = np.array([[rng.getrandbits(32)] for _ in range(samples)], dtype=np.uint32)
    return mt_torch._padded_system(u32_to_torch(outs, dev), 32, samples)


def panel_inputs(a, cols, panels=PANELS):
    """{t: (bT, used, w0)} of the default engine's eager elimination of ``a``."""
    seen = {}
    real = gauss_blocked.scan_subset

    def spy(bT, used, w0, K_, cols_, decided):
        t = w0 // (K_ // 32)
        if t in panels:
            seen[t] = (bT.clone(), used.clone(), w0)
        return real(bT, used, w0, K_, cols_, decided)

    gauss_blocked.scan_subset = spy
    try:
        gauss_blocked._rref_origin_body(a, None, cols, K, "pallas_scan", "mxu")
    finally:
        gauss_blocked.scan_subset = real
    torch.cuda.synchronize()
    return seen


def random_slices(dev):
    out = []
    for seed, rows, kw, frac_used, dens in ((1, 768, 8, 0.2, 0.5), (2, 5000, 8, 0.5, 0.01),
                                            (3, 3000, 3, 0.0, 0.02), (4, 400, 2, 0.1, 0.5),
                                            (5, 70000, 8, 0.3, 0.003)):
        rng = np.random.default_rng(seed)
        bits = rng.random((kw, rows, 32)) < dens
        words = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
        used = (rng.random((1, rows)) < frac_used).astype(np.uint32)
        out.append((f"random {rows}x{kw} dens {dens}", u32_to_torch(words, dev),
                    u32_to_torch(used, dev), int(rng.integers(0, 3)), 32 * kw + 100))
    return out


def check_one(name, bT, used, w0, cols):
    dev = bT.device
    Kb = 32 * bT.shape[0]
    S = phase1.SCAN_SUBSET_ROWS
    decided = torch.zeros((1,), dtype=torch.int32, device=dev)
    prow, used_o, cT, scratch = phase1.launch_scan_subset(bT, used, w0, Kb, cols, decided)
    torch.cuda.synchronize()
    bc, uc = bT.cpu(), used.cpu()
    sp, su, sc, sscr = phase1.scan_subset_steps_plain(bc, uc, w0, Kb, cols, S)
    miss = phase1.scan_subset_test_plain(bc, uc, sscr, w0, Kb, cols)
    route = phase1.scan_route(bT.shape[1], bT.shape[0])
    chained = route.kernel == "scan_chunked"
    if not miss:
        assert torch.equal(prow.cpu(), sp) and torch.equal(used_o.cpu(), su), name
        assert torch.equal(scratch.cpu(), sscr), f"{name}: scratch"
    elif not chained:  # the cluster scan leaves the record and the header alone
        assert torch.equal(scratch.cpu(), sscr), f"{name}: scratch"
    assert int(decided) == int(not miss), f"{name}: decided {int(decided)}, miss {miss}"
    want = phase1.scan_plain(bT, used, w0, Kb, cols)
    torch.cuda.synchronize()
    assert torch.equal(prow, want[0]) and torch.equal(used_o, want[1]), f"{name}: vs scan_plain"
    piv = want[0] >= 0
    ps = want[0].clamp(min=0).long()[piv]
    assert torch.equal(cT[:, ps], want[2][:, ps]), f"{name}: pivot coefficients"
    flag, sub_end, subset_rows = sscr[-3:].tolist()
    print(f"  {name} S={S}: ok ({'miss, fallback ran' if miss else 'decided'}; "
          f"{int(piv.sum())} pivots, subset {subset_rows} rows, sub_end {sub_end}, "
          f"flag {flag})")
    return not miss


def device_times(fn, reps=20):
    """{kernel name: device us per call} of ``fn`` under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA and not ev.name().startswith(("Memcpy", "Memset")):
            name = ev.name().replace("void ", "").replace("(anonymous namespace)::", "")
            name = re.split(r"[(]", name)[0]
            out[name] = out.get(name, 0.0) + (ev.end_ns() - ev.start_ns()) / 1000 / reps
    return out


def graph_ms(fn, calls=20, reps=5):
    """Device ms of one ``fn()`` replayed from a CUDA graph of ``calls`` calls."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps / calls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--solve", action="store_true")
    args = ap.parse_args()
    if not (args.check or args.time or args.solve):
        args.check = args.time = args.solve = True
    dev = torch.device("cuda", 0)
    print(card(), torch.__version__, torch.version.cuda, flush=True)
    systems = {"flagship": (mt_matrix(624, 7, dev), COLS),
               "very tall": (mt_matrix(2100, 8, dev), COLS)}
    inputs = []
    for name, (a, cols) in systems.items():
        for t, (bT, used, w0) in sorted(panel_inputs(a, cols).items()):
            inputs.append((f"{name} panel {t}", bT, used, w0, cols))
    inputs += random_slices(dev)

    if args.check:
        print("check: the card against the twins", flush=True)
        for name, bT, used, w0, cols in inputs:
            check_one(name, bT, used, w0, cols)

    if args.time:
        print("time: device us a call (profiler), and whole calls from a graph", flush=True)
        for name, bT, used, w0, cols in inputs:
            Kb = 32 * bT.shape[0]
            full = graph_ms(lambda: phase1.scan(bT, used, w0, Kb, cols))
            decided = torch.zeros((1,), dtype=torch.int32, device=dev)

            def call():
                phase1.launch_scan_subset(bT, used, w0, Kb, cols, decided)

            whole = graph_ms(call)
            kern = device_times(call)
            parts = ", ".join(f"{k} {v:.1f}"
                              for k, v in sorted(kern.items(), key=lambda kv: -kv[1]))
            print(f"  {name}: full scan {1000 * full:.1f}; subset-first "
                  f"{1000 * whole:.1f} [{parts}]", flush=True)
        # the plain twin on the card, once, on the flagship's panel 20
        name, bT, used, w0, cols = inputs[2]
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        phase1.scan_subset_plain(bT, used, w0, 32 * bT.shape[0], cols)
        e1.record()
        torch.cuda.synchronize()
        print(f"  {name}: scan_subset_plain on the card {e0.elapsed_time(e1):.1f} ms", flush=True)
        # what a call costs besides its steps: the same inputs with no valid column
        for name, bT, used, w0, cols in inputs[:6]:
            Kb = 32 * bT.shape[0]
            decided = torch.zeros((1,), dtype=torch.int32, device=dev)
            kern = device_times(lambda: phase1.launch_scan_subset(bT, used, w0, Kb, 0, decided))
            print(f"  {name}, no valid column: " + ", ".join(
                f"{k} {v:.1f}" for k, v in sorted(kern.items(), key=lambda kv: -kv[1])), flush=True)

    if args.solve:
        print("solve: replayed eliminations, subset-first plan against the full scan", flush=True)
        for name, (a, cols) in systems.items():
            (_, _), first = gauss_blocked._rref_origin_body(a, None, cols, K, "pallas_scan", "mxu")
            plans = {"subset-first": tuple(bool(v) for v in first.tolist()),
                     "full scan": (False,) * first.shape[0]}
            outs, times = {}, {}
            for label, plan in plans.items():
                entry = gauss_blocked._RrefGraph("rref")
                entry.plan = plan
                body = lambda m, p: gauss_blocked._rref_origin_body(  # noqa: E731
                    m, p, cols, K, "pallas_scan", "mxu")
                outs[label] = [t.clone() for t in entry.run(a, body)]
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(10):
                    entry.run(a, body)
                t1.record()
                torch.cuda.synchronize()
                times[label] = t0.elapsed_time(t1) / 10
            same = all(torch.equal(x, y) for x, y in zip(outs["subset-first"], outs["full scan"]))
            print(f"  {name}: subset panels {sum(plans['subset-first'])} of {len(first)}; "
                  f"replay ms subset-first {times['subset-first']:.3f}, full scan "
                  f"{times['full scan']:.3f}; outputs equal: {same}", flush=True)
            assert same


if __name__ == "__main__":
    main()

"""Time the two-pivot cluster scan and the one-launch mxu2 update, on one NVIDIA GPU:

    python3 scripts/tune_scan2_mxu2_torch.py [--ptxas] [--wgmma] [--parity]
        [--only scan2|mxu2] [--repo DIR]

* the two-pivot scan (``gf2_scan2``) on every cluster size that holds the
  slice, beside the 1-pivot cluster scan on the same inputs, in microseconds
  per pair of columns;
* the mxu2 update (one launch) on 768 words and trailing on 640 words,
  beside the mxu4 kernel and the table kernel on the same inputs.

Random (rows, 640 or 768) matrices (half the bits set), K = 256, panel 20,
25% of the rows used; each launch replayed from a CUDA graph, every
configuration held against its plain twin first.

``--parity`` times instead, on the same inputs, the kernels that share code
with the changed sources and must keep their times (the 1-pivot scan, the
batched scan at B = 4, the fused update + scan, the fused phase 1, the mxu4
update), for comparing two checkouts in one call: run it with ``--repo``
naming each checkout in turn.  ``--ptxas`` prints what ``nvcc -Xptxas -v``
says of ``scan2.cu`` and ``update_mma.cu`` (registers, spills); ``--wgmma``
what ``ptxas`` says of a ``wgmma.mma_async`` with one-bit operands."""

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
    for name in ("scan2.cu", "update_mma.cu"):
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-Xptxas", "-v", "-c",
               "-o", "/dev/null", str(_cuda.CSRC / name)]
        t0 = time.perf_counter()
        err = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
        print(f"{name}: compiled in {time.perf_counter() - t0:.1f} s")
        lines = err.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                print(name, mangled, "|", lines[i + 2].strip(), "|", lines[i + 3].strip())


# one-bit wgmma forms to hand to ptxas (m64n8k256: a 64 x 8 s32 tile, four
# registers a thread of the warpgroup)
WGMMA_FORMS = [
    "wgmma.mma_async.sync.aligned.m64n8k256.s32.b1.b1.and.popc",
    "wgmma.mma_async.sync.aligned.m64n8k256.and.popc.s32.b1.b1",
]


def wgmma(_cuda, build: Path):
    build.mkdir(parents=True, exist_ok=True)
    for i, form in enumerate(WGMMA_FORMS):
        src = build / f"wgmma_b1_probe_{i}.cu"
        src.write_text(
            "#include <cstdint>\n"
            "__global__ void k(int* out, uint64_t da, uint64_t db) {\n"
            "  int d0 = 0, d1 = 0, d2 = 0, d3 = 0;\n"
            "  asm volatile(\"wgmma.fence.sync.aligned;\\n\");\n"
            "  asm volatile(\"{\\n.reg .pred p;\\nsetp.ne.b32 p, %6, 0;\\n"
            f"{form} {{%0, %1, %2, %3}}, %4, %5, p;\\n}}\\n\"\n"
            "               : \"+r\"(d0), \"+r\"(d1), \"+r\"(d2), \"+r\"(d3)\n"
            "               : \"l\"(da), \"l\"(db), \"r\"(1));\n"
            "  asm volatile(\"wgmma.commit_group.sync.aligned;\\n\");\n"
            "  asm volatile(\"wgmma.wait_group.sync.aligned 0;\\n\");\n"
            "  out[threadIdx.x] = d0 + d1 + d2 + d3;\n"
            "}\n")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-c", "-o", "/dev/null", str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        said = (res.stdout + res.stderr).strip().replace("\n", " | ")
        print(f"wgmma one-bit form `{form}`: nvcc rc {res.returncode}: {said or 'accepted'}")
    cutlass = Path("/usr/local/cutlass/include/cute/arch")
    hits = []
    for f in sorted(cutlass.glob("mma_sm90*.hpp")) if cutlass.is_dir() else []:
        hits += [f"{f.name}: {line.strip()}" for line in f.read_text().splitlines()
                 if "b1" in line and "wgmma" in line][:4]
    print("CUTLASS sm90 headers naming a one-bit wgmma: " + ("; ".join(hits) or "none"))


def sass(_cuda, build: Path, patterns: list[str]):
    """The SASS of the kernels whose mangled names hold every string of one
    pattern (``cuobjdump -sass`` of a cubin per source)."""
    build.mkdir(parents=True, exist_ok=True)
    cuobjdump = Path(_cuda._nvcc()).with_name("cuobjdump")
    for name in ("scan2.cu", "update_mma.cu", "scan.cu"):
        cubin = build / f"{name}.cubin"
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-cubin", "-o",
                        str(cubin), str(_cuda.CSRC / name)], check=True, capture_output=True)
        out = subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True,
                             capture_output=True, text=True).stdout
        for fn in out.split("\t\tFunction : ")[1:]:
            head = fn.split("\n", 1)[0]
            if any(all(p in head for p in pat.split("&")) for pat in patterns):
                body = [line for line in fn.splitlines() if "/*" in line and "*/" in line]
                print(f"SASS {name} {head}: {len(body)} instructions")
                print(fn)


def graph_ms(fn, n: int = 32) -> float:
    from gf2bv_tpu_torch.ops import launch_floor

    x = torch.zeros(1, device="cuda")
    return launch_floor.chain_us(lambda y: (fn(), y)[1], x, n, graph=True) / 1000


def same(got, want, what: str) -> None:
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel differs from its twin")


def inputs(rows: int, wp: int, seed: int):
    from gf2bv_tpu_torch.core.words import u32_to_torch

    rng = np.random.default_rng(seed)
    a = u32_to_torch(rng.integers(0, 2**32, size=(rows, wp), dtype=np.uint32), "cuda")
    used = torch.from_numpy((rng.random((1, rows)) < 0.25).astype(np.int32)).cuda()
    bT = a[:, W0 : W0 + K // 32].T.contiguous()
    return a, bT, used


def tune_scan2(tag: str) -> None:
    from gf2bv_tpu_torch.ops import phase1

    kw = K // 32
    for rows in (768, 2560, ROWS, 40192):
        a, bT, used = inputs(rows, WP, rows)
        want = phase1.scan2_plain(bT, used, W0, K, COLS)
        route = phase1.scan2_route(rows, kw)
        parts = []
        for nb in phase1.SCAN_CLUSTER_SIZES:
            if not phase1.scan_fits(-(-rows // nb), kw, pairs=True) or rows < 32 * nb:
                continue
            same(phase1.scan2_cluster(bT, used, W0, K, COLS, nb), want,
                 f"scan2 on {nb} blocks, {rows} rows")
            ms = graph_ms(lambda: phase1.scan2_cluster(bT, used, W0, K, COLS, nb))
            parts.append(f"{nb} blocks {ms:.4f} ms ({2000 * ms / K:.3f} us a pair)")
        one = graph_ms(lambda: phase1.scan(bT, used, W0, K, COLS))
        print(f"two-pivot scan, {rows} rows (route: {route.kernel} on {route.nblocks} blocks): "
              + "; ".join(parts) + "; 1-pivot cluster scan "
              f"{one:.4f} ms ({1000 * one / K:.3f} us a column) ({tag})")


def tune_mxu2(tag: str) -> None:
    from gf2bv_tpu_torch.ops import panel_update as pu

    kw = K // 32
    rng = np.random.default_rng(9)
    for wp, w0 in ((768, None), (640, None), (640, 160), (640, 632), (638, None)):
        a, _, _ = inputs(ROWS, wp, wp)
        sel = torch.from_numpy(rng.integers(-2**31, 2**31, size=(ROWS, kw),
                                            dtype=np.int64).astype(np.int32)).cuda()
        pf = torch.from_numpy(rng.integers(-2**31, 2**31, size=(K, wp),
                                           dtype=np.int64).astype(np.int32)).cuda()
        want = pu.update_mxu2_plain(a.clone(), sel, pf, w0)
        same([pu.update_mxu2(a.clone(), sel, pf, w0)], [want], f"mxu2 wp={wp} w0={w0}")
        scratch = a.clone()
        t = {"mxu2": graph_ms(lambda: pu.update_mxu2(scratch, sel, pf, w0)),
             "mxu4": graph_ms(lambda: pu.update_mxu4(scratch, sel, pf, w0)),
             "mxu2 again": graph_ms(lambda: pu.update_mxu2(scratch, sel, pf, w0))}
        if w0 is None:
            t["table (update_pallas)"] = graph_ms(lambda: pu.update_pallas(scratch, sel, pf))
        print(f"update on {ROWS} x {wp} words, w0={w0}: "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in t.items()) + f" ({tag})")


def parity(tag: str) -> None:
    from gf2bv_tpu_torch.ops import gauss_batched, panel_update, phase1

    kw = K // 32
    a, bT, used = inputs(ROWS, WP, 7)
    rng = np.random.default_rng(8)
    t = {"scan": graph_ms(lambda: phase1.scan(bT, used, W0, K, COLS))}
    bT4 = bT.expand(4, kw, ROWS).contiguous()
    used4 = used.expand(4, ROWS).contiguous()
    t["scan_batched B=4"] = graph_ms(lambda: gauss_batched.scan_batched(bT4, used4, W0, K, COLS))
    t["phase1_fused"] = graph_ms(lambda: phase1.phase1_panel(a, bT, used, W0, K, COLS))
    sel = torch.from_numpy(rng.integers(-2**31, 2**31, size=(ROWS, kw),
                                        dtype=np.int64).astype(np.int32)).cuda()
    pf, _, _ = phase1.phase1_panel(a, bT, used, W0, K, COLS)
    scratch = a.clone()
    bTn = a[:, W0 + kw : W0 + 2 * kw].T.contiguous()
    for w0t in (None, W0):
        t[f"update_scan w0={w0t}"] = graph_ms(lambda: panel_update.update_scan(
            scratch, sel, pf, bTn, used, W0 + kw, COLS, w0t))
    a768, _, _ = inputs(ROWS, 768, 11)
    pf768 = torch.cat([pf, pf[:, :128]], dim=1).contiguous()
    t["update_mxu4 768 words"] = graph_ms(lambda: panel_update.update_mxu4(a768, sel, pf768))
    t["update_mxu4 w0=160"] = graph_ms(lambda: panel_update.update_mxu4(scratch, sel, pf, 160))
    print(f"parity ({tag}): " + "; ".join(f"{k} {v:.4f} ms" for k, v in t.items()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--wgmma", action="store_true")
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--sass", nargs="*", metavar="PATTERN",
                    help="print the SASS of the kernels whose names hold a pattern's "
                         "&-separated parts")
    ap.add_argument("--only", choices=("scan2", "mxu2"), help="time one of the two kernels")
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    from gf2bv_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.lib()
    tag = f"{args.repo}; {card()}"
    print(f"kernels built in {time.perf_counter() - t0:.1f} s ({tag})")
    if args.ptxas:
        ptxas(_cuda)
    if args.wgmma:
        wgmma(_cuda, repo / "build")
    if args.sass:
        sass(_cuda, repo / "build", args.sass)
        return 0
    if args.parity:
        parity(tag)
    else:
        if args.only != "mxu2":
            tune_scan2(tag)
        if args.only != "scan2":
            tune_mxu2(tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())

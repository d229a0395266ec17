"""Host timing of the two product expansions of gf2bv_tpu_torch.

A batch of quadratic products has two host implementations that give the
same bits: ``QuadraticSystem.mul_bits`` (numpy, one slice write per
monomial row block; the lazy trace's) and ``ops/quad_device.mul_bits_batch``
(vectorized torch on the CPU; the reference's lazy trace takes its own
form of it for large batches).  This script times both on random narrow
operand rows at several (products, n) sizes, the NLFSR attack's 17384
products at n = 128 among them, checks that they agree bit for bit, and
prints one line per size and the best of ``--repeat`` runs of each.

    python scripts/time_mul_bits_torch.py [--repeat 3] [--sizes 8x24,17384x128]

It runs on the CPU only; the torch thread count and the CPU count are
printed beside the times.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from gf2bv_tpu_torch.core import packing
from gf2bv_tpu_torch.core.bitvec import BitVec
from gf2bv_tpu_torch.core.system import QuadraticSystem
from gf2bv_tpu_torch.ops.quad_device import mul_bits_batch

DEFAULT_SIZES = "8x24,64x24,1024x24,8x64,256x64,4096x64,8x128,256x128,2048x128,17384x128"


def narrow_rows(rng, rows: int, n: int) -> np.ndarray:
    """(rows, nwords64(1 + n)) uint64 rows with bits past 1 + n clear."""
    bits = rng.integers(0, 2, size=(rows, 1 + n), dtype=np.uint8)
    return packing.pack_bits(bits, 1 + n)


def best_of(fn, repeat: int) -> float:
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--sizes", default=DEFAULT_SIZES, help="comma list of PRODUCTSxN")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    print(f"host: {os.cpu_count()} CPUs, torch {torch.__version__} with {torch.get_num_threads()} threads")
    results = []
    for spec in args.sizes.split(","):
        rows, n = (int(v) for v in spec.split("x"))
        qsys = QuadraticSystem([n], device="cpu")
        a, b = narrow_rows(rng, rows, n), narrow_rows(rng, rows, n)
        numpy_route = lambda: qsys.mul_bits(BitVec(a, 1 + n), BitVec(b, 1 + n)).rows
        torch_route = lambda: mul_bits_batch(qsys, a, b)
        if not np.array_equal(numpy_route(), torch_route()):  # also the warm-up
            print(f"{rows}x{n}: the two routes disagree", file=sys.stderr)
            return 1
        t_np, t_torch = best_of(numpy_route, args.repeat), best_of(torch_route, args.repeat)
        results.append({"products": rows, "n": n, "work": rows * n * n,
                        "mul_bits_ms": t_np * 1e3, "mul_bits_batch_ms": t_torch * 1e3})
        print(f"{rows:6d} products, n = {n:3d} (B*n^2 = {rows * n * n:11d}): "
              f"mul_bits {t_np * 1e3:10.3f} ms, mul_bits_batch {t_torch * 1e3:10.3f} ms "
              f"(best of {args.repeat})")
    print(json.dumps({"mul_bits_routes": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

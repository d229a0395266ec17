"""Launch-floor probe of the PyTorch/CUDA port (gf2bv_tpu_torch).

Chains 256 launches of each of three rungs, replays the chain from a CUDA
graph (the card alone, no host work between launches) and prints
microseconds per launch beside the card's name and power limit:

  probe   : out = a ^ 1 on (256, 128) words, one launch: the launch floor
            (also launched from Python, the host's enqueue included)
  xor     : torch.bitwise_xor on the same array (PyTorch's own launch)
  1-tile  : the rank-256 panel update on one (256-row, 128-word) tile: a
            kernel's latency to read against the floor, not a floor

Run on a machine with an NVIDIA GPU and nvcc:

    python scripts/bench_launch_floor_torch.py
"""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

from gf2bv_tpu_torch.ops import launch_floor


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_launch_floor_torch: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    runs = [launch_floor.measure("cuda", 256) for _ in range(3)]
    best = {k: min(r[k] for r in runs) for k in runs[0]}
    print(f"{card}: chains of {best['n']} launches replayed from a CUDA graph, best of 3, "
          f"us per launch")
    for label, key in (("probe (one launch, a ^ 1): the floor", "probe_us"),
                       ("probe launched from Python", "probe_python_us"),
                       ("torch.bitwise_xor", "bitwise_xor_us"),
                       ("rank-256 update, one tile (latency)", "update_tile_us")):
        print(f"  {label:38s} {best[key]:8.3f}")
    print(json.dumps({"card": card, **best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

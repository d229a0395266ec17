"""Run a cell's control on the card: the program with one guarantee of the
configuration broken, which ``correct`` must refuse.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 10

The control is the cell's entry with ``control=True``: the program run with
the guarantee that the configuration's ``control`` key names broken (for
MT19937 too few outputs to fix the state, for SFMT half of the leaks).
Each seed is one run of the cell as ``run.py`` makes it, in one process; a
line per seed gives the numbers compared beside their limits.  The
benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from benchmark.harness import cells, core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    cell = cells.resolve(cells.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = core.run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                                  control=True)
        print(json.dumps({"workload": cell.name, "control": True, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

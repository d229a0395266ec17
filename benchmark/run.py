"""Run one cell of the benchmark of gf2bv_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout.  The cell is an entry of
``BENCHMARK.json``'s ``workloads``; its configuration, traffic mix, entry,
reference and metric readers are found by name under ``benchmark/``
(harness/cells.py).  The result is one JSON object, the last line of
standard output; the numbers compared for ``correct`` are the last lines of
standard error.  Exits non-zero, printing no result, without enough CUDA
devices or when a forbidden module was loaded.
"""

import time

_T0 = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from benchmark.harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t0=_T0))

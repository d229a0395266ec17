"""Phase wall-clock timers: the timeit harness of the original gf2bv
examples.

A copy of ``gf2bv_tpu/utils/timing.py``.  The host clock stops when the
block ends; a block that launches CUDA work should end in
``torch.cuda.synchronize()`` to time the work and not its launch."""

from __future__ import annotations

from contextlib import contextmanager
from time import perf_counter


@contextmanager
def timeit(task_name: str, record: dict | None = None, quiet: bool = False):
    start = perf_counter()
    try:
        yield
    finally:
        elapsed = perf_counter() - start
        if record is not None:
            record[task_name] = elapsed
        if not quiet:
            print(f"{task_name} took {elapsed:.2f} seconds")

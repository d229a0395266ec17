"""The one generator of traffic: a closed loop of victims drawn from the seed.

A mix file (``benchmark/traffic/<mix>.json``) gives its parameters:

* ``entry``: the module of ``benchmark/entries/`` that serves a request;
* ``loop`` ``"closed"`` and ``clients`` 1: the next request is sent when the
  previous one has returned;
* ``outputs``: the observed outputs each request hands the program;
* ``warmup``: requests served in set-up, on victims of their own;
* ``trace_requests``: the requests of the profiled stretch of a traced run;
* ``victims_per_s``: how many victims set-up makes per second of window
  (more are made in chunks if a run serves faster).

Every victim is a distinct seed of its generator: the seeds are
``base + i * 0x9E3779B1 (mod 2**32)`` for the run's ``i``-th victim, with
``base`` drawn from ``--seed``, so no victim repeats within a run and the
same ``--seed`` gives the same victims in the same order.
"""

from __future__ import annotations

import numpy as np

STRIDE = 0x9E3779B1  # odd, so i -> base + i * STRIDE is one to one mod 2**32
CHUNK = 256  # victims made at once when a run outgrows what set-up made


def victim_seeds(seed: int, start: int, count: int) -> np.ndarray:
    """Generator seeds of victims ``start`` .. ``start + count - 1``."""
    base = int(np.random.default_rng(seed % 2**64).integers(2**32))
    idx = np.arange(start, start + count, dtype=np.uint64)
    return (np.uint64(base) + idx * np.uint64(STRIDE)) & np.uint64(0xFFFFFFFF)


class VictimStream:
    """The run's victims in order, made by the configuration's reference."""

    def __init__(self, reference, config: dict, traffic: dict, seed: int):
        self.reference, self.config, self.traffic, self.seed = reference, config, traffic, seed
        self.made: list = []
        self.next_index = 0

    def make(self, count: int) -> None:
        seeds = victim_seeds(self.seed, len(self.made), count)
        self.made.extend(self.reference.make_victims(self.config, self.traffic, seeds))

    def next(self):
        if self.next_index >= len(self.made):
            self.make(CHUNK)
        v = self.made[self.next_index]
        self.next_index += 1
        return v

"""Entry: the annihilator attack on a filtered LFSR, one victim a request.

Set-up runs the program's own symbolic register (``crypto.lfsr``) once over
a narrow ``LinearSystem([width])``, collecting the affine forms of the tap
bits of every step, and builds every step's annihilator equation on the
card with ``ops/quad_device.quad_rows``.  The rows stay there as a template
(``QuadraticSystem.select_rows``).  A request keeps the rows of the
victim's keystream ones and calls ``solve_one(keep)``: the kept indices
are uploaded, the rows gathered and padded to the row bucket on the card,
solved in mode 1, and the first point that passes the consistency filter
is the recovered state.

Set-up also solves, twice each, row subsets of every bucket that a count of
ones within two standard deviations of its mean lands in, so the
elimination of each common shape is captured before the window (the rows of
such a subset disagree with any keystream: their systems are unsatisfiable,
which costs the same elimination).  The control keeps the first
``control.keep_outputs`` keystream bits only: their space passes the
enumeration guard, and the control answers its origin's state bits, as a
caller who ignored the guard would.
"""

from __future__ import annotations

import math

import numpy as np


def _common_buckets(outputs: int, bucket: int) -> list[int]:
    """Row buckets of the kept counts within two standard deviations of
    ``outputs / 2`` (a keystream bit is 1 half the time)."""
    mean, sd = outputs / 2, math.sqrt(outputs) / 2
    lo, hi = math.ceil((mean - 2 * sd) / bucket), math.ceil((mean + 2 * sd) / bucket)
    return [bucket * k for k in range(lo, hi + 1)]


def setup(config: dict, traffic: dict, device: str, control: bool = False):
    from gf2bv_tpu_torch import BitVec, DimensionTooLargeError, LinearSystem, QuadraticSystem
    from gf2bv_tpu_torch.crypto import lfsr
    from gf2bv_tpu_torch.ops import quad_device

    width, steps = config["width"], traffic["outputs"]
    qsys = QuadraticSystem([width], device=device)
    if not hasattr(qsys, "select_rows"):
        raise RuntimeError("the program has no QuadraticSystem.select_rows")
    lin = LinearSystem([width], device=device)
    reg = getattr(lfsr, config["generator"])(width, int(config["taps"], 16),
                                             BitVec.stack(lin.gens(lazy=False)))
    taps = [[] for _ in config["select"]]
    for _ in range(steps):
        reg()
        for bits, p in zip(taps, config["select"]):
            bits.append(reg.state[p])
    forms = [BitVec.stack(bits) for bits in taps]
    ann = config["annihilator"]
    eqs = quad_device.quad_rows(qsys, pairs=[(forms[i], forms[j]) for i, j in ann["pairs"]],
                                linear=[forms[i] for i in ann["linear"]],
                                const=(1 << steps) - 1 if ann["const"] else 0)
    template = qsys.select_rows(eqs)
    kept = config["control"]["keep_outputs"] if control else steps
    for rows in _common_buckets(kept, template.bucket):
        keep = np.zeros(steps, dtype=bool)
        keep[: rows - template.bucket // 2] = True
        for _ in range(2):  # the shape's eager call, then its capture
            template.space(keep)

    def solve(observed):
        keep = np.array(observed, dtype=bool)
        keep[kept:] = False
        try:
            sol = template.solve_one(keep)
        except DimensionTooLargeError as exc:
            if not control:
                raise
            return exc.space.origin & ((1 << width) - 1)
        return None if sol is None else sol[0]

    return solve

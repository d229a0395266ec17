"""Entry: many victims of one captured SFMT model, one victim a request.

Set-up captures the model once through ``LinearSystem([32] * N32,
device=...).capture(fn)``: ``fn`` runs the program's own symbolic SFMT from
a block boundary and XORs a per-victim constant slot onto the low
``leak_bits`` of each draw.  A request binds a victim's leaks to the slots
and calls ``CapturedTrace.solve_one``, which reuses the cached device matrix
(ops/lazy_solve.py) and returns the state words as a tuple.  The control
captures the model over the first ``outputs - control.drop_outputs`` leaks
only.
"""

from __future__ import annotations


def setup(config: dict, traffic: dict, device: str, control: bool = False):
    from gf2bv_tpu_torch import LinearSystem
    from gf2bv_tpu_torch.crypto import sfmt

    model_cls = getattr(sfmt, config["generator"])
    n32 = config["n32"]
    mask = (1 << config["leak_bits"]) - 1
    leaks = traffic["outputs"] - (config["control"]["drop_outputs"] if control else 0)

    def model(words, p):
        sym = model_cls(list(words), index=n32)
        return [(sym() & mask) ^ p[k] for k in range(leaks)]

    tmpl = LinearSystem([32] * n32, device=device).capture(model)

    def solve(observed):
        return tmpl.solve_one(observed[:leaks])

    return solve

"""Entry: one victim a request through ``solve_mt19937``.

``gf2bv_tpu_torch.crypto.mt_torch.solve_mt19937(outs, bs, samples)`` builds
the recovery system on the card from the observed outputs, solves it in
mode 0 with the default engines and returns the 624 state words as a tuple
on the host.  The control solves the first ``control.keep_outputs``
outputs only, too few to fix the state.
"""

from __future__ import annotations


def setup(config: dict, traffic: dict, device: str, control: bool = False):
    from gf2bv_tpu_torch.crypto.mt_torch import solve_mt19937

    bs = config["bs"]
    keep = config["control"]["keep_outputs"] if control else traffic["outputs"]

    def solve(observed):
        return solve_mt19937(observed[:keep], bs, samples=keep, device=device)

    return solve

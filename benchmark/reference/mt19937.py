"""Plain reference of the MT19937 configurations: CPython's ``random.Random``.

Victims are ``random.Random(s)`` for distinct 32-bit seeds ``s``; each hands
the program ``outputs`` values of ``getrandbits(bs)``.  The state the
program must return is the victim's own ``getstate()[1][:624]``: the
outputs and the pin ``mt[0] ^ 0x80000000`` (CPython sets the MSB of mt[0])
have full rank, so the state is unique and the comparison is exact.

Imports nothing of the program.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

# every number compared, with its limit: an exact comparison
LIMITS = {"wrong_words": 0}


@dataclass
class Victim:
    observed: list[int]
    state: tuple[int, ...]


def shape(config: dict, traffic: dict) -> dict:
    """The elimination's equations and unknowns: ``bs`` equations an
    output, and the 32 of the pin."""
    return {"rows": traffic["outputs"] * config["bs"] + config["w"],
            "cols": config["n"] * config["w"]}


def make_victims(config: dict, traffic: dict, seeds) -> list[Victim]:
    out = []
    for s in seeds:
        r = random.Random(int(s))
        state = tuple(r.getstate()[1][: config["n"]])
        out.append(Victim([r.getrandbits(config["bs"]) for _ in range(traffic["outputs"])],
                          state))
    return out


def judge(config: dict, traffic: dict, victims: list[Victim], answers: list) -> dict:
    """The number compared: state words that differ from the victims' over
    every request; a request with no answer (``None``: no solution, or it
    raised) or an answer of another length has every word wrong."""
    wrong = 0
    for v, a in zip(victims, answers):
        if a is None or len(a) != len(v.state):
            wrong += len(v.state)
        else:
            wrong += sum(int(x) != y for x, y in zip(a, v.state))
    return {"wrong_words": wrong}

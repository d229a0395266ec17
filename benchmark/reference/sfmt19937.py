"""Plain reference of the SFMT configurations: SFMT in numpy, over victims.

SFMT (Saito and Matsumoto) as the canonical C code defines it: ``N32``
little-endian 32-bit words in 128-bit lanes, ``init_gen_rand`` with period
certification, and the recursion

    r = a ^ (a <<128 8*SL2) ^ ((b >>32 SR1) & MSK) ^ (c >>128 8*SR2) ^ (d <<32 SL1)

with ``b`` the ``POS1``-lagged lane and ``c`` / ``d`` the two lanes produced
last.  Every function runs on a (victims, N32) uint32 array, one victim a
row, so set-up makes hundreds of victims in a few hundred numpy calls.

A victim is seeded, burns ``burn`` draws (whole blocks), then leaks the low
``leak_bits`` of ``outputs`` draws; the program returns a state at that
block boundary.  The state has a subspace (``N32 * 32 - MEXP`` bits) that
the transition annihilates and the leaks do not see, so a returned state is
judged by what it predicts, not by equality: it must replay every leak and
predict the victim's next ``future`` draws in full.

Imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# every number compared, with its limit: exact comparisons
LIMITS = {"wrong_leaks": 0, "wrong_future": 0}

U32 = np.uint32


@dataclass
class Victim:
    observed: list[int]
    future: np.ndarray  # (future,) uint32: the draws after the leaks


def _shl128(x: np.ndarray, nbytes: int) -> np.ndarray:
    """(V, 4) lanes as 128-bit little-endian values, shifted left."""
    bits = 8 * nbytes
    whole, rem = divmod(bits, 32)
    out = np.zeros_like(x)
    for i in range(whole, 4):
        lo = x[:, i - whole]
        v = lo << U32(rem) if rem else lo.copy()
        if rem and i - whole - 1 >= 0:
            v |= x[:, i - whole - 1] >> U32(32 - rem)
        out[:, i] = v
    return out


def _shr128(x: np.ndarray, nbytes: int) -> np.ndarray:
    """(V, 4) lanes as 128-bit little-endian values, shifted right."""
    bits = 8 * nbytes
    whole, rem = divmod(bits, 32)
    out = np.zeros_like(x)
    for i in range(0, 4 - whole):
        hi = x[:, i + whole]
        v = hi >> U32(rem) if rem else hi.copy()
        if rem and i + whole + 1 < 4:
            v |= x[:, i + whole + 1] << U32(32 - rem)
        out[:, i] = v
    return out


def gen_block(state: np.ndarray, cfg: dict) -> np.ndarray:
    """``gen_rand_all``: the next block of every victim, in place; returns it."""
    nl = cfg["n32"] // 4
    lanes = state.reshape(state.shape[0], nl, 4)
    msk = np.array(cfg["msk"], dtype=U32)
    sl1, sr1 = U32(cfg["sl1"]), U32(cfg["sr1"])
    r1, r2 = lanes[:, nl - 2].copy(), lanes[:, nl - 1].copy()
    for i in range(nl):
        a, b = lanes[:, i], lanes[:, (i + cfg["pos1"]) % nl]
        new = (a ^ _shl128(a, cfg["sl2"]) ^ ((b >> sr1) & msk) ^ _shr128(r1, cfg["sr2"])
               ^ (r2 << sl1))
        lanes[:, i] = new
        r1, r2 = r2, new
    return state


def init_gen_rand(seeds, cfg: dict) -> np.ndarray:
    """(V, N32) seeded states, period certified."""
    n = cfg["n32"]
    s = np.zeros((len(seeds), n), dtype=U32)
    s[:, 0] = np.asarray(seeds, dtype=np.uint64).astype(U32)
    mul = U32(1812433253)
    for i in range(1, n):
        prev = s[:, i - 1]
        s[:, i] = mul * (prev ^ (prev >> U32(30))) + U32(i)
    parity = np.array(cfg["parity"], dtype=U32)
    inner = np.zeros(len(seeds), dtype=U32)
    for i in range(4):
        inner ^= s[:, i] & parity[i]
    for sh in (16, 8, 4, 2, 1):
        inner ^= inner >> U32(sh)
    even = (inner & U32(1)) == 0
    # flip the lowest set bit of the parity vector where the parity is even
    for i in range(4):
        if parity[i]:
            low = parity[i] & (~parity[i] + U32(1))
            s[even, i] ^= low
            break
    return s


def draws(state: np.ndarray, cfg: dict, count: int) -> np.ndarray:
    """The next ``count`` draws of every victim from a block boundary
    (``index = N32``): (V, count) uint32.  Advances ``state``."""
    n = cfg["n32"]
    blocks = [gen_block(state, cfg).copy() for _ in range(-(-count // n))]
    return np.concatenate(blocks, axis=1)[:, :count]


def shape(config: dict, traffic: dict) -> dict:
    return {"rows": traffic["outputs"] * config["leak_bits"], "cols": config["n32"] * 32}


def make_victims(config: dict, traffic: dict, seeds) -> list[Victim]:
    n, leaks = config["n32"], traffic["outputs"]
    if config["burn"] % n or leaks % n:
        raise ValueError("burn and leaks are whole blocks")
    state = init_gen_rand(seeds, config)
    for _ in range(config["burn"] // n):
        gen_block(state, config)
    mask = U32((1 << config["leak_bits"]) - 1)
    observed = draws(state, config, leaks) & mask
    future = draws(state, config, config["future"])
    return [Victim([int(x) for x in observed[k]], future[k]) for k in range(len(seeds))]


def _is_state(answer, n: int) -> bool:
    return len(answer) == n and all(0 <= int(x) < 2**32 for x in answer)


def judge(config: dict, traffic: dict, victims: list[Victim], answers: list) -> dict:
    """The numbers compared: leaks that a returned state does not replay,
    and future draws it does not predict, over every request; a request
    with no answer (``None``: no solution, or it raised) or with no state
    of ``N32`` words gets every leak and every draw wrong."""
    n = config["n32"]
    got = [k for k, a in enumerate(answers) if a is not None and _is_state(a, n)]
    missing = len(answers) - len(got)
    out = {"wrong_leaks": traffic["outputs"] * missing, "wrong_future": config["future"] * missing}
    if not got:
        return out
    state = np.array([[int(x) for x in answers[k]] for k in got], dtype=U32)
    mask = U32((1 << config["leak_bits"]) - 1)
    replay = draws(state, config, traffic["outputs"]) & mask
    observed = np.array([victims[k].observed for k in got], dtype=U32)
    out["wrong_leaks"] += int((replay != observed).sum())
    future = draws(state, config, config["future"])
    want = np.stack([victims[k].future for k in got])
    out["wrong_future"] += int((future != want).sum())
    return out

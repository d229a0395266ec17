"""Plain reference of the filtered-LFSR configurations: the register and its
keystream in numpy over victims, the annihilator equations by direct
evaluation, a plain GF(2) elimination, and the judge.

A victim is a nonzero ``width``-bit secret drawn from its seed.  The Galois
register steps ``out = s & 1; s = (s >> 1) ^ (out ? taps : 0)``, and after
each step the combiner of the bits at ``select`` is one keystream bit; the
victim hands over ``outputs`` of them.  The state is held as 64-bit words,
one victim a row, so a step is a few numpy calls over every victim at once.

Whenever a keystream bit is 1 the annihilator of the combiner vanishes on
the tap bits: one quadratic equation in the secret's bits.  Linearised over
the ``width`` linear and ``width * (width - 1) / 2`` quadratic monomials
(``x_i x_j``, i > j, i outer, j inner), those equations pin the secret.  The
program must return the secret itself (``wrong_states``, limit 0).

:func:`annihilator_rows` and :func:`solve_space` build and solve that system
with Python integers, for the CPU tests at small widths.

Imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# every number compared, with its limit: an exact comparison
LIMITS = {"wrong_states": 0}

U64 = np.uint64


@dataclass
class Victim:
    observed: np.ndarray  # (outputs,) uint8 keystream bits
    secret: int


def _words(config: dict) -> int:
    return -(-config["width"] // 64)


def _to_words(values, nw: int) -> np.ndarray:
    """Python ints -> (V, nw) uint64, least significant word first."""
    out = np.zeros((len(values), nw), dtype=U64)
    for k, v in enumerate(values):
        for w in range(nw):
            out[k, w] = (v >> (64 * w)) & (2**64 - 1)
    return out


def secrets(config: dict, seeds) -> list[int]:
    """The nonzero ``width``-bit secret of each victim seed."""
    width, nw = config["width"], _words(config)
    out = []
    for s in seeds:
        words = np.random.default_rng(int(s)).integers(0, 2**64, size=nw, dtype=U64)
        v = sum(int(x) << (64 * i) for i, x in enumerate(words)) & ((1 << width) - 1)
        out.append(v or 1)
    return out


def keystreams(config: dict, states, steps: int) -> np.ndarray:
    """(V, steps) uint8: the keystream of every secret in ``states``."""
    nw = _words(config)
    s = _to_words(states, nw)
    taps = _to_words([int(config["taps"], 16) & ((1 << config["width"]) - 1)], nw)[0]
    tap_word = [p // 64 for p in config["select"]]
    tap_shift = [U64(p % 64) for p in config["select"]]
    one = U64(1)
    out = np.empty((steps, len(states)), dtype=np.uint8)
    for t in range(steps):
        fb = (s[:, :1] & one) * taps[None, :]  # taps where the output bit is 1
        s[:, :-1] = (s[:, :-1] >> one) | (s[:, 1:] << U64(63))
        s[:, -1] >>= one
        s ^= fb
        bits = [(s[:, w] >> sh) & one for w, sh in zip(tap_word, tap_shift)]
        ks = np.zeros(len(states), dtype=U64)
        for mono in config["combiner"]:
            term = bits[mono[0]].copy()
            for i in mono[1:]:
                term &= bits[i]
            ks ^= term
        out[t] = ks
    return out.T


def shape(config: dict, traffic: dict) -> dict:
    """The nominal selected system: a keystream bit is 1 half the time, and
    the unknowns are the linear and the quadratic monomials."""
    w = config["width"]
    return {"rows": traffic["outputs"] // 2, "cols": w + w * (w - 1) // 2}


def make_victims(config: dict, traffic: dict, seeds) -> list[Victim]:
    sec = secrets(config, seeds)
    ks = keystreams(config, sec, traffic["outputs"])
    return [Victim(ks[k], sec[k]) for k in range(len(sec))]


def judge(config: dict, traffic: dict, victims: list[Victim], answers: list) -> dict:
    """The number compared: requests whose returned state is not the
    victim's secret; a request with no answer (``None``: no solution, or it
    raised) counts as wrong."""
    wrong = sum(a is None or int(a) != v.secret for v, a in zip(victims, answers))
    return {"wrong_states": wrong}


# -- the system by direct evaluation, for the CPU tests ------------------------------


def _monomial(n: int, i: int, j: int) -> int:
    """Column of ``x_i x_j`` (0-based variables) among 1 + n + n(n-1)/2: the
    affine bit 0, the linear ``x_i`` at 1 + i, then ``x_i x_j`` for i > j."""
    if i == j:
        return 1 + i
    i, j = max(i, j), min(i, j)
    return 1 + n + i * (i - 1) // 2 + j


def _product(n: int, a: int, b: int) -> int:
    """The product of two affine forms (bit 0 the constant, bit 1 + i the
    variable x_i), linearised."""
    terms = [k for k in range(n + 1) if a >> k & 1], [k for k in range(n + 1) if b >> k & 1]
    out = 0
    for p in terms[0]:
        for q in terms[1]:
            if p == 0 or q == 0:
                out ^= 1 << (p + q)  # the constant times a term is the term
            else:
                out ^= 1 << _monomial(n, p - 1, q - 1)
    return out


def tap_forms(config: dict, steps: int) -> list[list[int]]:
    """The register run on affine forms of the secret's bits: per step, the
    forms of the bits at ``select`` after the step."""
    n = config["width"]
    taps = int(config["taps"], 16)
    state = [1 << (1 + i) for i in range(n)]
    out = []
    for _ in range(steps):
        fb = state[0]
        state = state[1:] + [0]
        for i in range(n):
            if taps >> i & 1:
                state[i] ^= fb
        out.append([state[p] for p in config["select"]])
    return out


def annihilator_rows(config: dict, keystream) -> list[int]:
    """One linearised equation (an int over 1 + n + n(n-1)/2 bits, bit 0 the
    constant) for each keystream bit that is 1: the annihilator of the
    configuration on that step's tap forms."""
    n = config["width"]
    ann = config["annihilator"]
    rows = []
    for bit, forms in zip(keystream, tap_forms(config, len(keystream))):
        if not bit:
            continue
        row = ann["const"]
        for i in ann["linear"]:
            row ^= forms[i]
        for i, j in ann["pairs"]:
            row ^= _product(n, forms[i], forms[j])
        rows.append(row)
    return rows


def solve_space(rows: list[int], nvars: int):
    """Plain Gauss-Jordan over GF(2) on equations ``row`` meaning
    ``XOR_k bit k+1 of row * y_k = bit 0``: None when unsatisfiable, else
    (origin, basis) as ints over ``nvars`` bits, the free variables 0 in
    the origin and one basis vector per free variable, ascending."""
    pivots: dict[int, int] = {}  # column -> its reduced row
    for row in rows:
        for col, prow in pivots.items():
            if row >> col & 1:
                row ^= prow
        var = row >> 1
        if not var:
            if row & 1:
                return None
            continue
        col = (var & -var).bit_length()  # the lowest set variable column
        for c, prow in pivots.items():
            if prow >> col & 1:
                pivots[c] = prow ^ row
        pivots[col] = row
    origin = sum(1 << (c - 1) for c, prow in pivots.items() if prow & 1)
    basis = []
    for f in range(1, nvars + 1):
        if f in pivots:
            continue
        v = 1 << (f - 1)
        for c, prow in pivots.items():
            if prow >> f & 1:
                v |= 1 << (c - 1)
        basis.append(v)
    return origin, basis

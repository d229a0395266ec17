"""MT19937 symbolic trace as a device program (the flagship fast path).

Port of ``gf2bv_tpu/crypto/mt_jax.py``: the packed MT19937 recovery system
is built directly on the device from structured bit-matrix algebra (the
initial state is a one-hot basis, twist and temper are row masks, shifts
and XORs), so only the observed outputs cross to the device.  Semantics
mirror crypto/mt.py: the twist linearizes ``(y & 1) * a`` as broadcast
bit 0 AND a; ``getrandbits(bs)`` takes the top ``bs`` bits of each output
word, multi-word values joined LSB-first.

Words are int32 tensors with the JAX package's uint32 bit patterns, so the
matrices compare byte for byte.  :func:`solve_mt19937` returns the state
(mode 0) or the affine solution space (mode 1); :func:`solve_mt19937_batch`
recovers many states with one readback.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.affine import AffineSpace
from ..core.words import I32, bit_i32, resolve_device, torch_to_u32, u32_to_torch
from ..ops import gauss_blocked

# MT19937 parameters (as in crypto/mt.py)
W, N, M, R = 32, 624, 397, 31
A = 0x9908B0DF
U, D = 11, 0xFFFFFFFF
S_, B = 7, 0x9D2C5680
T_, C = 15, 0xEFC60000
L = 18

COLS = W * N  # 19968
_NBITS = 1 + COLS


def _bits32(mask: int, device) -> torch.Tensor:
    return torch.tensor([(mask >> i) & 1 for i in range(32)], dtype=I32, device=device)


def _wp(pad_words: int = 128) -> int:
    w32 = 2 * packing.nwords64(_NBITS)
    return -(-w32 // pad_words) * pad_words


def _temper(y: torch.Tensor) -> torch.Tensor:
    """Temper a (..., 32, wp) block of bit rows."""

    def sh(v, n, left):
        z = torch.zeros(v.shape[:-2] + (n, v.shape[-1]), dtype=v.dtype, device=v.device)
        if left:
            return torch.cat([z, v[..., :-n, :]], dim=-2)
        return torch.cat([v[..., n:, :], z], dim=-2)

    def mask(v, m):
        return v * _bits32(m, v.device)[:, None]

    y = y ^ mask(sh(y, U, False), D)
    y = y ^ mask(sh(y, S_, True), B)
    y = y ^ mask(sh(y, T_, True), C)
    y = y ^ sh(y, L, False)
    return y


def mt19937_system_device(outs: torch.Tensor, bs: int, samples: int) -> torch.Tensor:
    """Packed equation matrix for MT19937 recovery, built on ``outs``' device.

    outs: the observed getrandbits(bs) values as int32 words — (samples,)
    for bs <= 32, or (samples, ceil(bs/32)) LSB-first words for larger bs.
    Returns (rows, wp) int32: ``samples*bs`` output equations followed by the
    32 known-MSB equations mt[0] ^ 0x80000000.
    """
    if bs < 1:
        raise ValueError("bs must be >= 1")
    dev = outs.device
    wp = _wp()
    wpc = -(-bs // 32)  # words per getrandbits call
    total_words = samples * wpc
    epochs = -(-total_words // N)
    if outs.ndim == 1:
        outs = outs[:, None]
    if tuple(outs.shape) != (samples, wpc):
        raise ValueError(f"outs shape {tuple(outs.shape)}, expected {(samples, wpc)}")

    # initial symbolic state: S[i, b] has packed bit (1 + 32 i + b) set
    pos = 1 + torch.arange(N * W, dtype=torch.int64, device=dev)
    state = torch.zeros((N * W, wp), dtype=I32, device=dev)
    state[torch.arange(N * W, device=dev), pos >> 5] = bit_i32(pos & 31)
    state = state.view(N, W, wp)

    umsk = _bits32(0x80000000, dev)[None, :, None]
    lmsk = _bits32(0x7FFFFFFF, dev)[None, :, None]
    a_bits = _bits32(A, dev)[None, :, None]

    # Vectorized twist, split at multiples of N-M so every chunk reads only
    # values fixed before the chunk (see the reference module).
    bounds = list(range(0, N, N - M)) + [N]  # [0, 227, 454, 624]

    def twist_chunk(st, lo, hi):
        c = hi - lo
        idx1 = torch.from_numpy(np.arange(lo + 1, hi + 1) % N).to(dev)
        idxm = torch.from_numpy((np.arange(lo, hi) + M) % N).to(dev)
        y = (st[lo:hi] * umsk) ^ (st[idx1] * lmsk)  # (c, W, wp)
        y_shr = torch.cat([y[:, 1:, :], torch.zeros((c, 1, wp), dtype=I32, device=dev)], dim=1)
        sel = y[:, 0:1, :] * a_bits
        st[lo:hi] = st[idxm] ^ y_shr ^ sel

    blocks = []
    for _ in range(epochs):
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            twist_chunk(state, lo, hi)
        blocks.append(_temper(state))
    tempered = torch.cat(blocks, dim=0)[:total_words]  # (tw, 32, wp)

    # value bit b of call c comes from tempered word c*wpc + b//32, bit-row
    # (32 - nb) + (b % 32), nb = the bit count that word contributes
    e = np.arange(samples * bs)
    c = e // bs
    b = e % bs
    j = b // 32
    t = b % 32
    nb = np.where(j < wpc - 1, 32, bs - 32 * (wpc - 1))
    flat_row = torch.from_numpy((c * wpc + j) * 32 + (32 - nb) + t).to(dev)
    eqs = tempered.reshape(total_words * 32, wp)[flat_row]
    # XOR the observed constant into the affine column (packed bit 0)
    obs = outs[torch.from_numpy(c).to(dev), torch.from_numpy(j).to(dev)]
    eqs[:, 0] ^= (obs >> torch.from_numpy(t).to(dev).to(I32)) & 1

    # known-MSB equations: mt[0] ^ 0x80000000
    msb_pos = 1 + torch.arange(W, dtype=torch.int64, device=dev)
    msb = torch.zeros((W, wp), dtype=I32, device=dev)
    msb[torch.arange(W, device=dev), msb_pos >> 5] = bit_i32(msb_pos & 31)
    msb[31, 0] |= 1  # const bit on bit 31
    return torch.cat([eqs, msb], dim=0)


def _padded_system(outs32: torch.Tensor, bs: int, samples: int) -> torch.Tensor:
    """The recovery system with its rows padded to a multiple of 256."""
    eqs = mt19937_system_device(outs32, bs, samples)
    rows = eqs.shape[0]
    return torch.nn.functional.pad(eqs, (0, 0, 0, -(-rows // 256) * 256 - rows))


def _state_words(origin64: np.ndarray) -> tuple[int, ...]:
    """A packed (W64,) uint64 origin -> the 624 state words."""
    s = packing.words_to_int(origin64)
    sol = []
    for _ in range(N):
        sol.append(s & 0xFFFFFFFF)
        s >>= 32
    return tuple(sol)


def solve_mt19937_batch(outs_batch, bs: int = 32, device="cuda"):
    """Recover many MT19937 states: per instance the system is built on the
    device and solved by the trailing solver; the origins and verdicts of
    all instances are read back once.

    outs_batch: (B, samples) observed getrandbits(bs) values, bs <= 32.
    Returns a list of B state tuples (None for an unsatisfiable entry)."""
    if not 1 <= bs <= 32:
        raise ValueError("solve_mt19937_batch takes 1 <= bs <= 32; loop solve_mt19937 instead")
    dev = resolve_device(device)
    outs_b = u32_to_torch(np.asarray(outs_batch, dtype=np.uint32), dev)
    phase1, phase2 = gauss_blocked._pick_engines(_wp())
    origins, unsats = [], []
    for outs in outs_b:
        origin32, unsat = gauss_blocked.rref_origin_blocked(
            _padded_system(outs, bs, outs_b.shape[1]), COLS, gauss_blocked.K_PANEL,
            phase1=phase1, phase2=phase2,
        )
        origins.append(origin32)
        unsats.append(unsat)
    origins_h = packing.from_u32(torch_to_u32(torch.stack(origins)))
    unsats_h = torch.stack(unsats).cpu().numpy()
    return [None if u else _state_words(o) for o, u in zip(origins_h, unsats_h)]


def solve_mt19937(outs, bs: int = 32, samples: int | None = None, mode: int = 0,
                  device="cuda"):
    """Build the system on ``device`` and solve it.  Mode 0 returns the
    624-tuple of state words, mode 1 the AffineSpace of states; None when
    the outputs are inconsistent."""
    dev = resolve_device(device)
    if samples is None:
        samples = len(outs)
    wpc = -(-bs // 32)
    arr = np.zeros((len(outs), wpc), np.uint32)
    for i, v in enumerate(outs):
        for jw in range(wpc):
            arr[i, jw] = (int(v) >> (32 * jw)) & 0xFFFFFFFF
    # engines from gauss_blocked._pick_engines, read per call
    raw = gauss_blocked.solve_on_device(_padded_system(u32_to_torch(arr, dev), bs, samples),
                                        COLS, mode)
    if raw is None:
        return None
    return AffineSpace(raw[0], raw[1], COLS) if mode == 1 else _state_words(raw)

"""Incremental GF(2) solving: add equations WITHOUT re-eliminating.

Port of ``gf2bv_tpu/ops/incremental.py``.  A from-scratch solve factors the
whole system again on every call, so the online-attack loop (observe a few
more outputs, re-solve, repeat until the space collapses to a point) pays a
full elimination per round.  Here the RREF stays on the system's device and
is UNIQUE, so appending B rows is three bounded passes:

1. reduce the new rows against the existing pivots: RREF pivot columns are
   elementary vectors, so one rank-R pass ``new ^= S · M`` (S = the new
   rows' bits at the pivot columns) reduces them fully;
2. mutually eliminate the reduced block (B rank-1 steps, each clearing a
   row's leading live column from the other new rows): the rows that stay
   are the unique RREF rows of the new quotient space;
3. back-substitute: one rank-B pass clears the new pivot columns from the
   existing matrix, and the new pivot rows land in preallocated slack rows.

Passes 1 and 3 are the full-width rank-K update ``a ^= sel·pf``, which is
:func:`panel_update.update_full` (the table kernel of ``csrc/update_table.cu``
on the card, its plain twin on the CPU) over 256-row chunks of ``pf``
(:func:`_xor_select_update`).  Pass 2 is a loop of small PyTorch operations
on the device with no readback inside; each add reads back exactly two
numbers, ``unsat`` and the count of new pivots, in one transfer.

The maintained state (``_M``, ``_pof``, ``_pcol``, ``_nrows``, ``_rank``,
``_unsat``) is bit for bit the JAX package's after the same adds: the full
(non-trailing) RREF of everything added so far.  It lives on the system's
device (the card by default, ``device="cpu"`` when asked) with no fallback
from one to the other.  An add streams the whole matrix twice, so use this
class for its online semantics (device-resident state across rounds, rank
and dimension after every add, sticky unsat); its times on the card beside a
from-scratch solve are in ``PERF.md``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import packing
from ..core.affine import AffineSpace
from ..core.words import I32, or_fold, resolve_device, torch_to_u32, u32_to_torch
from . import extract_device
from .panel_update import update_full

_B_BUCKETS = (128, 512, 2048)
_BIG = 1 << 30  # "no live bit" column sentinel
_CHUNK = 256  # rows of pf per update launch: the update kernel's largest K


def _bucket_rows(n: int) -> int:
    for b in _B_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"add at most {_B_BUCKETS[-1]} equations per call (got {n})")


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, K) 0/1 int32 -> (N, K/32) int32 words, bit t in word t >> 5."""
    n, k = bits.shape
    shifts = torch.arange(32, dtype=I32, device=bits.device)
    return or_fold(bits.view(n, k // 32, 32) << shifts, dim=2)


def _xor_select_update(a: torch.Tensor, sel_bits: torch.Tensor, pf: torch.Tensor):
    """``a ^= sel·pf`` over GF(2), in place: a (N, wp) int32, sel_bits (N, K)
    0/1 int32, pf (K, wp) int32 with K a multiple of 32.  One
    :func:`update_full` launch per 256-row chunk of pf."""
    k = pf.shape[0]
    for lo in range(0, k, _CHUNK):
        hi = min(lo + _CHUNK, k)
        update_full(a, _pack_bits(sel_bits[:, lo:hi].contiguous()), pf[lo:hi].contiguous())
    return a


def _bits_at(mat: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit ``pos[k]`` of every row: (N, wp) int32, (K,) int32 -> (N, K) int32
    0/1.  Negative positions yield 0."""
    p = pos.clamp(min=0)
    bits = (mat[:, (p >> 5).long()] >> (p & 31)[None, :]) & 1
    return torch.where((pos >= 0)[None, :], bits, 0)


def _mutual_eliminate(red: torch.Tensor, cols: int, n: int):
    """Pass 2 on the device, in place: for each of the first ``n`` rows in
    turn its leading live column (bits 1..cols; bit 0 is the affine term) is
    cleared from the other rows.  The rows from ``n`` on are the bucket's zero
    padding: they have no lead and are never hit, so they need no step.
    Returns (red, piv (B,) int32: each row's pivot column, -1 for a row with
    no live bit).  No value is read back inside the loop."""
    nb, wp = red.shape
    dev = red.device
    shifts = torch.arange(32, dtype=I32, device=dev)
    gbit = 32 * torch.arange(wp, dtype=I32, device=dev)[:, None] + shifts[None, :]
    key = torch.where((gbit >= 1) & (gbit <= cols), gbit, _BIG)  # (wp, 32)
    row_ids = torch.arange(nb, dtype=I32, device=dev)
    piv = torch.full((nb,), -1, dtype=I32, device=dev)
    for b in range(n):
        row = red[b]
        bits = ((row[:, None] >> shifts[None, :]) & 1) == 1
        lead = torch.where(bits, key, _BIG).amin()
        has = lead < _BIG
        lead0 = torch.where(has, lead, 0)
        col = red.index_select(1, (lead0 >> 5).long().view(1))[:, 0]
        hit = ((col >> (lead0 & 31)) & 1) * (has & (row_ids != b))
        red ^= (-hit)[:, None] & row[None, :]
        piv[b] = torch.where(has, lead, -1)
    return red, piv


def _add_step(M: torch.Tensor, pof: torch.Tensor, pcol: torch.Tensor, nrows: int,
              new: torch.Tensor, cols: int, n: int):
    """One incremental add.  M (rows_cap, wp) int32: the full RREF, zero
    slack rows from ``nrows`` on; pof (cols,) int32 variable -> pivot row;
    pcol (rows_cap,) int32 pivot row -> variable (-1 elsewhere); new
    (B_pad, wp) int32 packed new equations, zero from row ``n`` on.  M is
    updated in place.

    Returns (M, pof', pcol', unsat, npiv): the last two 0-dim tensors on
    the device."""
    rows_cap, _ = M.shape
    dev = M.device

    # -- 1) reduce against the existing pivots: rows past nrows are zero, so
    # the pass stops at the 128-row boundary after them.  pcol's -1 stays
    # negative through the +1 shift (0 would select the affine bit, and the
    # 0 = 1 row of an unsat matrix would be XORed into the new rows).
    live_rows = min(rows_cap, -(-nrows // 128) * 128)
    pc = pcol[:live_rows]
    red = new.clone()
    _xor_select_update(red, _bits_at(new, torch.where(pc >= 0, pc + 1, -1)), M[:live_rows])

    # -- 2) mutual elimination of the new block
    red, piv = _mutual_eliminate(red, cols, n)

    # a fully reduced row with no live column but the affine bit set: 0 = 1
    is_piv = piv >= 0
    unsat = (~is_piv & ((red[:, 0] & 1) == 1)).any()
    npiv = is_piv.to(I32).sum()

    # -- 3) back-substitute the new pivot columns out of the old rows
    old = M[:nrows]
    _xor_select_update(old, _bits_at(old, piv), red)

    # -- 4) land the new pivot rows in the slack rows.  A row that is no pivot
    # writes zeros to row nrows + npiv, a slack row past the new ones (in
    # range whenever such a row exists, since nrows + B_pad <= rows_cap);
    # pof and pcol take their dump writes in an extra slot.
    dst = nrows + torch.cumsum(is_piv.to(I32), 0, dtype=I32) - 1
    M[torch.where(is_piv, dst, nrows + npiv).long()] = torch.where(is_piv[:, None], red, 0)
    var = torch.where(is_piv, piv - 1, cols)
    pof_ext = torch.cat([pof, pof.new_zeros(1)])
    pof_ext[var.long()] = dst
    pcol_ext = torch.cat([pcol, pcol.new_zeros(1)])
    pcol_ext[torch.where(is_piv, dst, rows_cap).long()] = var
    return M, pof_ext[:cols], pcol_ext[:rows_cap], unsat, npiv


class IncrementalSolver:
    """Online solving over a device-resident RREF (see the module docstring).

    >>> inc = IncrementalSolver(system, zeros)
    >>> inc.add(more_zeros)          # no re-elimination
    >>> inc.dimension                # remaining solution-space dimension
    >>> inc.solve_one()              # per-block tuple | None, like system
    """

    def __init__(self, system, zeros=(), *, slack: int = 2048, k_panel: int | None = None):
        eqs = system.get_eqs_packed(list(zeros))
        self._init_packed(system, eqs, system._cols, slack, k_panel, system._device)

    @classmethod
    def from_packed(cls, eqs, cols: int, *, slack: int = 2048, k_panel: int | None = None,
                    device="cuda") -> "IncrementalSolver":
        """Build from an already-packed ``(rows, W64)`` uint64 matrix (no
        system object) on ``device``.  ``add_packed`` takes packed rows too;
        only the raw query surface (``solve_raw_*``) is available."""
        self = cls.__new__(cls)
        self._init_packed(None, np.asarray(eqs, np.uint64), cols, slack, k_panel,
                          resolve_device(device))
        return self

    def _init_packed(self, system, eqs, cols, slack, k_panel, device):
        from .gauss_blocked import K_PANEL, _pad, _pick_engines, rref_blocked

        self.system = system
        self._cols = cols
        k_panel = k_panel or K_PANEL
        if eqs.shape[0]:
            a32 = _pad(eqs, k_panel, word_align=128)
        else:
            want_w = -(-(1 + cols) // 32)
            a32 = np.zeros((128, -(-want_w // 128) * 128), np.uint32)
        p1, p2 = _pick_engines(a32.shape[1])
        # keywords: the fourth positional parameter is ``trailing``, which
        # would leave the matrix stale left of each panel
        rref32, pof, bad = rref_blocked(u32_to_torch(a32, device), cols, k_panel,
                                        trailing=False, phase1=p1, phase2=p2)
        self._unsat = bool(bad)
        rows, _ = rref32.shape
        cap = rows + -(-slack // 128) * 128
        self._M = torch.nn.functional.pad(rref32, (0, 0, 0, cap - rows))
        self._pof = pof.contiguous()
        pcol = torch.full((cap + 1,), -1, dtype=I32, device=device)  # + dump slot
        pidx = torch.arange(cols, dtype=I32, device=device)
        pcol[torch.where(pof >= 0, pof, cap).long()] = pidx
        self._pcol = pcol[:cap].contiguous()
        self._nrows = rows
        self._rank = int((pof >= 0).sum())

    # -- online updates -----------------------------------------------------

    def add(self, zeros) -> "IncrementalSolver":
        """Fold new equations into the maintained RREF.  Returns self."""
        return self.add_packed(self.system.get_eqs_packed(list(zeros)))

    def add_packed(self, eqs) -> "IncrementalSolver":
        """:meth:`add` for an already-packed ``(rows, W64)`` uint64 matrix."""
        new32 = packing.to_u32(np.asarray(eqs, np.uint64))
        top = _B_BUCKETS[-1]
        for lo in range(0, new32.shape[0], top):
            self._add_chunk(new32[lo : lo + top])
        return self

    def _add_chunk(self, new32: np.ndarray) -> None:
        wp = self._M.shape[1]
        bpad = _bucket_rows(new32.shape[0])
        buf = np.zeros((bpad, wp), np.uint32)
        # a u64 -> u32 view can carry one zero tail word past wp; drop it
        new32 = new32[:, :wp]
        buf[: new32.shape[0], : new32.shape[1]] = new32
        if self._nrows + bpad > self._M.shape[0]:
            grow = -(-bpad // 2048) * 2048
            self._M = torch.nn.functional.pad(self._M, (0, 0, 0, grow))
            self._pcol = torch.nn.functional.pad(self._pcol, (0, grow), value=-1)
        M, pof, pcol, unsat, npiv = _add_step(
            self._M, self._pof, self._pcol, self._nrows, u32_to_torch(buf, self._M.device),
            self._cols, new32.shape[0],
        )
        unsat_h, npiv_h = torch.stack([unsat.to(I32), npiv]).tolist()  # the add's one readback
        self._M, self._pof, self._pcol = M, pof, pcol
        self._nrows += npiv_h
        self._unsat = self._unsat or bool(unsat_h)
        self._rank += npiv_h

    # -- queries ------------------------------------------------------------

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def dimension(self) -> int:
        """Dimension of the current solution space (meaningless if unsat)."""
        return self._cols - self._rank

    @property
    def unsat(self) -> bool:
        return self._unsat

    def _origin(self) -> np.ndarray:
        o32 = extract_device.origin_device(self._M, self._pof, self._cols)
        return packing.from_u32(torch_to_u32(o32)[None])[0]

    def solve_raw_one(self):
        if self._unsat:
            return None
        return packing.words_to_int(self._origin())

    def solve_raw_space(self):
        if self._unsat:
            return None
        basis = extract_device._basis_host_orchestrated(
            self._M, self._pof.cpu().numpy(), self._cols
        )
        return AffineSpace(self._origin(), basis, self._cols)

    def solve_one(self):
        if self.system is None:
            raise TypeError(
                "solve_one needs a system for convert_sol; "
                "from_packed solvers expose solve_raw_one/solve_raw_space"
            )
        raw = self.solve_raw_one()
        return None if raw is None else self.system.convert_sol(raw)

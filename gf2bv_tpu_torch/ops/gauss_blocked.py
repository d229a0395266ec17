"""Panel-blocked Gauss-Jordan to RREF — the large-system path.

Port of ``gf2bv_tpu/ops/gauss_blocked.py``.  Per K-column panel:

* phase 1 (ops/phase1.py): scan the thin (rows, K/32) slice for pivots,
  gather the pivot rows, rebuild them at full width and back-eliminate
  them into the panel's intra-panel RREF rows PF;
* phase 2 (ops/panel_update.py): one rank-K update ``a ^= S·PF``, with the
  selector S taken from the SAVED original panel slice
  (:func:`selector_from_prow`).

Engines, picked as in the reference by ``phase1=`` / ``phase2=`` or, at the
entry points, by ``GF2BV_TPU_PHASE1`` / ``GF2BV_TPU_PHASE2``
(:func:`_pick_engines`; defaults ``pallas_scan`` and ``mxu``):

* phase 1: ``pallas_scan`` (scan + rebuild), ``pallas_scan2`` (two pivots
  per scan step), ``pallas_scanm`` (min-key scan), ``pallas`` (the fused
  phase-1 kernel) and ``pallas_sub`` (the scan on a subset of rows, with a
  full pass where the subset missed a pivot);
* phase 2: ``mxu`` (in trailing mode the segmented update), ``mxu_noseg``
  (the trailing update with a runtime panel start), ``mxu_la`` (the
  update of panel t fused with the scan of panel t+1; too small shapes run
  ``mxu``, as in the reference), ``pallas`` (the table kernel; full-width
  in trailing mode too), ``mxu2`` and ``mxu4`` (the update as a tensor-core
  product, each with its own trailing rule) and the diagnostic ``skip``
  (no update at all: it times phase 1 alone and solves nothing);
* ``jnp`` in either phase: the reference's portable formulation, plain
  PyTorch on either device (phase 1 a per-pivot loop over the panel's
  columns, slow by nature; phase 2 ``panel_update.rank_k_xor_``).

A name with the ``_interpret`` suffix means the same engine.  A CUDA tensor
runs the engine's Hopper kernels, a CPU tensor their plain twins; nothing
else chooses between them.  The RREF is unique and every engine keeps the
pivot rule, so results are bit for bit those of the JAX package.

Under ``pallas_scan`` a panel's scan is the subset-first scan
(:func:`phase1.scan_subset`: the first ``SCAN_SUBSET_ROWS`` unused rows, with
the full scan where they miss a pivot), unless a plan says otherwise.

The mode-0 elimination (:func:`rref_origin_blocked`) and the full RREF of
mode 1 (:func:`rref_full_blocked`) of a system shape met before on the card
are replayed from a CUDA graph of the same body, kept per body and shape
(at most :data:`GRAPH_KEYS`).  The graph scans a panel subset-first only
where the shape's first call's subset decided it (:class:`_RrefGraph`).
"""

from __future__ import annotations

import functools
import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..core import packing
from ..core.words import (
    I32, bit_i32, or_fold, parity32, resolve_device, srl, torch_to_u32,
    u32_to_torch, xor_fold,
)
from ..utils import profiling
from . import _cuda, extract_device
from .panel_update import (
    SEG_TILE, la_grid, rank_k_xor_, update_full, update_mxu2, update_mxu4, update_pallas,
    update_scan, update_seg, update_trailing,
)
from .phase1 import (
    SUBSET_ROWS, _bitval, phase1_panel, phase1_scan_subset, rebuild_pivots, reconstruct, scan,
    scan_subset,
)

K_PANEL = 256  # panel width in bits
_ROW_BUCKET = 256

PHASE1_ENGINES = ("pallas_scan", "pallas_scan2", "pallas_scanm", "pallas", "pallas_sub",
                  "jnp")
PHASE2_ENGINES = ("mxu", "mxu_noseg", "mxu_la", "pallas", "mxu2", "mxu4", "skip", "jnp")
_SCAN_VARIANT = {"pallas_scan": "", "pallas_scan2": "2", "pallas_scanm": "m", "pallas_sub": ""}

# Panels the pallas_sub engine ran a second time over all rows because the
# subset missed a pivot; reset it with SUBSET_FALLBACKS["panels"] = 0.
SUBSET_FALLBACKS = {"panels": 0}


def engine(name: str, phase: str) -> str:
    """The engine ``name`` (``_interpret`` suffix dropped) for ``phase``
    ("phase1" or "phase2"); an unknown name raises ValueError."""
    known = PHASE1_ENGINES if phase == "phase1" else PHASE2_ENGINES
    base = name[: -len("_interpret")] if name.endswith("_interpret") else name
    if base in known:
        return base
    raise ValueError(f"unknown {phase} engine {name!r}; expected one of {known}")


def apply_rank_k_update(a: torch.Tensor, s: torch.Tensor, pf: torch.Tensor, phase2: str,
                        w0: int | None = None) -> torch.Tensor:
    """Phase 2 under the engine ``phase2`` (a name :func:`engine` returned),
    in place.  ``w0`` (the panel's first word) asks for the trailing update:
    the ``mxu`` family, ``mxu2`` and ``mxu4`` take it, each with its own rule;
    ``pallas`` and ``jnp`` update every word whatever ``w0`` (``jnp`` is
    plain PyTorch on either device, as the reference's is plain jnp outside
    any kernel); ``skip`` leaves ``a`` as it is."""
    if phase2 == "skip":
        return a
    if phase2 == "mxu4":
        return update_mxu4(a, s, pf, w0)
    if phase2 == "mxu2":
        return update_mxu2(a, s, pf, w0)
    if phase2.startswith("mxu"):
        return update_full(a, s, pf) if w0 is None else update_trailing(a, s, pf, w0)
    if phase2 == "pallas":
        return update_pallas(a, s, pf)
    rank_k_xor_(a, s, pf)
    return a


def _pick_engines(wp: int) -> tuple[str, str]:
    """(phase1, phase2) for a matrix of ``wp`` words: ``GF2BV_TPU_PHASE1`` /
    ``GF2BV_TPU_PHASE2`` when set, else ``pallas_scan`` and ``mxu`` (the
    tensor's device then picks kernel or twin).  Read at call time, as the
    reference does.  ``wp`` is taken for the reference's signature: every
    engine runs at any width here."""
    del wp
    return (
        os.environ.get("GF2BV_TPU_PHASE1", "pallas_scan"),
        os.environ.get("GF2BV_TPU_PHASE2", "mxu"),
    )


def selector_from_prow(b_orig: torch.Tensor, prow: torch.Tensor,
                       owned: torch.Tensor | None = None,
                       local_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Phase-2 selector: the saved slice masked to pivot columns, with the
    diagonal flipped on each pivot's own row.  b_orig (rows, kw); prow (K,)
    (-1 = free column).  For the row-sharded solvers ``owned`` (K,) bool
    marks the pivots whose rows live in this shard and ``local_idx`` (K,)
    maps them to local rows: the pivot-column mask still comes from every
    pivot, but only owned pivots flip a diagonal bit.  Default: the single
    shard (every pivot owned, global == local).  Writes for free columns and
    unowned pivots go to an extra dump row, so duplicate scatter indices only
    ever write the same value."""
    rows, kw = b_orig.shape
    K = prow.shape[0]
    dev = b_orig.device
    bit_ids = torch.arange(K, dtype=I32, device=dev)
    piv = prow >= 0
    if owned is None:
        owned, local_idx = piv, prow
    pm = or_fold(torch.where(piv, bit_i32(bit_ids & 31), 0).view(kw, 32), dim=1)
    s_ext = torch.cat(
        [b_orig & pm[None, :], torch.zeros((1, kw), dtype=I32, device=dev)]
    )
    bitval = torch.where(owned, bit_i32(bit_ids & 31), 0)
    prow_safe = torch.where(owned, local_idx, rows).long()
    wordidx = (bit_ids >> 5).long()
    s_ext[prow_safe, wordidx] = s_ext[prow_safe, wordidx] ^ bitval
    return s_ext[:rows]


def phase1_panel_jnp(a: torch.Tensor, b_orig: torch.Tensor, used: torch.Tensor,
                     w0: int, K: int, cols: int):
    """The portable ``jnp`` phase 1 of one panel, the reference's per-pivot
    loop in plain PyTorch on either device: per column the lowest unused row
    with the bit set pivots, its row is rebuilt at full width from the
    matrix and the earlier pivot rows, the slice's other candidates are
    eliminated and their coefficients recorded; then the back pass over the
    pivot rows.  a (rows, wp) at the panel's start, b_orig (rows, kw) its
    slice, used (1, rows).  Returns (pf (K, wp), prow (K,), used'), the
    contract of ``phase1.phase1_panel_split``.  K small launches per panel:
    slow by nature."""
    rows, wp = a.shape
    kw = K // 32
    dev = a.device
    b = b_orig.clone()
    cmat = torch.zeros((rows, kw), dtype=I32, device=dev)
    pf = torch.zeros((K, wp), dtype=I32, device=dev)
    u = used[0] != 0
    prow = torch.full((K,), -1, dtype=I32, device=dev)
    row_ids = torch.arange(rows, dtype=I32, device=dev)
    pf_ids = torch.arange(K, dtype=I32, device=dev)
    for jj in range(K):
        if not 1 <= 32 * w0 + jj <= cols:
            continue
        word, shift = jj >> 5, jj & 31
        cand = (((b[:, word] >> shift) & 1) == 1) & ~u
        piv = torch.where(cand, row_ids, rows).amin()
        has = piv < rows
        ps = torch.where(has, piv, 0).long()
        # the forward pivot row at full width: a[piv] and the earlier rows
        # its recorded coefficients select
        take = ((cmat[ps][(pf_ids >> 5).long()] >> (pf_ids & 31)) & 1) == 1
        full = a[ps] ^ xor_fold(torch.where(take[:, None], pf, 0), dim=0)
        pf[jj] = torch.where(has, full, 0)
        elim = cand & (row_ids != piv)
        b ^= torch.where(elim[:, None], b[ps][None, :], 0)
        cmat[:, word] ^= torch.where(elim, _bitval(shift), 0).to(I32)
        u = u | ((row_ids == piv) & has)
        prow[jj] = torch.where(has, piv, -1)
    for jj in range(K - 1, -1, -1):  # back pass -> intra-panel RREF rows
        colb = (pf[:, w0 + (jj >> 5)] >> (jj & 31)) & 1
        elim = (colb == 1) & (pf_ids != jj) & (prow[jj] >= 0)
        pf ^= torch.where(elim[:, None], pf[jj][None, :], 0)
    return pf, prow, u.to(I32)[None, :]


class _Panels:
    """The state of one blocked elimination: the matrix (updated in place),
    the used rows and the pivot map (with its dump slot at ``cols``).
    ``decided`` (panels,) int32 is set to 1 on each panel whose subset-first
    scan decided it; ``subset_first`` (a bool a panel, or None: every panel)
    says which panels ``pallas_scan`` scans subset-first, the others by
    :func:`scan`."""

    def __init__(self, a: torch.Tensor, cols: int, K: int, trailing: bool, phase2: str,
                 decided: torch.Tensor, subset_first: tuple | None):
        self.a = a
        self.cols = cols
        self.K = K
        self.kw = K // 32
        self.rows, self.wp = a.shape
        dev = a.device
        self.bit_ids = torch.arange(K, dtype=I32, device=dev)
        self.used = torch.zeros((1, self.rows), dtype=I32, device=dev)
        self.pof = torch.full((cols + 1,), -1, dtype=I32, device=dev)
        self.decided = decided
        self.subset_first = subset_first
        self.trailing = trailing
        self.phase2 = phase2
        # mxu in trailing mode: the segmented update, dead tiles d = w0 // 128
        self.seg = (trailing and phase2 == "mxu" and self.wp % SEG_TILE == 0
                    and SEG_TILE % self.kw == 0)

    def record(self, prow: torch.Tensor, w0: int) -> None:
        dst = torch.where(prow >= 0, 32 * w0 + self.bit_ids - 1, self.cols).long()
        self.pof[dst] = prow

    def update(self, s: torch.Tensor, pf: torch.Tensor, w0: int) -> None:
        """Phase 2 of the panel at word w0 (apply_rank_k_update's dispatch)."""
        a = self.a
        if self.seg:
            dead = w0 // SEG_TILE
            if dead >= 1:
                update_seg(a, s, pf, dead)
            else:
                update_full(a, s, pf)
        else:
            apply_rank_k_update(a, s, pf, self.phase2, w0 if self.trailing else None)

    def full_pass(self, t: int, phase1: str) -> None:
        """One panel over all rows (the reference's _panel_kernel_full).
        Spans ``panel.scan``, ``panel.rebuild`` (the split engines; ``jnp``
        and ``pallas`` rebuild inside the scan's span) and ``panel.update``."""
        K, kw = self.K, self.kw
        w0 = t * kw
        with profiling.span("panel.scan"):
            b_orig = self.a[:, w0 : w0 + kw].clone()  # saved before the update
            bT = b_orig.T.contiguous()
            if phase1 == "jnp":
                pf, prow, self.used = phase1_panel_jnp(self.a, b_orig, self.used, w0, K,
                                                       self.cols)
            elif phase1 == "pallas":
                pf, prow, self.used = phase1_panel(self.a, bT, self.used, w0, K, self.cols)
            elif phase1 == "pallas_scan" and (self.subset_first is None or self.subset_first[t]):
                prow, self.used, cT = scan_subset(bT, self.used, w0, K, self.cols,
                                                  self.decided[t : t + 1])
            else:
                prow, self.used, cT = scan(bT, self.used, w0, K, self.cols,
                                           _SCAN_VARIANT[phase1])
        if phase1 not in ("jnp", "pallas"):
            with profiling.span("panel.rebuild"):
                pf = rebuild_pivots(self.a, prow, cT, w0)
        with profiling.span("panel.update"):
            self.record(prow, w0)
            self.update(selector_from_prow(b_orig, prow), pf, w0)

    def subset_pass(self, t: int) -> None:
        """The reference's _panel_kernel_subset: scan only the first
        SUBSET_ROWS unused rows (the pivot is the lowest row, so the
        subset's winner is the global one whenever the subset sees the
        column), update, and where a column left free still has a live bit
        in an unused row, run the panel again over all rows.  That check is
        read on the host: one synchronisation per panel."""
        K, kw, rows, S = self.K, self.kw, self.rows, SUBSET_ROWS
        dev = self.a.device
        w0 = t * kw
        with profiling.span("panel.scan"):
            b_orig = self.a[:, w0 : w0 + kw].clone()
            unused = (self.used[0] == 0).to(I32)
            slot = torch.cumsum(unused, 0, dtype=I32) - 1
            take = (unused == 1) & (slot < S)
            row_ids = torch.arange(rows, dtype=I32, device=dev)
            subset_ext = torch.zeros((S + 1,), dtype=I32, device=dev)  # + dump slot
            subset_ext[torch.where(take, slot, S).long()] = row_ids
            subset_idx = subset_ext[:S]
            n_sub = torch.clamp(slot[-1] + 1, max=S)
            bT_c = b_orig[subset_idx.long()].T.contiguous()  # (kw, S)
            used_in = (torch.arange(S, device=dev) >= n_sub).to(I32)[None, :]
            prow_l, cT_c = phase1_scan_subset(bT_c, used_in, w0, K, self.cols)
        with profiling.span("panel.rebuild"):
            pl_safe = prow_l.clamp(min=0).long()
            prow = torch.where(prow_l >= 0, subset_idx[pl_safe], -1)
            coeff = cT_c[:, pl_safe].T.contiguous()
            pf = reconstruct(self.a[prow.clamp(min=0).long()], coeff, prow, w0)
        with profiling.span("panel.update"):
            used_ext = torch.cat([self.used[0], torch.zeros(1, dtype=I32, device=dev)])
            used_ext[torch.where(prow >= 0, prow, rows).long()] = 1
            self.used = used_ext[None, :rows].contiguous()
            self.record(prow, w0)
            self.update(selector_from_prow(b_orig, prow), pf, w0)

        # deficit check: a column left free with a live bit in an unused row
        gbit = 32 * w0 + self.bit_ids
        free = (prow < 0) & (gbit >= 1) & (gbit <= self.cols)
        freemask = or_fold(torch.where(free, bit_i32(self.bit_ids & 31), 0).view(kw, 32), dim=1)
        b_post = self.a[:, w0 : w0 + kw]
        live = ((b_post & freemask[None, :]) != 0).any(dim=1) & (self.used[0] == 0)
        if bool(live.any()):
            SUBSET_FALLBACKS["panels"] += 1
            self.full_pass(t, "pallas_sub")

    def lookahead(self, panels: int) -> None:
        """The reference's _rref_lookahead (``mxu_la``): the scan of panel
        t+1 runs in the same launch as the update of panel t.  Per panel:
        rebuild, selector, pivot map, a thin update of the next panel's
        slice (the update kernel on kw words), then the fused update + scan.
        The scans are the 1-pivot scan whatever the phase-1 engine."""
        K, kw, wp = self.K, self.kw, self.wp
        a = self.a
        with profiling.span("panel.scan"):
            prow, used, cT = scan(a[:, :kw].T.contiguous(), self.used, 0, K, self.cols)
        for t in range(panels):
            w0 = t * kw
            with profiling.span("panel"):
                with profiling.span("panel.rebuild"):
                    pf = rebuild_pivots(a, prow, cT, w0)
                with profiling.span("panel.update"):  # and the next panel's scan
                    s = selector_from_prow(a[:, w0 : w0 + kw], prow)
                    self.record(prow, w0)
                    # the next panel's slice; past the last panel the reference's
                    # dynamic_slice clamps its start, and the scan at w0n finds
                    # every column invalid (32*w0n > cols), so any slice does
                    w0n = w0 + kw
                    lo = min(w0n, wp - kw)
                    slice_n = a[:, lo : lo + kw].contiguous()
                    update_full(slice_n, s, pf[:, lo : lo + kw].contiguous())
                    _, prow, cT, used = update_scan(
                        a, s, pf, slice_n.T.contiguous(), used, w0n, self.cols,
                        w0 if self.trailing else None,
                    )
        self.used = used


def _panel_count(wp: int, cols: int, k_panel: int) -> int:
    """Panels of a blocked elimination of ``wp`` words over ``cols`` columns."""
    kw = k_panel // 32
    return min(wp // kw, -(-(1 + cols) // (32 * kw)))


def rref_blocked(a: torch.Tensor, cols: int, k_panel: int = K_PANEL,
                 trailing: bool = False, *, phase1: str = "pallas_scan",
                 phase2: str = "mxu", subset_first: tuple | None = None,
                 decided: torch.Tensor | None = None):
    """Blocked RREF of ``a`` (rows, wp) int32.

    Returns (rref, pivot_row_of_col (cols,), inconsistent 0-dim bool).  The
    input is not modified (the elimination runs on a copy).  ``phase1`` /
    ``phase2`` pick the engines (module docstring).  A width that is not a
    multiple of ``k_panel // 32`` words (a per-pivot cached matrix beside a
    multi-RHS tile) runs zero-padded to one and comes back at ``wp`` words:
    zero words stay zero under row operations, and only the reference's
    ``wp // kw`` panels are scanned.

    ``trailing=True`` (mode-0 fast path): only the tiles from the panel's on
    and word 0 stay up to date (``mxu``: panels are grouped by their count
    of dead 128-word tiles ``d = (t*kw) // 128``, and panels with ``d >= 1``
    use the segmented update; ``mxu_noseg``, ``mxu_la``, ``mxu2`` and
    ``mxu4``: the engine's trailing update with the panel start; ``pallas``
    and ``jnp`` update every word all the same).  The returned matrix is
    then not a full RREF left of the last panel and ``inconsistent`` is
    unreliable; mode 0 verifies its solution against the original system
    instead (:func:`rref_origin_blocked`).

    Under ``pallas_scan`` a panel is scanned subset-first
    (:func:`phase1.scan_subset`) where ``subset_first`` (a bool a panel) says
    so, every panel where it is None, the others by the full scan alone.
    ``decided``, a (panels,) int32 zero tensor on ``a``'s device where
    given, receives 1 on each panel the subset-first scan decided.
    """
    p1 = engine(phase1, "phase1")
    p2 = engine(phase2, "phase2")
    K = k_panel
    kw = K // 32
    rows, wp = a.shape
    pad = -wp % kw
    panels = _panel_count(wp, cols, K)
    work = torch.nn.functional.pad(a, (0, pad)) if pad else a.clone()
    if p2 == "mxu_la" and not (la_grid(rows, wp + pad)[2] * 32 >= K and (wp + pad) % 128 == 0):
        p2 = "mxu"  # too few grid steps to host a panel's scan: the reference's gate
    if decided is None:
        decided = torch.zeros((panels,), dtype=I32, device=a.device)
    st = _Panels(work, cols, K, trailing, p2, decided, subset_first)
    if p2 == "mxu_la":
        st.lookahead(panels)
    else:
        for t in range(panels):
            with profiling.span("panel"):
                if p1 == "pallas_sub":
                    st.subset_pass(t)
                else:
                    st.full_pass(t, p1)
    rref = st.a[:, :wp].contiguous() if pad else st.a
    return rref, st.pof[:cols], extract_device.inconsistent_device(rref)


def origin_parity_unsat(a: torch.Tensor, origin32: torch.Tensor) -> torch.Tensor:
    """Per-row parity of A & [1|x] over the ORIGINAL system; any odd row
    means the candidate origin does not satisfy it (0-dim bool tensor)."""
    wp = a.shape[1]
    ox = origin32
    if wp > ox.shape[0]:
        ox = torch.cat([ox, torch.zeros(wp - ox.shape[0], dtype=I32, device=ox.device)])
    # xfull = packed [const=1 | x]: the solution shifted up one bit
    lo = torch.cat([torch.ones(1, dtype=I32, device=ox.device), srl(ox[:-1], 31)])
    xfull = ((ox << 1) | lo)[:wp]
    row_words = xor_fold(a & xfull[None, :], dim=1)
    return (parity32(row_words) == 1).any()


def _rref_planned(a: torch.Tensor, subset_first: tuple | None, trailing: bool, cols: int,
                  k_panel: int, phase1: str, phase2: str):
    """:func:`rref_blocked`'s outputs with its panels scanned subset-first
    as ``subset_first`` says, and the panels' ``decided`` flags."""
    decided = torch.zeros((_panel_count(a.shape[1], cols, k_panel),), dtype=I32,
                          device=a.device)
    out = rref_blocked(a, cols, k_panel, trailing, phase1=phase1, phase2=phase2,
                       subset_first=subset_first, decided=decided)
    return tuple(out), decided


def _rref_origin_body(a: torch.Tensor, subset_first: tuple | None, cols: int, k_panel: int,
                      phase1: str, phase2: str):
    """The body of :func:`rref_origin_blocked`, its panels scanned
    subset-first as ``subset_first`` says: ((origin32, unsat), decided)."""
    (rref32, pof, _), decided = _rref_planned(a, subset_first, True, cols, k_panel, phase1,
                                              phase2)
    origin32 = extract_device.origin_device(rref32, pof, cols)
    return (origin32, origin_parity_unsat(a, origin32)), decided


def _rref_origin_eager(a: torch.Tensor, cols: int, k_panel: int = K_PANEL, *,
                       phase1: str = "pallas_scan", phase2: str = "mxu"):
    """The body of :func:`rref_origin_blocked`, run call by call: every
    panel's PyTorch calls and launches from Python, every panel of
    ``pallas_scan`` scanned subset-first."""
    return _rref_origin_body(a, None, cols, k_panel, phase1, phase2)[0]


def _rref_full_body(a: torch.Tensor, subset_first: tuple | None, cols: int, k_panel: int,
                    phase1: str, phase2: str):
    """The body of :func:`rref_full_blocked`, as :func:`_rref_origin_body`:
    ((rref, pivot_row_of_col, inconsistent), decided)."""
    return _rref_planned(a, subset_first, False, cols, k_panel, phase1, phase2)


def _count_scans(decided: torch.Tensor | None, replayed: bool = False) -> None:
    """While a profiler runs: the panels scanned (``scan_panels``) and
    those the subset-first scan decided (``scan_subset_panels``), summed
    from ``decided`` only when the span log is read, so that the elimination
    waits on nothing; a graph's own flags (``replayed``), which its next
    replay overwrites, are copied first on the card.  Off, nothing runs."""
    if decided is not None and profiling.tracing():
        profiling.count("scan_panels", decided.shape[0])
        profiling.count_sum("scan_subset_panels", decided.clone() if replayed else decided)


# -- the eliminations replayed from a CUDA graph -------------------------------------

GRAPH_KEYS = 4  # (body, system shape) keys whose graphs are kept; the least recently used goes
_SEEN_KEYS = 256  # keys remembered as called once
# phase-1 engines that read back to the host inside the loop: never captured
_READS_BACK = ("pallas_sub", "jnp")


class _RrefGraph:
    """One body's elimination of one system shape captured as a CUDA graph:
    the static input the caller's matrix is copied into, the graph (its
    private pool holds the working copy and every intermediate), the outputs
    it writes, and the launches of the port's kernels it makes per replay.
    ``kind``, the prefix of its counters, names the body: ``"rref"`` the
    mode-0 elimination with its origin (:func:`rref_origin_blocked`),
    ``"rref_full"`` the full RREF of mode 1 (:func:`rref_full_blocked`).

    ``first`` holds the ``decided`` flags of the key's first (eager) call,
    read once when the graph is captured: the plan scans a panel
    subset-first where the first call's subset decided it, and by the full
    scan alone where it missed (the full scan is exact on every system; the
    subset-first scan stays exact on a later system that misses, through its
    test on the card).  ``decided``, the graph's own flags, is counted only
    while a profiler runs (:func:`_count_scans`)."""

    def __init__(self, kind: str, first: torch.Tensor | None = None):
        self.kind = kind
        self.lock = threading.Lock()  # capture and replays, one at a time
        self.graph = self.done = None
        self.static = None
        self.outputs: tuple = ()
        self.decided = None
        self.first = first
        self.plan: tuple | None = None
        self.launches: dict[str, int] = {}

    def _capture(self, a: torch.Tensor, body) -> None:
        """Capture ``body`` under the plan from :attr:`first` on a static
        input of ``a``'s shape.  The launches the wrappers count while
        capturing are taken back: a capture runs nothing."""
        if self.first is not None:
            self.plan = tuple(bool(v) for v in self.first.tolist())
            self.first = None
        self.static = torch.empty(a.shape, dtype=a.dtype, device=a.device)
        before = dict(_cuda.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: other threads' CUDA calls stay legal while this one captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs, self.decided = body(self.static, self.plan)
                self.outputs = tuple(outputs)
        finally:
            self.launches = {k: n - before[k] for k, n in _cuda.LAUNCHES.items()
                             if n != before[k]}
            for k, n in self.launches.items():
                _cuda.LAUNCHES[k] -= n
        self.graph = graph
        profiling.count(f"{self.kind}_graph_captures")

    def run(self, a: torch.Tensor, body) -> tuple:
        """``body(a)`` by a replay (captured on the first run), on the
        current stream; the outputs are cloned out of the graph's pool."""
        with self.lock:
            if self.graph is None:
                self._capture(a, body)
                self.done = torch.cuda.Event()
            # the previous replay's readers, on whatever stream, go first
            torch.cuda.current_stream().wait_event(self.done)
            self.static.copy_(a)
            self.graph.replay()
            for k, n in self.launches.items():
                _cuda.LAUNCHES[k] += n
            profiling.count(f"{self.kind}_graph_replays")
            _count_scans(self.decided, replayed=True)
            out = tuple(t.clone() for t in self.outputs)
            self.done.record()
            return out


_graphs: OrderedDict = OrderedDict()  # key -> _RrefGraph, least recently used first
_seen: OrderedDict = OrderedDict()  # keys called once, eager -> that call's decided flags
_graphs_lock = threading.Lock()


def _graph_key(a: torch.Tensor, cols: int, k_panel: int, phase1: str, phase2: str,
               kind: str = "rref"):
    """The cache key of an elimination that a CUDA graph can replay:
    ``(device, rows, wp, cols, k_panel, phase1, phase2, kind)``, ``kind`` the
    body (:class:`_RrefGraph`); None where it cannot: a CPU tensor, a phase-1
    engine that reads back inside the loop, or a matrix off the current
    device (the eager body raises there).  A key is recorded only after an
    eager call succeeded, so a matrix the kernels refuse never reaches a
    capture."""
    p1, p2 = engine(phase1, "phase1"), engine(phase2, "phase2")
    if (a.device.type != "cuda" or p1 in _READS_BACK
            or a.device.index != torch.cuda.current_device()):
        return None
    return (a.device, *a.shape, cols, k_panel, p1, p2, kind)


def _graph_for(key) -> _RrefGraph | None:
    """The graph entry of ``key`` (made, not yet captured, on the key's
    second call, evicting the least recently used past :data:`GRAPH_KEYS`);
    None while the key has not been called."""
    with _graphs_lock:
        entry = _graphs.get(key)
        if entry is not None:
            _graphs.move_to_end(key)
        elif key in _seen:
            entry = _graphs[key] = _RrefGraph(key[-1], _seen.pop(key))
            if len(_graphs) > GRAPH_KEYS:
                _graphs.popitem(last=False)
        return entry


def _record_seen(key, decided: torch.Tensor | None = None) -> None:
    with _graphs_lock:
        _seen[key] = decided
        if len(_seen) > _SEEN_KEYS:
            _seen.popitem(last=False)


def _drop_graph(key, entry: _RrefGraph) -> None:
    with _graphs_lock:
        if _graphs.get(key) is entry:
            del _graphs[key]


def clear_graphs() -> None:
    """Forget every captured elimination and every shape seen."""
    with _graphs_lock:
        _graphs.clear()
        _seen.clear()


def _replayed(kind: str, body, a: torch.Tensor, cols: int, k_panel: int, phase1: str,
              phase2: str) -> tuple:
    """``body(a, plan)``'s outputs, by a replay of its graph where
    :func:`_graph_key` gives a key that has been called before, else eager
    with no plan (every panel subset-first).  Counts ``<kind>_calls``, and
    while a profiler runs ``scan_panels`` and ``scan_subset_panels``."""
    profiling.count(f"{kind}_calls")
    key = _graph_key(a, cols, k_panel, phase1, phase2, kind)
    entry = None if key is None else _graph_for(key)
    if entry is None:
        out, decided = body(a, None)
        if key is not None:
            _record_seen(key, decided)
        _count_scans(decided)
        return out
    try:
        return entry.run(a, body)
    except BaseException:
        _drop_graph(key, entry)
        raise


def rref_origin_blocked(a: torch.Tensor, cols: int, k_panel: int = K_PANEL, *,
                        phase1: str = "pallas_scan", phase2: str = "mxu"):
    """Trailing-mode RREF + mode-0 extraction.  Returns (origin32 (Wsol32,)
    int32, unsat 0-dim bool); the verdict checks the origin against ``a``.

    On the card, a system shape met before (:func:`_graph_key`) is solved by
    replaying a CUDA graph of the same body: the same kernels in the same
    order on the same bytes, one launch from the host instead of ~5000
    PyTorch calls.  Its first call runs eager and records the shape and
    which panels the subset-first scan decided; the second captures, with the
    subset-first scan on those panels and the full scan alone on the others.
    CPU tensors and the engines that read back inside the loop always run
    eager.  Counters: ``rref_calls``, ``rref_graph_replays``,
    ``rref_graph_captures``; while a profiler runs ``scan_panels`` and
    ``scan_subset_panels``."""
    body = functools.partial(_rref_origin_body, cols=cols, k_panel=k_panel,
                             phase1=phase1, phase2=phase2)
    return _replayed("rref", body, a, cols, k_panel, phase1, phase2)


def rref_full_blocked(a: torch.Tensor, cols: int, k_panel: int = K_PANEL, *,
                      phase1: str = "pallas_scan", phase2: str = "mxu"):
    """The full RREF of mode 1: ``rref_blocked(a, cols, k_panel, False,
    ...)``, returning (rref, pivot_row_of_col, inconsistent).  Replayed from
    a CUDA graph under the gate of :func:`rref_origin_blocked`, in a cache
    entry of its own.  Counters: ``rref_full_calls``,
    ``rref_full_graph_replays``, ``rref_full_graph_captures``."""
    body = functools.partial(_rref_full_body, cols=cols, k_panel=k_panel,
                             phase1=phase1, phase2=phase2)
    return _replayed("rref_full", body, a, cols, k_panel, phase1, phase2)


def _pad(eqs: np.ndarray, k_panel: int, word_align: int = 1) -> np.ndarray:
    a32 = packing.to_u32(eqs)
    return packing.pad2d(
        a32, row_align=_ROW_BUCKET, word_align=max(k_panel // 32, word_align)
    )


def _pad_device(a32: torch.Tensor, k_panel: int, word_align: int = 1) -> torch.Tensor:
    """Zero-pad a (rows, W32) tensor to the solver's row bucket and word
    alignment on its own device."""
    rows, w32 = a32.shape
    walign = max(k_panel // 32, word_align)
    want_rows = max(_ROW_BUCKET, -(-rows // _ROW_BUCKET) * _ROW_BUCKET)
    want_w = -(-w32 // walign) * walign
    if want_rows == rows and want_w == w32:
        return a32
    return torch.nn.functional.pad(a32, (0, want_w - w32, 0, want_rows - rows))


def solve_on_device(a: torch.Tensor, cols: int, mode: int, k_panel: int = K_PANEL,
                    phase2: str | None = None, phase1: str | None = None):
    """Solve a padded (rows, wp) int32 matrix where it lies.  Mode 0: the
    trailing solver and its parity check (:func:`rref_origin_blocked`),
    returning the packed origin (W64,) uint64; mode 1: the full RREF
    (:func:`rref_full_blocked`; the extraction after it reads back, eager),
    returning (origin, basis (dim, W64) uint64); None when unsatisfiable.
    Engines left None come from :func:`_pick_engines`.  The phases
    ``rref+origin`` or ``rref`` and ``extract`` are recorded by
    ``utils.profiling``, as in the reference's ``solve_blocked``."""
    auto1, auto2 = _pick_engines(a.shape[1])
    engines = dict(phase1=phase1 or auto1, phase2=phase2 or auto2)
    if mode == 0:
        with profiling.phase("rref+origin"):
            origin32, unsat = rref_origin_blocked(a, cols, k_panel, **engines)
            origin32, unsat = torch_to_u32(origin32), bool(unsat)
        if unsat:
            return None
        return packing.from_u32(origin32[None, :])[0]
    with profiling.phase("rref"):
        rref32, pof, inconsistent = rref_full_blocked(a, cols, k_panel, **engines)
    with profiling.phase("extract"):
        return extract_device.finalize(rref32, pof, inconsistent, cols, mode)


def solve_blocked(eqs: np.ndarray, cols: int, mode: int, k_panel: int = K_PANEL,
                  phase2: str | None = None, phase1: str | None = None, device="cuda"):
    """Solve packed (rows, W64) uint64 rows; results as :func:`solve_on_device`.
    Records the phases ``pad`` and ``h2d`` before it, as the reference does;
    ``h2d`` waits for the copy on a CUDA device."""
    dev = resolve_device(device)
    with profiling.phase("pad"):
        a32 = _pad(eqs, k_panel, word_align=128)
    with profiling.phase("h2d"):
        a = u32_to_torch(a32, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return solve_on_device(a, cols, mode, k_panel, phase2, phase1)

"""The least time an elimination needs on the card, from the cell's shapes.

The panel loop of a GF(2) elimination over ``K``-column panels moves, per
panel, the panel's slice of every row (read once) and the rank-K update of
every row's live words (read once, written once), with the update's
selector and the panel's pivot rows read once.  The live words of a panel
under the mode-0 trailing rule are the affine word 0 and every word from the
panel's first on: the columns left of the panel are already final.  This
counts the work the system needs, not what any kernel moves, so the same
share is read whatever kernels later do the work, and it is a lower bound:
rows and words are the system's own, not padded.

No operations term: the data sheet names no rate for one-bit XOR work on
the CUDA cores, so bytes bound the elimination.
"""

from __future__ import annotations

K_PANEL = 256  # panel width in columns the count is made for

# Published peaks (NVIDIA's data sheet, H100 SXM, at its 700 W limit).
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "power_w": 700.0},
}


def peak_for(kind: str) -> dict | None:
    """The peak table's entry whose key the card's name contains."""
    for key, peak in PEAKS.items():
        if key in kind:
            return peak
    return None


def update_bytes(rows: int, kw: int, live_words: int) -> int:
    """Bytes of a rank-K update that touches ``live_words`` words of every
    row: a read and written, sel and pf's live words read.  A copy of
    ``chip_smoke.update_bytes``."""
    return 4 * (2 * rows * live_words + rows * kw + 32 * kw * live_words)


def live_words(panel: int, words: int, kw: int) -> int:
    """Words of every row a mode-0 elimination still has to update at
    ``panel``: from the panel's first word on, and the affine word 0."""
    first = panel * kw
    return words - first + (1 if first > 0 else 0)


def elimination_bytes(rows: int, cols: int, k_panel: int = K_PANEL) -> int:
    """Bytes a mode-0 elimination of ``rows`` equations over ``cols``
    unknowns (and the affine bit) must move: each panel's slice read once
    and its rank-K update's live words read and written once."""
    kw = k_panel // 32
    words = -(-(1 + cols) // 32)
    panels = -(-(1 + cols) // k_panel)
    total = 0
    for t in range(panels):
        total += 4 * rows * kw  # the panel's slice
        total += update_bytes(rows, kw, live_words(t, words, kw))
    return total


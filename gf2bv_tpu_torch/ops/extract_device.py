"""On-device solution extraction (mode 0).

Port of ``gf2bv_tpu/ops/extract_device.py``: :func:`origin_device` and
:func:`inconsistent_device`.  The mode-1 kernel basis (``_basis_partial``,
``_basis_onehot``, ``_basis_device``) and ``finalize`` are ROADMAP queue 1
item 2.  Plain torch on either device.
"""

from __future__ import annotations

import torch

from ..core import packing
from ..core.words import I32, or_fold, srl


def _wsol32(cols: int) -> int:
    return 2 * packing.nwords64(cols)


def origin_device(rref32: torch.Tensor, pof: torch.Tensor, cols: int) -> torch.Tensor:
    """Packed particular solution (free variables 0), (Wsol32,) int32 words:
    variable ``c`` (1-based column c+1) takes the RHS bit of its pivot row."""
    nw32 = _wsol32(cols)
    prow_safe = pof.clamp(min=0).long()
    rhs = rref32[prow_safe, 0] & 1
    x = torch.where(pof >= 0, rhs, 0).to(I32)  # (cols,)
    pad = nw32 * 32 - cols
    if pad:
        x = torch.cat([x, torch.zeros(pad, dtype=I32, device=x.device)])
    shifts = torch.arange(32, dtype=I32, device=x.device)
    return or_fold(x.view(nw32, 32) << shifts[None, :], dim=1)


def inconsistent_device(rref32: torch.Tensor) -> torch.Tensor:
    """Any row reduced to 0*x = 1 (variable bits empty, const bit set);
    a 0-dim bool tensor."""
    const_bit = (rref32[:, 0] & 1) == 1
    var_any = srl(rref32[:, 0], 1) != 0
    if rref32.shape[1] > 1:
        var_any = var_any | (rref32[:, 1:] != 0).any(dim=1)
    return (const_bit & ~var_any).any()

"""Entry points of the port: a one-device step on the flagship path and a
multi-shard dryrun.

The counterparts of the JAX package's ``__graft_entry__.entry`` and
``dryrun_multichip`` (that file stays the JAX package's): :func:`entry`
returns the panel-blocked mode-0 solve on the reference's 2048-column
system, placed on a device; :func:`dryrun_multichip` runs the reference's
dryrun checks of the sharded solvers on a mesh of shards.
"""

from __future__ import annotations

import functools
import os

import numpy as np


def entry(device="cuda"):
    """(fn, example_args): the flagship path's forward step, the
    panel-blocked trailing RREF + mode-0 origin extraction + parity check
    (``gauss_blocked.rref_origin_blocked``, the program of the flagship
    MT19937 solve), on a 2048-column system with a rank surplus, padded as
    the solver pads it and placed on ``device``.  ``fn(*example_args)``
    returns ``(origin32, unsat)``; engines from ``_pick_engines``."""
    from .core import packing
    from .core.words import u32_to_torch
    from .ops import gauss_blocked

    cols = 2048
    rows = 2176  # rank surplus; bucketed to 2304 by _pad
    rng = np.random.default_rng(0)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(rows, cols)).astype(np.uint8)
    rhs = (coeff @ secret) % 2
    eqs = packing.pack_bits(np.concatenate([rhs[:, None], coeff], axis=1), 1 + cols)
    a = u32_to_torch(gauss_blocked._pad(eqs, gauss_blocked.K_PANEL, word_align=128), device)
    phase1, phase2 = gauss_blocked._pick_engines(a.shape[1])
    fn = functools.partial(
        gauss_blocked.rref_origin_blocked,
        cols=cols,
        k_panel=gauss_blocked.K_PANEL,
        phase1=phase1,
        phase2=phase2,
    )
    return fn, (a,)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run every sharded solver once on tiny shapes over a mesh of
    ``n_devices`` shards on ``device`` (several shards share it, as the
    JAX package's virtual CPU devices share the host; ``device="cpu"`` for
    a mesh of CPU shards): the per-pivot,
    blocked and tournament row-sharded solves, the fused tournament across
    panels with a planted unsat, the batch over the mesh's batch axis,
    multi-RHS and its mesh-sharded form, the lazy trace and the quadratic
    expansion.  Raises AssertionError on any wrong answer.

    The dryrun validates the device paths, so the CPU's preference for the
    host C engine is pinned off for its duration and restored after."""
    prev = os.environ.get("GF2BV_TPU_CPU_NATIVE")
    os.environ["GF2BV_TPU_CPU_NATIVE"] = "0"
    try:
        _dryrun_multichip_impl(n_devices, device)
    finally:
        if prev is None:
            os.environ.pop("GF2BV_TPU_CPU_NATIVE", None)
        else:
            os.environ["GF2BV_TPU_CPU_NATIVE"] = prev


def _dryrun_multichip_impl(n_devices: int, device) -> None:
    from .core import packing
    from .core.words import resolve_device
    from .parallel import batch as pbatch
    from .parallel import mesh as meshlib
    from .parallel.rowshard import solve_rowsharded
    from .parallel.rowshard_blocked import solve_rowsharded_blocked
    from .parallel.rowshard_tournament import solve_rowsharded_tournament

    dev = resolve_device(device)
    devices = [dev] * n_devices
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh = meshlib.make_mesh(batch=2, rows=n_devices // 2, devices=devices)
    else:
        mesh = meshlib.make_mesh(batch=1, rows=n_devices, devices=devices)

    cols = 48
    rng = np.random.default_rng(1)
    secret = rng.integers(0, 2, size=cols).astype(np.uint8)
    coeff = rng.integers(0, 2, size=(64, cols)).astype(np.uint8)
    rhs = (coeff @ secret) % 2
    bits = np.concatenate([rhs[:, None], coeff], axis=1)
    eqs = packing.pack_bits(bits, 1 + cols)

    # 1) one system row-sharded across the mesh: per-pivot, blocked, tournament
    want = packing.pack_bits(secret[None, :], cols)[0]
    got = solve_rowsharded(eqs, cols, 0, mesh)
    assert got is not None and np.array_equal(got, want), "row-sharded solve mismatch"
    got_b = solve_rowsharded_blocked(eqs, cols, 0, mesh, k_panel=64)
    assert got_b is not None and np.array_equal(got_b, want), \
        "blocked row-sharded solve mismatch"
    got_t = solve_rowsharded_tournament(eqs, cols, 0, mesh, k_panel=64)
    assert got_t is not None and np.array_equal(got_t, want), \
        "tournament row-sharded solve mismatch"

    # 1b) the fused-origin tournament at a PANEL-CROSSING shape (pivots over
    # several 64-column panels: trailing updates, the psum'd origin and the
    # parity tail across panel boundaries) and a planted unsat
    cols2 = 160
    secret2 = rng.integers(0, 2, size=cols2).astype(np.uint8)
    coeff2 = rng.integers(0, 2, size=(192, cols2)).astype(np.uint8)
    rhs2 = (coeff2 @ secret2) % 2
    bits2 = np.concatenate([rhs2[:, None], coeff2], axis=1)
    want2 = packing.pack_bits(secret2[None, :], cols2)[0]
    got2 = solve_rowsharded_tournament(packing.pack_bits(bits2, 1 + cols2), cols2, 0, mesh,
                                       k_panel=64)
    assert got2 is not None and np.array_equal(got2, want2), \
        "panel-crossing tournament mismatch"
    bits2u = bits2.copy()
    bits2u[-1] = bits2u[0]
    bits2u[-1, 0] ^= 1  # a contradictory duplicate row
    got2u = solve_rowsharded_tournament(
        packing.pack_bits(bits2u, 1 + cols2), cols2, 0, mesh, k_panel=64
    )
    assert got2u is None, "planted unsat not detected by the fused tail"

    # 2) independent systems split over the batch axis
    res = pbatch.solve_batch([eqs] * (2 * n_devices + 1), cols, 0, mesh=mesh)
    assert all(np.array_equal(r, want) for r in res), "batched solve mismatch"

    # 2b) multi-RHS: many instances of one coefficient matrix in one
    # augmented elimination
    from .ops import multi_rhs
    from .ops.gauss_blocked import K_PANEL, _pad

    nb = 5
    secrets = rng.integers(0, 2, size=(nb, cols)).astype(np.uint8)
    rhs_b = (secrets @ coeff.T % 2).astype(np.uint8)
    eqs_m = packing.pack_bits(
        np.concatenate([np.zeros((64, 1), np.uint8), coeff], axis=1), 1 + cols
    )
    a32m = _pad(eqs_m, K_PANEL, word_align=128)
    got_m = multi_rhs.solve_multi_rhs(a32m, cols, rhs_b, 0, device=dev)
    want_m = [
        int.from_bytes(np.packbits(s, bitorder="little").tobytes(), "little")
        for s in secrets
    ]
    assert got_m == want_m, "multi-RHS dryrun mismatch"

    # 2c) mesh-sharded multi-RHS: instances over the batch axis, the matrix
    # replicated, zero collectives
    from .parallel.multi_rhs_sharded import solve_multi_rhs_sharded

    mesh_b = meshlib.make_mesh(batch=n_devices, rows=1, devices=devices)
    got_ms = solve_multi_rhs_sharded(a32m, cols, rhs_b, 0, mesh=mesh_b)
    assert got_ms == want_m, "sharded multi-RHS dryrun mismatch"

    # 3) the lazy trace engine through the public API (device-cached
    # coefficient matrix + per-solve affine delta)
    from . import LinearSystem, QuadraticSystem
    from .crypto.lfsr import GaloisLFSR

    taps, init = 0xB400, 0xBEEF
    reg = GaloisLFSR(16, taps, init)
    stream = [reg() for _ in range(32)]
    lin = LinearSystem([16], device=dev)
    (s0,) = lin.gens()  # lazy by default
    sym = GaloisLFSR(16, taps, s0)
    assert lin.solve_one([sym() ^ b for b in stream]) == (init,), "lazy-engine solve mismatch"

    # 4) the quadratic expansion on the device + a pre-packed solve
    from .ops import quad_device

    qsys = QuadraticSystem([8], device=dev)
    lin8 = LinearSystem([8], device=dev)
    (v,) = lin8.gens()
    a_bits = type(v).stack([v[i] for i in range(4)])
    b_bits = type(v).stack([v[i + 4] for i in range(4)])
    eqs_dev = quad_device.quad_rows(
        qsys, pairs=[(a_bits, b_bits)], linear=[a_bits], const=0b1010
    )
    host = qsys.mul_bits(a_bits, b_bits) ^ qsys.lift(a_bits) ^ 0b1010
    from .core.words import torch_to_u32

    got_dev = torch_to_u32(eqs_dev)
    want_dev = packing.to_u32(host.rows)
    assert np.array_equal(got_dev[:, : want_dev.shape[1]], want_dev), \
        "device quadratic expansion mismatch"
    assert qsys.solve_raw_packed(eqs_dev, 1) is not None

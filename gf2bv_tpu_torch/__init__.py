"""gf2bv_tpu_torch — the GF(2) linear-system engine on PyTorch and CUDA.

The port of ``gf2bv_tpu`` (JAX on a TPU) to PyTorch with hand-written
Hopper (sm_90a) CUDA kernels.  Write an ordinary Python function on symbolic
bitvectors; asserted-zero bitvectors become a GF(2) system ``Ax = b`` that
the solver eliminates on the device.  Ported so far: one solution
(``LinearSystem(sizes, device=...).solve_one``), the affine solution space
(``solve_raw_space`` / ``solve_all``), pre-packed systems
(``solve_raw_packed``), batches (``solve_one_batch`` / ``solve_all_batch``),
captured traces (``LinearSystem.capture`` -> :class:`CapturedTrace`, whose
``solve_raw_batch`` solves many instances with one elimination), guess
sweeps (``solve_one_sweep`` / ``solve_all_sweep``), degree-2 systems by
linearization (:class:`QuadraticSystem`, with the quadratic rows built on
the device by ``ops.quad_device.quad_rows`` and the consistency filter run
there by ``ops.enumerate``), the device-built MT19937 system
(``crypto.mt_torch``), online solving over a device-resident RREF
(:class:`IncrementalSolver`), the reference's model library (``crypto/``:
MT19937, SFMT, PHP ``mt_rand``, LFSRs, Berlekamp-Massey, xorshift / V8
``Math.random``, xoshiro, WELL, Tausworthe, CRC, GF(2^m) / GHASH), the
low-level :func:`m4ri_solve`, the Sage, numpy and scipy exports, trace
serialization and the matrix PNG (``utils/``), the backends of the
reference: ``blocked`` (the Hopper kernels), ``jax`` (the per-pivot solver),
``native`` (the host C engine) and ``oracle`` (numpy), the sharded solvers
on a device mesh (``parallel/``: row-sharded eliminations, mesh-sharded
multi-RHS, ``mesh=`` on the batches and sweeps, one process per GPU through
``torch.distributed``), the phase timers and ``torch.profiler`` traces
(``utils/profiling.py``, ``utils/timing.py``) and the entry points
(``entry.py``).

``device="cuda"`` (the default) runs the kernels in ``csrc/``, which
are compiled by nvcc on first use; ``device="cpu"`` runs their plain
PyTorch twins (or the host C engine, which gcc builds on first use).
Importing this package imports neither JAX nor the JAX package, and never
runs nvcc or gcc.
"""

from .core.affine import AffineSpace
from .core.bitvec import BitVec
from .core.capture import CapturedTrace
from .core.system import (
    DimensionTooLargeError,
    LinearSystem,
    QuadraticSystem,
    Zeros,
)
from .core.words import torch_to_u32, u32_to_torch
from .ops.incremental import IncrementalSolver

__version__ = "0.1.0"


def m4ri_solve(equations, cols: int, mode: int, *, device="cuda"):
    """Low-level compat shim for the reference's native entry point:
    equations are big-int masks (bit 0 = const, bits 1..cols = variables);
    mode 0 returns one solution int (or None), mode 1 the AffineSpace (or
    None).  Solved on ``device``, the card by default."""
    from .core import packing
    from .ops import solver

    eqs = packing.ints_to_rows(list(equations), 1 + cols)
    return solver.solve(eqs, cols, mode, device=device)

__all__ = [
    "AffineSpace",
    "BitVec",
    "CapturedTrace",
    "DimensionTooLargeError",
    "IncrementalSolver",
    "LinearSystem",
    "QuadraticSystem",
    "Zeros",
    "m4ri_solve",
    "torch_to_u32",
    "u32_to_torch",
]

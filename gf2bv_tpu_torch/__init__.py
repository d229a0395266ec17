"""gf2bv_tpu_torch — the GF(2) linear-system engine on PyTorch and CUDA.

The port of ``gf2bv_tpu`` (JAX on a TPU) to PyTorch with hand-written
Hopper (sm_90a) CUDA kernels.  Write an ordinary Python function on symbolic
bitvectors; asserted-zero bitvectors become a GF(2) system ``Ax = b`` that
the panel-blocked solver eliminates on the device.  Ported so far: one
solution (``LinearSystem(sizes, device=...).solve_one``), the affine
solution space (``solve_raw_space`` / ``solve_all``), pre-packed systems
(``solve_raw_packed``), batches (``solve_one_batch`` / ``solve_all_batch``),
captured traces (``LinearSystem.capture`` -> :class:`CapturedTrace`, whose
``solve_raw_batch`` solves many instances with one elimination), guess
sweeps (``solve_one_sweep`` / ``solve_all_sweep``) and the device-built
MT19937 system (``crypto.mt_torch``).

``device="cuda"`` (the default) runs the kernels in ``csrc/``, which
are compiled by nvcc on first use; ``device="cpu"`` runs their plain
PyTorch twins.  Importing this package imports neither JAX nor the JAX
package, and never runs nvcc.
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

__version__ = "0.1.0"

__all__ = [
    "AffineSpace",
    "BitVec",
    "CapturedTrace",
    "DimensionTooLargeError",
    "LinearSystem",
    "QuadraticSystem",
    "Zeros",
    "torch_to_u32",
    "u32_to_torch",
]

from . import packing
from .affine import AffineSpace
from .bitvec import BitVec
from .system import LinearSystem, QuadraticSystem
from .words import torch_to_u32, u32_to_torch

__all__ = [
    "packing",
    "AffineSpace",
    "BitVec",
    "LinearSystem",
    "QuadraticSystem",
    "torch_to_u32",
    "u32_to_torch",
]

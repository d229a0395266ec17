"""The modules a run of the benchmark may never hold.

Names are compared by their top-level part (before the first dot), whole:
``gf2bv_tpu_torch`` is the program under test, ``gf2bv_tpu`` the JAX
package it was ported from.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "gf2bv_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names of loaded modules that are forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))

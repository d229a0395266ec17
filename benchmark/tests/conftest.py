"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
checkout's root.  They run on the CPU; the tests that need the card carry
the ``cuda`` marker and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

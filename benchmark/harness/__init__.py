"""The benchmark's yardstick: cell resolution, traffic, statistics, byte
counts, the reduction of a profiler trace, and the run itself.

Nothing here imports the program at module level; the program
(``gf2bv_tpu_torch``) is reached only through the entry modules under
``benchmark/entries/``.
"""

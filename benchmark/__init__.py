"""The benchmark of gf2bv_tpu_torch (``python3 benchmark/run.py --help``)."""

"""The benchmark of pyamg_tpu_torch (see run.py)."""

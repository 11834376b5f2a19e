"""The benchmark harness of fdgan_tpu_torch (see ../run.py)."""

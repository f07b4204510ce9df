"""The benchmark of ``libultrahdr_tpu_torch``: see README.md."""

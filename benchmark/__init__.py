"""The benchmark of dddpm_tpu_torch (see README.md)."""

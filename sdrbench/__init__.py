"""The benchmark of cutesdr_tpu_torch (README.md)."""

"""The benchmark of twilight_tpu_torch on the H100 (README.md)."""

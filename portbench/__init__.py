"""The benchmark of flacx_torch (see README.md)."""

"""The benchmark of motionstyle_torch on NVIDIA cards (see README.md)."""

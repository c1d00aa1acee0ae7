"""Operators of the port: plain PyTorch ops and the wrappers of the
hand-written Hopper kernels (`csrc/`).  Nothing here builds or loads a
kernel at import time."""

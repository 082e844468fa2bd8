"""Hand-written CUDA kernels of the encode and decode paths and their
wrappers.

One module per kernel.  Each holds the kernel's plain PyTorch version
(``<name>_plain``) and its wrapper (``<name>``): the wrapper takes the
plain version for tensors on the CPU and, for CUDA tensors, checks its
inputs, launches the kernel built from ``csrc/`` and counts the launch in
its ``launches`` attribute.  Nothing is built or loaded at import time.
"""

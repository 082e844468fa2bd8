"""Hand-written CUDA kernels of the encode and decode paths and their
wrappers.

One module per kernel.  Each holds the kernel's plain PyTorch version
(``<name>_plain``) and its wrapper (``<name>``): the wrapper takes the
plain version for tensors on the CPU and, for CUDA tensors, checks its
inputs and launches the kernel built from ``csrc/`` through
:func:`build.launch`, which counts every launch under ``launch.<name>``
(:mod:`flacx_torch.trace`).  Nothing is built or loaded at import time.
"""

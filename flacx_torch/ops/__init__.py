"""Plain PyTorch stages of the batched encoder and decoder.

Each module mirrors its namesake in the JAX package.  Integer stages
carry unsigned 32-bit symbol values and packed words in ``int64`` masked
to 32 bits (PyTorch's CPU ``uint32`` lacks shifts, adds, comparisons and
``gather``).
"""

#: Mask of the low 32 bits, for unsigned 32-bit words carried in int64.
MASK32 = 0xFFFFFFFF

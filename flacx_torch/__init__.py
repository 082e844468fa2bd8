"""flacx_torch: the batched FLAC encoder and decoder on PyTorch and CUDA.

A port of the JAX package ``flacx`` beside it.  Plain tensor code is
PyTorch; every TPU kernel on the encode path, and each scan of the
decode path, has a hand-written CUDA counterpart under
``flacx_torch/kernels/csrc``.  Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``, which
takes each kernel's plain PyTorch version.

Importing this package imports neither ``jax`` nor ``flacx``; the encoder
lives in :mod:`flacx_torch.encoder`, the decoder in
:mod:`flacx_torch.decoder`.
"""

__version__ = "0.1.0"

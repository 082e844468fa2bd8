"""Explicit device resolution: the card by default, the CPU only on request."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``, refusing a CUDA device without CUDA.

    There is no fallback: a caller that wants the plain CPU path passes
    ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"flacx_torch: device {str(dev)!r} requested but CUDA is not "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"flacx_torch: unsupported device {str(dev)!r}")
    return dev


def on_device(dev: torch.device):
    """The context that makes ``dev`` the current card (kernels launch on
    the current card's stream); nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()

"""Emit → pack → CRC of a batch of frames through one kernel.

Counterpart of the JAX package's ``ops/tilepack.py``: the header region's
symbols and the partition-parameter symbols are computed here in plain
PyTorch (small ``[B, C, ·]`` arrays); the per-sample symbols, the bit
packing and the frame CRC-16 happen inside the ``frame_pack`` kernel,
which takes the plan's per-segment parameters instead of its per-sample
expansions.
"""

from __future__ import annotations

import torch

from flacx_torch.kernels.frame_pack import frame_pack
from flacx_torch.ops.emit import (partition_param_symbols,
                                  subframe_header_symbols)
from flacx_torch.ops.headers import HeaderSymbols
from flacx_torch.ops.rice import RicePlan


def pack_frames(hdr: HeaderSymbols, kind: torch.Tensor, order: torch.Tensor,
                bps: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                shift: torch.Tensor, precision: int, zz: torch.Tensor,
                plan: RicePlan, psize_min: int, max_frame_bytes: int,
                wasted: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Frame bytes ``u8 [B, max_frame_bytes]`` (CRC-16 appended) and
    lengths ``int32 [B]`` of the chosen subframes; arguments as
    :func:`flacx_torch.ops.emit.subframe_symbols` plus the frame header
    symbols ``hdr``."""
    sh_v, sh_l = subframe_header_symbols(kind, order, bps, x, taps, shift,
                                         precision, plan, wasted)
    pv, pl = partition_param_symbols(kind, plan)
    kesc = plan.k_seg.to(torch.int32) | (plan.esc_seg.to(torch.int32) << 7)
    return frame_pack(hdr.values, hdr.lengths, sh_v, sh_l, pv, pl, zz, x,
                      kesc, kind, order, bps, psize_min, max_frame_bytes)

"""Frame header construction as byte symbols for the bit packer.

The FLAC frame header is byte-aligned throughout (sync + flags are exactly
4 bytes, then whole-byte coded-number / uncommon-size / CRC-8 fields), so
it is built as byte *symbols* with per-symbol distances-from-end, and the
trailing CRC-8 folds without first compacting the variable layout.
Sample rate and sample size use the from-streaminfo encoding; the channel
field is per frame (the stereo mode is chosen per frame).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from flacx_torch.format import encode_block_size_bits
from flacx_torch.ops.crcfold import crc8_fold

SAMPLE_RATE_FROM_STREAMINFO = 0b0000
SAMPLE_SIZE_FROM_STREAMINFO = 0b000

#: coded-number size thresholds: value >= 2^cap ⇒ one more byte
_CN_THRESHOLDS = (7, 11, 16, 21, 26, 31)
#: prefix byte leading-ones pattern per total size 1..7
_CN_PREFIX = (0x00, 0xC0, 0xE0, 0xF0, 0xF8, 0xFC, 0xFE)


@lru_cache(maxsize=None)
def _cn_prefix(device: torch.device) -> torch.Tensor:
    """:data:`_CN_PREFIX` on ``device``, built once a device."""
    return torch.tensor(_CN_PREFIX, dtype=torch.int64, device=device)


def frame_indices(frame_index, b: int, device: torch.device) -> torch.Tensor:
    """Each frame's coded number, ``[b]`` int64 on ``device``: a scalar
    ``frame_index`` is the first of ``b`` consecutive frames, a ``[b]``
    array or tensor gives every frame its own (a corpus batch mixes the
    frames of many files).  An array of another shape raises.  A 0-d
    tensor is read on the device, never on the host: a captured graph's
    input, written before each replay."""
    if isinstance(frame_index, torch.Tensor) and not frame_index.ndim:
        return frame_index.to(device, torch.int64) + torch.arange(
            b, dtype=torch.int64, device=device)
    if isinstance(frame_index, (torch.Tensor, np.ndarray)) \
            and frame_index.ndim:
        if tuple(frame_index.shape) != (b,):
            raise ValueError(f"frame indices of shape "
                             f"{tuple(frame_index.shape)} for a batch of "
                             f"{b} frames")
        return torch.as_tensor(frame_index).to(device, torch.int64)
    return int(frame_index) + torch.arange(b, dtype=torch.int64,
                                           device=device)


class HeaderSymbols(NamedTuple):
    values: torch.Tensor    # [B, H] int64 (byte values)
    lengths: torch.Tensor   # [B, H] int32
    nbytes: torch.Tensor    # [B] header length in bytes (incl. CRC-8)


def frame_header_symbols(frame_index: torch.Tensor, ch_code: torch.Tensor,
                         block_size: int) -> HeaderSymbols:
    """Header byte-symbols for a batch of frames.

    Args:
      frame_index: ``[B]`` int64 frame ordinals (fixed blocking strategy).
      ch_code: ``[B]`` int32 4-bit channel-assignment codes.
      block_size: block size (full blocks only).
    """
    b = frame_index.shape[0]
    dev = frame_index.device
    idx = frame_index.long()
    bs_code, bs_extra_bits, bs_extra = encode_block_size_bits(block_size)

    def full(v):
        return torch.full((b,), v, dtype=torch.int64, device=dev)

    size = torch.ones(b, dtype=torch.int64, device=dev)
    for cap in _CN_THRESHOLDS:
        size = size + (idx >= (1 << cap)).long()

    # fixed four bytes: sync(15) + blocking(1) = FF F8, then packed codes
    b0 = full(0xFF)
    b1 = full(0xF8)
    b2 = full((bs_code << 4) | SAMPLE_RATE_FROM_STREAMINFO)
    b3 = (ch_code.long() << 4) | (SAMPLE_SIZE_FROM_STREAMINFO << 1)

    # coded-number byte slots 0..6
    prefix = _cn_prefix(dev)[size - 1]
    top = (idx >> (6 * (size - 1))) & 0xFFFFFFFF
    cn0 = torch.where(size == 1, idx & 0xFFFFFFFF, prefix | top)
    cn_vals, cn_lens = [cn0], [full(8)]
    for t in range(1, 7):
        sh = torch.clamp(6 * (size - 1 - t), min=0)
        cn_vals.append(0x80 | ((idx >> sh) & 0x3F))
        cn_lens.append(torch.where(t < size, 8, 0))

    # uncommon-block-size extra bytes (0, 1 or 2 of them)
    n_extra = bs_extra_bits // 8
    extra_vals = [full((bs_extra >> (8 * (n_extra - 1 - i))) & 0xFF)
                  for i in range(n_extra)]
    extra_lens = [full(8)] * n_extra

    values = torch.stack([b0, b1, b2, b3, *cn_vals, *extra_vals], dim=-1)
    lengths = torch.stack([full(8)] * 4 + cn_lens + extra_lens,
                          dim=-1).to(torch.int32)

    # CRC-8 over all active bytes: fixed slots at 0..3; cn slot t at 4+t;
    # extra slot e at 4+size+e
    h = values.shape[-1]
    slot = torch.arange(h, dtype=torch.int64, device=dev)
    active = lengths > 0
    pos = torch.where(slot < 11, slot, 0).expand(b, h)
    if n_extra:
        pos = torch.where(slot >= 11, 4 + size[:, None] + (slot - 11), pos)
    total_precrc = 4 + size + n_extra
    dist = total_precrc[:, None] - 1 - pos
    crc = crc8_fold(values, dist, active)

    values = torch.cat([values, crc[:, None]], dim=-1)
    lengths = torch.cat(
        [lengths, torch.full((b, 1), 8, dtype=torch.int32, device=dev)],
        dim=-1)
    return HeaderSymbols(values=values, lengths=lengths,
                         nbytes=total_precrc + 1)

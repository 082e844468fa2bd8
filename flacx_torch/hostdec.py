"""The host's full parse of a batch of equal-block-size frames.

The decode grammar is bit-serial *within* a frame, but frames are
independent: the native runtime (``flacx_torch.native``, threaded C++)
parses every frame of a batch into structure-of-arrays form, residual
values included.  This is the decoder's host route, taken when the device
route flags an error or a CRC-16 mismatch; reconstruction then runs
through ``flacx_torch.kernels.reconstruct``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ParsedFrames(NamedTuple):
    """Structure-of-arrays for F parsed frames (C coded channels)."""
    channel_code: np.ndarray   # [F]
    kind: np.ndarray           # [F, C] 0=const 1=verb 2=fixed 3=lpc
    order: np.ndarray          # [F, C]
    shift: np.ndarray          # [F, C]
    taps: np.ndarray           # [F, C, 32]
    wasted: np.ndarray         # [F, C]
    residual: np.ndarray       # [F, C, N] int64 (warmup at i<order;
    #                            constants replicated; verbatim raw)
    end_bits: np.ndarray       # [F] cursor after last subframe (pre-padding)


def parse_frames(data: np.ndarray, start_bits: np.ndarray, block_size: int,
                 channels: int, bps: int) -> ParsedFrames:
    """Parse F equal-block-size frames with the native runtime.

    Args:
      data: ``[F, L]`` u8 — each row holds (at least) one whole frame.
      start_bits: ``[F]`` bit offset of each frame's sync code in its row.
      block_size / channels / bps: stream parameters (from Streaminfo).
    Raises ValueError on a parse error.
    """
    from flacx_torch.native import lib

    f = data.shape[0]
    data = np.ascontiguousarray(data, np.uint8)
    start = np.ascontiguousarray(start_bits, np.int64)
    channel_code = np.zeros(f, np.int32)
    kind = np.zeros((f, channels), np.int32)
    order = np.zeros((f, channels), np.int32)
    shift = np.zeros((f, channels), np.int32)
    wasted = np.zeros((f, channels), np.int32)
    taps = np.zeros((f, channels, 32), np.int32)
    residual = np.zeros((f, channels, block_size), np.int64)
    end_bits = np.zeros(f, np.int64)
    rc = lib().fxt_parse_frames(
        data.ctypes.data, f, data.shape[1], start.ctypes.data, block_size,
        channels, bps, channel_code.ctypes.data, kind.ctypes.data,
        order.ctypes.data, shift.ctypes.data, wasted.ctypes.data,
        taps.ctypes.data, residual.ctypes.data, end_bits.ctypes.data, None)
    if rc != 0:
        raise ValueError(f"frame parse error in row {int(rc) - 1}")
    return ParsedFrames(channel_code=channel_code,
                        kind=kind.astype(np.int64),
                        order=order.astype(np.int64),
                        shift=shift.astype(np.int64),
                        taps=taps.astype(np.int64), wasted=wasted,
                        residual=residual, end_bits=end_bits)
